"""The readings that the correctness limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --fault-seeds 1,2,3

For each seed of `--seeds` the program runs the cell's traffic through its
checked steps (no timed window: control steps until the traffic's
`check.last`), and the harness's own check (`harness.verify`) gives the
numbers of a sound run, with what the limits are chosen from beside them:
the largest state gap, the envs over a few gaps, the reset envs, the envs
with a hull contact, and the terminal gaps of every env against the
reference's own step.  For each seed of `--fault-seeds` the same run is
made again with each fault of `benchmark/faults.py` planted in the
program's step, and judged the same way.  Prints one JSON line per run.
Run with the card; the benchmark's own runs do not run it.
"""

import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from benchmark import check, faults, harness  # noqa: E402
from benchmark import traffic as traffic_mod  # noqa: E402


def extra(ref, run, tally):
    """What the limits are chosen from, beyond the numbers themselves."""
    gaps = torch.cat(tally.gaps).double()
    out = {"gap_max": float(gaps.max()), "reset_envs": tally.done,
           "hull_envs": [ref.hull_envs(rec.before) for rec in run.records]}
    out.update({f"envs_over_{g:g}": int((gaps > g).sum()) for g in (1e-5, 1e-4, 1e-3, 1e-2)})
    # every env's terminal observation against the reference's own step, a
    # larger sample of what the reset envs' terminal_gap reads
    term, frame = 0.0, 0.0
    for rec, mine in zip(run.records, tally.mine):
        last = ref.observe(mine.terminal)
        if ref.pixels:
            term = max(term, check._gap(rec.out.final_obs["agent_pos"], last["agent_pos"]))
            frame = max([frame] + check.frame_shares(rec.out.final_obs["pixels"],
                                                     last["pixels"]).tolist())
        else:
            term = max(term, check._gap(rec.out.final_obs, last))
    out["terminal_gap_every_env"] = term
    if ref.pixels:
        out["terminal_frame_gap_every_env"] = frame
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default="", help="comma-separated; default all")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.load_benchmark()
    cell, config = harness.find_cell(bench, a.workload)
    spec = traffic_mod.load(cell["traffic"])
    device = torch.device("cuda", 0)
    env = harness.build_program(config, int(spec["envs"]), 0, device)
    step = env.step
    ref = check.Reference(config, device)
    last = int(spec["check"]["last"]) + 1

    def one(seed, kind, fault=None):
        t0 = time.perf_counter()
        env.step = step if fault is None else fault(step)
        run = harness.Run(cell, config, spec)
        traffic = traffic_mod.Traffic(spec, seed, device)
        try:
            harness.drive(run, env, traffic, device, max_steps=last)
            correct, rows, _, tally = harness.verify(run, config, device, ref)
        except RuntimeError as e:          # a stand-in that crashes has failed
            print(json.dumps({"cell": a.workload, "seed": seed, "kind": kind,
                              "error": str(e)[:400]}), flush=True)
            return
        line = {"cell": a.workload, "seed": seed, "kind": kind, "correct": correct,
                "numbers": {n: v for n, v, _ in rows}, "failed": run.failed}
        if fault is None:
            line["extra"] = extra(ref, run, tally)
        line["s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)

    for seed in [int(s) for s in a.seeds.split(",") if s]:
        one(seed, "sound")
    fault_seeds = [int(s) for s in a.fault_seeds.split(",") if s]
    if fault_seeds:
        planted = faults.for_config(config, device)
        names = [f for f in a.faults.split(",") if f] or sorted(planted)
        for seed in fault_seeds:
            for name in names:
                one(seed, name, planted[name])
    return 0


if __name__ == "__main__":
    sys.exit(main())
