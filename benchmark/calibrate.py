"""The readings that the correctness limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --fault-seeds 1,2,3

For each seed of `--seeds` the cell's program (`benchmark/programs/`) runs
the cell's traffic through its checked work, with no timed window, and its
check (`verify`) gives the numbers of a sound run, with what the limits are
chosen from beside them (its `readings`).  For each seed of
`--fault-seeds` the same run is made again with each of the program's
faults planted (`faults`), each fault in a program of its own, built anew
and planted before its first step, and judged the same way.  Prints one
JSON line per run.  Run with the card; the benchmark's own runs do not
run it.
"""

import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark import traffic as traffic_mod  # noqa: E402


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
    prog = harness.program(config)
    spec = traffic_mod.load(cell["traffic"])
    device = torch.device("cuda", 0)
    ref = None

    def one(subject, seed, kind):
        nonlocal ref
        t0 = time.perf_counter()
        run = harness.Run(cell, config, spec)
        try:
            prog.drive(run, subject, prog.traffic(spec, seed, device), device, seconds=0)
            correct, rows, ref, tally = prog.verify(run, config, device, ref)
        except RuntimeError as e:          # a stand-in that crashes has failed
            print(json.dumps({"cell": a.workload, "seed": seed, "kind": kind,
                              "error": str(e)[:400]}), flush=True)
            return
        line = {"cell": a.workload, "seed": seed, "kind": kind, "correct": correct,
                "numbers": {n: v for n, v, _ in rows}, "failed": run.failed}
        if kind == "sound":
            line["extra"] = prog.readings(ref, run, tally)
        line["s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)

    seeds = [int(s) for s in a.seeds.split(",") if s]
    if seeds:
        subject = prog.build(config, spec, 0, device)
        for seed in seeds:
            one(subject, seed, "sound")
        del subject
    fault_seeds = [int(s) for s in a.fault_seeds.split(",") if s]
    if fault_seeds:
        planted = prog.faults(config, device)
        for name in [f for f in a.faults.split(",") if f] or sorted(planted):
            torch.cuda.empty_cache()
            subject = planted[name](prog.build(config, spec, 0, device))
            for seed in fault_seeds:
                one(subject, seed, name)
            del subject
    return 0


if __name__ == "__main__":
    sys.exit(main())
