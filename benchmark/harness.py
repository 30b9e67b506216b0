"""One run of one benchmark cell: set-up, the measured window, the
reference's check and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json` `workloads`) names a configuration
(`benchmark/configs/<config>.json`: scene, task, precision, contact slots,
observation mode) and a traffic mix (`benchmark/traffic/<traffic>.json`,
read by `traffic.Traffic`).  The program under test is
`gym_so100_tpu_torch`; the window drives its public batched env step,
`BatchedEnv.step`, in a closed loop.  Metrics are found by name: each is a
reader `benchmark/metrics/<name>.py` with `read(run) -> float | None`.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from . import check, imports
from . import trace as tracing
from . import traffic as traffic_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Run:
    """What a metric reader reads: the cell, the window's record and, in a
    traced run, the trace of one control step."""

    def __init__(self, cell, config, traffic):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.setup_s = None
        self.window_s = None
        self.steps = 0
        self.env_steps = 0
        self.step_s = []          # host clock per control step (diagnostic)
        self.cpu_s = []           # the main thread's CPU time per control step
        self.failed = 0
        self.trace = None
        self.shapes = None        # the cell's kernel shapes, from the reference model
        self.records = []
        self.start = None
        self.marks = {}           # set-up phases, seconds since process start


def load_benchmark():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find_cell(bench, name):
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return cell, json.loads((ROOT / config["file"]).read_text())


def metrics_for(bench, cell, kind):
    """The cell's `end_to_end` or `per_layer` entries."""
    return [m for m in bench[kind]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def reader(name):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_state():
    """nvidia-smi's line for the card: name, power limit, SM clock and its
    maximum, power draw, temperature (None where it cannot be read)."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
             "power.draw,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def build_program(config, num_envs, seed, device):
    """The program's batched env for the configuration."""
    import torch

    from gym_so100_tpu_torch.models.builder import build_model
    from gym_so100_tpu_torch.parallel.batch import BatchedEnv

    if config["dtype"] != "float32":
        raise ValueError("the configurations run in float32")
    os.environ["GST_OBS_TRIS"] = str(config["tris_per_mesh"])
    m, aux = build_model(str(ROOT / config["scene_xml"]), max_contacts=config["max_contacts"],
                         device=device, dtype=torch.float32)
    return BatchedEnv(m, task=config["task"], num_envs=num_envs,
                      hull_contacts=config["hull_contacts"], obs_mode=config["obs_mode"],
                      device=device, seed=seed, max_contacts=config["max_contacts"],
                      obs_height=config["obs_height"], obs_width=config["obs_width"],
                      render_aux=aux)


def _nonfinite(es, obs, reward):
    """(B,) envs whose returned state, obs or reward is not finite."""
    import torch

    bad = ~torch.isfinite(reward)
    for x in (es.physics.qpos, es.physics.qvel):
        bad |= ~torch.isfinite(x).all(1)
    o = obs["agent_pos"] if isinstance(obs, dict) else obs
    return bad | ~torch.isfinite(o).all(1)


def drive(run, env, traffic, device, seconds=None, max_steps=None, trace=False,
          t_process=None, sync=None):
    """Reset, warm up, then the window: control steps in a closed loop until
    `seconds` have passed (the step under way then finishes and counts) and
    the checked steps are done, or until `max_steps` are done.  Keeps the
    checked steps' records in `run.records`.  With `trace`, once the window
    has closed, one more control step runs under the profiler, outside the
    window, and its Trace goes to `run.trace`."""
    import torch

    sync = sync or (lambda: torch.cuda.synchronize(device))
    mark = (lambda k: run.marks.__setitem__(k, time.perf_counter() - t_process)) \
        if t_process is not None else (lambda k: None)
    poses, ages = traffic.initial()
    es = env.reset(box_pose=poses)
    es = es.replace(t=ages)
    run.start = (check.state_only(es), poses, ages)
    sync()
    mark("reset")
    for _ in range(int(traffic.spec["warmup_steps"])):
        es = env.step(es, *traffic.step_inputs())[0]
    sync()
    mark("warm-up")
    wanted = set(traffic.check_steps())
    min_steps = int(traffic.spec["check"]["last"]) + 1
    bad = torch.zeros((), dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    if t_process is not None:
        run.setup_s = t0 - t_process
    i = 0
    while True:
        actions, spawn = traffic.step_inputs()
        rec = None
        if i in wanted:
            rec = check.Record(i, check.state_only(es), actions.clone(), spawn.clone())
        ts, cs = time.perf_counter(), time.thread_time()
        out = env.step(es, actions, reset_box_pose=spawn)
        es2, obs, reward, term, trunc, info = out
        bad += _nonfinite(es2, obs, reward).sum()
        if rec is not None:
            rec.out = check.outputs_of(es2, obs, reward, term, trunc, info["final_obs"])
            run.records.append(rec)
        es = es2
        i += 1
        run.step_s.append(time.perf_counter() - ts)
        run.cpu_s.append(time.thread_time() - cs)
        if max_steps is not None and i >= max_steps:
            break
        if seconds is not None and time.perf_counter() - t0 >= seconds and i >= min_steps:
            break
    sync()
    run.window_s = time.perf_counter() - t0
    run.steps = i
    run.env_steps = i * traffic.envs
    run.failed = int(bad)
    if trace:
        actions, spawn = traffic.step_inputs()
        out, prof = tracing.capture(lambda: env.step(es, actions, reset_box_pose=spawn))
        es = out[0]
        run.trace = tracing.from_kineto(prof.profiler.kineto_results.events())
    return es


def kernel_shapes(ref, envs):
    """The cell's shapes that the roofline readers take, worked out from
    the reference's own model (its constraint rows at one resting env)."""
    import torch

    from .reference.ops import constraint_lanes, smooth_lanes
    from .reference.ops.collision import hull_lanes, narrowphase
    from .reference.models.scene import Data

    m = ref.env.m
    tb = hull_lanes.hull_tables(m)
    pose = torch.tensor([[-0.2, 0.45, 0.05, 1.0, 0.0, 0.0, 0.0]], dtype=m.dtype, device=m.device)
    es = ref.env.reset(pose)
    s = es.physics
    sl = smooth_lanes.forward_smooth_lanes(m, s)
    d = Data(geom_xpos=sl["geom_xpos"], geom_xmat=sl["geom_xmat"],
             site_xpos=sl["site_xpos"], site_xmat=sl["site_xmat"],
             subtree_com=sl["subtree_com0"][:, None], cdof=sl["cdof"])
    efc = constraint_lanes.make_efc_from_lanes(m, d, s, narrowphase.collide_batched_lanes(m, d))
    return dict(
        B=envs, nv=m.nv, K=m.max_contacts, neq=efc.neq, nf=efc.nf, nl=efc.nl,
        hull=dict(G=tb.G, ND=int(tb.D.shape[0]), P=tb.P, Vmax=tb.verts.shape[1] // 3,
                  counts=[int(c) for c in tb.counts.tolist()]),
    )


def verify(run, config, device, ref=None):
    """The reference's check of the run's records; returns (correct,
    [(name, value, limit)], the Reference, the Tally)."""
    ref = ref or check.Reference(config, device)
    tally = check.Tally(ref.pixels, config["check"]["off_gap"])
    before, poses, ages = run.start
    tally.start(ref, before, poses, ages)
    for rec in run.records:
        tally.add(ref, rec, rec.out, ref.step(rec, observe=False))
    correct, rows = check.judge(tally.numbers(), config["limits"], tally.steps)
    return correct, rows, ref, tally


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_process):
    args = parse(argv)
    bench = load_benchmark()
    cell, config = find_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"no result: the cell needs {cell['chips']} CUDA device(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tspec = traffic_mod.load(cell["traffic"])
    traffic = traffic_mod.Traffic(tspec, args.seed, device)
    run = Run(cell, config, tspec)
    torch.cuda.synchronize(device)
    run.marks["imports and device"] = time.perf_counter() - t_process
    env = build_program(config, traffic.envs, args.seed, device)
    torch.cuda.synchronize(device)
    run.marks["program built"] = time.perf_counter() - t_process
    kind = "per_layer" if args.trace else "end_to_end"
    wanted = metrics_for(bench, cell, kind)
    # a traced run, or one whose end-to-end metrics come from the device's trace
    traced = bool(args.trace) or any(m["source"] == "device_trace" for m in wanted)
    drive(run, env, traffic, device, seconds=args.seconds, trace=traced, t_process=t_process)
    peak = torch.cuda.max_memory_allocated(device)
    card = card_state()
    print(f"window: {run.steps} control steps of {traffic.envs} envs in {run.window_s:.4f} s; "
          f"set-up {run.setup_s:.4f} s (" + ", ".join(f"{k} at {v:.2f}" for k, v in
                                               run.marks.items()) + "); host s per step "
          + " ".join(f"{x:.4f}" for x in run.step_s) + "; main thread CPU s per step "
          + " ".join(f"{x:.4f}" for x in run.cpu_s) + f"; card: {card}", file=sys.stderr)
    del env
    torch.cuda.empty_cache()

    correct, rows, ref, _ = verify(run, config, device)
    metrics = {}
    if traced:
        run.shapes = kernel_shapes(ref, traffic.envs)
        kernels = [e.name for e in run.trace.device_ops() if e.kind == "kernel"]
        busy = tracing.union_us((e.start, e.end) for e in run.trace.device_ops())
        print(f"trace: one control step after the window, {run.trace.wall_us / 1e3:.3f} ms, "
              f"device busy {busy / 1e3:.3f} ms; host ms by range "
              + json.dumps({r: tracing.range_ms(run.trace, r) for r in tracing.PHYSICS_RANGES})
              + "; events by kind "
              + json.dumps(run.trace.kinds) + "; hull_sweep launches "
              f"{sum('hull_sweep' in n for n in kernels)}, newton_solve launches "
              f"{sum('newton_solve' in n for n in kernels)}, physics ranges "
              + json.dumps({r: len(run.trace.host_ranges(r)) for r in tracing.PHYSICS_RANGES})
              + "; shapes " + json.dumps(run.shapes), file=sys.stderr)
    for m in wanted:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = imports.forbidden_loaded()
    if found:
        print("no result: forbidden modules loaded: " + ", ".join(found), file=sys.stderr)
        return 3
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell["chips"], "memory_peak_bytes": int(peak),
                   "nvidia_smi": card}
    result = {"correct": bool(correct), "attempted": run.env_steps, "failed": run.failed,
              "metrics": metrics, "device": device_info}
    if args.trace:
        busy = tracing.union_us((e.start, e.end) for e in run.trace.device_ops())
        device_info["busy_s"] = busy * 1e-6
        device_info["window_s"] = run.trace.wall_us * 1e-6
        result["breakdown"] = tracing.breakdown(run.trace)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    print(f"correct {bool(correct)}: {len(run.records)} control steps checked", file=sys.stderr)
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0
