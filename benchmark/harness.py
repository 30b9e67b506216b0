"""One run of one benchmark cell: set-up, the measured window, the
reference's check and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json` `workloads`) names a configuration
(`benchmark/configs/<config>.json`) and a traffic mix
(`benchmark/traffic/<traffic>.json`).  The configuration names the program
under test, a part of `gym_so100_tpu_torch` and how to drive it: a module
`benchmark/programs/<program>.py` (`batched_env` where it names none; the
contract is `benchmark/programs/__init__.py`'s), which makes the run's
inputs from the traffic file, builds the program, drives the window and
checks it against the plain reference.  Metrics are found by name too:
each is a reader `benchmark/metrics/<name>.py` with
`read(run) -> float | None`.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

from . import imports
from . import trace as tracing
from . import traffic as traffic_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAMS = HERE / "programs"


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
        self.records = []         # what the program's check reads
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


def program(config):
    """The program module that the configuration names,
    `benchmark/programs/<program>.py` (`batched_env` where it names none)."""
    name = config.get("program", "batched_env")
    spec = importlib.util.spec_from_file_location("benchmark.programs." + name,
                                                  PROGRAMS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    prog = program(config)
    tspec = traffic_mod.load(cell["traffic"])
    traffic = prog.traffic(tspec, args.seed, device)
    run = Run(cell, config, tspec)
    torch.cuda.synchronize(device)
    run.marks["imports and device"] = time.perf_counter() - t_process
    subject = prog.build(config, tspec, args.seed, device)
    torch.cuda.synchronize(device)
    run.marks["program built"] = time.perf_counter() - t_process
    kind = "per_layer" if args.trace else "end_to_end"
    wanted = metrics_for(bench, cell, kind)
    # a traced run, or one whose end-to-end metrics come from the device's trace
    traced = bool(args.trace) or any(m["source"] == "device_trace" for m in wanted)
    prog.drive(run, subject, traffic, device, seconds=args.seconds, trace=traced,
               t_process=t_process)
    peak = torch.cuda.max_memory_allocated(device)
    card = card_state()
    print(f"window: {run.steps} control steps, {run.env_steps} env-steps in {run.window_s:.4f} s; "
          f"set-up {run.setup_s:.4f} s (" + ", ".join(f"{k} at {v:.2f}" for k, v in
                                               run.marks.items()) + "); host s per step "
          + " ".join(f"{x:.4f}" for x in run.step_s) + "; main thread CPU s per step "
          + " ".join(f"{x:.4f}" for x in run.cpu_s) + f"; card: {card}", file=sys.stderr)
    del subject
    torch.cuda.empty_cache()

    correct, rows, ref, _ = prog.verify(run, config, device)
    metrics = {}
    if traced:
        run.shapes = prog.kernel_shapes(ref, tspec)
        busy = tracing.union_us((e.start, e.end) for e in run.trace.device_ops())
        print(f"trace: one control step after the window, {run.trace.wall_us / 1e3:.3f} ms, "
              f"device busy {busy / 1e3:.3f} ms; events by kind " + json.dumps(run.trace.kinds)
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
