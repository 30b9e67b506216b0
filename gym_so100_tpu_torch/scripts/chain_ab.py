"""Build the chain probe kernel's sources and time them against each other
on one GPU.

    python -m gym_so100_tpu_torch.scripts.chain_ab \\
        --source old=path/to/old/chain_probe.cu \\
        --source new=gym_so100_tpu_torch/csrc/chain_probe.cu

Each source is compiled alone with the port's flags
(`newton_ab.nvcc_library`) into a library of its own under
`gym_so100_tpu_torch/_build/ab/`, one after another; each build's nvcc
seconds, ptxas lines and launch shape are printed.  Then, on the probe's
inputs (`probe_chain.probe_inputs`, seed 0) at each `--batch` (default
4096, the probe's):

* every build's output at each `--ns` (default 0, 50 and 200 iterations)
  is held bit-equal to the first build's, and at n = 0 and 50 to
  `probe_chain.chain_plain` (the non-finite components as sets, nan where
  nan: `probe_chain.compare`);
* ROUNDS rounds, in alternating order (first to last, then last to
  first), of a profiler trace of REPS launches of each build at each n
  (`probe_chain.kernel_device_us`); a call from Python takes longer than
  the kernel, so a launch's time is its kernel's device time in the
  trace.  Per build: the median over the rounds of the mean µs at each n,
  the fixed cost (the time at the smallest n), and the ns and cycles per
  iteration (the slope between the two largest n; cycles at the SM clock
  measured first).

Before the builds are timed it measures the card's dependent latencies
and SM clock (`probe_chain.dependent_latency`, from
`csrc/chain_latency.cu` built alone) and gives the chain's floor at n =
50 and 200 (`probe_chain.chain_floor_ms`).

Prints the latency probe's JSON line, one JSON line per batch, then the
card's name and power limit; exits 1 if builds disagree.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from gym_so100_tpu_torch import kernels
from gym_so100_tpu_torch.scripts import probe_chain as pc
from gym_so100_tpu_torch.scripts.newton_ab import nvcc_library

ROUNDS = 10     # timing rounds, in alternating order
REPS = 20       # launches per build, n and round
_P, _I = ctypes.c_void_p, ctypes.c_int


def build_all(sources):
    """{name: (library, launch shape at B = 4096, nvcc seconds, ptxas lines)}."""
    built = {}
    for name, path in sources:
        lib, seconds, ptxas = nvcc_library(f"libchain_{name}.so", [path],
                                           entry="chain_probe")
        lib.gst_chain_probe.argtypes = [_P] * 4 + [_I] * 2 + [_P]
        lib.gst_chain_probe.restype = ctypes.c_int
        shape = (ctypes.c_int * 3)()
        lib.gst_chain_probe_shape.argtypes = [_I, _P]
        lib.gst_chain_probe_shape(pc.B, ctypes.cast(shape, _P))
        built[name] = (lib, tuple(shape), seconds, ptxas)
    return built


def run_batch(B, ns, built, clock_ghz):
    q, v, M = (torch.from_numpy(a).to("cuda") for a in pc.probe_inputs(B))
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (q, v, M)]
    outs = {n: torch.empty(3, B, device="cuda") for n in ns}
    res, ref = {}, {}
    plain = {n: pc.chain_plain(q, v, M, n) for n in ns if n in (0, pc.N)}

    def call(lib, n):
        return lambda: lib.gst_chain_probe(*ptrs, outs[n].data_ptr(), n, B, stream)

    for name, (lib, _, _, _) in built.items():
        entry = dict(equal=True, equal_plain=True)
        for n in ns:
            outs[n].fill_(float("nan"))
            assert call(lib, n)() == 0
            torch.cuda.synchronize()
            out = outs[n].clone()
            ref.setdefault(n, out)
            c = pc.compare(out, ref[n])
            entry["equal"] &= bool(c["same_nonfinite"] and c["max_abs_err"] == 0.0)
            if n in plain:
                c = pc.compare(out, plain[n])
                entry["equal_plain"] &= bool(c["same_nonfinite"] and c["max_abs_err"] == 0.0)
        res[name] = entry
    names = list(built)
    per = {(name, n): [] for name in names for n in ns}
    for r in range(ROUNDS):
        for name in (names if r % 2 == 0 else names[::-1]):
            for n in ns:
                us = pc.kernel_device_us(call(built[name][0], n), REPS)
                if us is None:
                    raise RuntimeError(f"{name} n = {n}: the trace lost its kernel events")
                per[name, n].append(us)
    lo, hi = sorted(ns)[-2:]
    for name in names:
        per_n = {n: per[name, n] for n in ns}
        med = {n: statistics.median(per_n[n]) for n in ns}
        ns_iter = (med[hi] - med[lo]) / (hi - lo) * 1e3
        res[name].update(
            us=med, us_rounds=per_n, fixed_us=med[min(ns)], ns_per_iter=ns_iter,
            cycles_per_iter=ns_iter * clock_ghz if clock_ghz else None,
            launch_shape=built[name][1])
    print(json.dumps({"B": B, "ns": list(ns), "rounds": ROUNDS, "reps": REPS,
                      "builds": res}), flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", action="append", required=True, metavar="NAME=PATH",
                    help="a chain_probe.cu to build and time (repeat; the first is the "
                         "reference of the bit-equality check)")
    ap.add_argument("--batch", default=str(pc.B), help="comma-separated batches (envs)")
    ap.add_argument("--ns", default=f"0,{pc.N},{pc.N_LONG}",
                    help="comma-separated iteration counts (the slope: the two largest)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chain_ab: no CUDA device", file=sys.stderr)
        return 2
    sources = [tuple(s.split("=", 1)) for s in a.source]
    for _, path in sources:
        if not Path(path).is_file():
            raise FileNotFoundError(path)
    lib, seconds, _ = nvcc_library("libchain_latency.so", [kernels.CSRC / "chain_latency.cu"])
    lat = pc.dependent_latency(lib)
    ghz = lat["sm_clock_ghz"]
    lat.update(nvcc_s=seconds,
               chain_floor_us={n: pc.chain_floor_ms(n, lat) * 1e3 for n in (pc.N, pc.N_LONG)})
    print(json.dumps({"latency": lat}), flush=True)
    built = build_all(sources)
    for name, (_, shape, seconds, ptxas) in built.items():
        print(f"{name}: nvcc {seconds:.1f} s, launch shape {shape} (envs per block, "
              f"threads, shared bytes)", flush=True)
        for ln in ptxas:
            print(f"{name} ptxas: {ln}", flush=True)
    ns = [int(n) for n in a.ns.split(",")]
    ok = True
    for B in (int(b) for b in a.batch.split(",")):
        res = run_batch(B, ns, built, ghz)
        ok &= all(e["equal"] and e["equal_plain"] for e in res.values())
        for name, e in res.items():
            print(f"B = {B} {name}: " + ", ".join(f"n = {n} {e['us'][n]:.4f} us" for n in ns)
                  + f"; fixed {e['fixed_us']:.4f} us, {e['ns_per_iter']:.3f} ns "
                  f"({e['cycles_per_iter']:.1f} cycles) per iteration; bit-equal "
                  f"{e['equal']}, to chain_plain {e['equal_plain']}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    if not ok:
        print("chain_ab: builds disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
