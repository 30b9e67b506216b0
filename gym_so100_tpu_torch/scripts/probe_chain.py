"""What per-operation overhead costs against one fused kernel: a chain of
small elementwise operations run op by op and as one kernel.

    python -m gym_so100_tpu_torch.scripts.probe_chain            # on the card
    python -m gym_so100_tpu_torch.scripts.probe_chain --device cpu

The port of the JAX package's probe `devtools/probe_pallas.py`.  Per env,
n times: rotate v by the unit quaternion q, v3 = M v2, M <- 0.999 M +
0.001 v3 v2^T, v <- (v3 + v2) / 2; the result is v.  The tensors are
structures of arrays: q (4, B), v (3, B), M (9, B) with M[i][j] in row
3 i + j (the probe's (C, B / 1024, 8, 128) tiles are a view of the same
memory).  The inputs are the probe's: q a normal draw normalised, v a
normal draw, M = 0.1 normal + I, here from numpy's generator with a seed.

* `chain_plain`: the plain version, op by op in the Pallas kernel's order
  (`pallas_kernel`), every product and sum its own operation;
* `chain_body_fn`: op by op in `body_fn`'s order (crosses, einsums), the
  counterpart of the probe's `chain_scan` and `chain_unroll`;
* `chain_fused`: the hand-written kernel `csrc/chain_probe.cu` for CUDA
  tensors (one launch per call, counted in `chain_fused.launches`),
  `chain_plain` for CPU tensors.

`main` times, as the probe does: (a) `chain_body_fn` at n = 50; (b) the
same at n = 200, and the cost of one more iteration; (c) `torch.compile`
of (a), the counterpart of the probe's unrolled jit, a comparison only;
(d) the kernel at n = 50; and (p) `chain_plain` at n = 50.  On the card the
times are CUDA events over back-to-back calls, it counts the device
kernels that one call of (a) runs, and it reads the kernel's own device
time per launch at n = 0, 50 and 200 from a profiler trace of each (a
call of (d) is shorter on the card than its launch from Python, so the
events time the host): its fixed cost (n = 0) and its time per
iteration (the slope from 50 to 200), in µs and in cycles at the SM
clock that `dependent_latency` measures in the same run, beside the
chain's floor (`chain_floor_ms`); on the CPU they are host clock times.
Each row names the card and its power limit.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

B = 4096
N = 50          # iterations of the probe's chain
N_LONG = 200    # the probe's second scan length
SEED = 0
REPS = 20       # calls timed per row (the kernel: 5 x REPS)
# float operations per env and iteration, as the kernel does them: the two
# crosses and the doubling 12 + 9, the rotation 9, M v 15, the M update 3 +
# 27, the mean 9
OPS_PER_ITER = 84
# dependent float operations per iteration: v -> t (3 deep) -> w t, ct (2)
# -> r (1) -> M r (3) -> v (2); the chain's floor is CHAIN_DEPTH n of them
CHAIN_DEPTH = 11
# the kinds of dependent operation that csrc/chain_latency.cu times
LATENCY_KINDS = ("fadd", "fmul", "fmul_fadd", "shfl")
LATENCY_ITERS = 1024    # x 64 dependent operations per timed chain


def probe_inputs(num_envs=B, seed=SEED):
    """The probe's inputs as float32 numpy arrays (4, B), (3, B), (9, B)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((num_envs, 4)).astype(np.float32)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.standard_normal((num_envs, 3)).astype(np.float32)
    M = (rng.standard_normal((num_envs, 3, 3)).astype(np.float32) * np.float32(0.1)
         + np.eye(3, dtype=np.float32))
    return (np.ascontiguousarray(q.T), np.ascontiguousarray(v.T),
            np.ascontiguousarray(M.reshape(num_envs, 9).T))


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def chain_plain(q, v, M, n=N):
    """The chain op by op in `pallas_kernel`'s order (probe_pallas.py:75-105):
    (4, B), (3, B), (9, B) -> v (3, B)."""
    w, xyz = q[0], [q[1], q[2], q[3]]
    vs = [v[i] for i in range(3)]
    Ms = [[M[3 * i + j] for j in range(3)] for i in range(3)]
    for _ in range(n):
        t = [2.0 * x for x in _cross(xyz, vs)]
        ct = _cross(xyz, t)
        v2 = [vs[i] + w * t[i] + ct[i] for i in range(3)]
        v3 = [Ms[i][0] * v2[0] + Ms[i][1] * v2[1] + Ms[i][2] * v2[2] for i in range(3)]
        Ms = [[Ms[i][j] * 0.999 + 0.001 * v3[i] * v2[j] for j in range(3)]
              for i in range(3)]
        vs = [v3[i] * 0.5 + v2[i] * 0.5 for i in range(3)]
    return torch.stack(vs)


def chain_body_fn(q, v, M, n):
    """The chain op by op in `body_fn`'s order (probe_pallas.py:38-48):
    crosses over the component axis, then the two einsums."""
    B_ = q.shape[1]
    w, xyz = q[:1], q[1:]
    M = M.reshape(3, 3, B_)
    for _ in range(n):
        t = 2 * torch.linalg.cross(xyz, v, dim=0)
        v2 = v + w * t + torch.linalg.cross(xyz, t, dim=0)
        v3 = torch.einsum("ijb,jb->ib", M, v2)
        M = M * 0.999 + 0.001 * torch.einsum("ib,jb->ijb", v3, v2)
        v = v3 * 0.5 + v2 * 0.5
    return v


def chain_fused(q, v, M, n=N):
    """The chain as one kernel launch for CUDA tensors (float32, contiguous;
    raises otherwise), `chain_plain` for CPU tensors."""
    if q.device.type == "cpu":
        return chain_plain(q, v, M, n)
    from .. import kernels

    B_ = q.shape[1]
    kernels.check(q, (4, B_), torch.float32, "q")
    kernels.check(v, (3, B_), torch.float32, "v")
    kernels.check(M, (9, B_), torch.float32, "M")
    out = torch.empty(3, B_, dtype=torch.float32, device=q.device)
    kernels.launch("gst_chain_probe", q, v, M, out, int(n), B_)
    chain_fused.launches += 1
    return out


chain_fused.launches = 0


def compare(out, ref):
    """How far `out` is from `ref` (same shape): `same_nonfinite` whether the
    non-finite components are the same set with the same infinities (nan
    where nan), `max_abs_err` over the finite ones, and the counts."""
    fin = torch.isfinite(ref)
    same = (torch.equal(fin, torch.isfinite(out))
            and torch.equal(torch.isnan(ref), torch.isnan(out))
            and torch.equal(out[torch.isinf(ref)], ref[torch.isinf(ref)]))
    err = float((out[fin].double() - ref[fin].double()).abs().max()) if fin.any() else 0.0
    lanes = int((~fin).any(0).sum())
    return dict(same_nonfinite=same, max_abs_err=err, nonfinite_lanes=lanes,
                lanes=ref.shape[1])


def card_name_and_power():
    """nvidia-smi's name and power limit of the card, or '' without one."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return ""
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else ""


def timed_ms(fn, reps, device):
    """Mean ms of fn() over `reps` calls after one warm-up call: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_events(fn, reps=1):
    """The device events (kernels, copies, sets) of a profiler trace of
    `reps` calls of fn(), after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def kernel_device_us(fn, reps, tries=3):
    """Mean device time (µs) of the chain kernel's launches in a profiler
    trace of `reps` calls of fn() (after a warm-up call), counting only the
    kernels inside the trace's device-side span of the calls.  The profiler
    now and then loses kernel events, and late in a long process a trace
    has held kernels that fell outside that span: a trace that holds fewer
    than half of the calls' kernels is taken again, up to `tries` traces;
    None if every one fell short."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("chain_probe_timed"):
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
        ev = [e.time_range for e in prof.events() if e.device_type == DeviceType.CUDA
              and e.name == "chain_probe_timed"]
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and "chain_probe_kernel" in e.name
              and any(s.start <= e.time_range.start <= s.end for s in ev)]
        if len(us) * 2 >= reps:
            return sum(us) / len(us)
    return None


def dependent_latency(lib=None):
    """The current card's cycles per dependent operation of each of
    LATENCY_KINDS (the least of 3 chains of 64 LATENCY_ITERS operations on
    one warp, the loop's branch included) and its SM clock in GHz (the
    median over the chains of clock64() cycles over %globaltimer ns), from
    `gst_chain_latency` (csrc/chain_latency.cu) in `lib`, the port's
    library by default."""
    from gym_so100_tpu_torch import kernels

    if lib is None:
        lib = kernels.library()
    fn = lib.gst_chain_latency
    fn.argtypes, fn.restype = kernels._SIGNATURES["gst_chain_latency"]
    inp = torch.ones(34, device="cuda")
    inp[33] = 0.0
    out = torch.empty(32, device="cuda")
    res = torch.zeros(2, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ops = 64 * LATENCY_ITERS
    cycles, ghz = {}, []
    for kind, label in enumerate(LATENCY_KINDS):
        runs = []
        for _ in range(3):
            err = fn(inp.data_ptr(), out.data_ptr(), res.data_ptr(), kind, LATENCY_ITERS,
                     stream)
            if err != 0:
                raise RuntimeError(f"gst_chain_latency: CUDA error {err} at launch")
            c, ns = res.tolist()
            runs.append(c / ops)
            ghz.append(c / ns)
        cycles[label] = min(runs)
    return dict(cycles_per_op=cycles, sm_clock_ghz=statistics.median(ghz),
                ops_per_chain=ops)


def chain_floor_ms(n, lat):
    """The least time of n iterations of the chain: CHAIN_DEPTH n dependent
    float operations at the alternating FMUL/FADD latency and the SM clock
    of `lat` (`dependent_latency`)."""
    return CHAIN_DEPTH * n * lat["cycles_per_op"]["fmul_fadd"] / lat["sm_clock_ghz"] / 1e6


def timings(q, v, M, rows="abcdp", reps=REPS, log=print, card=""):
    """Run the rows of `main` on these tensors; returns their numbers.
    `kernel_calls` is how many times row (d) called `chain_fused`."""
    device = q.device
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    on = f" on {card}" if card else ""
    res = {}
    if "a" in rows or "b" in rows:
        res["a_ms"] = timed_ms(lambda: chain_body_fn(q, v, M, N), reps, device)
        log(f"(a) eager chain_body_fn n = {N}: {res['a_ms']:.4f} ms ({clock}){on}")
        if device.type == "cuda":
            res["a_kernels"] = len(device_events(lambda: chain_body_fn(q, v, M, N))) or None
        log(f"    device kernels per call of (a): "
            f"{res.get('a_kernels') or 'not measured'}")
    if "b" in rows:
        res["b_ms"] = timed_ms(lambda: chain_body_fn(q, v, M, N_LONG), max(reps // 4, 1),
                               device)
        res["us_per_iter"] = (res["b_ms"] - res["a_ms"]) / (N_LONG - N) * 1e3
        log(f"(b) eager chain_body_fn n = {N_LONG}: {res['b_ms']:.4f} ms ({clock}){on}")
        log(f"    per extra iteration: {res['us_per_iter']:.3f} us")
        if res.get("a_kernels"):
            res["us_per_kernel"] = res["a_ms"] * 1e3 / res["a_kernels"]
            log(f"    per device kernel of (a): {res['us_per_kernel']:.3f} us")
    if "c" in rows:
        compiled = torch.compile(lambda q_, v_, M_: chain_body_fn(q_, v_, M_, N))
        t0 = time.perf_counter()
        compiled(q, v, M)
        res["c_compile_s"] = time.perf_counter() - t0
        res["c_ms"] = timed_ms(lambda: compiled(q, v, M), reps, device)
        log(f"(c) torch.compile of (a): {res['c_ms']:.4f} ms ({clock}; compiled in "
            f"{res['c_compile_s']:.1f} s){on}")
    if "d" in rows:
        res["kernel_calls"] = 1 + 5 * reps
        res["d_ms"] = timed_ms(lambda: chain_fused(q, v, M, N), 5 * reps, device)
        log(f"(d) chain_fused n = {N}: {res['d_ms']:.4f} ms per call ({clock}){on}")
        if device.type == "cuda":
            ns = (0, N, N_LONG)
            calls = []

            def fused(n):
                calls.append(n)
                return chain_fused(q, v, M, n)

            dev = {n: kernel_device_us(lambda n=n: fused(n), reps) for n in ns}
            res["kernel_calls"] += len(calls)
            dev = {n: us / 1e3 for n, us in dev.items() if us is not None}
            res["d_device_ms"] = dev.get(N)
            log(f"    the kernel's device time per launch (profiler): " + ", ".join(
                f"n = {n} " + (f"{dev[n]:.5f} ms" if n in dev else "not measured")
                for n in ns))
            if len(dev) == len(ns):
                res["d_fixed_ms"] = dev[0]
                res["d_us_per_iter"] = (dev[N_LONG] - dev[N]) / (N_LONG - N) * 1e3
            lat = res["latency"] = dependent_latency()
            ghz = lat["sm_clock_ghz"]
            res["chain_floor_ms"] = chain_floor_ms(N, lat)
            log(f"    dependent latency (csrc/chain_latency.cu): " + ", ".join(
                f"{k} {c:.3f}" for k, c in lat["cycles_per_op"].items())
                + f" cycles; SM clock {ghz:.4f} GHz; the chain's floor at n = {N} "
                f"{res['chain_floor_ms']:.6f} ms ({CHAIN_DEPTH} x {N} dependent operations)")
            if "d_us_per_iter" in res:
                res["d_cycles_per_iter"] = res["d_us_per_iter"] * ghz * 1e3
                log(f"    fixed cost (n = 0) {dev[0] * 1e3:.3f} us, per iteration "
                    f"{res['d_us_per_iter'] * 1e3:.2f} ns, "
                    f"{res['d_cycles_per_iter']:.1f} cycles at {ghz:.4f} GHz")
        for r in "ac":
            if f"{r}_ms" in res:
                res[f"d_over_{r}"] = res[f"{r}_ms"] / res["d_ms"]
                log(f"    speedup of (d) over ({r}): {res[f'd_over_{r}']:.1f}x")
    if "p" in rows:
        res["p_ms"] = timed_ms(lambda: chain_plain(q, v, M, N), reps, device)
        log(f"(p) chain_plain n = {N}: {res['p_ms']:.4f} ms ({clock}){on}")
    return res


def main(device="cuda", argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=device)
    p.add_argument("--rows", default="abcdp",
                   help="rows to run: a, b, c, d, p (default all)")
    args = p.parse_args(argv)
    from ..device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    card = card_name_and_power() if dev.type == "cuda" else "the CPU"
    q, v, M = (torch.from_numpy(a).to(dev) for a in probe_inputs())
    print(f"probe_chain: B = {B}, float32, seed {SEED}, on {card}", flush=True)
    timings(q, v, M, rows=args.rows, log=lambda s: print(s, flush=True), card=card)
    if dev.type == "cuda":
        print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
