"""Time builds of the hull sweep kernel against each other on one GPU.

    python -m gym_so100_tpu_torch.scripts.hull_ab \\
        --source old=path/to/old/hull_sweep.cu \\
        --source new=gym_so100_tpu_torch/csrc/hull_sweep.cu

Each source is compiled alone, with the port's nvcc flags
(`kernels.NVCC_FLAGS`), into a library of its own under
`gym_so100_tpu_torch/_build/ab/`; the builds run in parallel, and each
one's ptxas lines (registers, spills) are printed.  Then, on the inputs of
real states built once with the checkout's own modules:

* `k16`: the joint scene, 4096 envs, K = 16, after 12 control steps of
  seeded random actions (the timed state of `chip_smoke.py`'s phase 3);
* `k32`: the joint scene, 128 envs, K = 32, at touchdown (the first control
  step after which at least half the envs have a contact);
* `ee`: the mocap-weld scene (`CartesianBatchedEnv`), 1024 envs, K = 32,
  after 10 moves (the checked state of `chip_smoke.py`'s phase 8);

every build's output is held bit-equal to that of the first build that ran
the state (a build whose entry point refuses the state's sizes is reported
as refused), and every build is timed by CUDA events over 100 launches, in
10 rounds whose order alternates (first to last, then last to first), so
that drift of the card falls on each build alike.
Prints one JSON line per state, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from gym_so100_tpu_torch import kernels

SEED = 0
ROUNDS = 10     # timing rounds, in alternating order
REPS = 100      # launches per build per round
AB_DIR = kernels.BUILD_DIR / "ab"


def build_all(sources):
    """Compile every (name, path) at once; returns {name: (library, ptxas lines)}."""
    AB_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in sources:
        out = AB_DIR / f"libhull_{name}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out), str(path)]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.gst_hull_sweep.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        lib.gst_hull_sweep.restype = ctypes.c_int
        lib.gst_hull_sweep_shape.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.gst_hull_sweep_shape.restype = None
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        built[name] = (lib, ptxas)
    return built


def hull_inputs(m, physics):
    """The kernel's arguments at this state, as `hull_lanes.sweep_h` packs them."""
    from gym_so100_tpu_torch.ops.collision import hull_lanes
    from gym_so100_tpu_torch.ops.smooth_lanes import kinematics

    d = kinematics(m, physics)
    tb = hull_lanes.hull_tables(m)
    gx = d.geom_xpos[:, tb.gidx, :]
    gm = d.geom_xmat[:, tb.gidx, :, :]
    p_pack = torch.cat([gx[..., k].T for k in range(3)]).contiguous()
    R_pack = torch.cat([gm[..., j, k].T for j in range(3) for k in range(3)]).contiguous()
    return tb, (p_pack, R_pack, tb.verts, tb.D, tb.counts, tb.i1, tb.i2)


def _random_steps(env, es, steps, gen):
    for _ in range(steps):
        actions = torch.rand(env.num_envs, 6, generator=gen, device=env.device) * 2 - 1
        es = env.step(es, actions)[0]
    return es


def joint_state(num_envs, max_contacts, touchdown):
    """The joint scene after 12 random control steps, or at touchdown."""
    from gym_so100_tpu_torch.ops.collision import narrowphase
    from gym_so100_tpu_torch.ops.smooth_lanes import kinematics
    from gym_so100_tpu_torch.parallel.batch import BatchedEnv

    env = BatchedEnv(task="so100_touch_cube", num_envs=num_envs, device="cuda", seed=SEED,
                     max_contacts=max_contacts)
    gen = torch.Generator(device=env.device).manual_seed(SEED + 1)
    es = env.reset(seed=SEED)
    if not touchdown:
        return env.m, _random_steps(env, es, 12, gen).physics
    for _ in range(16):
        es = _random_steps(env, es, 1, gen)
        cl = narrowphase.collide_batched_lanes(env.m, kinematics(env.m, es.physics))
        if float(cl.active.any(0).float().mean()) >= 0.5:
            return env.m, es.physics
    raise RuntimeError("no touchdown in 16 control steps")


def ee_state():
    """CartesianBatchedEnv at 1024 envs after 10 moves along seeded unit
    directions (z >= 0), as chip_smoke.py's phase 8 drives it."""
    from gym_so100_tpu_torch.envs.ee_env import CartesianBatchedEnv

    B = 1024
    env = CartesianBatchedEnv(num_envs=B, device="cuda", seed=SEED + 9, max_contacts=32)
    dirs = np.random.RandomState(0).uniform(-1, 1, (B, 3))
    dirs[:, 2] = np.abs(dirs[:, 2])
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    move = torch.cat([torch.tensor(dirs * 0.5, dtype=torch.float32, device=env.device),
                      torch.zeros(B, 1, device=env.device)], 1)
    es = env.reset(seed=SEED + 10)
    for _ in range(10):
        es = env.step(es, move)[0]
    return env.m, es.physics


def run_state(label, m, physics, built):
    tb, args = hull_inputs(m, physics)
    G, ND, P, B = tb.G, tb.D.shape[0], tb.P, args[0].shape[1]
    Vmax = tb.verts.shape[1] // 3
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a.data_ptr() for a in args]
    res, runs, ref = {}, {}, None
    for name, (lib, _) in built.items():
        shape = (ctypes.c_int * 3)()
        lib.gst_hull_sweep_shape(G, ND, P, tb.vtot, ctypes.cast(shape, ctypes.c_void_p))
        out = torch.full((4 * P, B), float("nan"), device=args[0].device)
        call = (lambda lib=lib, out=out: lib.gst_hull_sweep(
            *ptrs, out.data_ptr(), G, ND, P, Vmax, tb.vtot, B, stream))
        err = call()
        torch.cuda.synchronize()
        entry = dict(envs_per_block=shape[0], smem=shape[2], err=err)
        if err == 0:
            ref = out if ref is None else ref
            entry["equal"] = bool(torch.equal(out, ref))
            runs[name] = call
            entry["ms"] = []
        res[name] = entry
    names = list(runs)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for r in range(ROUNDS):
        for name in (names if r % 2 == 0 else names[::-1]):
            start.record()
            for _ in range(REPS):
                runs[name]()
            end.record()
            torch.cuda.synchronize()
            res[name]["ms"].append(start.elapsed_time(end) / REPS)
    for name in names:
        res[name]["median_ms"] = statistics.median(res[name]["ms"])
    print(json.dumps({"state": label, "B": B, "G": G, "ND": ND, "P": P, "builds": res}),
          flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", action="append", required=True, metavar="NAME=PATH",
                    help="a hull_sweep.cu to build and time (repeat; the first is the "
                         "reference of the bit-equality check)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hull_ab: no CUDA device", file=sys.stderr)
        return 2
    sources = [tuple(s.split("=", 1)) for s in a.source]
    for _, path in sources:
        if not Path(path).is_file():
            raise FileNotFoundError(path)
    built = build_all(sources)
    for name, (_, ptxas) in built.items():
        for ln in ptxas:
            print(f"{name} ptxas: {ln}", flush=True)
    makers = {"k16": lambda: joint_state(4096, 16, touchdown=False),
              "k32": lambda: joint_state(128, 32, touchdown=True),
              "ee": ee_state}
    ok = True
    for label, make in makers.items():
        res = run_state(label, *make(), built)
        ok &= all(e.get("equal", True) for e in res.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    if not ok:
        print("hull_ab: builds disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
