"""Build the Newton-solve kernel's sources and time them against each other
on one GPU.

    python -m gym_so100_tpu_torch.scripts.newton_ab \\
        --source old=path/to/old/newton_solve.cu \\
        --source new=gym_so100_tpu_torch/csrc/newton_solve.cu

`--define NAME=MACRO[=VALUE]` adds `-DMACRO[=VALUE]` to the build of
source NAME: `--source wide=gym_so100_tpu_torch/csrc/newton_solve.cu
--define wide=NEWTON_NVS=` builds no instantiation, so that every nv runs
on the runtime-nv kernel; `--define NAME=NEWTON_CLOCK` builds source NAME
with the runtime-nv kernel's cycle counters (`clock64()` per phase and per
env into a buffer that `gst_newton_clock` sets; the default build compiles
none of them), and each state that runs on that kernel then also prints
the mean cycles per env of each phase, its share, the mean `niter` and the
mean over groups of 4 consecutive envs of their largest `niter` (the
iterations a 4-env block waits for).  Each source is compiled with the
checkout's `csrc/hull_sweep.cu` in one nvcc call, as `kernels.py` builds the port,
with its flags (`kernels.NVCC_FLAGS`), into a library of its own under
`gym_so100_tpu_torch/_build/ab/`, one build after another; each build's
nvcc seconds and its ptxas lines (registers, spills, one block per
instantiation) are printed.  A source whose C entry point takes no nv
(the kernel before it took nv as a template parameter) is run at nv = 12
only.  Then, on the solver inputs of real states built once with the
checkout's own modules (its kernels included):

* `k16_touchdown` and `k16`: the joint scene, 4096 envs, K = 16, at
  touchdown (the first control step after which at least half the envs
  have a contact) and after 12 control steps of seeded random actions
  (the timed state of `chip_smoke.py`'s phase 3);
* `ee`: the mocap-weld scene (`CartesianBatchedEnv`), 1024 envs, K = 32,
  after 10 moves (the checked state of phase 8);
* `panda`: the Panda EE scene (nv = 15), 1024 envs, K = 24, after 4
  control steps holding each mocap target on its ee and 8 after moving it
  3 cm along +x (phase 14's moves, which that phase now cuts to 2 + 6);
* `mc36` and `mc18`: `chip_smoke.py`'s five-cube scene (nv = 36, the
  runtime-nv kernel), 4096 envs, and its one-extra-cube scene (nv = 18),
  1024 envs, K = 32, each after phase 15's 4 control steps from its start;

`--states` picks some of them (default: all six).  Every build's output
is held bit-equal to that of the first build that ran
the state, and every build is timed by CUDA events over 20 launches, in 10
rounds whose order alternates (first to last, then last to first), so that
drift of the card falls on each build alike.  Prints one JSON line per
state, then the card's name and power limit; exits 1 if builds disagree.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gym_so100_tpu_torch import kernels
from gym_so100_tpu_torch.scripts.hull_ab import SEED, ee_state, joint_state

# the phases of the runtime-nv kernel's cycle counters (csrc/newton_solve.cu,
# Phase); a source that counts fewer leaves the rest at 0 (one that has no
# "back substitution" phase counts it in the Cholesky's)
PHASES = ("staging", "warmstart pick", "row pass and J'g", "Hessian",
          "gradient, Cholesky and triangular solves", "djar and M d", "line search",
          "accept", "force and output", "wait for the block's other envs",
          "back substitution and the direction")

ROUNDS = 10     # timing rounds, in alternating order
REPS = 20       # launches per build per round
AB_DIR = kernels.BUILD_DIR / "ab"
_P, _I = ctypes.c_void_p, ctypes.c_int


def takes_nv(path):
    return re.search(r"gst_newton_solve\([^)]*int nv,", Path(path).read_text()) is not None


def nvcc_library(out, srcs, flags=(), entry=""):
    """Compile `srcs` with the port's flags (`kernels.NVCC_FLAGS`) and
    `flags` into the shared library `out` under AB_DIR; returns (the loaded
    library, nvcc seconds, the ptxas lines: registers, spills and those
    that name `entry`)."""
    AB_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-o", str(AB_DIR / out),
           *map(str, srcs)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out}:\n{res.stdout}{res.stderr}")
    ptxas = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
             if (entry and entry in ln) or "registers" in ln or "spill" in ln]
    return ctypes.CDLL(str(AB_DIR / out)), seconds, ptxas


def build_all(sources, defines=None):
    """Compile every (name, path), one after another, each with its
    `defines[name]` (-D flags); returns {name: (library, takes nv, nvcc
    seconds, ptxas lines)}."""
    built = {}
    for name, path in sources:
        lib, seconds, ptxas = nvcc_library(
            f"libnewton_{name}.so", [kernels.CSRC / "hull_sweep.cu", path],
            (defines or {}).get(name, []), entry="newton_solve")
        nv_arg = takes_nv(path)
        lib.gst_newton_solve.argtypes = [_P] * 9 + [_I] * (10 if nv_arg else 9) + [
            ctypes.c_float, _P]
        lib.gst_newton_solve.restype = ctypes.c_int
        if hasattr(lib, "gst_newton_clock"):
            lib.gst_newton_clock.argtypes = [_P]
            lib.gst_newton_clock.restype = ctypes.c_int
        built[name] = (lib, nv_arg, seconds, ptxas)
    return built


def panda_state():
    """The Panda EE scene at 1024 envs from "home" (each env's arm joints
    moved by a seeded draw of at most 0.01 rad, each mocap target on its
    ee), 4 control steps holding, then the targets 3 cm along +x for 8."""
    from gym_so100_tpu_torch.models.builder import PANDA_XML, build_model
    from gym_so100_tpu_torch.models.scene import State
    from gym_so100_tpu_torch.ops import forward as fwd
    from gym_so100_tpu_torch.ops import smooth_lanes

    B = 1024
    m, aux = build_model(PANDA_XML, max_contacts=24, device="cuda")
    kq, kc = aux["keyframes"]["home"]
    qpos = np.tile(np.asarray(kq, np.float64), (B, 1))
    qpos[:, :7] += np.random.RandomState(SEED + 11).uniform(-0.01, 0.01, (B, 7))
    one = fwd.make_state(m, qpos=kq, ctrl=kc)
    s = State(qpos=torch.tensor(qpos, dtype=m.dtype, device=m.device),
              qvel=torch.zeros(B, m.nv, device=m.device), ctrl=one.ctrl.expand(B, -1).clone(),
              mocap_pos=one.mocap_pos.expand(B, -1, -1).clone(),
              mocap_quat=one.mocap_quat.expand(B, -1, -1).clone(),
              qacc_warmstart=torch.zeros(B, m.nv, device=m.device))
    ee = m.site_id("ee_site")
    s = s.replace(mocap_pos=smooth_lanes.kinematics(m, s).site_xpos[:, ee][:, None].clone())
    for i in range(12):
        if i == 4:
            s = s.replace(mocap_pos=s.mocap_pos + torch.tensor(
                [0.03, 0.0, 0.0], device=m.device))
        s = fwd.n_steps_batched(m, s, 10)[0]
    return m, s


def multicube_state(cubes, B):
    """chip_smoke.py's multi-cube scene with `cubes` free cubes (K = 32)
    at B envs after phase 15's control steps from its start."""
    import tempfile

    import chip_smoke
    from gym_so100_tpu_torch.models.builder import build_model
    from gym_so100_tpu_torch.ops import forward as fwd

    with tempfile.TemporaryDirectory() as tmp:
        m, _ = build_model(str(chip_smoke.write_multicube_scene(tmp, cubes)),
                           max_contacts=chip_smoke.MC_K, device="cuda")
    s = chip_smoke._multicube_start(m, B)
    for _ in range(chip_smoke.MC_STEPS):
        s = fwd.n_steps_batched(m, s, 10)[0]
    return m, s


def clock_split(lib, call, B, niter):
    """Run `call` once with the cycle counters of a NEWTON_CLOCK build on;
    returns the mean cycles per env of each phase and its share, and the
    iteration counts that bound a block of 4 envs."""
    buf = torch.zeros(len(PHASES), B, dtype=torch.int64, device="cuda")
    assert lib.gst_newton_clock(buf.data_ptr()) == 0
    assert call() == 0
    torch.cuda.synchronize()
    assert lib.gst_newton_clock(None) == 0
    cyc = buf.double().mean(1)
    total = max(float(cyc.sum()), 1.0)
    n = niter.double()
    groups = n[: B - B % 4].view(-1, 4)
    return dict(
        cycles_per_env={p: round(float(c), 1) for p, c in zip(PHASES, cyc)},
        share={p: round(float(c) / total, 4) for p, c in zip(PHASES, cyc)},
        cycles_per_env_total=total, cycles_per_iteration=total / float(n.mean()),
        niter_mean=float(n.mean()), niter_max4_mean=float(groups.amax(1).mean()),
        niter_hist={int(k): int((n == k).sum()) for k in n.unique()})


def solver_inputs(m, physics):
    """The kernel's packed inputs and sizes at this state, as
    `solver_lanes.solve_fused` packs them."""
    from gym_so100_tpu_torch.models.scene import Data
    from gym_so100_tpu_torch.ops import constraint_lanes, smooth_lanes, solver_lanes
    from gym_so100_tpu_torch.ops.collision import narrowphase

    sl = smooth_lanes.forward_smooth_lanes(m, physics)
    d = Data(geom_xpos=sl["geom_xpos"], geom_xmat=sl["geom_xmat"],
             site_xpos=sl["site_xpos"], site_xmat=sl["site_xmat"],
             subtree_com=sl["subtree_com0"][:, None], cdof=sl["cdof"])
    efc = constraint_lanes.make_efc_from_lanes(
        m, d, physics, narrowphase.collide_batched_lanes(m, d))
    inp = solver_lanes.pack_fused_inputs(m, sl["qM_lanes"], sl["qacc_smooth"], efc,
                                         physics.qacc_warmstart)
    NE, B = efc.aref.shape
    sizes = (NE, efc.neq, efc.nf, efc.nl, efc.con_mu.shape[0], B)
    return [inp[k] for k in ("J", "aref", "D", "aux", "us", "qM", "x0", "warm")], sizes, \
        solver_lanes.budgets(m, torch.float32)


def run_state(label, m, physics, built):
    args, sizes, budgets = solver_inputs(m, physics)
    B = sizes[-1]
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a.data_ptr() for a in args]
    res, runs, ref = {}, {}, None
    for name, (lib, nv_arg, _, _) in built.items():
        if not nv_arg and m.nv != 12:
            res[name] = dict(refused=f"built for nv = 12 only, the state has nv = {m.nv}")
            continue
        out = torch.full((2 * m.nv + 1, B), float("nan"), device=args[0].device)
        nv = (m.nv,) if nv_arg else ()
        call = (lambda lib=lib, out=out, nv=nv: lib.gst_newton_solve(
            *ptrs, out.data_ptr(), *nv, *sizes, *budgets, stream))
        err = call()
        torch.cuda.synchronize()
        entry = dict(err=err)
        if err == 0:
            ref = out if ref is None else ref
            entry["equal"] = bool(torch.equal(out, ref))
            entry["niter_mean"] = float(out[2 * m.nv].mean())
            runs[name] = call
            entry["ms"] = []
            if hasattr(lib, "gst_newton_clock") and m.nv > 16:
                entry["clock"] = clock_split(lib, call, B, out[2 * m.nv].clone())
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
    print(json.dumps({"state": label, "nv": m.nv, "B": B, "NE": sizes[0], "neq": sizes[1],
                      "K": sizes[4], "builds": res}), flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", action="append", required=True, metavar="NAME=PATH",
                    help="a newton_solve.cu to build and time (repeat; the first that "
                         "runs a state is the reference of its bit-equality check)")
    ap.add_argument("--define", action="append", default=[], metavar="NAME=MACRO[=VALUE]",
                    help="build source NAME with -DMACRO[=VALUE] (repeat)")
    ap.add_argument("--states", default="k16_touchdown,k16,ee,panda,mc36,mc18",
                    help="comma-separated states to run (default: all six)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("newton_ab: no CUDA device", file=sys.stderr)
        return 2
    sources = [tuple(s.split("=", 1)) for s in a.source]
    for _, path in sources:
        if not Path(path).is_file():
            raise FileNotFoundError(path)
    defines = {}
    for d in a.define:
        name, macro = d.split("=", 1)
        defines.setdefault(name, []).append(f"-D{macro}")
    built = build_all(sources, defines)
    for name, (_, nv_arg, seconds, ptxas) in built.items():
        print(f"{name}: nvcc {seconds:.1f} s (with hull_sweep.cu), takes nv: {nv_arg}",
              flush=True)
        for ln in ptxas:
            print(f"{name} ptxas: {ln}", flush=True)
    makers = {"k16_touchdown": lambda: joint_state(4096, 16, touchdown=True),
              "k16": lambda: joint_state(4096, 16, touchdown=False),
              "ee": ee_state, "panda": panda_state,
              "mc36": lambda: multicube_state(4, 4096), "mc18": lambda: multicube_state(1, 1024)}
    ok = True
    for label in a.states.split(","):
        make = makers[label]
        res = run_state(label, *make(), built)
        ok &= all(e.get("equal", True) for e in res.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    if not ok:
        print("newton_ab: builds disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
