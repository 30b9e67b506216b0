"""The CUDA kernels' own source, compiled for the host and checked on the CPU.

The machine without a GPU has no nvcc, but the kernels in
gym_so100_tpu_torch/csrc are plain C++ apart from a few CUDA keywords.  This
test compiles them with the host C++ compiler through a small shim (CUDA
qualifiers dropped, shared memory a static buffer, each launch a serial loop
over blocks and threads; the hull kernel, which synchronizes its threads,
runs one thread per block), with floating-point contraction off, and
compares them with their plain PyTorch versions:

* hull sweep, float32: equal to `sweep_h_plain` (same operations, same
  order);
* Newton solve, built in float64 (every `float` of the source made
  `double`): equal to `solve_plain` in float64 under the same budgets to
  1e-9 on at least 95% of the lanes, on a state whose contacts reach both
  the top and the middle zone of the elliptic cone (a lane can part at a knife edge of the
  line search, e.g. the sign of a directional derivative that is 0 up to
  rounding); built in float32: finite, with iteration counts in range.

It skips where no host C++ compiler is installed.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from gym_so100_tpu_torch.models.builder import build_model
from gym_so100_tpu_torch.models.scene import Data, State
from gym_so100_tpu_torch.ops import constraint_lanes, smooth_lanes, solver_lanes
from gym_so100_tpu_torch.ops import forward as fwd
from gym_so100_tpu_torch.ops.collision import hull_lanes, narrowphase

CSRC = Path(__file__).resolve().parents[1] / "gym_so100_tpu_torch" / "csrc"

SHIM = r"""
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __shared__
struct dim3_ { unsigned x, y, z; };
static dim3_ blockIdx, blockDim, threadIdx;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline void __syncthreads() {}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float sqrtf(float x) { return std::sqrt(x); }
inline float fmaxf(float a, float b) { return a > b ? a : b; }
inline float fminf(float a, float b) { return a < b ? a : b; }
inline float fabsf(float a) { return a < 0 ? -a : a; }
inline double sqrtf(double x) { return std::sqrt(x); }
inline double fmaxf(double a, double b) { return a > b ? a : b; }
inline double fminf(double a, double b) { return a < b ? a : b; }
inline double fabsf(double a) { return a < 0 ? -a : a; }
"""


def _host_source(name, one_thread, real):
    s = (CSRC / f"{name}.cu").read_text()
    s = s.replace("#include <cuda_runtime.h>", "").replace("#include <math.h>", "")
    s = s.replace("extern __shared__ float smem[];", "static float smem[1 << 20];")

    def launch(mt):
        kern, cfg, args = mt.group(1), mt.group(2), mt.group(3)
        parts, depth, cur = [], 0, ""
        for ch in cfg:
            depth += (ch == "(") - (ch == ")")
            if ch == "," and depth == 0:
                parts.append(cur)
                cur = ""
            else:
                cur += ch
        grid, block = parts[0].strip(), ("1" if one_thread else parts[1].strip())
        return (f"for (unsigned b_ = 0; b_ < (unsigned)({grid}); ++b_) "
                f"for (unsigned t_ = 0; t_ < (unsigned)({block}); ++t_) {{ "
                f"blockIdx.x = b_; blockDim.x = {block}; threadIdx.x = t_; {kern}({args}); }}")

    s = re.sub(r"(\w+)<<<(.*?)>>>\((.*?)\);", launch, s, flags=re.S)
    if real == "double":
        s = re.sub(r"\bfloat\b", "double", s)
    return s


def _build(tmp, name, one_thread, real):
    src = tmp / f"{name}_{real}.cpp"
    src.write_text(SHIM + _host_source(name, one_thread, real))
    lib = tmp / f"lib{name}_{real}.so"
    res = subprocess.run(
        ["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", "-o", str(lib), str(src)],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    tmp = tmp_path_factory.mktemp("csrc_host")
    P, I = ctypes.c_void_p, ctypes.c_int
    hull = _build(tmp, "hull_sweep", True, "float")
    hull.gst_hull_sweep.argtypes = [P] * 8 + [I] * 5 + [P]
    libs = dict(hull=hull)
    for real, ct in (("float", ctypes.c_float), ("double", ctypes.c_double)):
        lib = _build(tmp, "newton_solve", False, real)
        lib.gst_newton_solve.argtypes = [P] * 11 + [I] * 9 + [ct, P]
        libs[f"solve_{real}"] = lib
    return libs


def _call(fn, *args):
    err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], None)
    assert err == 0


@pytest.fixture(scope="module")
def contact_state():
    """A float32 batch with the cube resting on the table (every env in
    contact) after 20 substeps with random arm offsets and controls."""
    m, _ = build_model(max_contacts=16, device="cpu")
    B = 32
    rng = np.random.RandomState(5)
    qpos = np.tile(m.qpos0.numpy(), (B, 1))
    qpos[:, :6] += rng.uniform(-0.3, 0.3, (B, 6))
    qpos[:, 6:8] += rng.uniform(-0.05, 0.05, (B, 2))
    qpos[:, 8] = 0.0205
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    s = State(qpos=f32(qpos), qvel=torch.zeros(B, m.nv),
              ctrl=f32(rng.uniform(-0.5, 0.5, (B, m.nu))),
              mocap_pos=torch.zeros(B, 0, 3), mocap_quat=torch.zeros(B, 0, 4),
              qacc_warmstart=torch.zeros(B, m.nv))
    s, _ = fwd.n_steps_batched(m, s, 20)
    sl = smooth_lanes.forward_smooth_lanes(m, s)
    d = Data(geom_xpos=sl["geom_xpos"], geom_xmat=sl["geom_xmat"],
             subtree_com=sl["subtree_com0"][:, None], cdof=sl["cdof"])
    return m, s, sl, d


def test_hull_kernel_source_equals_plain(host_libs, contact_state):
    m, _, _, d = contact_state
    tb = hull_lanes.hull_tables(m)
    gx = d.geom_xpos[:, tb.gidx]
    gm = d.geom_xmat[:, tb.gidx]
    p_pack = torch.cat([gx[..., k].T for k in range(3)]).contiguous()
    R_pack = torch.cat([gm[..., j, k].T for j in range(3) for k in range(3)]).contiguous()
    args = (p_pack, R_pack, tb.verts, tb.D, tb.counts, tb.i1, tb.i2)
    ref = hull_lanes.sweep_h_plain(*args)
    out = torch.full_like(ref, float("nan"))
    _call(host_libs["hull"].gst_hull_sweep, *args, out, tb.G, tb.D.shape[0], tb.P,
          tb.verts.shape[1] // 3, p_pack.shape[1])
    assert (ref[:tb.P] < 0).any(), "no penetrating hull pair in the test state"
    assert torch.equal(out, ref)


def _solve_host(lib, m, qM, a0, efc, warm, budgets, tol):
    inp = solver_lanes.pack_fused_inputs(m, qM, a0, efc, warm)
    NE, B = efc.aref.shape
    K = efc.con_mu.shape[0]
    dt = a0.dtype
    jar, djar = torch.empty(NE, B, dtype=dt), torch.empty(NE, B, dtype=dt)
    out = torch.empty(2 * m.nv + 1, B, dtype=dt)
    _call(lib.gst_newton_solve, *[inp[k] for k in
          ("J", "aref", "D", "aux", "us", "qM", "x0", "warm")], jar, djar, out,
          NE, efc.neq, efc.nf, efc.nl, K, B, *budgets, tol)
    return out[:m.nv].T, out[m.nv:2 * m.nv].T, out[2 * m.nv]


def _problem(contact_state, dtype):
    m, s, sl, d = contact_state
    efc = constraint_lanes.make_efc_from_lanes(m, d, s, narrowphase.collide_batched_lanes(m, d))
    assert efc.con_active.any(0).all(), "some env has no active contact"
    cast = lambda t: t.to(dtype)
    efc = dataclasses.replace(efc, **{
        f.name: cast(getattr(efc, f.name)) for f in dataclasses.fields(efc)
        if isinstance(getattr(efc, f.name), torch.Tensor)
        and getattr(efc, f.name).is_floating_point()})
    return m, cast(sl["qM_lanes"]), cast(sl["qacc_smooth"]), efc, cast(s.qacc_warmstart)


@pytest.mark.parametrize("budgets", [
    (solver_lanes.NEWTON_ITERS, solver_lanes.LS_ITERS, solver_lanes.BRACKET_ITERS),
    (3, 6, 5), (1, 6, 0)])
def test_solver_kernel_source_equals_plain_in_float64(host_libs, contact_state, budgets,
                                                      monkeypatch):
    m, qM, a0, efc, warm = _problem(contact_state, torch.float64)
    # the float32 budgets and tol (and two shorter ones) on both sides, so
    # that lanes stop with their budget spent as on the card
    tol = solver_lanes.budgets(m, torch.float32)[-1]
    monkeypatch.setattr(solver_lanes, "budgets", lambda m, dtype: (*budgets, tol))
    qk, fk, nk = _solve_host(host_libs["solve_double"], m, qM, a0, efc, warm, budgets, tol)
    qp, fp, npl = solver_lanes.solve_plain(m, qM, a0, efc, warm)
    # the state must reach every zone of the elliptic cone
    jar = (efc.J * qp.T[:, None]).sum(0) - efc.aref
    cone = solver_lanes._cost_terms(efc, jar)[5]
    assert (cone["top"] & efc.con_active).any() and (cone["middle"] & efc.con_active).any()
    same = ((qk - qp).abs().amax(1) <= 1e-9 * qp.abs().amax().clamp(min=1.0)) & \
           ((fk - fp).abs().amax(1) <= 1e-9 * fp.abs().amax().clamp(min=1.0)) & \
           (nk == npl.double())
    assert same.double().mean() >= 0.95, same.double().mean()


def test_solver_kernel_source_runs_in_float32(host_libs, contact_state):
    m, qM, a0, efc, warm = _problem(contact_state, torch.float32)
    *budgets, tol = solver_lanes.budgets(m, torch.float32)
    qk, fk, nk = _solve_host(host_libs["solve_float"], m, qM, a0, efc, warm, budgets, tol)
    qp, _, npl = solver_lanes.solve_plain(m, qM, a0, efc, warm)
    assert torch.isfinite(qk).all() and torch.isfinite(fk).all()
    assert ((nk >= 1) & (nk <= solver_lanes.NEWTON_ITERS)).all()
    rms = float(qp.pow(2).mean().sqrt())
    err = (qk - qp).abs().amax(1) / max(rms, 1.0)
    assert float(err.median()) < 1e-4
    assert abs(float(nk.mean()) - float(npl.float().mean())) < 0.5
