"""The CUDA kernels' own source, compiled for the host and checked on the CPU.

The machine without a GPU has no nvcc, but the kernels in
gym_so100_tpu_torch/csrc are plain C++ apart from a few CUDA keywords.  This
test compiles them with the host C++ compiler through a small shim (CUDA
qualifiers dropped, shared memory a static buffer), with floating-point
contraction off, and runs each launch with its real block shape: the
blocks one after another, each block's threads as host threads.
`__syncthreads` is a barrier of the block, `__syncwarp` a barrier of the
thread's warp, and `__shfl_sync`, `__shfl_xor_sync` and `__ballot_sync`
an exchange through a per-block buffer between two warp barriers, so a warp-cooperative kernel runs as on the card
(a missing barrier shows up as a race).  It compares them with their plain
PyTorch versions:

* hull sweep, float32: equal to `sweep_h_plain` (same operations, same
  order), also at a batch that leaves the last block partly empty, and on
  the mocap-weld scene, whose larger tables run 4 envs per block; tables
  too large for a 4-env block make the entry point return an error;
* Newton solve, built in float64 (every `float` of the source made
  `double`): equal to `solve_plain` in float64 under the same budgets to
  1e-9 on at least 95% of the lanes, on a state whose contacts reach both
  the top and the middle zone of the elliptic cone (a lane can part at a knife edge of the
  line search, e.g. the sign of a directional derivative that is 0 up to
  rounding), and on two states of the mocap-weld scene, whose 6 equality
  rows lead the rows (there half the lanes sit on such knife edges, so
  the lanes that one-ulp perturbations of the plain solve's inputs change
  are held to what those perturbations do instead); built in float32: finite, with iteration counts in range;
  in both builds, the results of a batch that leaves the last block partly
  empty equal those of a full batch on its lanes;
* the float64 check fails for mutated copies of the solver source: a
  middle-zone gradient or Hessian term scaled, or the rows of one lane of
  the warp dropped from the gradient; on the EE states, the equality
  rows' gradient scaled by 1.01.

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

from gym_so100_tpu_torch.envs.ee_env import EE_XML, CartesianBatchedEnv
from gym_so100_tpu_torch.models.builder import build_model
from gym_so100_tpu_torch.models.scene import Data, State
from gym_so100_tpu_torch.ops import constraint_lanes, smooth_lanes, solver_lanes
from gym_so100_tpu_torch.ops import forward as fwd
from gym_so100_tpu_torch.ops.collision import hull_lanes, narrowphase

CSRC = Path(__file__).resolve().parents[1] / "gym_so100_tpu_torch" / "csrc"

SHIM = r"""
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static
#define __launch_bounds__(...)
struct dim3_ { unsigned x, y, z; };
static thread_local dim3_ blockIdx, threadIdx;
static dim3_ blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
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

// one block at a time: its threads are host threads
struct Block_ {
    std::unique_ptr<std::barrier<>> all;
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    std::uint64_t xbuf[1024];
};
static Block_* blk_;
inline void __syncthreads() { blk_->all->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
    blk_->warps[threadIdx.x / 32]->arrive_and_wait();
}
template <class T> T __shfl_xor_sync(unsigned, T v, int m) {
    std::uint64_t u = 0;
    std::memcpy(&u, &v, sizeof(T));
    blk_->xbuf[threadIdx.x] = u;
    __syncwarp();
    u = blk_->xbuf[threadIdx.x ^ m];
    __syncwarp();
    T r;
    std::memcpy(&r, &u, sizeof(T));
    return r;
}
template <class T> T __shfl_sync(unsigned, T v, int src) {
    std::uint64_t u = 0;
    std::memcpy(&u, &v, sizeof(T));
    blk_->xbuf[threadIdx.x] = u;
    __syncwarp();
    u = blk_->xbuf[(threadIdx.x & ~31u) + src];
    __syncwarp();
    T r;
    std::memcpy(&r, &u, sizeof(T));
    return r;
}
inline unsigned __ballot_sync(unsigned, int pred) {
    blk_->xbuf[threadIdx.x] = pred != 0;
    __syncwarp();
    unsigned bal = 0;
    const unsigned w0 = threadIdx.x & ~31u;
    for (unsigned l = 0; l < 32 && w0 + l < blockDim.x; ++l)
        bal |= (unsigned)blk_->xbuf[w0 + l] << l;
    __syncwarp();
    return bal;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <class F> void launch_(unsigned grid, unsigned block, F body) {
    blockDim = {block, 1, 1};
    for (unsigned b = 0; b < grid; ++b) {
        Block_ bk;
        bk.all.reset(new std::barrier<>(block));
        for (unsigned w = 0; w * 32 < block; ++w)
            bk.warps.emplace_back(new std::barrier<>(block - w * 32 < 32 ? block - w * 32 : 32));
        blk_ = &bk;
        std::vector<std::thread> th;
        for (unsigned t = 0; t < block; ++t)
            th.emplace_back([=] { blockIdx = {b, 0, 0}; threadIdx = {t, 0, 0}; body(); });
        for (auto& x : th) x.join();
    }
}
"""


def _host_source(name, real, mutate=None):
    s = (CSRC / f"{name}.cu").read_text()
    if mutate is not None:
        old, new = mutate
        assert s.count(old) == 1, f"mutation target not unique: {old!r}"
        s = s.replace(old, new)
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
        grid, block = parts[0].strip(), parts[1].strip()
        return f"launch_((unsigned)({grid}), (unsigned)({block}), [&] {{ {kern}({args}); }});"

    s = re.sub(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);", launch, s, flags=re.S)
    if real == "double":
        s = re.sub(r"\bfloat\b", "double", s)
    return s


def _build(tmp, name, real, mutate=None, tag=""):
    src = tmp / f"{name}_{real}{tag}.cpp"
    src.write_text(SHIM + _host_source(name, real, mutate))
    lib = tmp / f"lib{name}_{real}{tag}.so"
    res = subprocess.run(
        ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-pthread",
         "-Wno-unknown-pragmas", "-o", str(lib), str(src)],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return ctypes.CDLL(str(lib))


_P, _I = ctypes.c_void_p, ctypes.c_int


def _solver_lib(tmp, real, mutate=None, tag=""):
    lib = _build(tmp, "newton_solve", real, mutate, tag)
    ct = ctypes.c_float if real == "float" else ctypes.c_double
    lib.gst_newton_solve.argtypes = [_P] * 9 + [_I] * 9 + [ct, _P]
    return lib


@pytest.fixture(scope="module")
def host_tmp(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    return tmp_path_factory.mktemp("csrc_host")


@pytest.fixture(scope="module")
def host_libs(host_tmp):
    hull = _build(host_tmp, "hull_sweep", "float")
    hull.gst_hull_sweep.argtypes = [_P] * 8 + [_I] * 6 + [_P]
    hull.gst_hull_sweep_shape.argtypes = [_I] * 4 + [_P]
    libs = dict(hull=hull)
    for real in ("float", "double"):
        libs[f"solve_{real}"] = _solver_lib(host_tmp, real)
    return libs


def _out_buffer(shape, dtype):
    """A NaN-filled output of `shape` and the NaN-filled block of memory
    just past it, which a kernel must leave alone."""
    n = int(np.prod(shape))
    buf = torch.full((n + 64,), float("nan"), dtype=dtype)
    return buf[:n].view(shape), buf[n:]


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


def _ee_state(lift_mocap_box):
    """A float32 batch of the mocap-weld (EE) scene: the cube resting on
    the table, random arm offsets, and each mocap target 1-3 cm off the ee
    site, after 20 substeps; the 6 weld rows lead the constraint rows.  The
    scene's mocap target carries a 4 x 12 x 4 cm box that lies in the
    gripper (16 deep contacts per env); `lift_mocap_box` puts that box 10 m
    above its body, out of reach, so the cube's table contacts remain."""
    m, _ = build_model(EE_XML, max_contacts=16, device="cpu")
    if lift_mocap_box:
        box = [g for g in range(m.ngeom) if m.body_mocapid[m.geom_bodyid[g]] >= 0]
        gpos = m.geom_pos.clone()
        gpos[box, 2] += 10.0
        m = dataclasses.replace(m, geom_pos=gpos)
    B = 32
    rng = np.random.RandomState(6)
    env = CartesianBatchedEnv(m, num_envs=B, device="cpu")
    pose = np.zeros((B, 7))
    pose[:, 0] = rng.uniform(-0.25, -0.15, B)
    pose[:, 1] = rng.uniform(0.3, 0.6, B)
    pose[:, 2] = 0.0205
    pose[:, 3] = 1.0
    s = env.reset(box_pose=pose).physics
    qpos = s.qpos.clone()
    qpos[:, :5] += torch.tensor(rng.uniform(-0.2, 0.2, (B, 5)), dtype=torch.float32)
    off = rng.randn(B, 1, 3)
    off *= rng.uniform(0.01, 0.03, (B, 1, 1)) / np.linalg.norm(off, axis=-1, keepdims=True)
    s = s.replace(qpos=qpos, mocap_pos=s.mocap_pos + torch.tensor(off, dtype=torch.float32))
    s, _ = fwd.n_steps_batched(env.m, s, 20)
    sl = smooth_lanes.forward_smooth_lanes(env.m, s)
    d = Data(geom_xpos=sl["geom_xpos"], geom_xmat=sl["geom_xmat"],
             site_xpos=sl["site_xpos"], site_xmat=sl["site_xmat"],
             subtree_com=sl["subtree_com0"][:, None], cdof=sl["cdof"])
    return env.m, s, sl, d


@pytest.fixture(scope="module")
def ee_full_scene():
    return _ee_state(lift_mocap_box=False)


@pytest.fixture(scope="module", params=["lifted_mocap_box", "full_scene"])
def ee_state(request, ee_full_scene):
    if request.param == "full_scene":
        return request.param, ee_full_scene
    return request.param, _ee_state(lift_mocap_box=True)


def _hull_inputs(contact_state, lanes=None):
    m, _, _, d = contact_state
    tb = hull_lanes.hull_tables(m)
    gx = d.geom_xpos[:lanes, tb.gidx]
    gm = d.geom_xmat[:lanes, tb.gidx]
    p_pack = torch.cat([gx[..., k].T for k in range(3)]).contiguous()
    R_pack = torch.cat([gm[..., j, k].T for j in range(3) for k in range(3)]).contiguous()
    return tb, (p_pack, R_pack, tb.verts, tb.D, tb.counts, tb.i1, tb.i2)


def _hull_host(lib, tb, args, ND=None):
    """Run the hull kernel source; returns (error code, output)."""
    B = args[0].shape[1]
    out, past = _out_buffer((4 * tb.P, B), torch.float32)
    err = lib.gst_hull_sweep(
        *[a.data_ptr() for a in args], out.data_ptr(), tb.G, ND or tb.D.shape[0], tb.P,
        tb.verts.shape[1] // 3, tb.vtot, B, None)
    assert torch.isnan(past).all(), "the kernel wrote past its output"
    return err, out


def test_hull_kernel_source_equals_plain(host_libs, contact_state):
    tb, args = _hull_inputs(contact_state)
    ref = hull_lanes.sweep_h_plain(*args)
    err, out = _hull_host(host_libs["hull"], tb, args)
    assert err == 0
    assert (ref[:tb.P] < 0).any(), "no penetrating hull pair in the test state"
    assert torch.equal(out, ref)


def test_hull_kernel_source_equals_plain_in_a_partial_block(host_libs, contact_state):
    """B = 29 is no multiple of the 8 envs of a block: the last block mixes
    real envs with zero-filled staging lanes that must write nothing."""
    tb, args = _hull_inputs(contact_state, lanes=29)
    ref = hull_lanes.sweep_h_plain(*args)
    err, out = _hull_host(host_libs["hull"], tb, args)
    assert err == 0 and out.shape[1] == 29
    assert torch.equal(out, ref)


def test_hull_kernel_source_refuses_tables_too_large_for_a_block(host_libs,
                                                                 contact_state):
    """Tables that do not fit one block's shared memory at 8 envs, nor at
    4, make the entry point return an error, and nothing is launched."""
    tb, args = _hull_inputs(contact_state)
    err, out = _hull_host(host_libs["hull"], tb, args, ND=4 * tb.D.shape[0])
    assert err != 0 and torch.isnan(out).all()


def test_hull_kernel_source_equals_plain_on_the_ee_scene(host_libs, ee_full_scene):
    """The mocap-weld scene has one hull geom more (G = 26, P = 138): 8
    envs no longer fit a block, so the kernel runs 4 per block, and its
    tables stay bit-equal to the plain version's (B = 32 and 29)."""
    for lanes in (None, 29):
        tb, args = _hull_inputs(ee_full_scene, lanes)
        shape = (ctypes.c_int * 3)()
        host_libs["hull"].gst_hull_sweep_shape(tb.G, tb.D.shape[0], tb.P, tb.vtot, shape)
        assert (tb.G, tb.P, shape[0]) == (26, 138, 4)
        ref = hull_lanes.sweep_h_plain(*args)
        err, out = _hull_host(host_libs["hull"], tb, args)
        assert err == 0 and torch.equal(out, ref)
    assert (ref[:tb.P] < 0).any(), "no penetrating hull pair in the test state"


def _solve_host(lib, m, qM, a0, efc, warm, budgets, tol):
    inp = solver_lanes.pack_fused_inputs(m, qM, a0, efc, warm)
    NE, B = efc.aref.shape
    K = efc.con_mu.shape[0]
    out, past = _out_buffer((2 * m.nv + 1, B), a0.dtype)
    _call(lib.gst_newton_solve, *[inp[k] for k in
          ("J", "aref", "D", "aux", "us", "qM", "x0", "warm")], out,
          NE, efc.neq, efc.nf, efc.nl, K, B, *budgets, tol)
    assert torch.isnan(past).all(), "the kernel wrote past its output"
    return out[:m.nv].T, out[m.nv:2 * m.nv].T, out[2 * m.nv]


def _problem(contact_state, dtype, lanes=None):
    """The solver's inputs for the state, cast to `dtype`; the first
    `lanes` envs only when given (batch-last lanes, batch-first rows)."""
    m, s, sl, d = contact_state
    efc = constraint_lanes.make_efc_from_lanes(m, d, s, narrowphase.collide_batched_lanes(m, d))
    assert efc.con_active.any(0).all(), "some env has no active contact"
    cast = lambda t: t.to(dtype) if t.is_floating_point() else t
    lane = lambda t: cast(t[..., :lanes]).contiguous()
    efc = dataclasses.replace(efc, **{
        f.name: lane(getattr(efc, f.name)) for f in dataclasses.fields(efc)
        if isinstance(getattr(efc, f.name), torch.Tensor)})
    return (m, lane(sl["qM_lanes"]), cast(sl["qacc_smooth"][:lanes]), efc,
            cast(s.qacc_warmstart[:lanes]))


def _share_equal_in_float64(lib, contact_state, budgets, monkeypatch, lanes=None,
                            zones=("top", "middle")):
    """Share of lanes on which the float64 kernel source equals
    `solve_plain` (qacc and qfrc to 1e-9, same iteration count); the
    state's active contacts must reach each of the cone `zones`."""
    m, qM, a0, efc, warm = _problem(contact_state, torch.float64, lanes)
    # the float32 budgets and tol (and two shorter ones) on both sides, so
    # that lanes stop with their budget spent as on the card
    tol = solver_lanes.budgets(m, torch.float32)[-1]
    monkeypatch.setattr(solver_lanes, "budgets", lambda m, dtype: (*budgets, tol))
    qk, fk, nk = _solve_host(lib, m, qM, a0, efc, warm, budgets, tol)
    qp, fp, npl = solver_lanes.solve_plain(m, qM, a0, efc, warm)
    # the state must reach the given zones of the elliptic cone
    jar = (efc.J * qp.T[:, None]).sum(0) - efc.aref
    cone = solver_lanes._cost_terms(efc, jar)[5]
    for zone in zones:
        assert (cone[zone] & efc.con_active).any(), zone
    same = ((qk - qp).abs().amax(1) <= 1e-9 * qp.abs().amax().clamp(min=1.0)) & \
           ((fk - fp).abs().amax(1) <= 1e-9 * fp.abs().amax().clamp(min=1.0)) & \
           (nk == npl.double())
    return float(same.double().mean())


FULL_BUDGETS = (solver_lanes.NEWTON_ITERS, solver_lanes.LS_ITERS, solver_lanes.BRACKET_ITERS)
EPS64 = 2.220446049250313e-16
PERTURB_SAMPLES = 40      # one-ulp perturbations of the plain solve's inputs


@pytest.mark.parametrize("budgets", [FULL_BUDGETS, (3, 6, 5), (1, 6, 0)])
def test_solver_kernel_source_equals_plain_in_float64(host_libs, contact_state, budgets,
                                                      monkeypatch):
    share = _share_equal_in_float64(host_libs["solve_double"], contact_state, budgets,
                                    monkeypatch)
    assert share >= 0.95, share


def _check_ee_state(lib, state, monkeypatch):
    """The EE scene: the 6 weld rows (neq = 6, active in every env, with a
    residual) lead the rows, and every env has contacts.

    Its states put many lanes on knife edges of the float64 plain solve
    itself: one-ulp perturbations of its inputs (PERTURB_SAMPLES of them)
    change the iteration count of about half the lanes (the stop test
    after convergence, with the mocap box lifted) and, on the full scene,
    move lanes by far more than 1e-9 of the scale.  So the
    criterion above (1e-9, same iteration count, >= 95% of lanes) holds on
    the lanes that no perturbation changes; on the others the kernel may
    part from the plain solve only as the perturbations do: values by at
    most twice the most they moved that lane, and another iteration count
    only where they changed it."""
    m, s, sl, d = state
    efc = constraint_lanes.make_efc_from_lanes(m, d, s, narrowphase.collide_batched_lanes(m, d))
    assert efc.neq == 6 and (efc.D[:6] > 0).all() and (efc.pos[:6].abs().amax(0) > 1e-4).all()
    m, qM, a0, efc, warm = _problem(state, torch.float64)
    tol = solver_lanes.budgets(m, torch.float32)[-1]
    monkeypatch.setattr(solver_lanes, "budgets", lambda m, dtype: (*FULL_BUDGETS, tol))
    qk, fk, nk = _solve_host(lib, m, qM, a0, efc, warm, FULL_BUDGETS, tol)
    qp, fp, npl = solver_lanes.solve_plain(m, qM, a0, efc, warm)
    sq, sf = qp.abs().amax().clamp(min=1.0), fp.abs().amax().clamp(min=1.0)
    dq, df = (qk - qp).abs().amax(1), (fk - fp).abs().amax(1)
    same_x = (dq <= 1e-9 * sq) & (df <= 1e-9 * sf)
    same_n = nk == npl.double()
    gen = torch.Generator().manual_seed(7)
    ulp = lambda t: t * (1 + EPS64 * torch.randn(t.shape, generator=gen, dtype=t.dtype))
    wq, wf = torch.zeros_like(dq), torch.zeros_like(df)
    moved_n = torch.zeros_like(same_n)
    for _ in range(PERTURB_SAMPLES):
        q2, f2, n2 = solver_lanes.solve_plain(
            m, ulp(qM), ulp(a0),
            dataclasses.replace(efc, J=ulp(efc.J), aref=ulp(efc.aref), D=ulp(efc.D)), warm)
        wq = torch.maximum(wq, (q2 - qp).abs().amax(1))
        wf = torch.maximum(wf, (f2 - fp).abs().amax(1))
        moved_n |= n2 != npl
    stable = (wq <= 1e-9 * sq) & (wf <= 1e-9 * sf) & ~moved_n
    assert stable.sum() >= 8, stable
    assert float((same_x & same_n)[stable].double().mean()) >= 0.95
    assert (dq[~same_x] <= 2 * wq[~same_x]).all() and (df[~same_x] <= 2 * wf[~same_x]).all()
    assert not (~same_n & ~moved_n).any()


def test_solver_kernel_source_with_equality_rows_equals_plain_in_float64(
        host_libs, ee_state, monkeypatch):
    _check_ee_state(host_libs["solve_double"], ee_state[1], monkeypatch)


def test_solver_check_fails_for_mutated_equality_rows(host_tmp, ee_state, monkeypatch):
    """The check above fails on both EE states when the equality rows'
    gradient is scaled by 1.01 in the source."""
    mutation = ("            g = Dr * jr;\n            h = Dr;",
                "            g = (r < L.neq ? 1.01f : 1.f) * Dr * jr;\n            h = Dr;")
    lib = _solver_lib(host_tmp, "double", mutation, tag="_equality_gradient")
    with pytest.raises(AssertionError):
        _check_ee_state(lib, ee_state[1], monkeypatch)


def test_solver_kernel_source_in_a_partial_block_equals_full_blocks(host_libs,
                                                                   contact_state):
    """B = 29 is no multiple of the envs of a block: the warps of the last
    block past B stage zeros and must neither solve nor write (a write past
    B lands in the next output row).  Each env's result must not depend on
    the batch, so the first 29 lanes equal those of the B = 32 run bit for
    bit, in both builds.  (`solve_plain` is no reference here: its float64
    results move with the batch width, as torch's vector loops round the
    last lanes otherwise.)"""
    for real, dtype in (("double", torch.float64), ("float", torch.float32)):
        lib = host_libs[f"solve_{real}"]
        *budgets, tol = solver_lanes.budgets(contact_state[0], torch.float32)
        full = _solve_host(lib, *_problem(contact_state, dtype), budgets, tol)
        part = _solve_host(lib, *_problem(contact_state, dtype, lanes=29), budgets, tol)
        for f, p in zip(full, part):
            assert p.shape[0] == 29 and torch.equal(f[:29], p)


# Mutations of newton_solve.cu that the float64 check must catch: a
# middle-zone term of the gradient and of the Hessian scaled by 1.1, and the
# rows of lane 0 (contact 0, active in every env of the state) dropped from
# the warp's gradient sum.
MUTATIONS = {
    "middle_gradient": ("+ kw * mu * uhat[j - 1] * usj[j];",
                        "+ 1.1f * kw * mu * uhat[j - 1] * usj[j];"),
    "middle_hessian": ("a[m] += kz * ai * al + wmu * (ss - pi * pl);",
                       "a[m] += 1.1f * kz * ai * al + wmu * (ss - pi * pl);"),
    "lane0_gradient": ("gcon[v] += t;", "if (lane != 0) gcon[v] += t;"),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_solver_check_fails_for_mutated_source(host_tmp, contact_state, mutation,
                                               monkeypatch):
    lib = _solver_lib(host_tmp, "double", MUTATIONS[mutation], tag=f"_{mutation}")
    share = _share_equal_in_float64(lib, contact_state, FULL_BUDGETS, monkeypatch)
    assert share < 0.95, share


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
