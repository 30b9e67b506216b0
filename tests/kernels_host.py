"""Shared pieces of the host builds of the CUDA kernels' source.

The machine without a GPU has no nvcc, but the kernels in
gym_so100_tpu_torch/csrc are plain C++ apart from a few CUDA keywords.  The
tests in test_torch_kernels_host*.py compile them with the host C++
compiler through the shim below (CUDA qualifiers dropped, shared memory a
static buffer), with floating-point contraction off, and run each launch
with its real block shape: the blocks one after another, each block's
threads as fibers (ucontext) on one host thread.  A fiber runs until it
reaches a barrier: `__syncthreads` is a barrier of the block, `__syncwarp`
a barrier of the thread's warp, and `__shfl_sync`, `__shfl_xor_sync` and
`__ballot_sync` an exchange through a per-block buffer between two warp
barriers, so a warp-cooperative kernel runs as on the card.  A fiber runs
ahead of the others up to its next barrier, first thread first in even
blocks and last thread first in odd ones, so a missing barrier shows up
as a wrong read, the same on every run, where it lets a thread read what
another writes in the same block; the shim cannot see one that guards a
shared value every block writes alike (the shared arrays keep the last
block's values).  A barrier that some thread never reaches aborts.  One host thread per process: the tests do not
contend for cores with their own threads.

This module holds the shim, the builds, the launches and the test states;
the test files import what they use.  They skip where no host C++
compiler is installed.
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
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>
#include <ucontext.h>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static
#define __launch_bounds__(...)
struct dim3_ { unsigned x, y, z; };
static dim3_ blockIdx, threadIdx, blockDim;
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

// One block at a time; its threads are fibers (ucontext) on this host
// thread.  A fiber runs until it reaches a barrier; the scheduler resumes
// each fiber whose barrier every member has reached, in thread order in
// even blocks and in reverse order in odd ones.
enum { RUN_, AT_BLOCK_, AT_WARP_, DONE_ };
struct Fiber_ {
    ucontext_t ctx;
    std::unique_ptr<char[]> stack;
    int state;
    unsigned gen;
};
struct Block_ {
    std::vector<Fiber_> f;
    ucontext_t sched;
    unsigned cur, block_arrived, block_gen;
    std::vector<unsigned> warp_arrived, warp_gen, warp_size;
    std::function<void()> body;
    std::uint64_t xbuf[1024];
};
static Block_* blk_;
static const std::size_t STACK_ = 256 * 1024;
static void fiber_main_() {
    blk_->body();
    blk_->f[blk_->cur].state = DONE_;
    swapcontext(&blk_->f[blk_->cur].ctx, &blk_->sched);
}
inline void wait_(int at, unsigned& arrived, unsigned& gen, unsigned size) {
    Fiber_& me = blk_->f[blk_->cur];
    me.state = at;
    me.gen = gen;
    if (++arrived == size) {
        arrived = 0;
        ++gen;
    }
    swapcontext(&me.ctx, &blk_->sched);
}
inline void __syncthreads() {
    wait_(AT_BLOCK_, blk_->block_arrived, blk_->block_gen, (unsigned)blk_->f.size());
}
inline void __syncwarp(unsigned = 0xffffffffu) {
    const unsigned w = threadIdx.x / 32;
    wait_(AT_WARP_, blk_->warp_arrived[w], blk_->warp_gen[w], blk_->warp_size[w]);
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
    Block_ bk;
    bk.body = body;
    bk.f.resize(block);
    for (auto& x : bk.f) x.stack.reset(new char[STACK_]);
    for (unsigned w = 0; w * 32 < block; ++w)
        bk.warp_size.push_back(block - w * 32 < 32 ? block - w * 32 : 32);
    blk_ = &bk;
    for (unsigned b = 0; b < grid; ++b) {
        blockIdx = {b, 0, 0};
        bk.block_arrived = bk.block_gen = 0;
        bk.warp_arrived.assign(bk.warp_size.size(), 0);
        bk.warp_gen.assign(bk.warp_size.size(), 0);
        for (auto& x : bk.f) {
            getcontext(&x.ctx);
            x.ctx.uc_stack.ss_sp = x.stack.get();
            x.ctx.uc_stack.ss_size = STACK_;
            x.ctx.uc_link = nullptr;
            makecontext(&x.ctx, fiber_main_, 0);
            x.state = RUN_;
        }
        for (unsigned done = 0; done < block;) {
            bool moved = false;
            done = 0;
            for (unsigned i = 0; i < block; ++i) {
                const unsigned t = b % 2 ? block - 1 - i : i;   // odd blocks: last thread first
                Fiber_& x = bk.f[t];
                const bool ready = x.state == RUN_
                    || (x.state == AT_BLOCK_ && bk.block_gen != x.gen)
                    || (x.state == AT_WARP_ && bk.warp_gen[t / 32] != x.gen);
                done += x.state == DONE_;
                if (!ready) continue;
                x.state = RUN_;
                bk.cur = t;
                threadIdx = {t, 0, 0};
                swapcontext(&bk.sched, &x.ctx);
                moved = true;
            }
            if (!moved && done < block) std::abort();   // a barrier nobody releases
        }
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


def _build(tmp, name, real, mutate=None, tag="", defines=()):
    src = tmp / f"{name}_{real}{tag}.cpp"
    src.write_text(SHIM + _host_source(name, real, mutate))
    lib = tmp / f"lib{name}_{real}{tag}.so"
    res = subprocess.run(
        ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", *[f"-D{d}" for d in defines], "-o", str(lib), str(src)],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return ctypes.CDLL(str(lib))


_P, _I = ctypes.c_void_p, ctypes.c_int


def _solver_lib(tmp, real, mutate=None, tag="", nvs=(12,)):
    """The Newton source built for the host with only the instantiations
    `nvs` (ascending; a problem runs on the first NV >= its nv, padded)."""
    lib = _build(tmp, "newton_solve", real, mutate, tag,
                 defines=[f"NEWTON_NVS={','.join(map(str, nvs))}"])
    ct = ctypes.c_float if real == "float" else ctypes.c_double
    lib.gst_newton_solve.argtypes = [_P] * 9 + [_I] * 10 + [ct, _P]
    return lib


@pytest.fixture(scope="module")
def host_tmp(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    return tmp_path_factory.mktemp("csrc_host")


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


def _solve_host(lib, m, qM, a0, efc, warm, budgets, tol):
    inp = solver_lanes.pack_fused_inputs(m, qM, a0, efc, warm)
    NE, B = efc.aref.shape
    K = efc.con_mu.shape[0]
    out, past = _out_buffer((2 * m.nv + 1, B), a0.dtype)
    _call(lib.gst_newton_solve, *[inp[k] for k in
          ("J", "aref", "D", "aux", "us", "qM", "x0", "warm")], out,
          m.nv, NE, efc.neq, efc.nf, efc.nl, K, B, *budgets, tol)
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


FULL_BUDGETS = (solver_lanes.NEWTON_ITERS, solver_lanes.LS_ITERS, solver_lanes.BRACKET_ITERS)
EPS64 = 2.220446049250313e-16
PERTURB_SAMPLES = 40      # one-ulp perturbations of the plain solve's inputs
