// A chain of small elementwise operations fused into one kernel, one thread
// per env, one warp on each SM sub-partition.
//
// Replaces the Pallas kernel devtools/probe_pallas.py::chain_pallas (body
// pallas_kernel), which the JAX round wrote to measure what per-operation
// overhead costs against one fused kernel.  Per env, n times:
//   v2 = rotate v by the unit quaternion q  (t = 2 (xyz x v), v + w t + xyz x t)
//   v3 = M v2
//   M  = 0.999 M + 0.001 v3 v2^T
//   v  = v3 / 2 + v2 / 2
// and v is written out.  n is a run-time argument (the probe uses 50, as
// the Pallas kernel's unrolled loop does).
//
// Layout: structure of arrays, each component a row of B floats: q (4, B),
// v (3, B), M (9, B) with M[i][j] in row 3 i + j, out (3, B).  The Pallas
// kernel's (C, B / 1024, 8, 128) tiles are a view of the same memory.
// Thread b owns env b: it loads its 16 floats once (consecutive threads
// read consecutive addresses of each row, so every load is coalesced),
// keeps q, v and M in registers for the whole loop and stores 3 floats.
//
// What bounds it: per env 16 floats read and 3 written, 84 float
// operations per iteration (no multiply-add: see Rounding) and a chain of
// 11 dependent ones (v -> t 3 deep -> w t, ct 2 -> r 1 -> M r 3 -> v 2).
// At B = 4096 the bytes take ~0.1 us and the operations ~0.5 us over the
// whole card, but a warp issues one instruction a cycle, so each warp
// spends at least 84 cycles on an iteration of its 32 envs: the kernel is
// bound by the issue of its warps, one iteration after another.
//
// Design: blocks of 4 warps, so at B = 4096 the 32 blocks go to 32 SMs with
// one warp on each of their four schedulers (256-thread blocks put two
// warps on each scheduler of 16 SMs: twice the issue cycles).  v is
// computed before M's update and the loop is unrolled 10 times.  Without
// a min-blocks hint ptxas chose 32 registers; with __launch_bounds__(128, 1)
// it takes 40 and schedules an iteration in ~91 cycles, 94 with 32.  An
// env spread over three lanes (a row of M each, v exchanged by shuffles:
// ~53 operations a lane) was slower: a shuffle's 26 cycles fall on every
// iteration's chain (scripts/chain_ab.py, csrc/chain_latency.cu; PERF.md).
//
// Rounding: every operation is pallas_kernel's, in its order, each rounded
// on its own (the build passes -fmad=false, so no multiply-add is
// contracted): the plain PyTorch version (scripts/probe_chain.py::
// chain_plain) gives the same bits.  The constants are the float32
// roundings of the double literals, as torch and JAX convert a Python
// float.  The chain diverges in some lanes (|v| grows without bound, to
// inf and nan by n = 50 in about a third of them); those lanes follow the
// same operations and so the same non-finite values.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;    // 4 warps: one on each SM sub-partition

__global__ void __launch_bounds__(THREADS, 1) chain_probe_kernel(
    const float* __restrict__ q, const float* __restrict__ v,
    const float* __restrict__ M, float* __restrict__ out, int n, int B)
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const float c2 = (float)2.0, c999 = (float)0.999, c001 = (float)0.001,
                c05 = (float)0.5;
    const float w = q[b], x = q[B + b], y = q[2 * B + b], z = q[3 * B + b];
    float v0 = v[b], v1 = v[B + b], v2 = v[2 * B + b];
    float m[9];
    for (int k = 0; k < 9; ++k) m[k] = M[k * B + b];

#pragma unroll 10
    for (int it = 0; it < n; ++it) {
        // t = 2 * cross(xyz, v)
        const float t0 = c2 * (y * v2 - z * v1);
        const float t1 = c2 * (z * v0 - x * v2);
        const float t2 = c2 * (x * v1 - y * v0);
        // ct = cross(xyz, t)
        const float ct0 = y * t2 - z * t1;
        const float ct1 = z * t0 - x * t2;
        const float ct2 = x * t1 - y * t0;
        // r = v + w t + ct  (the rotated v, v2 in pallas_kernel)
        const float r0 = v0 + w * t0 + ct0;
        const float r1 = v1 + w * t1 + ct1;
        const float r2 = v2 + w * t2 + ct2;
        // s = M r  (v3 in pallas_kernel)
        const float s0 = m[0] * r0 + m[1] * r1 + m[2] * r2;
        const float s1 = m[3] * r0 + m[4] * r1 + m[5] * r2;
        const float s2 = m[6] * r0 + m[7] * r1 + m[8] * r2;
        // v = s * 0.5 + r * 0.5
        v0 = s0 * c05 + r0 * c05;
        v1 = s1 * c05 + r1 * c05;
        v2 = s2 * c05 + r2 * c05;
        // M = M * 0.999 + 0.001 * s_i * r_j
        const float s[3] = {s0, s1, s2};
        const float r[3] = {r0, r1, r2};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const float si = c001 * s[i];
#pragma unroll
            for (int j = 0; j < 3; ++j) m[3 * i + j] = m[3 * i + j] * c999 + si * r[j];
        }
    }
    out[b] = v0;
    out[B + b] = v1;
    out[2 * B + b] = v2;
}

}  // namespace

// (envs per block, threads per block, bytes of dynamic shared memory).
extern "C" void gst_chain_probe_shape(int B, int* shape)
{
    (void)B;
    shape[0] = THREADS;
    shape[1] = THREADS;
    shape[2] = 0;
}

// Returns cudaErrorInvalidValue for a negative n or B.
extern "C" int gst_chain_probe(const float* q, const float* v, const float* M, float* out,
                               int n, int B, void* stream)
{
    if (n < 0 || B < 0) return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    chain_probe_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
        q, v, M, out, n, B);
    return (int)cudaGetLastError();
}
