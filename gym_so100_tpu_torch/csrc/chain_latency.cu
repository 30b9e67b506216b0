// A measurement of the card, not a port of a kernel: the cycles one warp
// takes per dependent float32 operation, and the SM clock, which together
// give the chain probe kernel's floor (csrc/chain_probe.cu: 11 dependent
// float multiplies and adds per iteration that no layout can shorten).
//
// One block of one warp runs x through 64 * iters dependent operations of
// one kind: 0 FADD, 1 FMUL, 2 FMUL and FADD alternating (the chain's own
// mix), 3 __shfl_sync.  It reads clock64() (SM cycles) and %globaltimer
// (ns) around the chain; res gets both.  The loop's counter and branch
// fall once per 64 operations.  scripts/probe_chain.py::dependent_latency
// launches it.

#include <cuda_runtime.h>

namespace {

constexpr int UNROLL = 64;

__device__ __forceinline__ unsigned long long global_ns()
{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

template <int KIND>
__global__ void chain_latency_kernel(const float* in, float* out, long long* res, int iters)
{
    float x = in[threadIdx.x];
    const float a = in[32], b = in[33];
    const int src = (threadIdx.x + 1) & 31;
    __syncwarp();
    const long long c0 = clock64();
    const unsigned long long t0 = global_ns();
    for (int k = 0; k < iters; ++k) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            if (KIND == 0) x = x + b;
            else if (KIND == 1) x = x * a;
            else if (KIND == 2) x = (u & 1) ? x + b : x * a;
            else x = __shfl_sync(0xffffffffu, x, src);
        }
    }
    const long long c1 = clock64();
    const unsigned long long t1 = global_ns();
    out[threadIdx.x] = x;
    if (threadIdx.x == 0) {
        res[0] = c1 - c0;
        res[1] = (long long)(t1 - t0);
    }
}

}  // namespace

// in: 34 floats (32 starting values, the factor, the addend); out: 32
// floats; res: 2 int64 (cycles, ns).  The chain has 64 * iters operations.
extern "C" int gst_chain_latency(const float* in, float* out, long long* res, int kind,
                                 int iters, void* stream)
{
    if (kind < 0 || kind > 3 || iters < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (kind) {
    case 0: chain_latency_kernel<0><<<1, 32, 0, s>>>(in, out, res, iters); break;
    case 1: chain_latency_kernel<1><<<1, 32, 0, s>>>(in, out, res, iters); break;
    case 2: chain_latency_kernel<2><<<1, 32, 0, s>>>(in, out, res, iters); break;
    default: chain_latency_kernel<3><<<1, 32, 0, s>>>(in, out, res, iters); break;
    }
    return (int)cudaGetLastError();
}
