// Hull support sweep + per-pair overlap, one CUDA block per env.
//
// Replaces the Pallas kernel gym_so100_tpu/ops/collision/hull_lanes.py::
// _sweep_h_pallas.  For each of G hull geoms it rotates the ND fixed
// directions into the geom frame, takes the running max and min of d.v over
// the geom's TRUE vertex count, and adds d.p: the support tables Ttop and
// Tbot (G, ND).  For each of P pairs, h[d] = Ttop[g1][d] - Tbot[g2][d];
// depth = -min_d h, normal = D[argmin], the FIRST minimal index winning ties.
//
// What bounds it on an H100: arithmetic.  Per env it does G*ND*(9 + 5*V)
// flops on 12*G input floats and writes 4*P outputs, so bytes are tiny and
// the vertex chains dominate (about 0.5 MFLOP per env at the SO100 scene's
// vertex counts).  The design keeps both (G, ND) tables of an env in shared
// memory (2*25*132*4 B = 26.4 KB at G=25, ND=132), so the P pair reductions
// never touch device memory: threads stride over (g, d) for the sweep, then
// over pairs for the min/argmin.  Inputs and outputs are batch-minor
// (rows, B), so a block's reads and writes are strided by B; they are a few
// hundred floats per env and not what limits it.
//
// Rounding: every product and sum uses __fmul_rn/__fadd_rn, which nvcc
// never contracts into an FMA, in the same order as the plain PyTorch
// version (hull_lanes.sweep_h_plain), so the tables, and hence the argmin,
// are bit-identical to it whatever the build's -fmad setting.

#include <cuda_runtime.h>

namespace {

__global__ void hull_sweep_kernel(
    const float* __restrict__ p,      // (3G, B) rows j*G + g
    const float* __restrict__ R,      // (9G, B) rows (j*3+k)*G + g
    const float* __restrict__ verts,  // (G, 3*Vmax) col v*3 + k
    const float* __restrict__ D,      // (ND, 3)
    const int* __restrict__ counts,   // (G,) true vertex counts
    const int* __restrict__ i1,       // (P,)
    const int* __restrict__ i2,       // (P,)
    float* __restrict__ out,          // (4P, B)
    int G, int ND, int P, int Vmax, int B)
{
    extern __shared__ float smem[];
    float* Tt = smem;                 // (G, ND)
    float* Tb = Tt + G * ND;          // (G, ND)
    float* pr = Tb + G * ND;          // 12G: this env's p then R rows
    const int b = blockIdx.x;
    const size_t Bs = (size_t)B;

    for (int r = threadIdx.x; r < 12 * G; r += blockDim.x) {
        pr[r] = r < 3 * G ? p[r * Bs + b] : R[(r - 3 * G) * Bs + b];
    }
    __syncthreads();
    const float* pg = pr;             // p row j of geom g: pg[j*G + g]
    const float* Rg = pr + 3 * G;     // R entry (j, k) of geom g: Rg[(j*3+k)*G + g]

    for (int w = threadIdx.x; w < G * ND; w += blockDim.x) {
        const int g = w / ND;
        const int d = w - g * ND;
        const float D0 = D[3 * d], D1 = D[3 * d + 1], D2 = D[3 * d + 2];
        float ld[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            ld[k] = __fadd_rn(__fadd_rn(__fmul_rn(D0, Rg[(0 + k) * G + g]),
                                        __fmul_rn(D1, Rg[(3 + k) * G + g])),
                              __fmul_rn(D2, Rg[(6 + k) * G + g]));
        }
        const float* vg = verts + (size_t)g * 3 * Vmax;
        float smax = __fadd_rn(__fadd_rn(__fmul_rn(ld[0], vg[0]), __fmul_rn(ld[1], vg[1])),
                               __fmul_rn(ld[2], vg[2]));
        float smin = smax;
        const int V = counts[g];
        for (int v = 1; v < V; ++v) {
            const float s = __fadd_rn(
                __fadd_rn(__fmul_rn(ld[0], vg[3 * v]), __fmul_rn(ld[1], vg[3 * v + 1])),
                __fmul_rn(ld[2], vg[3 * v + 2]));
            smax = fmaxf(smax, s);
            smin = fminf(smin, s);
        }
        const float dp = __fadd_rn(__fadd_rn(__fmul_rn(D0, pg[g]), __fmul_rn(D1, pg[G + g])),
                                   __fmul_rn(D2, pg[2 * G + g]));
        Tt[w] = __fadd_rn(smax, dp);
        Tb[w] = __fadd_rn(smin, dp);
    }
    __syncthreads();

    for (int pp = threadIdx.x; pp < P; pp += blockDim.x) {
        const float* t1 = Tt + i1[pp] * ND;
        const float* t2 = Tb + i2[pp] * ND;
        float best = __fsub_rn(t1[0], t2[0]);
        int bd = 0;
        for (int d = 1; d < ND; ++d) {
            const float h = __fsub_rn(t1[d], t2[d]);
            if (h < best) {           // strict: the first minimum wins ties
                best = h;
                bd = d;
            }
        }
        out[pp * Bs + b] = -best;
        out[(P + pp) * Bs + b] = D[3 * bd];
        out[(2 * P + pp) * Bs + b] = D[3 * bd + 1];
        out[(3 * P + pp) * Bs + b] = D[3 * bd + 2];
    }
}

}  // namespace

extern "C" int gst_hull_sweep(
    const float* p, const float* R, const float* verts, const float* D,
    const int* counts, const int* i1, const int* i2, float* out,
    int G, int ND, int P, int Vmax, int B, void* stream)
{
    if (B == 0) return 0;
    const size_t smem = (size_t)(2 * G * ND + 12 * G) * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            hull_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    hull_sweep_kernel<<<B, 256, smem, (cudaStream_t)stream>>>(
        p, R, verts, D, counts, i1, i2, out, G, ND, P, Vmax, B);
    return (int)cudaGetLastError();
}
