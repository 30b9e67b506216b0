// Hull support sweep + per-pair overlap, E envs per CUDA block.
//
// Replaces the Pallas kernel gym_so100_tpu/ops/collision/hull_lanes.py::
// _sweep_h_pallas.  For each of G hull geoms it rotates the ND fixed
// directions into the geom frame, takes the running max and min of d.v over
// the geom's TRUE vertex count, and adds d.p: the support tables Ttop and
// Tbot (G, ND).  For each of P pairs, h[d] = Ttop[g1][d] - Tbot[g2][d];
// depth = -min_d h, normal = D[argmin], the FIRST minimal index winning ties.
//
// What bounds it on an H100: instruction issue.  Per env it does about
// G*ND*(9 + 7*V) float operations on 12*G input floats and writes 4*P
// outputs, so bytes are tiny.  With one env per block (the first design)
// every (geom, direction) cell issued three loads of `verts` per vertex for
// seven arithmetic operations, and every block reloaded the same vertices;
// loads and address arithmetic set the pace.  The rounding contract below
// forbids FMA, so the floor is about twice the bound that counts a
// multiply-add as two operations at the FMA rate.
//
// Design: a block serves E envs (8 at the SO100 scene).  It stages, once:
// the E envs' p and R rows (12*G floats each, read as rows of E consecutive
// floats), and every geom's true vertices as float4 (604 vertices, 9.7 KB).
// A thread owns one (geom, direction) cell for ALL E envs: one shared float4
// load of a vertex feeds E support dot products, so loads per arithmetic
// operation fall by E.  Both tables of every env stay in shared memory,
// rows padded to ND|1 floats so that pair threads reading different geoms
// spread over the banks: 2*G*(ND|1)*4 B = 26.6 KB per env.  At G = 25,
// ND = 132, E = 8 that is 212.8 KB of tables + 9.6 KB of poses + 9.7 KB of
// vertices = 232,164 B of the 232,448 a block may hold, so one block per
// SM.  The mocap-weld scene has one hull geom more (its mocap target's
// box, G = 26), which tips 8 envs over the limit (241,192 B), so E is 8
// where that fits and 4 otherwise (125,544 B there); larger tables (about
// G > 50) take 2, then 1, and only a scene whose single env's tables do
// not fit (about G > 150) makes the entry point return
// cudaErrorInvalidValue, where the Pallas kernel has no such bound.
// E = 4 on the joint scene took 13% longer at 4096 envs (and 40% less at
// 128, where 8 envs per block leave most SMs idle), so 8 stays first
// (scripts/hull_ab.py).  The block has 512 threads (16 warps; 256 were
// slower on the H100), 6.4 cells per thread, 64 registers, no spills (an
// E = 8 build without the template used 90 and ran as fast).  The pair
// phase spreads the P*E (pair, env) items over the block, env fastest, so
// its outputs go out as rows of E consecutive floats.  Left on the
// table: with one block per SM the staging, sweep and pair phases of a
// block do not overlap, and the 1,032 pair items take three rounds of 512
// (the third for 8 items).
//
// Rounding: every product and sum uses __fmul_rn/__fadd_rn, which nvcc
// never contracts into an FMA, in the same order as the plain PyTorch
// version (hull_lanes.sweep_h_plain), so the tables, and hence the argmin,
// are bit-identical to it whatever the build's -fmad setting.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr size_t SMEM_LIMIT = 232448;   // dynamic shared memory of one block

struct Shape {
    int G, ND, NDp, P, Vtot, E;         // E: envs per block

    __host__ __device__ size_t tables() const { return (size_t)E * 2 * G * NDp; }
    __host__ __device__ size_t poses() const { return (size_t)E * 12 * G; }
    // float offset of the vertex copy, rounded up to a float4 boundary
    __host__ __device__ size_t verts_at() const { return (tables() + poses() + 3) & ~(size_t)3; }
    __host__ __device__ size_t bytes() const {
        return (verts_at() + 4 * (size_t)Vtot) * sizeof(float) + G * sizeof(int);
    }
};

template <int E>
__global__ void __launch_bounds__(THREADS) hull_sweep_kernel(
    const float* __restrict__ p,      // (3G, B) rows j*G + g
    const float* __restrict__ R,      // (9G, B) rows (j*3+k)*G + g
    const float* __restrict__ verts,  // (G, 3*Vmax) col v*3 + k
    const float* __restrict__ D,      // (ND, 3)
    const int* __restrict__ counts,   // (G,) true vertex counts
    const int* __restrict__ i1,       // (P,)
    const int* __restrict__ i2,       // (P,)
    float* __restrict__ out,          // (4P, B)
    Shape s, int Vmax, int B)
{
    extern __shared__ float smem[];
    const int G = s.G, ND = s.ND, NDp = s.NDp, P = s.P;
    float* tab = smem;                          // env e: Ttop rows, then Tbot rows
    float* pr = smem + s.tables();              // env e: 12G floats, p then R rows
    float4* vs = reinterpret_cast<float4*>(smem + s.verts_at());
    int* vstart = reinterpret_cast<int*>(vs + s.Vtot);
    const int b0 = blockIdx.x * E;
    const size_t Bs = (size_t)B;

    // ---- stage the poses (rows of E consecutive envs) and the vertices ----
    for (int q = threadIdx.x; q < 12 * G * E; q += blockDim.x) {
        const int r = q / E, e = q - r * E;
        float v = 0.f;
        if (b0 + e < B) v = r < 3 * G ? p[r * Bs + b0 + e] : R[(r - 3 * G) * Bs + b0 + e];
        pr[e * 12 * G + r] = v;
    }
    if (threadIdx.x == 0) {
        int st = 0;
        for (int g = 0; g < G; ++g) {
            vstart[g] = st;
            st += counts[g];
        }
    }
    __syncthreads();
    for (int q = threadIdx.x; q < s.Vtot; q += blockDim.x) {
        int g = 0;
        while (g + 1 < G && vstart[g + 1] <= q) ++g;
        const float* vg = verts + ((size_t)g * Vmax + (q - vstart[g])) * 3;
        vs[q] = make_float4(vg[0], vg[1], vg[2], 0.f);
    }
    __syncthreads();

    // ---- support sweep: one (g, d) cell for all E envs per step ----
    for (int w = threadIdx.x; w < G * ND; w += blockDim.x) {
        const int g = w / ND;
        const int d = w - g * ND;
        const float D0 = D[3 * d], D1 = D[3 * d + 1], D2 = D[3 * d + 2];
        float ld[E][3];
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const float* Rg = pr + e * 12 * G + 3 * G;   // R entry (j, k): Rg[(j*3+k)*G + g]
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                ld[e][k] = __fadd_rn(__fadd_rn(__fmul_rn(D0, Rg[(0 + k) * G + g]),
                                               __fmul_rn(D1, Rg[(3 + k) * G + g])),
                                     __fmul_rn(D2, Rg[(6 + k) * G + g]));
            }
        }
        const float4* vg = vs + vstart[g];
        float smax[E], smin[E];
        {
            const float4 v = vg[0];
#pragma unroll
            for (int e = 0; e < E; ++e) {
                smax[e] = __fadd_rn(__fadd_rn(__fmul_rn(ld[e][0], v.x), __fmul_rn(ld[e][1], v.y)),
                                    __fmul_rn(ld[e][2], v.z));
                smin[e] = smax[e];
            }
        }
        const int V = counts[g];
        for (int v = 1; v < V; ++v) {
            const float4 u = vg[v];              // one load serves all E envs
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const float t = __fadd_rn(
                    __fadd_rn(__fmul_rn(ld[e][0], u.x), __fmul_rn(ld[e][1], u.y)),
                    __fmul_rn(ld[e][2], u.z));
                smax[e] = fmaxf(smax[e], t);
                smin[e] = fminf(smin[e], t);
            }
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const float* pg = pr + e * 12 * G;           // p row j of geom g: pg[j*G + g]
            const float dp = __fadd_rn(__fadd_rn(__fmul_rn(D0, pg[g]), __fmul_rn(D1, pg[G + g])),
                                       __fmul_rn(D2, pg[2 * G + g]));
            tab[(e * 2 * G + g) * NDp + d] = __fadd_rn(smax[e], dp);
            tab[(e * 2 * G + G + g) * NDp + d] = __fadd_rn(smin[e], dp);
        }
    }
    __syncthreads();

    // ---- per (pair, env): min and first argmin over the directions ----
    for (int q = threadIdx.x; q < P * E; q += blockDim.x) {
        const int pp = q / E, e = q - pp * E;
        if (b0 + e >= B) continue;
        const float* t1 = tab + (e * 2 * G + i1[pp]) * NDp;
        const float* t2 = tab + (e * 2 * G + G + i2[pp]) * NDp;
        float best = __fsub_rn(t1[0], t2[0]);
        int bd = 0;
        for (int d = 1; d < ND; ++d) {
            const float h = __fsub_rn(t1[d], t2[d]);
            if (h < best) {           // strict: the first minimum wins ties
                best = h;
                bd = d;
            }
        }
        const size_t col = (size_t)b0 + e;
        out[pp * Bs + col] = -best;
        out[(P + pp) * Bs + col] = D[3 * bd];
        out[(2 * P + pp) * Bs + col] = D[3 * bd + 1];
        out[(3 * P + pp) * Bs + col] = D[3 * bd + 2];
    }
}

// The block shape for these sizes: the most envs per block whose shared
// memory fits; E = 0 when not even one env's does.
Shape shape_of(int G, int ND, int P, int Vtot)
{
    const int choices[] = {8, 4, 2, 1};
    for (int E : choices) {
        const Shape s{G, ND, ND | 1, P, Vtot, E};
        if (s.bytes() <= SMEM_LIMIT) return s;
    }
    return Shape{G, ND, ND | 1, P, Vtot, 0};
}

template <int E>
int launch_sweep(const float* p, const float* R, const float* verts, const float* D,
                 const int* counts, const int* i1, const int* i2, float* out,
                 const Shape& s, int Vmax, int B, cudaStream_t stream)
{
    const size_t smem = s.bytes();
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            hull_sweep_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    hull_sweep_kernel<E><<<(B + E - 1) / E, THREADS, smem, stream>>>(
        p, R, verts, D, counts, i1, i2, out, s, Vmax, B);
    return (int)cudaGetLastError();
}

}  // namespace

// Launch shape for these sizes: shape[0] envs per block (0: does not fit),
// shape[1] threads, shape[2] bytes of dynamic shared memory.  Vtot is the
// sum of the counts.
extern "C" void gst_hull_sweep_shape(int G, int ND, int P, int Vtot, int* shape)
{
    const Shape s = shape_of(G, ND, P, Vtot);
    shape[0] = s.E;
    shape[1] = THREADS;
    shape[2] = (int)s.bytes();
}

// Returns cudaErrorInvalidValue when not even one env's tables fit in one
// block's shared memory.
extern "C" int gst_hull_sweep(
    const float* p, const float* R, const float* verts, const float* D,
    const int* counts, const int* i1, const int* i2, float* out,
    int G, int ND, int P, int Vmax, int Vtot, int B, void* stream)
{
    if (B == 0) return 0;
    const Shape s = shape_of(G, ND, P, Vtot);
    const cudaStream_t st = (cudaStream_t)stream;
    switch (s.E) {
    case 8: return launch_sweep<8>(p, R, verts, D, counts, i1, i2, out, s, Vmax, B, st);
    case 4: return launch_sweep<4>(p, R, verts, D, counts, i1, i2, out, s, Vmax, B, st);
    case 2: return launch_sweep<2>(p, R, verts, D, counts, i1, i2, out, s, Vmax, B, st);
    case 1: return launch_sweep<1>(p, R, verts, D, counts, i1, i2, out, s, Vmax, B, st);
    default: return (int)cudaErrorInvalidValue;
    }
}
