// Whole Newton constraint solve: one warp per env for nv up to 16, one
// block of 4 warps per env above (newton_solve_wide).
//
// Replaces the Pallas kernel gym_so100_tpu/ops/solver_lanes.py::
// _solve_fused_pallas.  Per env it minimizes the constraint cost over
// equality (quadratic), friction-loss (Huber), limit (one-sided) and
// elliptic-cone contact rows (top/middle/bottom zones) plus
// 1/2 (x - x0)' M (x - x0): warmstart-vs-x0 pick by total cost; then up to
// max_iters Newton iterations, each assembling cost, gradient and Hessian,
// factoring the nv x nv Hessian (Cholesky, steepest-descent guard when the
// direction does not descend), bracketing (bracket_len doublings) and
// regula falsi (ls_len steps) on the directional derivative, and stopping a
// lane once improvement or gradient norm (scaled) falls below tol.  Frozen
// lanes keep x and their iteration count, as in the masked scan.
//
// What bounds it on an H100: latency.  The inputs are ~5.3 KB per env at
// nv = 12, K = 16 (J alone is 12 x 82 floats) and the arithmetic ~0.3
// MFLOP per env, but every step of a Newton iteration depends on the one
// before.  The first design ran one thread per env: 128 one-warp blocks
// at B = 4096 (one warp on most SMs, nothing to hide a load's latency),
// 255 registers with spills, every row pass serial in that thread and read
// from device memory, and jar/djar in (NE, B) scratch in device memory.
//
// Design: one warp per env, ENVS = 4 envs (warps) per block.
// - Each env's inputs (J, aref, D, aux, uscale, the qM triangle, x0, warm)
//   are staged into shared memory once per launch by the whole block, as
//   rows of 4 consecutive envs of the batch-minor layout (16 bytes, half
//   of a 32-byte sector; the neighbouring block reads the other half).
//   J's rows are padded to NE|1 floats, so lanes reading the same row
//   index of different dofs (the Hessian pass) fall in different banks;
//   each env's region is padded to 32/ENVS (mod 32) floats so the staging
//   stores of a warp (8 rows x 4 envs) spread over the 32 banks.  Everything the solve
//   writes (jar, djar, row weights, the factor, x, x_new, the direction)
//   stays in the env's shared region too: no device-memory scratch.
// - The rows are split over the lanes (for_units): contact k, all 4 of its
//   component rows, on lane k % 32, so the cone zone is decided in one
//   place; the scalar rows (equality, friction loss, limit) round-robin
//   over the lanes without a contact.  At the SO100 scene (K = 16, 18
//   scalar rows) lanes 0-15 hold a contact each and lanes 16-31 one or two
//   scalar rows.  Only the owning lane touches a row's jar and djar.
// - Sums across lanes (cost, directional derivative, J'g, the force) use a
//   fixed __shfl_xor_sync butterfly, so every lane gets the same bits and
//   every branch on them is uniform across the warp; a line-search
//   evaluation is one unit per lane plus one 5-step butterfly.
// - The Hessian: in the row pass each lane writes its rows' diagonal
//   weights (h of a scalar row, Dc of a top-zone contact row) and its
//   contacts' middle-zone records (kz, wmu, uhat) to shared memory.  The
//   warp lists the rows of nonzero weight by ballot (about 35 of 82), then
//   lane t owns triangle entries t, t+32, ... (ceil(nv(nv+1)/64) of them,
//   in registers) and sums over the list: h_r J_ir J_lr, plus kz a_i a_l
//   + wmu (S_i.S_l - proj_i proj_l) for each middle-zone contact.
// - The Cholesky runs right-looking on those register-held entries: per
//   column the owner of the pivot broadcasts it, the column's owners scale
//   it and publish it to shared memory, and every lane updates its entries
//   to the right; the products are subtracted in the same order as in a
//   serial left-looking Cholesky.  The triangular solves and the products
//   with M run on lanes 0 to nv-1 (one row each) with shuffle broadcasts.
// - nv up to 16 is a template parameter, since the per-lane arrays (J'g,
//   the gradient, the direction, the force) and the entries a lane owns
//   (Owned packs a row and a column into 4 bits each) are sized by it and
//   must stay in registers.  Three instantiations are built, 12 (the SO100
//   scenes), 15 (the Panda) and 16; a problem of another nv <= 16 runs on
//   the next larger one, padded (see the kernel).  The nvcc build of both
//   kernels took 20.0 s with these three against 8.1 s with nv = 12 alone
//   and 52.1 s with all 16 (PERF.md).
// - nv above the largest instantiation, and an nv whose instantiation's
//   4-env block does not fit one block's shared memory (many contact
//   rows), run on one more kernel, which reads nv at run time
//   (newton_solve_wide, Layout<0>, below).
// - Occupancy (nv = 12, K = 16): about 7.9 KB of shared memory per env
//   (31.9 KB per 4-env block) and __launch_bounds__(128, 4), so at most
//   128 registers and no spills (x, x_new and the direction are kept in
//   shared memory, and the jar loop unrolls 6-fold, to stay there): 4
//   blocks, 16 warps, per SM, limited by registers; 1024 blocks at B =
//   4096.  A block holds its slot until its slowest env is done, and
//   Newton iteration counts run from 1 to 10, so the slowest envs set the
//   time; 4-env blocks free their slot sooner than 8-env blocks, and
//   timed 3% faster on the H100 (PERF.md).  Larger nv keep fewer warps per SM (warps_per_sm).  Tensor
//   cores stay out: TF32 keeps about three digits, and the products are
//   at most 16 x 16 per env.
//
// The runtime-nv kernel, newton_solve_wide: one env per block of 4 warps.
// - What bounded it: latency.  Its first design ran the instantiations'
//   warp per env over run-time nv, 4 envs per block: at nv
//   = 36, NE = 170, K = 32 an env's region is ~39 KB, so one 155 KB block,
//   4 warps, per SM, one per scheduler with nothing to hide a latency, and
//   each env's solve one serial chain on 32 lanes (5.9 ms at B = 4096
//   against a bound of 0.037 ms).  Its cycle counters (a NEWTON_CLOCK
//   build, scripts/newton_ab.py) put 44% of an env's cycles in the
//   Cholesky and triangular solves (36 columns, each a loop over 35 rows
//   with % in its index arithmetic), 22% in the Hessian (21 entries per
//   lane over ~100 listed rows) and 15% in staging (one 4-byte load at a
//   time per thread); the envs of a block took 2 or 3 iterations alike,
//   so their wait for the slowest cost 0.01%.
// - Design: one env per block of WW = 4 warps (2 and 8 timed 19% and 18%
//   slower at nv = 36), so the 43 KB region of the five-cube scene gives 5
//   blocks, 20 warps, per SM (__launch_bounds__(128, 5): 96 registers, no
//   spills).  The work is spread over the 128 threads across rows (jar,
//   djar), units (the cone and row passes), dofs (J'g and the force: a warp
//   sums 3 dofs at a time and runs their butterflies together), Hessian
//   tiles of 3 x 3 entries (each J load serves 3 entries) and Cholesky
//   entries, never inside one sum, so the bits are those of the
//   single-warp kernel (the section below says how).  The Cholesky is
//   right-looking with one block barrier per column: warp 0 takes each
//   pivot and its column and the forward solve's step, the other warps the
//   trailing update, two entries at a time; the back substitution runs on
//   warp 0.  The line search's bracket points (0, 1, 2, ..., 2^bracket_len)
//   are evaluated one per warp at once; its regula falsi steps on warp 0.
//   The iterate's jar and M (x - x0) are kept from the cost at the trial
//   point when the step is accepted, so a row pass does not recompute them.
//   Staging keeps 16 loads in flight per thread.
// - What bounds it now (cycle counters at nv = 36, 5 blocks per SM): the
//   Cholesky's 37 barrier steps and the back substitution's 36 dependent
//   divisions (~40% of an env's cycles together), then staging (~15%: an
//   env's 4-byte column of the lanes layout costs a 32-byte sector from
//   L2, 8x its bytes), the line search and the Hessian (~11% each):
//   1.15 ms at B = 4096 on the H100 (PERF.md).
// - The refusal stays: an nv and NE whose single env's region exceeds one
//   block's shared memory (cudaErrorInvalidValue, a zero launch shape),
//   the counterpart of the Pallas kernel's VMEM bound.

// Input layout (as the Pallas kernel took it): J (nv*NE, B) row v*NE + r;
// aref, D (NE, B); contact rows COMPONENT-major (row ns + j*K + k); aux rows
// [floss (nf) | R_f (nf) | mu (K) | Dn (K) | scale]; us (CDIM*K, B);
// qM lower triangle (nv(nv+1)/2, B) row by row; x0, warm (nv, B).  Output
// (2*nv + 1, B): qacc, qfrc_constraint, niter.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int CDIM = 4;
constexpr int WARP = 32;
constexpr int ENVS = 4;            // envs (one warp each) per block of an instantiation
constexpr size_t SMEM_LIMIT = 232448;   // dynamic shared memory of one block
constexpr int CZ = 6;              // contact record: middle?, kz, wmu, uhat[3]
constexpr float MINVAL = 1e-15f;
constexpr unsigned FULL = 0xffffffffu;

// The wide kernel's phases, for the cycle counts of a build with
// -DNEWTON_CLOCK (scripts/newton_ab.py; the default build has none of it).
enum Phase { PH_STAGE, PH_WARM, PH_ROWS, PH_HESS, PH_CHOL, PH_DIR, PH_LS, PH_ACCEPT, PH_FORCE,
             PH_WAIT, PH_BACK, NPHASE };

// Cycles per phase of one thread (clock64 deltas), written per env as
// (NPHASE, B) int64 rows to the buffer gst_newton_clock sets.  Empty, and
// every mark a no-op, without NEWTON_CLOCK.
#ifdef NEWTON_CLOCK
__device__ long long* clock_out;
__device__ long long now() {
#ifdef __CUDA_ARCH__
    return clock64();
#else
    return 0;
#endif
}
struct Clock {
    long long t, acc[NPHASE];
    __device__ Clock() : t(now()) {
        for (int p = 0; p < NPHASE; ++p) acc[p] = 0;
    }
    __device__ void mark(int p) {
        const long long n = now();
        acc[p] += n - t;
        t = n;
    }
    __device__ void write(int b, int B) const {
        if (clock_out)
            for (int p = 0; p < NPHASE; ++p) clock_out[(size_t)p * B + b] = acc[p];
    }
};
#else
struct Clock {
    __device__ void mark(int) {}
    __device__ void write(int, int) const {}
};
#endif

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }
__host__ __device__ constexpr int ntri(int n) { return n * (n + 1) / 2; }

// Warps an SM holds for the NV instantiation, set by the registers a thread
// may use (65,536 / 32 / warps): 16 warps leave 128 registers, which holds
// nv = 12 without spills; the longer per-lane arrays of larger nv take
// more.  At 12 warps (168 registers) nv = 15 takes 155 and nv = 16 163,
// without spills; at 16 warps both spilled (80-112 bytes) and nv = 15 ran
// 3% slower on the Panda (PERF.md).
__host__ __device__ constexpr int warps_per_sm(int NV) { return NV <= 12 ? 16 : 12; }

// Sizes and the float offsets of one env's arrays in shared memory.
template <int NV>
struct Layout {
    static constexpr int NTRI = ntri(NV);
    static constexpr int NOUT = 2 * NV + 1;
    int NE, NEp, neq, nf, ns, K;
    int J, aref, D, aux, us, qM, x0, warm, jar, djar, hw, rl, cz, A, dg, o, xs, xn, dn, size;

    __host__ __device__ Layout(int NE_, int neq_, int nf_, int nl_, int K_)
        : NE(NE_), NEp(NE_ | 1), neq(neq_), nf(nf_), ns(neq_ + nf_ + nl_), K(K_) {
        J = 0;
        aref = J + NV * NEp;
        D = aref + NE;
        aux = D + NE;
        us = aux + 2 * nf + 2 * K + 1;
        qM = us + CDIM * K;
        x0 = qM + NTRI;
        warm = x0 + NV;
        jar = warm + NV;
        djar = jar + NE;
        hw = djar + NE;
        rl = hw + NE;                          // ints: rows of nonzero weight
        cz = rl + NE;
        A = cz + CZ * K;
        dg = A + NTRI;
        o = dg + NV;
        xs = o + NOUT;                         // the iterate x
        xn = xs + NV;                          // the line search's x_new
        dn = xn + NV;                          // the Newton direction
        size = ((dn + NV + 31) & ~31) + 32 / ENVS;
    }
};

template <int NV>
struct Env {
    float* s;                      // this env's shared-memory block
    Layout<NV> L;

    __device__ float at(int off, int r) const { return s[off + r]; }
    __device__ float Jv(int v, int r) const { return s[L.J + v * L.NEp + r]; }
    __device__ float M(int i, int j) const { return s[L.qM + (i >= j ? tri(i, j) : tri(j, i))]; }
    __device__ float mu(int k) const { return s[L.aux + 2 * L.nf + k]; }
    __device__ float Dn(int k) const { return s[L.aux + 2 * L.nf + L.K + k]; }
    __device__ float uscale(int j, int k) const { return s[L.us + j * L.K + k]; }
    __device__ int crow(int j, int k) const { return L.ns + j * L.K + k; }

    // jar of row r at x: -aref + sum_v J[v][r] x[v]
    __device__ float jar_at(int r, const float* x) const {
        float acc = -at(L.aref, r);
#pragma unroll 6      // a full unroll tips the kernel over 128 registers
        for (int v = 0; v < NV; ++v) acc += Jv(v, r) * x[v];
        return acc;
    }

    // gradient g, Hessian weight h and cost c of scalar row r at jar value jr
    __device__ void scalar_row(int r, float jr, float& g, float& h, float& c) const {
        const float Dr = at(L.D, r);
        bool quad = true;
        if (r >= L.neq && r < L.neq + L.nf) {
            const int i = r - L.neq;
            const float fl = at(L.aux, i);
            const float lim = fl * at(L.aux, L.nf + i);
            if (fabsf(jr) > lim) {
                quad = false;
                g = fl * (float)((jr > 0.f) - (jr < 0.f));
                h = 0.f;
                c = fl * fabsf(jr) - 0.5f * fl * lim;
            }
        } else if (r >= L.neq + L.nf && !(jr < 0.f)) {
            quad = false;
            g = h = c = 0.f;
        }
        if (quad) {
            g = Dr * jr;
            h = Dr;
            c = 0.5f * Dr * jr * jr;
        }
    }
};

// The wide kernel's layout (nv given at run time), one env per block: the
// instantiations' inputs and per-row arrays, then the per-unit costs (uv
// at x, un at a trial point), the triangle and its entry table, and the
// dof-sized vectors.  jar/jn, xs/xn, dx/dxn and mx/mxn are pairs of
// buffers for the iterate and the trial point, swapped when a step is
// accepted.  (The instantiations keep their own Layout and Env: sharing one
// with the wide kernel moved their register allocation and cost them 2-4%
// on the card, scripts/newton_ab.py, PERF.md.)
template <>
struct Layout<0> {
    int nv, NE, NEp, neq, nf, ns, K, nu;
    int J, aref, D, aux, us, qM, x0, warm;          // the inputs
    int jar, jn, djar, hw, rl, gr, cz, uv, un;      // per row, contact, unit
    int A, tl, pv, dg, rr, yv, dd, dn, gd, gc, md;  // per entry, per dof
    int xs, xn, dx, dxn, mx, mxn, ls, size;

    __host__ __device__ Layout(int nv_, int NE_, int neq_, int nf_, int nl_, int K_)
        : nv(nv_), NE(NE_), NEp(NE_ | 1), neq(neq_), nf(nf_), ns(neq_ + nf_ + nl_), K(K_),
          nu(K_ + neq_ + nf_ + nl_) {
        J = 0;
        aref = J + nv * NEp;
        D = aref + NE;
        aux = D + NE;
        us = aux + 2 * nf + 2 * K + 1;
        qM = us + CDIM * K;
        x0 = qM + ntri(nv);
        warm = x0 + nv;
        jar = warm + nv;                       // jar at x ...
        jn = jar + NE;                         // ... and at the trial point
        djar = jn + NE;
        hw = djar + NE;                        // Hessian weight per row
        rl = hw + NE;                          // ints: rows of nonzero weight
        gr = rl + NE;                          // gradient weight per row
        cz = gr + NE;                          // middle-zone record per contact
        uv = cz + CZ * K;                      // cost per unit at x ...
        un = uv + nu;                          // ... and at the trial point
        A = un + nu;                           // M + H, then its factor
        tl = A + ntri(nv);                     // ints: (i << 16) | l of entry t
        pv = tl + ntri(nv);                    // the factor's diagonal
        dg = pv + nv;                          // A's diagonal
        rr = dg + nv;                          // forward solve: residual ...
        yv = rr + nv;                          // ... and solution
        dd = yv + nv;                          // H d = grad
        dn = dd + nv;                          // the direction
        gd = dn + nv;                          // the gradient M (x - x0) + J'g
        gc = gd + nv;                          // J'g
        md = gc + nv;                          // M dn
        xs = md + nv;                          // x ...
        xn = xs + nv;                          // ... and the trial point
        dx = xn + nv;                          // x - x0 ...
        dxn = dx + nv;
        mx = dxn + nv;                         // ... and M (x - x0)
        mxn = mx + nv;
        ls = mxn + nv;                         // line-search points, 2 rounds; a flag
        size = (ls + 2 * 32 + 1 + 31) & ~31;
    }
};

// The wide kernel's env: Env's accessors.
template <>
struct Env<0> {
    float* s;
    Layout<0> L;

    __device__ float at(int off, int r) const { return s[off + r]; }
    __device__ float Jv(int v, int r) const { return s[L.J + v * L.NEp + r]; }
    __device__ float mu(int k) const { return s[L.aux + 2 * L.nf + k]; }
    __device__ float Dn(int k) const { return s[L.aux + 2 * L.nf + L.K + k]; }
    __device__ float uscale(int j, int k) const { return s[L.us + j * L.K + k]; }
    __device__ int crow(int j, int k) const { return L.ns + j * L.K + k; }

    // as Env::scalar_row
    __device__ void scalar_row(int r, float jr, float& g, float& h, float& c) const {
        const float Dr = at(L.D, r);
        bool quad = true;
        if (r >= L.neq && r < L.neq + L.nf) {
            const int i = r - L.neq;
            const float fl = at(L.aux, i);
            const float lim = fl * at(L.aux, L.nf + i);
            if (fabsf(jr) > lim) {
                quad = false;
                g = fl * (float)((jr > 0.f) - (jr < 0.f));
                h = 0.f;
                c = fl * fabsf(jr) - 0.5f * fl * lim;
            }
        } else if (r >= L.neq + L.nf && !(jr < 0.f)) {
            quad = false;
            g = h = c = 0.f;
        }
        if (quad) {
            h = Dr;
            g = Dr * jr;
            c = 0.5f * Dr * jr * jr;
        }
    }
};

// Cone-zone quantities of one contact at its jar components jc.
struct Cone {
    float u[CDIM], usj[CDIM], Dc[CDIM], uhat[CDIM - 1];
    float T, w, kz, mu;
    bool top, middle;

    template <class E>
    __device__ void eval(const E& e, int k, const float* jc) {
        mu = e.mu(k);
        const float Dn = e.Dn(k);
#pragma unroll
        for (int j = 0; j < CDIM; ++j) {
            usj[j] = e.uscale(j, k);
            u[j] = jc[j] * usj[j];
            Dc[j] = e.at(e.L.D, e.crow(j, k));
        }
        const float un = u[0];
        const float Traw = sqrtf(u[1] * u[1] + u[2] * u[2] + u[3] * u[3]);
        T = fmaxf(Traw, 1e-30f);
        const bool bottom = mu * Traw <= un;
        const bool topraw = Traw <= -mu * un;
        top = topraw && Dn > 0.f;
        middle = !(bottom || topraw) && Dn > 0.f;
        w = mu * Traw - un;
        // kz and uhat enter only the middle zone (rare): skip the divisions
        kz = 0.f;
#pragma unroll
        for (int t = 0; t < CDIM - 1; ++t) uhat[t] = 0.f;
        if (middle) {
            kz = Dn / (1.f + mu * mu);
#pragma unroll
            for (int t = 0; t < CDIM - 1; ++t) uhat[t] = u[t + 1] / T;
        }
    }

    __device__ float cost(const float* jc) const {
        float c = 0.f;
        if (top) {
            float s = 0.f;
#pragma unroll
            for (int j = 0; j < CDIM; ++j) s += Dc[j] * jc[j] * jc[j];
            c = 0.5f * s;
        }
        if (middle) c += 0.5f * kz * w * w;
        return c;
    }

    __device__ void grad(const float* jc, float* g) const {
        const float kw = middle ? kz * w : 0.f;
        g[0] = (top ? Dc[0] * jc[0] : 0.f) - kw * usj[0];
#pragma unroll
        for (int j = 1; j < CDIM; ++j)
            g[j] = (top ? Dc[j] * jc[j] : 0.f) + kw * mu * uhat[j - 1] * usj[j];
    }
};

// Sum over the warp by a fixed butterfly: every lane gets the same bits.
__device__ float wsum(float v) {
#pragma unroll
    for (int m = WARP / 2; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
    return v;
}

// My = M y: lane i < NV computes entry i, then every lane gets all NV
// entries by broadcast (the same bits in every lane).
template <int NV>
__device__ void mat_vec(const Env<NV>& e, int lane, const float* y, float* My) {
    float mi = 0.f;
    if (lane < NV) {
#pragma unroll
        for (int j = 0; j < NV; ++j) mi += e.M(lane, j) * y[j];
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) My[i] = __shfl_sync(FULL, mi, i);
}

// dx' M dx for dx = x - x0, and M dx (into Mdx), in every lane.
template <int NV>
__device__ float quad_form(const Env<NV>& e, int lane, const float* x, float* Mdx) {
    float dx[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) dx[i] = x[i] - e.at(e.L.x0, i);
    mat_vec(e, lane, dx, Mdx);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) q += dx[i] * Mdx[i];
    return q;
}

// Solve L L' d = g for the Cholesky factor L in A, cooperatively: lane i
// < NV owns row i; per column the owner divides by the pivot and
// broadcasts, the other lanes update their residual.  The forward pass
// subtracts in the order of a serial row-by-row solve, the backward pass
// from the last column down.  Every lane ends with all of d.
template <int NV>
__device__ void chol_solve(const Env<NV>& e, int lane, const float* g, float* d) {
    const float* A = e.s + e.L.A;
    float r = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
        if (lane == i) r = g[i];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        float yk = lane == k ? r / A[tri(k, k)] : 0.f;
        yk = __shfl_sync(FULL, yk, k);
        if (lane == k) r = yk;
        else if (lane > k && lane < NV) r -= A[tri(lane, k)] * yk;
    }
#pragma unroll
    for (int k = NV - 1; k >= 0; --k) {
        float dk = lane == k ? r / A[tri(k, k)] : 0.f;
        dk = __shfl_sync(FULL, dk, k);
        d[k] = dk;
        if (lane < k) r -= A[tri(k, lane)] * dk;
    }
}

// Run scalar(r) for this lane's scalar rows and contact(k) for its
// contacts.  Contact k goes to lane k % 32; the scalar rows go round-robin
// over the lanes left without a contact (all lanes when K >= 32), so at
// K = 16 no lane carries a contact and a scalar row: lanes 0-15 take one
// contact each, lanes 16-31 the 18 scalar rows.
template <int NV, class S, class C>
__device__ void for_units(const Env<NV>& e, int lane, S scalar, C contact) {
    for (int k = lane; k < e.L.K; k += WARP) contact(k);
    const bool shared = e.L.K < WARP;
    int r = shared ? lane - e.L.K : lane;
    if (r < 0) r = e.L.ns;
    for (; r < e.L.ns; r += shared ? WARP - e.L.K : WARP) scalar(r);
}

// Total cost at x: constraint cost + 1/2 (x - x0)' M (x - x0).
template <int NV>
__device__ float cost_of(const Env<NV>& e, int lane, const float* x) {
    float cs = 0.f;
    for_units(e, lane, [&](int u) {
            float g, h, c;
            e.scalar_row(u, e.jar_at(u, x), g, h, c);
            cs += c;
    }, [&](int k) {
            float jc[CDIM];
#pragma unroll
            for (int j = 0; j < CDIM; ++j) jc[j] = e.jar_at(e.crow(j, k), x);
            Cone z;
            z.eval(e, k, jc);
            cs += z.cost(jc);
    });
    float Mdx[NV];
    const float q = quad_form(e, lane, x, Mdx);
    return wsum(cs) + 0.5f * q;
}

// Directional derivative along djar at step alpha (each lane its own rows).
template <int NV>
__device__ float d1_of(const Env<NV>& e, int lane, float alpha, float c1, float c2) {
    float d1 = 0.f;
    for_units(e, lane, [&](int u) {
            const float dj = e.at(e.L.djar, u);
            float g, h, c;
            e.scalar_row(u, e.at(e.L.jar, u) + alpha * dj, g, h, c);
            d1 += g * dj;
    }, [&](int k) {
            float jc[CDIM], dj[CDIM], gc[CDIM];
#pragma unroll
            for (int j = 0; j < CDIM; ++j) {
                const int r = e.crow(j, k);
                dj[j] = e.at(e.L.djar, r);
                jc[j] = e.at(e.L.jar, r) + alpha * dj[j];
            }
            Cone z;
            z.eval(e, k, jc);
            z.grad(jc, gc);
            float s = 0.f;
#pragma unroll
            for (int j = 0; j < CDIM; ++j) s += gc[j] * dj[j];
            d1 += s;
    });
    return (c1 + alpha * c2) + wsum(d1);
}

__device__ float falsi(float lo, float hi, float dlo, float dhi) {
    const float denom = dhi - dlo;
    return fabsf(denom) > MINVAL ? lo - dlo * (hi - lo) / denom : 0.5f * (lo + hi);
}

// The step along djar: bracket the root of the directional derivative
// (bracket_len doublings of hi), then ls_len regula falsi steps.
template <int NV>
__device__ float line_search(const Env<NV>& e, int lane, float c1, float c2,
                             int bracket_len, int ls_len) {
    float hi = 1.f;
    bool ok = false;
    for (int i = 0; i < bracket_len; ++i) {
        const bool ok2 = d1_of(e, lane, hi, c1, c2) > 0.f;
        if (!(ok || ok2)) hi *= 2.f;
        ok = ok || ok2;
    }
    float dhi = d1_of(e, lane, hi, c1, c2);
    float lo = 0.f;
    float dlo = d1_of(e, lane, 0.f, c1, c2);
    const float dlo0 = dlo;
    for (int i = 0; i < ls_len; ++i) {
        const float a = fminf(fmaxf(falsi(lo, hi, dlo, dhi), lo + 1e-14f), hi - 1e-14f);
        const float da = d1_of(e, lane, a, c1, c2);
        if (da < 0.f) {
            lo = a;
            dlo = da;
            dhi = 0.5f * dhi;
        } else {
            dlo = 0.5f * dlo;
            hi = a;
            dhi = da;
        }
    }
    return dlo0 >= 0.f ? 0.f : falsi(lo, hi, dlo, dhi);
}

// Row pass at x: writes jar, the Hessian weights and the contact records
// of this lane's rows; hands each scalar row's gradient weight to
// scalar(u, g) and each contact outside the bottom zone (which has no
// force) to contact(k, z, jc); returns this lane's constraint cost.
template <int NV, class S, class C>
__device__ float row_pass(const Env<NV>& e, int lane, const float* x, S scalar, C contact) {
    float* s = e.s;
    const Layout<NV>& L = e.L;
    float cl = 0.f;
    for_units(e, lane, [&](int u) {
            const float jr = e.jar_at(u, x);
            s[L.jar + u] = jr;
            float g, h, c;
            e.scalar_row(u, jr, g, h, c);
            cl += c;
            s[L.hw + u] = h;
            scalar(u, g);
    }, [&](int k) {
            float jc[CDIM];
#pragma unroll
            for (int j = 0; j < CDIM; ++j) {
                jc[j] = e.jar_at(e.crow(j, k), x);
                s[L.jar + e.crow(j, k)] = jc[j];
            }
            Cone z;
            z.eval(e, k, jc);
            cl += z.cost(jc);
#pragma unroll
            for (int j = 0; j < CDIM; ++j) s[L.hw + e.crow(j, k)] = z.top ? z.Dc[j] : 0.f;
            float* rec = s + L.cz + CZ * k;
            rec[0] = z.middle ? 1.f : 0.f;
            rec[1] = z.kz;
            rec[2] = z.middle ? z.kz * z.w * z.mu / z.T : 0.f;
#pragma unroll
            for (int t = 0; t < CDIM - 1; ++t) rec[3 + t] = z.uhat[t];
            if (z.top || z.middle) contact(k, z, jc);
    });
    return cl;
}

// Row pass at x (row_pass); returns the constraint cost and J'g (gcon),
// both summed over the warp.
template <int NV>
__device__ float assemble_rows(const Env<NV>& e, int lane, const float* x, float* gcon) {
#pragma unroll
    for (int v = 0; v < NV; ++v) gcon[v] = 0.f;
    const float cl = row_pass(e, lane, x, [&](int u, float g) {
            if (g != 0.f) {
#pragma unroll
                for (int v = 0; v < NV; ++v) gcon[v] += e.Jv(v, u) * g;
            }
    }, [&](int k, const Cone& z, const float* jc) {
            float gc[CDIM];
            z.grad(jc, gc);
#pragma unroll
            for (int v = 0; v < NV; ++v) {
                float t = 0.f;
#pragma unroll
                for (int j = 0; j < CDIM; ++j) t += e.Jv(v, e.crow(j, k)) * gc[j];
                gcon[v] += t;
            }
    });
#pragma unroll
    for (int v = 0; v < NV; ++v) gcon[v] = wsum(gcon[v]);
    return wsum(cl);
}

// The entries of the NTRI-entry lower triangle that a lane owns: t = lane
// + m * 32 for m < SLOTS, each kept as (i << 4) | l, or -1 where t >= NTRI.
// SLOTS = ceil(NTRI / 32): 3 at nv = 12 (78 entries), 4 at nv = 15 (120),
// 5 at nv = 16 (136).
template <int NV>
struct Owned {
    static_assert(NV <= 16, "Owned packs a row and a column index into 4 bits each");
    static constexpr int NTRI = ntri(NV);
    static constexpr int SLOTS = (NTRI + WARP - 1) / WARP;
    int il[SLOTS];

    __device__ explicit Owned(int lane) {
#pragma unroll
        for (int m = 0; m < SLOTS; ++m) {
            const int t = lane + m * WARP;
            int r = 0;
            while (t < NTRI && tri(r + 1, 0) <= t) ++r;
            il[m] = t < NTRI ? (r << 4) | (t - tri(r, 0)) : -1;
        }
    }
    __device__ bool ok(int m) const { return il[m] >= 0; }
    __device__ int i(int m) const { return ok(m) ? il[m] >> 4 : 0; }
    __device__ int l(int m) const { return ok(m) ? il[m] & 15 : 0; }
};

// This lane's entries of A = M + H (into a), from the weights of the row
// pass, and the diagonal of A into dg.  The warp first lists the rows of
// nonzero weight (inactive and bottom-zone rows drop out: about 35 of the
// 82 at the SO100 scene; weighted_rows, into rl, in ascending order, by
// ballot compaction), then one pass over that list serves all three
// entries.
template <int NV>
__device__ int weighted_rows(const Env<NV>& e, int lane) {
    float* s = e.s;
    const Layout<NV>& L = e.L;
    int* rows = reinterpret_cast<int*>(s + L.rl);
    int n = 0;
    for (int r0 = 0; r0 < L.NE; r0 += WARP) {
        const int r = r0 + lane;
        const bool nz = r < L.NE && s[L.hw + r] != 0.f;
        const unsigned bal = __ballot_sync(FULL, nz);
        if (nz) rows[n + __popc(bal & ((1u << lane) - 1u))] = r;
        n += __popc(bal);
    }
    __syncwarp();
    return n;
}

template <int NV>
__device__ void assemble_hessian(const Env<NV>& e, int lane, const Owned<NV>& own, float* a) {
    float* s = e.s;
    const Layout<NV>& L = e.L;
    const int* rows = reinterpret_cast<const int*>(s + L.rl);
    const int n = weighted_rows(e, lane);
#pragma unroll
    for (int m = 0; m < Owned<NV>::SLOTS; ++m) a[m] = 0.f;
    // diagonal weights: h of a scalar row, Dc of a top-zone contact row
#pragma unroll 2
    for (int q = 0; q < n; ++q) {
        const int r = rows[q];
        const float wr = s[L.hw + r];
#pragma unroll
        for (int m = 0; m < Owned<NV>::SLOTS; ++m) {
            const float wi = wr * e.Jv(own.i(m), r);
            a[m] += wi * e.Jv(own.l(m), r);
        }
    }
    // middle zone: kz a a' + wmu (SJt'SJt - proj proj')
    for (int k = 0; k < L.K; ++k) {
        const float* rec = s + L.cz + CZ * k;
        if (rec[0] == 0.f) continue;
        const float kz = rec[1], wmu = rec[2];
        const float mu = e.mu(k);
        float usj[CDIM];
#pragma unroll
        for (int j = 0; j < CDIM; ++j) usj[j] = e.uscale(j, k);
        const float gu[CDIM] = {-usj[0], mu * rec[3] * usj[1],
                                mu * rec[4] * usj[2], mu * rec[5] * usj[3]};
#pragma unroll
        for (int m = 0; m < Owned<NV>::SLOTS; ++m) {
            float Ji[CDIM], Jl[CDIM];
#pragma unroll
            for (int j = 0; j < CDIM; ++j) {
                Ji[j] = e.Jv(own.i(m), e.crow(j, k));
                Jl[j] = e.Jv(own.l(m), e.crow(j, k));
            }
            const float ai = gu[0] * Ji[0] + gu[1] * Ji[1] + gu[2] * Ji[2] + gu[3] * Ji[3];
            const float al = gu[0] * Jl[0] + gu[1] * Jl[1] + gu[2] * Jl[2] + gu[3] * Jl[3];
            float Si[CDIM - 1], Sl[CDIM - 1], pi = 0.f, pl = 0.f;
#pragma unroll
            for (int q = 0; q < CDIM - 1; ++q) {
                Si[q] = usj[q + 1] * Ji[q + 1];
                Sl[q] = usj[q + 1] * Jl[q + 1];
                pi += rec[3 + q] * Si[q];
                pl += rec[3 + q] * Sl[q];
            }
            const float ss = Si[0] * Sl[0] + Si[1] * Sl[1] + Si[2] * Sl[2];
            a[m] += kz * ai * al + wmu * (ss - pi * pl);
        }
    }
#pragma unroll
    for (int m = 0; m < Owned<NV>::SLOTS; ++m) {
        a[m] = e.M(own.i(m), own.l(m)) + a[m];
        if (own.ok(m) && own.i(m) == own.l(m)) s[L.dg + own.i(m)] = a[m];
    }
}

// Cholesky of A, right-looking, on the entries each lane holds in a: per
// column j the owner of (j, j) takes the pivot and broadcasts it, the
// owners of column j scale and publish it to shared memory (where it is
// final: the factor L is left in A), and every lane updates its entries
// right of column j by A[i][l] -= L[i][j] L[l][j].  Each entry sees the
// same products subtracted in the same order as in a serial left-looking
// Cholesky, so the factor has the same bits.
template <int NV>
__device__ void cholesky(const Env<NV>& e, int lane, const Owned<NV>& own, float* a, float tiny) {
    float* A = e.s + e.L.A;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
        const int owner = tri(j, j) % WARP, slot = tri(j, j) / WARP;
        float d = 0.f;
        if (lane == owner) d = sqrtf(fmaxf(a[slot], tiny));
        d = __shfl_sync(FULL, d, owner);
        const float inv = 1.f / d;
#pragma unroll
        for (int m = 0; m < Owned<NV>::SLOTS; ++m) {
            if (own.ok(m) && own.l(m) == j) {
                a[m] = own.i(m) == j ? d : a[m] * inv;
                A[tri(own.i(m), j)] = a[m];
            }
        }
        __syncwarp();
#pragma unroll
        for (int m = 0; m < Owned<NV>::SLOTS; ++m) {
            if (own.ok(m) && own.l(m) > j)
                a[m] -= A[tri(own.i(m), j)] * A[tri(own.l(m), j)];
        }
    }
    __syncwarp();
}

template <int NV>
__device__ void solve_env(const Env<NV>& e, int lane, int max_iters, int ls_len,
                          int bracket_len, float tol)
{
    const Layout<NV>& L = e.L;
    const float scl = e.at(L.aux, 2 * L.nf + 2 * L.K);
    const float tiny = sqrtf(1.17549435e-38f);   // sqrt(FLT_MIN)

    // x, x_new and the direction live in shared memory (read broadcast by
    // every lane), which keeps the kernel inside 128 registers
    float* x = e.s + L.xs;
    float* x_new = e.s + L.xn;
    float* dirn = e.s + L.dn;
    // warmstart selection: keep the warmstart only where it costs less
    const bool warm = cost_of(e, lane, e.s + L.warm) < cost_of(e, lane, e.s + L.x0);
    if (lane < NV) x[lane] = e.at(warm ? L.warm : L.x0, lane);
    __syncwarp();

    int it = 0;
    for (; it < max_iters; ) {
        __syncwarp();     // the last iteration's reads of A are done
        // ---- jar, constraint cost, J'g, then the Hessian ----
        float gcon[NV];
        const float cost_con = assemble_rows(e, lane, x, gcon);
        __syncwarp();
        const Owned<NV> own(lane);
        float a[Owned<NV>::SLOTS];
        assemble_hessian(e, lane, own, a);

        // ---- cost, gradient, Newton direction ----
        float grad[NV];
        const float cost = cost_con + 0.5f * quad_form(e, lane, x, grad);
        float gg = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            grad[i] = grad[i] + gcon[i];       // M (x - x0) + J'g
            gg += grad[i] * grad[i];
        }

        cholesky(e, lane, own, a, tiny);
        float d[NV];
        chol_solve(e, lane, grad, d);
        float slope = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            d[i] = -d[i];
            slope += grad[i] * d[i];
        }
        if (!(slope < 0.f)) {      // descent guard: Jacobi-scaled steepest descent
#pragma unroll
            for (int i = 0; i < NV; ++i) d[i] = -grad[i] / fmaxf(e.at(L.dg, i), MINVAL);
        }
#pragma unroll
        for (int i = 0; i < NV; ++i)
            if (lane == i) dirn[i] = d[i];
        __syncwarp();

        // ---- exact line search on the directional derivative ----
        auto djar_row = [&](int r) {
            float s = 0.f;
#pragma unroll
            for (int v = 0; v < NV; ++v) s += e.Jv(v, r) * dirn[v];
            e.s[L.djar + r] = s;
        };
        for_units(e, lane, djar_row, [&](int k) {
            for (int j = 0; j < CDIM; ++j) djar_row(e.crow(j, k));
        });
        // c1 = dirn' M (x - x0), c2 = dirn' M dirn, both from M dirn
        float Md[NV];
        mat_vec(e, lane, dirn, Md);
        float c1 = 0.f, c2 = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            c1 += (x[i] - e.at(L.x0, i)) * Md[i];
            c2 += dirn[i] * Md[i];
        }
        const float alpha = line_search(e, lane, c1, c2, bracket_len, ls_len);

        // ---- accept, count, stop test (uniform across the warp) ----
#pragma unroll
        for (int i = 0; i < NV; ++i)
            if (lane == i) x_new[i] = x[i] + alpha * dirn[i];
        __syncwarp();
        const float cost_new = cost_of(e, lane, x_new);
        const bool done = (cost - cost_new) * scl < tol || sqrtf(gg) * scl < tol;
        if (cost_new < cost && lane < NV) x[lane] = x_new[lane];
        __syncwarp();
        ++it;
        if (done) break;
    }

    // ---- constraint force at the solution ----
    float qfrc[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) qfrc[v] = 0.f;
    for_units(e, lane, [&](int u) {
            float g, h, c;
            e.scalar_row(u, e.jar_at(u, x), g, h, c);
#pragma unroll
            for (int v = 0; v < NV; ++v) qfrc[v] += e.Jv(v, u) * g;
    }, [&](int k) {
            float jc[CDIM], gc[CDIM];
#pragma unroll
            for (int j = 0; j < CDIM; ++j) jc[j] = e.jar_at(e.crow(j, k), x);
            Cone z;
            z.eval(e, k, jc);
            z.grad(jc, gc);
#pragma unroll
            for (int j = 0; j < CDIM; ++j) {
#pragma unroll
                for (int v = 0; v < NV; ++v) qfrc[v] += e.Jv(v, e.crow(j, k)) * gc[j];
            }
    });
#pragma unroll
    for (int v = 0; v < NV; ++v) qfrc[v] = wsum(qfrc[v]);
    if (lane == 0) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
            e.s[L.o + v] = x[v];
            e.s[L.o + NV + v] = -qfrc[v];
        }
        e.s[L.o + 2 * NV] = (float)it;
    }
}

struct Inputs {
    const float* __restrict__ J;
    const float* __restrict__ aref;
    const float* __restrict__ D;
    const float* __restrict__ aux;
    const float* __restrict__ us;
    const float* __restrict__ qM;
    const float* __restrict__ x0;
    const float* __restrict__ warm;
};

// Block-wide copy of `rows` (rows, B) rows into the E envs' shared
// blocks at `off`, as rows of E consecutive floats; source row r lands
// at (r / split) * pitch + r % split (J's padded dof rows).
__device__ void stage(float* smem, int E, int env_floats, int off, const float* __restrict__ src,
                      int rows, int split, int pitch, int b0, int B) {
    for (int q = threadIdx.x; q < rows * E; q += blockDim.x) {
        const int r = q / E, e = q - r * E;
        const int v = r / split, rr = r - v * split;
        smem[e * env_floats + off + v * pitch + rr] =
            b0 + e < B ? src[(size_t)r * B + b0 + e] : 0.f;
    }
}

// Block-wide fill of `n` floats at `off` of every env's block with f(i).
template <class F>
__device__ void fill(float* smem, int E, int env_floats, int off, int n, F f) {
    for (int q = threadIdx.x; q < n * E; q += blockDim.x) {
        const int i = q / E, e = q - i * E;
        smem[e * env_floats + off + i] = f(i);
    }
}

// Every input of the E envs of block b0 / E, nv dofs, into their regions.
template <int NV>
__device__ void stage_inputs(float* smem, int E, const Inputs& in, const Layout<NV>& L, int nv,
                             int b0, int B) {
    const int naux = 2 * L.nf + 2 * L.K + 1;
    const int tri_nv = ntri(nv);
    stage(smem, E, L.size, L.J, in.J, nv * L.NE, L.NE, L.NEp, b0, B);
    stage(smem, E, L.size, L.aref, in.aref, L.NE, L.NE, 0, b0, B);
    stage(smem, E, L.size, L.D, in.D, L.NE, L.NE, 0, b0, B);
    stage(smem, E, L.size, L.aux, in.aux, naux, naux, 0, b0, B);
    stage(smem, E, L.size, L.us, in.us, CDIM * L.K, CDIM * L.K, 0, b0, B);
    stage(smem, E, L.size, L.qM, in.qM, tri_nv, tri_nv, 0, b0, B);
    stage(smem, E, L.size, L.x0, in.x0, nv, nv, 0, b0, B);
    stage(smem, E, L.size, L.warm, in.warm, nv, nv, 0, b0, B);
}

// A problem of nv < NV dofs runs padded to NV: the padded dofs get J rows
// of 0, a qM block of the identity (diagonal 1, off-diagonal 0) and 0 in
// x0 and warm.  Their gradient, direction and factor rows are then 0 (the
// factor's diagonal 1), every sum over the real dofs is the unpadded one,
// and the output keeps the real dofs only.
template <int NV>
__global__ void __launch_bounds__(ENVS * WARP, warps_per_sm(NV) / ENVS) newton_solve_kernel(
    Inputs in, float* __restrict__ out, Layout<NV> L, int nv, int B,
    int max_iters, int ls_len, int bracket_len, float tol)
{
    extern __shared__ float smem[];
    const int b0 = blockIdx.x * ENVS;
    const int tri_nv = ntri(nv);
    stage_inputs(smem, ENVS, in, L, nv, b0, B);
    if (nv < NV) {
        const auto zero = [](int) { return 0.f; };
        fill(smem, ENVS, L.size, L.J + nv * L.NEp, (NV - nv) * L.NEp, zero);
        fill(smem, ENVS, L.size, L.qM + tri_nv, L.NTRI - tri_nv, [&](int i) {
            int r = nv;                        // the padded row of entry tri_nv + i
            while (tri(r + 1, 0) <= tri_nv + i) ++r;
            return tri_nv + i == tri(r, r) ? 1.f : 0.f;
        });
        fill(smem, ENVS, L.size, L.x0 + nv, NV - nv, zero);
        fill(smem, ENVS, L.size, L.warm + nv, NV - nv, zero);
    }
    __syncthreads();

    const int w = threadIdx.x / WARP;
    if (b0 + w < B) {
        Env<NV> e{smem + w * L.size, L};
        solve_env(e, threadIdx.x % WARP, max_iters, ls_len, bracket_len, tol);
    }
    __syncthreads();

    // output row r of (2 nv + 1): qacc, qfrc_constraint, niter of the real dofs
    for (int q = threadIdx.x; q < (2 * nv + 1) * ENVS; q += blockDim.x) {
        const int r = q / ENVS, e = q - r * ENVS;
        const int src = r < nv ? r : r < 2 * nv ? NV + r - nv : 2 * NV;
        if (b0 + e < B) out[(size_t)r * B + b0 + e] = smem[e * L.size + L.o + src];
    }
}

// ---- the wide kernel (nv read at run time): one env per block ----
// The same solve as solve_env, spread over the WW warps of a block.  The
// work parallelises across rows, units, dofs and triangle entries, never
// inside one sum: every sum keeps the order in which the single-warp
// kernel took it (a row's jar over v = 0..nv-1; each of the 32 "lanes'"
// partial sums over its units in for_units' partition, then the 5-step
// butterfly; each Hessian entry over the weighted rows in list order,
// then the middle-zone contacts in k order; each Cholesky entry's updates
// in column order), so an nv the instantiations also take gives their
// bits.  Steps that need every row, unit or entry of the step before are
// separated by a block barrier.  The short ordered reductions run on one
// warp where one warp decides (the cost, gg and the stop test, the slope,
// the regula falsi steps; warp 0, which hands on what the others need
// through shared memory) and alike in every warp where every warp needs
// the bits (the warmstart pick's costs, c1 and c2).

constexpr int WW = 4;                                  // warps per block (one env)
constexpr int WT = WW * WARP;                          // threads per block
constexpr int HT = 3;                                  // Hessian tile: HT x HT entries a thread
constexpr int JG = 3;                                  // dofs a warp sums at a time (J'g, force)
constexpr int TS = WT - WARP;                          // threads of the trailing Cholesky update
constexpr int LOADS = 16;                              // staging loads in flight per thread
// resident blocks per SM that __launch_bounds__ holds the registers to
// (96 a thread): 5 at nv = 36, NE = 170, where an env's region is 43,264 B
constexpr int WIDE_BLOCKS = 5;

// out[r] = (neg ? -neg[r] : 0) + sum_v J[v][r] y[v], in v order, for every
// row r; rows r and r + WT on one thread, two chains at a time.
__device__ void rows_dot(const Env<0>& e, const float* y, const float* neg, float* out) {
    const float* J = e.s + e.L.J;
    const int NE = e.L.NE, NEp = e.L.NEp, nv = e.L.nv;
    for (int r = threadIdx.x; r < NE; r += 2 * WT) {
        const int r2 = r + WT < NE ? r + WT : r;
        float a = neg ? -neg[r] : 0.f, b = neg ? -neg[r2] : 0.f;
#pragma unroll 4
        for (int v = 0; v < nv; ++v) {
            const float yv = y[v];
            a += J[v * NEp + r] * yv;
            b += J[v * NEp + r2] * yv;
        }
        out[r] = a;
        if (r2 != r) out[r2] = b;
    }
}

// out[i] = sum_j M[i][j] y[j] in j order (mat_vec's sum) for rows i = t,
// t + WT, ...: M's lower triangle along row i up to the diagonal, then
// down column i.
__device__ void mat_rows(const Env<0>& e, int t, const float* y, float* out) {
    const float* M = e.s + e.L.qM;
    const int nv = e.L.nv;
    for (int i = t; i < nv; i += WT) {
        const float* Mi = M + tri(i, 0);
        float mi = 0.f;
#pragma unroll 4
        for (int j = 0; j <= i; ++j) mi += Mi[j] * y[j];
        int q = tri(i + 1, i);                 // M[i][j] for j > i: qM[tri(j, i)]
#pragma unroll 4
        for (int j = i + 1; j < nv; q += ++j) mi += M[q] * y[j];
        out[i] = mi;
    }
}

// sum_i a[i] b[i], in i order
__device__ float dot_dofs(const float* a, const float* b, int n) {
    float q = 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) q += a[i] * b[i];
    return q;
}

enum UnitPass { U_COST, U_ROWS, U_FORCE };

// The units (contact u < K, else scalar row u - K) at the jar values at
// offset jar, one per thread: U_COST their costs into uv; U_ROWS also the
// row pass's Hessian weights, contact records and gradient weights (gr;
// a bottom-zone contact, which has no force, weight 0); U_FORCE the
// gradient weights of every unit only.
template <int MODE>
__device__ void unit_pass(const Env<0>& e, int jar, float* uv) {
    float* s = e.s;
    const Layout<0>& L = e.L;
    float* w = s + L.gr;
    for (int u = threadIdx.x; u < L.nu; u += WT) {
        if (u < L.K) {
            float jc[CDIM];
#pragma unroll
            for (int j = 0; j < CDIM; ++j) jc[j] = s[jar + e.crow(j, u)];
            Cone z;
            z.eval(e, u, jc);
            if (MODE != U_FORCE) uv[u] = z.cost(jc);
            if (MODE == U_ROWS) {
#pragma unroll
                for (int j = 0; j < CDIM; ++j) s[L.hw + e.crow(j, u)] = z.top ? z.Dc[j] : 0.f;
                float* rec = s + L.cz + CZ * u;
                rec[0] = z.middle ? 1.f : 0.f;
                rec[1] = z.kz;
                rec[2] = z.middle ? z.kz * z.w * z.mu / z.T : 0.f;
#pragma unroll
                for (int t = 0; t < CDIM - 1; ++t) rec[3 + t] = z.uhat[t];
            }
            if (MODE != U_COST) {
                float gc[CDIM];
                z.grad(jc, gc);
                const bool force = MODE == U_FORCE || z.top || z.middle;
#pragma unroll
                for (int j = 0; j < CDIM; ++j) w[e.crow(j, u)] = force ? gc[j] : 0.f;
            }
        } else {
            const int r = u - L.K;
            float g, h, c;
            e.scalar_row(r, s[jar + r], g, h, c);
            if (MODE != U_FORCE) uv[u] = c;
            if (MODE == U_ROWS) s[L.hw + r] = h;
            if (MODE != U_COST) w[r] = g;
        }
    }
}

// The units' costs in uv summed as cost_of sums them: each lane its units
// in for_units order, then the butterfly (the same bits in every thread).
__device__ float unit_sum(const Env<0>& e, int lane, const float* uv) {
    float acc = 0.f;
    for_units(e, lane, [&](int r) { acc += uv[e.L.K + r]; }, [&](int k) { acc += uv[k]; });
    return wsum(acc);
}

// sign * sum over the lanes of J[v] . w for every dof v into out[v *
// stride], from the per-row weights w in gr: warp g % WW takes dofs JG g
// to JG g + JG - 1, each lane sums its units (for_units) for them, and the
// warp runs their butterflies together.  GROUPED adds a contact's 4 rows
// up first (J'g in the row pass), else one row at a time (the force at
// the solution).  A scalar row of weight 0 is skipped: adding a zero
// product to a sum that starts at +0 changes no bit.
template <bool GROUPED>
__device__ void jt_weights(const Env<0>& e, int warp, int lane, float sign, float* out,
                           size_t stride) {
    const float* w = e.s + e.L.gr;
    const int nv = e.L.nv;
    for (int v0 = warp * JG; v0 < nv; v0 += WW * JG) {
        int vs[JG];
        float acc[JG];
#pragma unroll
        for (int g = 0; g < JG; ++g) {
            vs[g] = v0 + g < nv ? v0 + g : nv - 1;
            acc[g] = 0.f;
        }
        for_units(e, lane, [&](int u) {
                const float wu = w[u];
                if (wu != 0.f) {
#pragma unroll
                    for (int g = 0; g < JG; ++g) acc[g] += e.Jv(vs[g], u) * wu;
                }
        }, [&](int k) {
                int rk[CDIM];
                float wk[CDIM];
#pragma unroll
                for (int j = 0; j < CDIM; ++j) {
                    rk[j] = e.crow(j, k);
                    wk[j] = w[rk[j]];
                }
#pragma unroll
                for (int g = 0; g < JG; ++g) {
                    if (GROUPED) {
                        float t = 0.f;
#pragma unroll
                        for (int j = 0; j < CDIM; ++j) t += e.Jv(vs[g], rk[j]) * wk[j];
                        acc[g] += t;
                    } else {
#pragma unroll
                        for (int j = 0; j < CDIM; ++j) acc[g] += e.Jv(vs[g], rk[j]) * wk[j];
                    }
                }
        });
#pragma unroll
        for (int m = WARP / 2; m > 0; m >>= 1) {
#pragma unroll
            for (int g = 0; g < JG; ++g) acc[g] += __shfl_xor_sync(FULL, acc[g], m);
        }
        if (lane == 0) {
#pragma unroll
            for (int g = 0; g < JG; ++g)
                if (v0 + g < nv) out[(size_t)(v0 + g) * stride] = sign * acc[g];
        }
    }
}

// The rows of nonzero Hessian weight, ascending, into rl (weighted_rows):
// every warp counts them by ballot, warp 0 writes the list.
__device__ int weighted_rows_w(const Env<0>& e, int warp, int lane) {
    const float* hw = e.s + e.L.hw;
    int* rows = reinterpret_cast<int*>(e.s + e.L.rl);
    int n = 0;
    for (int r0 = 0; r0 < e.L.NE; r0 += WARP) {
        const int r = r0 + lane;
        const bool nz = r < e.L.NE && hw[r] != 0.f;
        const unsigned bal = __ballot_sync(FULL, nz);
        if (warp == 0 && nz) rows[n + __popc(bal & ((1u << lane) - 1u))] = r;
        n += __popc(bal);
    }
    return n;
}

// A = M + H over the n listed rows, each entry summed as assemble_hessian
// sums it, the diagonal also into dg.  The triangle is cut into HT x HT
// tiles of entries (rows i and columns l in blocks of HT), one tile per
// thread, so that each J[i][r] and J[l][r] a thread loads serves HT
// entries.
__device__ void assemble_hessian_w(const Env<0>& e, int n) {
    float* s = e.s;
    const Layout<0>& L = e.L;
    const int nv = L.nv, nb = (nv + HT - 1) / HT;
    const int* rows = reinterpret_cast<const int*>(s + L.rl);
    for (int tile = threadIdx.x; tile < ntri(nb); tile += WT) {
        int bi = 0;
        while (tri(bi + 1, 0) <= tile) ++bi;
        const int bl = tile - tri(bi, 0);
        int ii[HT], ll[HT];                    // the tile's rows and columns, clamped
#pragma unroll
        for (int a = 0; a < HT; ++a) {
            ii[a] = bi * HT + a < nv ? bi * HT + a : nv - 1;
            ll[a] = bl * HT + a < nv ? bl * HT + a : nv - 1;
        }
        float acc[HT][HT];
#pragma unroll
        for (int a = 0; a < HT; ++a)
#pragma unroll
            for (int b = 0; b < HT; ++b) acc[a][b] = 0.f;
        // diagonal weights: h of a scalar row, Dc of a top-zone contact row
#pragma unroll 2
        for (int q = 0; q < n; ++q) {
            const int r = rows[q];
            const float wr = s[L.hw + r];
            float wi[HT], Jl[HT];
#pragma unroll
            for (int a = 0; a < HT; ++a) {
                wi[a] = wr * e.Jv(ii[a], r);
                Jl[a] = e.Jv(ll[a], r);
            }
#pragma unroll
            for (int a = 0; a < HT; ++a)
#pragma unroll
                for (int b = 0; b < HT; ++b) acc[a][b] += wi[a] * Jl[b];
        }
        // middle zone: kz a a' + wmu (SJt'SJt - proj proj')
        for (int k = 0; k < L.K; ++k) {
            const float* rec = s + L.cz + CZ * k;
            if (rec[0] == 0.f) continue;
            const float kz = rec[1], wmu = rec[2];
            const float mu = e.mu(k);
            float usj[CDIM];
#pragma unroll
            for (int j = 0; j < CDIM; ++j) usj[j] = e.uscale(j, k);
            const float gu[CDIM] = {-usj[0], mu * rec[3] * usj[1],
                                    mu * rec[4] * usj[2], mu * rec[5] * usj[3]};
            float ai[HT], al[HT], Si[HT][CDIM - 1], Sl[HT][CDIM - 1], pi[HT], pl[HT];
#pragma unroll
            for (int a = 0; a < HT; ++a) {
                float Ji[CDIM], Jl[CDIM];
#pragma unroll
                for (int j = 0; j < CDIM; ++j) {
                    Ji[j] = e.Jv(ii[a], e.crow(j, k));
                    Jl[j] = e.Jv(ll[a], e.crow(j, k));
                }
                ai[a] = gu[0] * Ji[0] + gu[1] * Ji[1] + gu[2] * Ji[2] + gu[3] * Ji[3];
                al[a] = gu[0] * Jl[0] + gu[1] * Jl[1] + gu[2] * Jl[2] + gu[3] * Jl[3];
                pi[a] = 0.f;
                pl[a] = 0.f;
#pragma unroll
                for (int q = 0; q < CDIM - 1; ++q) {
                    Si[a][q] = usj[q + 1] * Ji[q + 1];
                    Sl[a][q] = usj[q + 1] * Jl[q + 1];
                    pi[a] += rec[3 + q] * Si[a][q];
                    pl[a] += rec[3 + q] * Sl[a][q];
                }
            }
#pragma unroll
            for (int a = 0; a < HT; ++a)
#pragma unroll
                for (int b = 0; b < HT; ++b) {
                    const float ss = Si[a][0] * Sl[b][0] + Si[a][1] * Sl[b][1]
                                     + Si[a][2] * Sl[b][2];
                    acc[a][b] += kz * ai[a] * al[b] + wmu * (ss - pi[a] * pl[b]);
                }
        }
#pragma unroll
        for (int a = 0; a < HT; ++a)
#pragma unroll
            for (int b = 0; b < HT; ++b) {
                const int i = bi * HT + a, l = bl * HT + b;
                if (i < nv && l <= i) {
                    const float v = s[L.qM + tri(i, l)] + acc[a][b];
                    s[L.A + tri(i, l)] = v;
                    if (i == l) s[L.dg + i] = v;
                }
            }
    }
}

// Cholesky of A, right-looking as `cholesky`, with the forward solve L y =
// g folded in, one block barrier per column.  At step j (columns 0 to j
// final) warp 0 takes the pivot of column j + 1 (A[j+1][j+1] less
// L[j+1][j]^2, as its owner would), updates column j + 1 by column j and
// scales it, then takes the forward solve's step j (as chol_solve's
// forward pass: row i's residual in rr by lane (i - j) % 32); the other
// warps' threads subtract column j's products from the entries right of
// column j + 1, two entries at a time (entry t on thread WARP + t % TS,
// its row and column from the entry table tl).  Each entry sees the same
// products subtracted in the same order as in a serial left-looking
// Cholesky, so the factor has the same bits.  The pivots go to pv; A's
// diagonal keeps its value from before the last update.
__device__ void cholesky_w(const Env<0>& e, const float* g, float tiny) {
    float* s = e.s;
    const Layout<0>& L = e.L;
    float* A = s + L.A;
    const int* tl = reinterpret_cast<const int*>(s + L.tl);
    float* pv = s + L.pv;
    float* r = s + L.rr;
    float* y = s + L.yv;
    const int nv = L.nv, nt = ntri(nv), warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
    const int own = threadIdx.x - WARP;      // the trailing update's thread index
    if (warp == 0) {
        const float d = sqrtf(fmaxf(A[0], tiny));
        const float inv = 1.f / d;
        for (int i = lane; i < nv; i += WARP) {
            if (i > 0) A[tri(i, 0)] = A[tri(i, 0)] * inv;
            else pv[0] = d;
            r[i] = g[i];
        }
    }
    __syncthreads();
    for (int j = 0; j < nv; ++j) {
        if (warp == 0) {
            if (j + 1 < nv) {
                const float lj = A[tri(j + 1, j)];
                const float d = sqrtf(fmaxf(A[tri(j + 1, j + 1)] - lj * lj, tiny));
                const float inv = 1.f / d;
                for (int i = j + 2 + lane; i < nv; i += WARP) {
                    const int t = tri(i, j + 1);
                    A[t] = (A[t] - A[tri(i, j)] * lj) * inv;
                }
                if (lane == 0) pv[j + 1] = d;
            }
            const float yj = r[j] / pv[j];
            for (int i = j + lane; i < nv; i += WARP) {
                if (i == j) y[j] = yj;
                else r[i] -= A[tri(i, j)] * yj;
            }
        } else {
            const int t0 = tri(j + 2, 0);
            for (int t = t0 + ((own - t0) % TS + TS) % TS; t < nt; t += 2 * TS) {
                const int t2 = t + TS < nt ? t + TS : t;
                const int il = tl[t], i = il >> 16, l = il & 0xffff;
                const int il2 = tl[t2], i2 = il2 >> 16, l2 = il2 & 0xffff;
                const float a = A[t], p = A[tri(i, j)] * A[tri(l, j)];
                const float a2 = A[t2], p2 = A[tri(i2, j)] * A[tri(l2, j)];
                if (l > j + 1) A[t] = a - p;
                if (t2 != t && l2 > j + 1) A[t2] = a2 - p2;
            }
        }
        __syncthreads();
    }
}

// Staging: every input of env b (column b of its (rows, B) array) into
// its region, and the triangle's entry table.  The inputs' rows are one
// index space of N elements: J's row q = v NE + r lands at v NEp + r (its
// rows padded), the other inputs' rows one after another from aref on (the
// region holds them in the order of Inputs).  Each thread has LOADS
// independent loads in flight, across the inputs, before their stores:
// 4 rounds per thread at nv = 36 (7,463 floats).  (A TMA
// box's inner dimension is at least 16 B, and an env's column is 4 B wide
// in the lanes layout (rows, B) the kernel takes, so the copy is by
// thread; 4-byte cp.async copies timed 1% slower at nv = 36.)
__device__ void stage_env(float* smem, const Inputs& in, const Layout<0>& L, int b, int B) {
    const int nv = L.nv, NE = L.NE, nJ = nv * NE;
    const float* const src[7] = {in.aref, in.D, in.aux, in.us, in.qM, in.x0, in.warm};
    const int rows[7] = {NE, NE, 2 * L.nf + 2 * L.K + 1, CDIM * L.K, ntri(nv), nv, nv};
    int N = nJ;
#pragma unroll
    for (int k = 0; k < 7; ++k) N += rows[k];
    int q = threadIdx.x, v = q / NE, rr = q - v * NE;     // element q of J: dof v, row rr
    for (; q < N; q += LOADS * WT) {
        int di[LOADS];
        float val[LOADS];
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
            const int qu = q + u * WT;
            const float* from = nullptr;
            di[u] = -1;
            if (qu < nJ) {
                di[u] = v * L.NEp + rr;
                from = in.J + (size_t)qu * B;
            } else if (qu < N) {
                int o = qu - nJ;
                di[u] = L.aref + o;
                from = src[0];
#pragma unroll
                for (int k = 0; k < 6; ++k) {
                    if (o < rows[k]) break;
                    o -= rows[k];
                    from = src[k + 1];
                }
                from += (size_t)o * B;
            }
            rr += WT;
            while (rr >= NE) {
                rr -= NE;
                ++v;
            }
            val[u] = di[u] >= 0 ? from[b] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < LOADS; ++u)
            if (di[u] >= 0) smem[di[u]] = val[u];
    }
    int* tl = reinterpret_cast<int*>(smem + L.tl);
    for (int i = threadIdx.x / WARP; i < nv; i += WW)
        for (int l = threadIdx.x % WARP; l <= i; l += WARP) tl[tri(i, l)] = (i << 16) | l;
}

__device__ void swap_off(int& a, int& b) {
    const int t = a;
    a = b;
    b = t;
}

// The solve of the block's env; writes qacc, qfrc_constraint and niter of
// env b to out.
__device__ void solve_env_w(Env<0> e, float* __restrict__ out, int b, int B, int max_iters,
                            int ls_len, int bracket_len, float tol, Clock& ck) {
    float* s = e.s;
    Layout<0>& L = e.L;
    const int nv = L.nv, tid = threadIdx.x, warp = tid / WARP, lane = tid % WARP;
    const float scl = s[L.aux + 2 * L.nf + 2 * L.K];
    const float tiny = sqrtf(1.17549435e-38f);   // sqrt(FLT_MIN)

    // ---- warmstart pick: the warmstart where it costs less than x0 ----
    rows_dot(e, s + L.warm, s + L.aref, s + L.jar);
    rows_dot(e, s + L.x0, s + L.aref, s + L.jn);
    for (int v = tid; v < nv; v += WT) {
        s[L.dx + v] = s[L.warm + v] - s[L.x0 + v];
        s[L.dxn + v] = s[L.x0 + v] - s[L.x0 + v];
    }
    __syncthreads();
    unit_pass<U_COST>(e, L.jar, s + L.uv);
    unit_pass<U_COST>(e, L.jn, s + L.un);
    mat_rows(e, WT - 1 - tid, s + L.dx, s + L.mx);
    mat_rows(e, WT - 1 - tid, s + L.dxn, s + L.mxn);
    __syncthreads();
    const float qw = dot_dofs(s + L.dx, s + L.mx, nv);
    const float q0 = dot_dofs(s + L.dxn, s + L.mxn, nv);
    const bool warm = unit_sum(e, lane, s + L.uv) + 0.5f * qw
                      < unit_sum(e, lane, s + L.un) + 0.5f * q0;
    float qx = warm ? qw : q0;                 // (x - x0)' M (x - x0)
    if (!warm) {
        swap_off(L.jar, L.jn);
        swap_off(L.dx, L.dxn);
        swap_off(L.mx, L.mxn);
    }
    for (int v = tid; v < nv; v += WT) s[L.xs + v] = s[(warm ? L.warm : L.x0) + v];
    __syncthreads();                           // the costs' units are read
    ck.mark(PH_WARM);

    int it = 0;
    for (; it < max_iters; ) {
        // ---- the row pass at x (jar holds its jar), J'g, the Hessian ----
        unit_pass<U_ROWS>(e, L.jar, s + L.uv);
        __syncthreads();
        // the cost, gg and the decisions on them are warp 0's
        const float cost_con = warp == 0 ? unit_sum(e, lane, s + L.uv) : 0.f;
        const int n = weighted_rows_w(e, warp, lane);
        jt_weights<true>(e, warp, lane, 1.f, s + L.gc, 1);
        __syncthreads();
        ck.mark(PH_ROWS);
        assemble_hessian_w(e, n);
        for (int v = tid; v < nv; v += WT) s[L.gd + v] = s[L.mx + v] + s[L.gc + v];
        __syncthreads();
        ck.mark(PH_HESS);

        // ---- cost, gradient, Newton direction ----
        const float* grad = s + L.gd;
        const float cost = cost_con + 0.5f * qx;
        const float gg = warp == 0 ? dot_dofs(grad, grad, nv) : 0.f;
        cholesky_w(e, grad, tiny);
        ck.mark(PH_CHOL);
        if (warp == 0) {
            // back substitution L' d = y, as chol_solve's backward pass:
            // row i's residual (in yv) kept by lane i % 32; every lane
            // divides for d[k] (one lane dividing and a shuffle, or the
            // residuals in registers, timed slower on the card)
            const float* A = s + L.A;
            float* y = s + L.yv;
            for (int k = nv - 1; k >= 0; --k) {
                const float dk = y[k] / s[L.pv + k];
                if (lane == 0) s[L.dd + k] = dk;
                for (int i = lane; i < k; i += WARP) y[i] -= A[tri(k, i)] * dk;
                __syncwarp();
            }
            float slope = 0.f;
            for (int i = 0; i < nv; ++i) slope += grad[i] * -s[L.dd + i];
            const bool descends = slope < 0.f;     // else Jacobi-scaled steepest descent
            for (int v = lane; v < nv; v += WARP)
                s[L.dn + v] = descends ? -s[L.dd + v] : -grad[v] / fmaxf(s[L.dg + v], MINVAL);
        }
        __syncthreads();
        ck.mark(PH_BACK);

        // ---- djar and M d, c1 = dn' M (x - x0), c2 = dn' M dn ----
        const float* dirn = s + L.dn;
        rows_dot(e, dirn, nullptr, s + L.djar);
        mat_rows(e, WT - 1 - tid, dirn, s + L.md);
        __syncthreads();
        float c1 = 0.f, c2 = 0.f;
#pragma unroll 4
        for (int i = 0; i < nv; ++i) {
            c1 += (s[L.xs + i] - s[L.x0 + i]) * s[L.md + i];
            c2 += dirn[i] * s[L.md + i];
        }
        ck.mark(PH_DIR);

        // ---- exact line search on the directional derivative ----
        // line_search's evaluations at 0 and at 1, 2, ..., 2^bracket_len
        // (every point its bracket can reach; the points it does not reach
        // are not read), one per warp per round, then its regula falsi
        // steps on warp 0, which writes x_new
        const int npts = bracket_len + 2;
        bool ok = false;
        int m = 0;                             // hi = 2^m
        float hi = 1.f, dhi = 0.f, dlo = 0.f;
        for (int p0 = 0, round = 0; p0 < npts; p0 += WW, ++round) {
            float* pts = s + L.ls + (round & 1) * WW;
            const int p = p0 + warp;
            if (p < npts) {
                float a = 0.f;
                if (p > 0) {
                    a = 1.f;
                    for (int i = 1; i < p; ++i) a *= 2.f;
                }
                const float d1 = d1_of(e, lane, a, c1, c2);
                if (lane == 0) pts[warp] = d1;
            }
            __syncthreads();
            for (int q = p0; warp == 0 && q < npts && q < p0 + WW; ++q) {
                const float d1 = pts[q - p0];
                if (q == 0) {
                    dlo = d1;
                } else if (q - 1 == m) {       // the point hi
                    dhi = d1;
                    if (m < bracket_len && !ok) {
                        if (d1 > 0.f) {
                            ok = true;
                        } else {
                            ++m;
                            hi *= 2.f;
                        }
                    }
                }
            }
        }
        if (warp == 0) {
            float lo = 0.f;
            const float dlo0 = dlo;
            for (int i = 0; i < ls_len; ++i) {
                const float a = fminf(fmaxf(falsi(lo, hi, dlo, dhi), lo + 1e-14f), hi - 1e-14f);
                const float da = d1_of(e, lane, a, c1, c2);
                if (da < 0.f) {
                    lo = a;
                    dlo = da;
                    dhi = 0.5f * dhi;
                } else {
                    dlo = 0.5f * dlo;
                    hi = a;
                    dhi = da;
                }
            }
            const float alpha = dlo0 >= 0.f ? 0.f : falsi(lo, hi, dlo, dhi);
            for (int v = lane; v < nv; v += WARP) s[L.xn + v] = s[L.xs + v] + alpha * dirn[v];
        }
        __syncthreads();
        ck.mark(PH_LS);

        // ---- the cost at x_new; accept, count, stop test ----
        rows_dot(e, s + L.xn, s + L.aref, s + L.jn);
        for (int v = tid; v < nv; v += WT) s[L.dxn + v] = s[L.xn + v] - s[L.x0 + v];
        __syncthreads();                       // jar and x - x0 at x_new are in jn, dxn
        unit_pass<U_COST>(e, L.jn, s + L.un);
        mat_rows(e, WT - 1 - tid, s + L.dxn, s + L.mxn);
        __syncthreads();                       // the units' costs at x_new are in un
        int* flag = reinterpret_cast<int*>(s + L.ls + 2 * 32);
        if (warp == 0) {
            const float qn = dot_dofs(s + L.dxn, s + L.mxn, nv);
            const float cost_new = unit_sum(e, lane, s + L.un) + 0.5f * qn;
            const bool done = (cost - cost_new) * scl < tol || sqrtf(gg) * scl < tol;
            const bool take = cost_new < cost;
            if (take) qx = qn;
            if (lane == 0) *flag = (int)done | (int)take << 1;
        }
        __syncthreads();
        const int f = *flag;
        if (f & 2) {                           // accepted: x_new is the iterate
            swap_off(L.xs, L.xn);
            swap_off(L.jar, L.jn);
            swap_off(L.dx, L.dxn);
            swap_off(L.mx, L.mxn);
        }
        ck.mark(PH_ACCEPT);
        ++it;
        if (f & 1) break;
    }

    // ---- constraint force at the solution, and the output ----
    unit_pass<U_FORCE>(e, L.jar, nullptr);
    __syncthreads();
    jt_weights<false>(e, warp, lane, -1.f, out + (size_t)nv * B + b, B);
    for (int v = tid; v < nv; v += WT) out[(size_t)v * B + b] = s[L.xs + v];
    if (tid == 0) out[(size_t)2 * nv * B + b] = (float)it;
    ck.mark(PH_FORCE);
}

// The wide kernel: any nv, one env per block of WT threads.
__global__ void __launch_bounds__(WT, WIDE_BLOCKS) newton_solve_wide(
    Inputs in, float* __restrict__ out, Layout<0> L, int B,
    int max_iters, int ls_len, int bracket_len, float tol)
{
    extern __shared__ float smem[];
    Clock ck;
    stage_env(smem, in, L, blockIdx.x, B);
    __syncthreads();
    ck.mark(PH_STAGE);
    solve_env_w(Env<0>{smem, L}, out, blockIdx.x, B, max_iters, ls_len, bracket_len, tol, ck);
    if (threadIdx.x == 0) ck.write(blockIdx.x, B);
}

// The instantiations, ascending; a problem of nv up to the largest runs on
// the first whose NV is at least its nv where that one's 4-env block fits
// (on_instantiation), any other on the wide kernel.
// The build may name its own (-DNEWTON_NVS=..., empty for none).
#ifndef NEWTON_NVS
#define NEWTON_NVS 12, 15, 16
#endif

// f(std::integral_constant<int, NV>) for the first instantiation whose NV
// is at least nv; cudaErrorInvalidValue, f not called, where there is none.
template <int... Ns, class F>
int with_nv(int nv, F f) {
    int err = (int)cudaErrorInvalidValue;
    bool found = false;
    ((!found && nv >= 1 && nv <= Ns ? (found = true, err = f(std::integral_constant<int, Ns>{}))
                                    : 0), ...);
    return err;
}

// Whether the wide kernel's one-env region fits one block's shared memory.
bool wide_fits(int nv, int NE, int neq, int nf, int nl, int K) {
    return (size_t)Layout<0>(nv, NE, neq, nf, nl, K).size * sizeof(float) <= SMEM_LIMIT;
}

// Whether nv runs on an instantiation: nv up to the largest, where that
// instantiation's 4-env block fits one block's shared memory (at nv = 16
// it stops fitting at about K = 140 contacts); every other nv >= 1 runs on
// the wide kernel, one env per block.
bool on_instantiation(int nv, int NE, int neq, int nf, int nl, int K) {
    bool fits = false;
    with_nv<NEWTON_NVS>(nv, [&](auto n) {
        const Layout<decltype(n)::value> L(NE, neq, nf, nl, K);
        fits = (size_t)ENVS * L.size * sizeof(float) <= SMEM_LIMIT;
        return 0;
    });
    return fits;
}

}  // namespace

#ifdef NEWTON_CLOCK
// The buffer (NPHASE, B) int64 that the wide kernel's launches write their
// cycle counts to (null: none).
extern "C" int gst_newton_clock(void* buf)
{
    return (int)cudaMemcpyToSymbol(clock_out, &buf, sizeof(buf));
}
#endif

// Launch shape for these sizes: shape[0] envs per block, shape[1] threads,
// shape[2] bytes of dynamic shared memory; all 0 where nv < 1, or where the
// wide kernel's single env does not fit a block.
extern "C" void gst_newton_solve_shape(int nv, int NE, int neq, int nf, int nl, int K,
                                       int* shape)
{
    shape[0] = shape[1] = shape[2] = 0;
    if (nv < 1) return;
    if (!on_instantiation(nv, NE, neq, nf, nl, K)) {
        if (!wide_fits(nv, NE, neq, nf, nl, K)) return;
        shape[0] = 1;
        shape[1] = WT;
        shape[2] = Layout<0>(nv, NE, neq, nf, nl, K).size * (int)sizeof(float);
        return;
    }
    with_nv<NEWTON_NVS>(nv, [&](auto n) {
        const Layout<decltype(n)::value> L(NE, neq, nf, nl, K);
        shape[0] = ENVS;
        shape[1] = ENVS * WARP;
        shape[2] = ENVS * L.size * (int)sizeof(float);
        return 0;
    });
}

// Returns cudaErrorInvalidValue for nv < 1, and for an nv and NE whose
// single env's region exceeds one block's shared memory (wide kernel).
// The dispatch is gst_newton_solve_shape's.
extern "C" int gst_newton_solve(
    const float* J, const float* aref, const float* D, const float* aux,
    const float* us, const float* qM, const float* x0, const float* warm, float* out,
    int nv, int NE, int neq, int nf, int nl, int K, int B,
    int max_iters, int ls_len, int bracket_len, float tol, void* stream)
{
    const Inputs in{J, aref, D, aux, us, qM, x0, warm};
    const cudaStream_t st = (cudaStream_t)stream;
    if (nv < 1) return (int)cudaErrorInvalidValue;
    if (!on_instantiation(nv, NE, neq, nf, nl, K)) {
        if (!wide_fits(nv, NE, neq, nf, nl, K)) return (int)cudaErrorInvalidValue;
        if (B == 0) return 0;
        const Layout<0> L(nv, NE, neq, nf, nl, K);
        const size_t smem = (size_t)L.size * sizeof(float);
        if (smem > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(
                newton_solve_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return (int)err;
        }
        newton_solve_wide<<<B, WT, smem, st>>>(in, out, L, B, max_iters, ls_len, bracket_len, tol);
        return (int)cudaGetLastError();
    }
    return with_nv<NEWTON_NVS>(nv, [&](auto n) {
        constexpr int NV = decltype(n)::value;
        if (B == 0) return 0;
        const Layout<NV> L(NE, neq, nf, nl, K);
        const size_t smem = (size_t)ENVS * L.size * sizeof(float);
        if (smem > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(
                newton_solve_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return (int)err;
        }
        newton_solve_kernel<NV><<<(B + ENVS - 1) / ENVS, ENVS * WARP, smem, st>>>(
            in, out, L, nv, B, max_iters, ls_len, bracket_len, tol);
        return (int)cudaGetLastError();
    });
}
