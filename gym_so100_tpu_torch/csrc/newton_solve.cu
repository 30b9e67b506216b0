// Whole Newton constraint solve, one warp per env.
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
// - nv is a template parameter (NV <= 16: a triangle entry's row and
//   column are packed into 4 bits each), since the per-lane arrays (J'g,
//   the gradient, the direction, the force) and the entries a lane owns
//   are sized by it and must stay in registers.  Three instantiations are
//   built, 12 (the SO100 scenes), 15 (the Panda) and 16; a problem of
//   another nv runs on the next larger one, padded (see the kernel).  The
//   nvcc build of both kernels took 20.0 s with these three against 8.1 s
//   with nv = 12 alone and 52.1 s with all 16 (PERF.md).
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
constexpr int ENVS = 4;            // envs (one warp each) per block
constexpr int CZ = 6;              // contact record: middle?, kz, wmu, uhat[3]
constexpr float MINVAL = 1e-15f;
constexpr unsigned FULL = 0xffffffffu;

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

// Row pass at x: writes jar and the Hessian weights of this lane's rows,
// returns the constraint cost and J'g (gcon), both summed over the warp.
template <int NV>
__device__ float assemble_rows(const Env<NV>& e, int lane, const float* x, float* gcon) {
    float* s = e.s;
    const Layout<NV>& L = e.L;
    float cl = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) gcon[v] = 0.f;
    for_units(e, lane, [&](int u) {
            const float jr = e.jar_at(u, x);
            s[L.jar + u] = jr;
            float g, h, c;
            e.scalar_row(u, jr, g, h, c);
            cl += c;
            s[L.hw + u] = h;
            if (g != 0.f) {
#pragma unroll
                for (int v = 0; v < NV; ++v) gcon[v] += e.Jv(v, u) * g;
            }
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
            if (!(z.top || z.middle)) return;        // bottom zone: no force
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
// 82 at the SO100 scene), then one pass over that list serves all three
// entries.
template <int NV>
__device__ void assemble_hessian(const Env<NV>& e, int lane, const Owned<NV>& own, float* a) {
    float* s = e.s;
    const Layout<NV>& L = e.L;
    // the rows of nonzero weight, in ascending order (ballot compaction)
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
        const float alpha = dlo0 >= 0.f ? 0.f : falsi(lo, hi, dlo, dhi);

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

// Block-wide copy of `rows` (rows, B) rows into the ENVS envs' shared
// blocks at `off`, as rows of ENVS consecutive floats; source row r lands
// at (r / split) * pitch + r % split (J's padded dof rows).
__device__ void stage(float* smem, int env_floats, int off, const float* __restrict__ src,
                      int rows, int split, int pitch, int b0, int B) {
    for (int q = threadIdx.x; q < rows * ENVS; q += blockDim.x) {
        const int r = q / ENVS, e = q - r * ENVS;
        const int v = r / split, rr = r - v * split;
        smem[e * env_floats + off + v * pitch + rr] =
            b0 + e < B ? src[(size_t)r * B + b0 + e] : 0.f;
    }
}

// Block-wide fill of `n` floats at `off` of every env's block with f(i).
template <class F>
__device__ void fill(float* smem, int env_floats, int off, int n, F f) {
    for (int q = threadIdx.x; q < n * ENVS; q += blockDim.x) {
        const int i = q / ENVS, e = q - i * ENVS;
        smem[e * env_floats + off + i] = f(i);
    }
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
    const int naux = 2 * L.nf + 2 * L.K + 1;
    const int tri_nv = ntri(nv);
    stage(smem, L.size, L.J, in.J, nv * L.NE, L.NE, L.NEp, b0, B);
    stage(smem, L.size, L.aref, in.aref, L.NE, L.NE, 0, b0, B);
    stage(smem, L.size, L.D, in.D, L.NE, L.NE, 0, b0, B);
    stage(smem, L.size, L.aux, in.aux, naux, naux, 0, b0, B);
    stage(smem, L.size, L.us, in.us, CDIM * L.K, CDIM * L.K, 0, b0, B);
    stage(smem, L.size, L.qM, in.qM, tri_nv, tri_nv, 0, b0, B);
    stage(smem, L.size, L.x0, in.x0, nv, nv, 0, b0, B);
    stage(smem, L.size, L.warm, in.warm, nv, nv, 0, b0, B);
    if (nv < NV) {
        const auto zero = [](int) { return 0.f; };
        fill(smem, L.size, L.J + nv * L.NEp, (NV - nv) * L.NEp, zero);
        fill(smem, L.size, L.qM + tri_nv, L.NTRI - tri_nv, [&](int i) {
            int r = nv;                        // the padded row of entry tri_nv + i
            while (tri(r + 1, 0) <= tri_nv + i) ++r;
            return tri_nv + i == tri(r, r) ? 1.f : 0.f;
        });
        fill(smem, L.size, L.x0 + nv, NV - nv, zero);
        fill(smem, L.size, L.warm + nv, NV - nv, zero);
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

// The instantiations, ascending; a problem runs on the first whose NV is
// at least its nv.  The build may name its own (-DNEWTON_NVS=...).
#ifndef NEWTON_NVS
#define NEWTON_NVS 12, 15, 16
#endif

// f(std::integral_constant<int, NV>) for the instantiation that runs nv;
// cudaErrorInvalidValue where none does (nv above the largest, or < 1).
template <int... Ns, class F>
int with_nv(int nv, F f) {
    int err = (int)cudaErrorInvalidValue;
    bool found = false;
    ((!found && nv >= 1 && nv <= Ns ? (found = true, err = f(std::integral_constant<int, Ns>{}))
                                    : 0), ...);
    return err;
}

}  // namespace

// Launch shape for these sizes: shape[0] envs per block, shape[1] threads,
// shape[2] bytes of dynamic shared memory; all 0 where no instantiation
// runs nv.
extern "C" void gst_newton_solve_shape(int nv, int NE, int neq, int nf, int nl, int K,
                                       int* shape)
{
    shape[0] = shape[1] = shape[2] = 0;
    with_nv<NEWTON_NVS>(nv, [&](auto n) {
        const Layout<decltype(n)::value> L(NE, neq, nf, nl, K);
        shape[0] = ENVS;
        shape[1] = ENVS * WARP;
        shape[2] = ENVS * L.size * (int)sizeof(float);
        return 0;
    });
}

extern "C" int gst_newton_solve(
    const float* J, const float* aref, const float* D, const float* aux,
    const float* us, const float* qM, const float* x0, const float* warm, float* out,
    int nv, int NE, int neq, int nf, int nl, int K, int B,
    int max_iters, int ls_len, int bracket_len, float tol, void* stream)
{
    return with_nv<NEWTON_NVS>(nv, [&](auto n) {
        constexpr int NV = decltype(n)::value;
        if (B == 0) return 0;
        const Layout<NV> L(NE, neq, nf, nl, K);
        const Inputs in{J, aref, D, aux, us, qM, x0, warm};
        const size_t smem = (size_t)ENVS * L.size * sizeof(float);
        if (smem > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(
                newton_solve_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return (int)err;
        }
        newton_solve_kernel<NV><<<(B + ENVS - 1) / ENVS, ENVS * WARP, smem,
                                  (cudaStream_t)stream>>>(
            in, out, L, nv, B, max_iters, ls_len, bracket_len, tol);
        return (int)cudaGetLastError();
    });
}
