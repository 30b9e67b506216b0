// Whole Newton constraint solve, one CUDA thread per env.
//
// Replaces the Pallas kernel gym_so100_tpu/ops/solver_lanes.py::
// _solve_fused_pallas.  Per env it minimizes the constraint cost over
// equality (quadratic), friction-loss (Huber), limit (one-sided) and
// elliptic-cone contact rows (top/middle/bottom zones) plus
// 1/2 (x - x0)' M (x - x0): warmstart-vs-x0 pick by total cost; then up to
// max_iters Newton iterations, each assembling cost, gradient and Hessian,
// factoring the 12x12 Hessian (Cholesky, steepest-descent guard when the
// direction does not descend), bracketing (bracket_len doublings) and
// regula falsi (ls_len steps) on the directional derivative, and stopping a
// lane once improvement or gradient norm (scaled) falls below tol.  Frozen
// lanes keep x and their iteration count, as in the masked scan.
//
// What bounds it on an H100: latency, not bytes or flops.  The inputs are
// ~4.4 KB per env at K=16 (J alone is 12 x 82 floats) and the arithmetic
// ~0.3 MFLOP per env, but every step of a Newton iteration depends on the
// one before.  The design gives each env one thread, reads every (rows, B)
// input batch-minor so a warp's loads are coalesced, keeps x, the gradient
// and the Hessian triangle in registers (spilling to local memory), and
// holds jar and djar in (NE, B) scratch that the wrapper allocates.  The
// Hessian is one pass over the rows (rows with zero weight skipped), and
// the 13 line-search evaluations read only jar and djar.  At B = 4096 that
// is 4096 threads in 128 one-warp blocks: one warp per SM, so it runs on
// latency; splitting an env over a warp is the next step.
//
// Input layout (as the Pallas kernel took it): J (NV*NE, B) row v*NE + r;
// aref, D (NE, B); contact rows COMPONENT-major (row ns + j*K + k); aux rows
// [floss (nf) | R_f (nf) | mu (K) | Dn (K) | scale]; us (CDIM*K, B);
// qM lower triangle (NTRI, B) row by row; x0, warm (NV, B).  Output
// (2*NV + 1, B): qacc, qfrc_constraint, niter.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NV = 12;
constexpr int NTRI = NV * (NV + 1) / 2;
constexpr int CDIM = 4;
constexpr float MINVAL = 1e-15f;

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

struct Env {
    const float* __restrict__ J;
    const float* __restrict__ aref;
    const float* __restrict__ D;
    const float* __restrict__ aux;
    const float* __restrict__ us;
    const float* __restrict__ qM;
    float* __restrict__ jar;
    float* __restrict__ djar;
    int NE, neq, nf, nl, ns, K;
    size_t B;
    int b;

    __device__ float at(const float* p, int r) const { return p[r * B + b]; }
    __device__ float Jv(int v, int r) const { return J[((size_t)v * NE + r) * B + b]; }
    __device__ float M(int i, int j) const {
        return qM[(size_t)(i >= j ? tri(i, j) : tri(j, i)) * B + b];
    }
    __device__ float mu(int k) const { return at(aux, 2 * nf + k); }
    __device__ float Dn(int k) const { return at(aux, 2 * nf + K + k); }
    __device__ float uscale(int j, int k) const { return at(us, j * K + k); }
    __device__ int crow(int j, int k) const { return ns + j * K + k; }

    // jar of row r at x: -aref + sum_v J[v][r] x[v]
    __device__ float jar_at(int r, const float* x) const {
        float acc = -at(aref, r);
#pragma unroll
        for (int v = 0; v < NV; ++v) acc += Jv(v, r) * x[v];
        return acc;
    }

    // gradient g, Hessian weight h and cost c of scalar row r at jar value jr
    __device__ void scalar_row(int r, float jr, float& g, float& h, float& c) const {
        const float Dr = at(D, r);
        bool quad = true;
        if (r >= neq && r < neq + nf) {
            const int i = r - neq;
            const float fl = at(aux, i);
            const float lim = fl * at(aux, nf + i);
            if (fabsf(jr) > lim) {
                quad = false;
                g = fl * (float)((jr > 0.f) - (jr < 0.f));
                h = 0.f;
                c = fl * fabsf(jr) - 0.5f * fl * lim;
            }
        } else if (r >= neq + nf && !(jr < 0.f)) {
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

    __device__ void eval(const Env& e, int k, const float* jc) {
        mu = e.mu(k);
        const float Dn = e.Dn(k);
#pragma unroll
        for (int j = 0; j < CDIM; ++j) {
            usj[j] = e.uscale(j, k);
            u[j] = jc[j] * usj[j];
            Dc[j] = e.at(e.D, e.crow(j, k));
        }
        const float un = u[0];
        const float Traw = sqrtf(u[1] * u[1] + u[2] * u[2] + u[3] * u[3]);
        T = fmaxf(Traw, 1e-30f);
        const bool bottom = mu * Traw <= un;
        const bool topraw = Traw <= -mu * un;
        top = topraw && Dn > 0.f;
        middle = !(bottom || topraw) && Dn > 0.f;
        w = mu * Traw - un;
        kz = Dn / (1.f + mu * mu);
#pragma unroll
        for (int t = 0; t < CDIM - 1; ++t) uhat[t] = u[t + 1] / T;
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

// Total cost at x: constraint cost + 1/2 (x - x0)' M (x - x0).
__device__ float cost_of(const Env& e, const float* x, const float* x0) {
    float cs = 0.f;
    for (int r = 0; r < e.ns; ++r) {
        float g, h, c;
        e.scalar_row(r, e.jar_at(r, x), g, h, c);
        cs += c;
    }
    for (int k = 0; k < e.K; ++k) {
        float jc[CDIM];
#pragma unroll
        for (int j = 0; j < CDIM; ++j) jc[j] = e.jar_at(e.crow(j, k), x);
        Cone z;
        z.eval(e, k, jc);
        cs += z.cost(jc);
    }
    float dx[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) dx[i] = x[i] - x0[i];
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
        float mi = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) mi += e.M(i, j) * dx[j];
        q += dx[i] * mi;
    }
    return cs + 0.5f * q;
}

// Directional derivative along djar at step alpha (reads the jar/djar scratch).
__device__ float d1_of(const Env& e, float alpha, float c1, float c2) {
    float d1 = c1 + alpha * c2;
    for (int r = 0; r < e.ns; ++r) {
        const float dj = e.at(e.djar, r);
        float g, h, c;
        e.scalar_row(r, e.at(e.jar, r) + alpha * dj, g, h, c);
        d1 += g * dj;
    }
    for (int k = 0; k < e.K; ++k) {
        float jc[CDIM], dj[CDIM], gc[CDIM];
#pragma unroll
        for (int j = 0; j < CDIM; ++j) {
            const int r = e.crow(j, k);
            dj[j] = e.at(e.djar, r);
            jc[j] = e.at(e.jar, r) + alpha * dj[j];
        }
        Cone z;
        z.eval(e, k, jc);
        z.grad(jc, gc);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < CDIM; ++j) s += gc[j] * dj[j];
        d1 += s;
    }
    return d1;
}

__device__ float falsi(float lo, float hi, float dlo, float dhi) {
    const float denom = dhi - dlo;
    return fabsf(denom) > MINVAL ? lo - dlo * (hi - lo) / denom : 0.5f * (lo + hi);
}

__global__ void newton_solve_kernel(
    Env e, const float* __restrict__ x0g, const float* __restrict__ warmg,
    float* __restrict__ out, int max_iters, int ls_len, int bracket_len, float tol)
{
    e.b = blockIdx.x * blockDim.x + threadIdx.x;
    if (e.b >= (int)e.B) return;
    const float scl = e.at(e.aux, 2 * e.nf + 2 * e.K);
    const float tiny = sqrtf(1.17549435e-38f);   // sqrt(FLT_MIN)

    float x0[NV], x[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
        x0[i] = e.at(x0g, i);
        x[i] = e.at(warmg, i);
    }
    // warmstart selection: keep the warmstart only where it costs less
    if (!(cost_of(e, x, x0) < cost_of(e, x0, x0))) {
#pragma unroll
        for (int i = 0; i < NV; ++i) x[i] = x0[i];
    }

    int it = 0;
    for (; it < max_iters; ) {
        // ---- jar, constraint cost, J'g and the Hessian in one row pass ----
        float H[NTRI], gcon[NV];
#pragma unroll
        for (int t = 0; t < NTRI; ++t) H[t] = 0.f;
#pragma unroll
        for (int v = 0; v < NV; ++v) gcon[v] = 0.f;
        float cost_con = 0.f;
        for (int r = 0; r < e.ns; ++r) {
            float Jr[NV];
            float jr = -e.at(e.aref, r);
#pragma unroll
            for (int v = 0; v < NV; ++v) {
                Jr[v] = e.Jv(v, r);
                jr += Jr[v] * x[v];
            }
            e.jar[r * e.B + e.b] = jr;
            float g, h, c;
            e.scalar_row(r, jr, g, h, c);
            cost_con += c;
            if (g != 0.f) {
#pragma unroll
                for (int v = 0; v < NV; ++v) gcon[v] += Jr[v] * g;
            }
            if (h != 0.f) {
#pragma unroll
                for (int i = 0; i < NV; ++i) {
                    const float wi = h * Jr[i];
#pragma unroll
                    for (int j = 0; j <= i; ++j) H[tri(i, j)] += wi * Jr[j];
                }
            }
        }
        for (int k = 0; k < e.K; ++k) {
            float Jc[NV][CDIM], jc[CDIM];
#pragma unroll
            for (int j = 0; j < CDIM; ++j) {
                const int r = e.crow(j, k);
                float jr = -e.at(e.aref, r);
#pragma unroll
                for (int v = 0; v < NV; ++v) {
                    Jc[v][j] = e.Jv(v, r);
                    jr += Jc[v][j] * x[v];
                }
                jc[j] = jr;
                e.jar[r * e.B + e.b] = jr;
            }
            Cone z;
            z.eval(e, k, jc);
            cost_con += z.cost(jc);
            if (!(z.top || z.middle)) continue;        // bottom zone: no force
            float gc[CDIM];
            z.grad(jc, gc);
#pragma unroll
            for (int v = 0; v < NV; ++v) {
                float s = 0.f;
#pragma unroll
                for (int j = 0; j < CDIM; ++j) s += Jc[v][j] * gc[j];
                gcon[v] += s;
            }
            if (z.top) {
#pragma unroll
                for (int j = 0; j < CDIM; ++j) {
#pragma unroll
                    for (int i = 0; i < NV; ++i) {
                        const float wi = z.Dc[j] * Jc[i][j];
#pragma unroll
                        for (int l = 0; l <= i; ++l) H[tri(i, l)] += wi * Jc[l][j];
                    }
                }
            } else {
                // middle zone: kz a a' + wmu (SJt'SJt - proj proj')
                const float gu[CDIM] = {
                    -z.usj[0], z.mu * z.uhat[0] * z.usj[1],
                    z.mu * z.uhat[1] * z.usj[2], z.mu * z.uhat[2] * z.usj[3]};
                const float wmu = z.kz * z.w * z.mu / z.T;
                float a[NV], proj[NV], S[NV][CDIM - 1];
#pragma unroll
                for (int v = 0; v < NV; ++v) {
                    a[v] = gu[0] * Jc[v][0] + gu[1] * Jc[v][1] + gu[2] * Jc[v][2]
                           + gu[3] * Jc[v][3];
                    proj[v] = 0.f;
#pragma unroll
                    for (int t = 0; t < CDIM - 1; ++t) {
                        S[v][t] = z.usj[t + 1] * Jc[v][t + 1];
                        proj[v] += z.uhat[t] * S[v][t];
                    }
                }
#pragma unroll
                for (int i = 0; i < NV; ++i) {
#pragma unroll
                    for (int l = 0; l <= i; ++l) {
                        const float ss = S[i][0] * S[l][0] + S[i][1] * S[l][1]
                                         + S[i][2] * S[l][2];
                        H[tri(i, l)] += z.kz * a[i] * a[l] + wmu * (ss - proj[i] * proj[l]);
                    }
                }
            }
        }

        // ---- cost, gradient, Newton direction ----
        float dx[NV], Mdx[NV], grad[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) dx[i] = x[i] - x0[i];
        float q = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            float mi = 0.f;
#pragma unroll
            for (int j = 0; j < NV; ++j) mi += e.M(i, j) * dx[j];
            Mdx[i] = mi;
            q += dx[i] * mi;
            grad[i] = mi + gcon[i];
        }
        const float cost = cost_con + 0.5f * q;

        float L[NTRI], diag[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) {
#pragma unroll
            for (int j = 0; j <= i; ++j) L[tri(i, j)] = e.M(i, j) + H[tri(i, j)];
            diag[i] = L[tri(i, i)];
        }
#pragma unroll
        for (int j = 0; j < NV; ++j) {
            float s = L[tri(j, j)];
#pragma unroll
            for (int k = 0; k < j; ++k) s -= L[tri(j, k)] * L[tri(j, k)];
            const float d = sqrtf(fmaxf(s, tiny));
            L[tri(j, j)] = d;
            const float inv = 1.f / d;
#pragma unroll
            for (int i = j + 1; i < NV; ++i) {
                float t = L[tri(i, j)];
#pragma unroll
                for (int k = 0; k < j; ++k) t -= L[tri(i, k)] * L[tri(j, k)];
                L[tri(i, j)] = t * inv;
            }
        }
        float dirn[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            float s = grad[i];
#pragma unroll
            for (int k = 0; k < i; ++k) s -= L[tri(i, k)] * dirn[k];
            dirn[i] = s / L[tri(i, i)];
        }
#pragma unroll
        for (int i = NV - 1; i >= 0; --i) {
            float s = dirn[i];
#pragma unroll
            for (int k = i + 1; k < NV; ++k) s -= L[tri(k, i)] * dirn[k];
            dirn[i] = s / L[tri(i, i)];
        }
        float slope = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            dirn[i] = -dirn[i];
            slope += grad[i] * dirn[i];
        }
        if (!(slope < 0.f)) {      // descent guard: Jacobi-scaled steepest descent
#pragma unroll
            for (int i = 0; i < NV; ++i) dirn[i] = -grad[i] / fmaxf(diag[i], MINVAL);
        }

        // ---- exact line search on the directional derivative ----
        for (int r = 0; r < e.NE; ++r) {
            float s = 0.f;
#pragma unroll
            for (int v = 0; v < NV; ++v) s += e.Jv(v, r) * dirn[v];
            e.djar[r * e.B + e.b] = s;
        }
        float c1 = 0.f, c2 = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            float mi = 0.f;
#pragma unroll
            for (int j = 0; j < NV; ++j) mi += e.M(i, j) * dirn[j];
            c1 += dirn[i] * Mdx[i];
            c2 += dirn[i] * mi;
        }
        float hi = 1.f;
        bool ok = false;
        for (int i = 0; i < bracket_len; ++i) {
            const bool ok2 = d1_of(e, hi, c1, c2) > 0.f;
            if (!(ok || ok2)) hi *= 2.f;
            ok = ok || ok2;
        }
        float dhi = d1_of(e, hi, c1, c2);
        float lo = 0.f;
        float dlo = d1_of(e, 0.f, c1, c2);
        const float dlo0 = dlo;
        for (int i = 0; i < ls_len; ++i) {
            const float a = fminf(fmaxf(falsi(lo, hi, dlo, dhi), lo + 1e-14f), hi - 1e-14f);
            const float da = d1_of(e, a, c1, c2);
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

        // ---- accept, count, stop test ----
        float x_new[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) x_new[i] = x[i] + alpha * dirn[i];
        const float cost_new = cost_of(e, x_new, x0);
        float gg = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) gg += grad[i] * grad[i];
        const bool done = (cost - cost_new) * scl < tol || sqrtf(gg) * scl < tol;
        if (cost_new < cost) {
#pragma unroll
            for (int i = 0; i < NV; ++i) x[i] = x_new[i];
        }
        ++it;
        if (done) break;
    }

    // ---- constraint force at the solution ----
    float qfrc[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) qfrc[v] = 0.f;
    for (int r = 0; r < e.ns; ++r) {
        float g, h, c;
        e.scalar_row(r, e.jar_at(r, x), g, h, c);
#pragma unroll
        for (int v = 0; v < NV; ++v) qfrc[v] += e.Jv(v, r) * g;
    }
    for (int k = 0; k < e.K; ++k) {
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
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
        out[v * e.B + e.b] = x[v];
        out[(NV + v) * e.B + e.b] = -qfrc[v];
    }
    out[2 * NV * e.B + e.b] = (float)it;
}

}  // namespace

extern "C" int gst_newton_solve(
    const float* J, const float* aref, const float* D, const float* aux,
    const float* us, const float* qM, const float* x0, const float* warm,
    float* jar, float* djar, float* out,
    int NE, int neq, int nf, int nl, int K, int B,
    int max_iters, int ls_len, int bracket_len, float tol, void* stream)
{
    if (B == 0) return 0;
    Env e;
    e.J = J; e.aref = aref; e.D = D; e.aux = aux; e.us = us; e.qM = qM;
    e.jar = jar; e.djar = djar;
    e.NE = NE; e.neq = neq; e.nf = nf; e.nl = nl; e.ns = neq + nf + nl; e.K = K;
    e.B = (size_t)B; e.b = 0;
    const int threads = 32;   // one warp per block spreads B = 4096 over 128 SMs
    newton_solve_kernel<<<(B + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        e, x0, warm, out, max_iters, ls_len, bracket_len, tol);
    return (int)cudaGetLastError();
}
