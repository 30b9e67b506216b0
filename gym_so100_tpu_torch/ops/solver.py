"""Newton constraint solver of the single-env engine (elliptic friction
cones, exact Hessian).

The port of `gym_so100_tpu/ops/solver.py`.  It minimizes MuJoCo's
constraint problem over qacc,

    f(x) = 0.5 (x - a0)' M (x - a0) + sum_i s_i(J x - aref),

with per-row costs: Huber for dof friction loss, a one-sided quadratic for
joint limits, an always-active quadratic for equality rows, and the
circular-cone cost for elliptic contacts in the scaled coordinates of
`constraint.py` (bottom zone 0, top zone 0.5 sum D jar^2, middle zone
0.5 Dn / (1 + mu^2) (mu T - u_n)^2).  Each iteration: the analytic
gradient and exact Hessian (cone curvature included), a Cholesky
direction (Jacobi-scaled steepest descent where it fails to descend), an
exact line search (bracket expansion, then Illinois regula falsi on the
monotone phi'), and the improvement/gradient stop.  The start is the better
of the warm start and qacc_smooth.

Budgets follow the dtype, as in JAX.  float32: a masked loop of min(iters,
10) iterations, line search 6, bracket 5; a finished solve keeps x (niter
counts the unfrozen iterations), so the loop ends at the first done
iteration with the same result.  float64: up to `solver_iterations`,
line search max(ls_iterations, 25), bracket 16; the loop reads `done` on
the host once per iteration and stops at the first done iteration, which
is JAX's `while_loop`.  The bracket expansion stops at its first success
(one host read per step), after which JAX's fixed-length scan keeps hi.
"""

from __future__ import annotations

import torch

from ..models.scene import Data, Model
from . import linalg
from .constraint import CDIM, Efc

MINVAL_ = 1e-15


def _weighted_gram(U, V, w):
    """sum_r w_r U_r V_r^T for U, V (R, n), w (R,) -> (n, n)."""
    return ((w[:, None] * U)[:, :, None] * V[:, None, :]).sum(0)


def _split(efc: Efc, a):
    """(scalar rows, contact rows as (K, CDIM)) of a per-row array."""
    start = efc.neq + efc.nf + efc.nl
    return a[:start], a[start:].reshape(-1, CDIM)


def _cost_terms(efc: Efc, jar):
    """Total constraint cost, per-row dcost/djar of the scalar rows, their
    second derivative, the contact rows' gradient (K, CDIM), their D, and
    the cone zone data."""
    jar_s, jar_c = _split(efc, jar)
    D_s, D_c = _split(efc, efc.D)
    R_s, _ = _split(efc, efc.R)
    fl_s, _ = _split(efc, efc.floss)
    isf, _ = _split(efc, efc.is_floss)
    isl, _ = _split(efc, efc.is_limit)

    # friction loss: Huber
    lim = fl_s * R_s
    quad_f = torch.abs(jar_s) <= lim
    cost_f = torch.where(quad_f, 0.5 * D_s * jar_s ** 2,
                         fl_s * torch.abs(jar_s) - 0.5 * fl_s * lim)
    grad_f = torch.where(quad_f, D_s * jar_s, fl_s * torch.sign(jar_s))
    hess_f = torch.where(quad_f, D_s, 0.0)
    # limits: one-sided, active where jar < 0 (D gated by pos < 0)
    act_l = jar_s < 0
    cost_l = torch.where(act_l, 0.5 * D_s * jar_s ** 2, 0.0)
    grad_l = torch.where(act_l, D_s * jar_s, 0.0)
    hess_l = torch.where(act_l, D_s, 0.0)
    # equality rows (neither mask): always-active quadratic
    iseq = ~(isf | isl)
    cost_s = torch.where(isf, cost_f, torch.where(iseq, 0.5 * D_s * jar_s ** 2, cost_l))
    grad_s = torch.where(isf, grad_f, torch.where(iseq, D_s * jar_s, grad_l))
    hess_s = torch.where(isf, hess_f, torch.where(iseq, D_s, hess_l))

    # contact cones
    u = jar_c * efc.con_uscale
    un = u[:, 0]
    ut = u[:, 1:]
    Traw = torch.sqrt((ut * ut).sum(-1))
    # guarded T for divisions: it only ever multiplies a zero mask where
    # T ~ 0, but must never make a NaN
    T = torch.clamp(Traw, min=1e-30)
    mu = efc.con_mu
    Dn = efc.con_Dn
    bottom = mu * Traw <= un
    top = Traw <= -mu * un
    middle = ~(bottom | top) & (Dn > 0)
    top = top & (Dn > 0)

    w = mu * Traw - un
    k = Dn / (1 + mu * mu)
    cost_c = (torch.where(top, 0.5 * (D_c * jar_c ** 2).sum(-1), 0.0)
              + torch.where(middle, 0.5 * k * w * w, 0.0))
    uhat = ut / T[:, None]
    g_mid_u = torch.cat([-torch.ones_like(un)[:, None], mu[:, None] * uhat], -1)  # dw/du
    grad_c = (top[:, None] * D_c * jar_c
              + middle[:, None] * (k * w)[:, None] * g_mid_u * efc.con_uscale)

    cost = cost_s.sum() + cost_c.sum()
    cone = dict(middle=middle, top=top, k=k, w=w, mu=mu, uhat=uhat, T=T)
    return cost, grad_s, hess_s, grad_c, D_c, cone


def _assemble(efc: Efc, M, jar):
    """Constraint cost, its gradient J'g (nv,) and Hessian J'HJ (nv, nv)."""
    cost, grad_s, hess_s, grad_c, D_c, cone = _cost_terms(efc, jar)
    start = efc.neq + efc.nf + efc.nl
    nv = efc.J.shape[-1]
    Js = efc.J[:start]
    Jc = efc.J[start:].reshape(-1, CDIM, nv)                 # (K, CDIM, nv)
    grad = linalg.matvec_t(Js, grad_s) + (Jc * grad_c[..., None]).sum((0, 1))

    # scalar rows and the contact top zone: diagonal row weights, one gram
    w_top = (cone["top"][:, None] * D_c).reshape(-1)
    H = _weighted_gram(efc.J, efc.J, torch.cat([hess_s, w_top]))
    # contact middle zone: k (g g' + w mu H_T) in u-space, mapped to jar
    us = efc.con_uscale
    g_u = torch.cat([-torch.ones_like(cone["w"])[:, None],
                     cone["mu"][:, None] * cone["uhat"]], -1) * us
    kk = cone["k"] * cone["middle"]
    a = (g_u[..., None] * Jc).sum(-2)                        # (K, nv)
    Hgg = _weighted_gram(a, a, kk)
    # curvature of T: (I - uhat uhat') / T in tangential coordinates
    uh = cone["uhat"]
    eye = torch.eye(CDIM - 1, dtype=jar.dtype, device=jar.device)
    PT = (eye[None] - uh[:, :, None] * uh[:, None, :]) / cone["T"][:, None, None]
    wmu = kk * cone["w"] * cone["mu"]
    St = us[:, 1:]
    PTs = St[:, :, None] * PT * St[:, None, :]
    Jt = Jc[:, 1:, :]
    Bm = (PTs[..., None] * Jt[:, None, :, :]).sum(-2)        # (K, 3, nv)
    Hcurv = _weighted_gram(Jt.reshape(-1, nv), Bm.reshape(-1, nv),
                           wmu.repeat_interleave(CDIM - 1))
    return cost, grad, H + Hgg + Hcurv


def solve(m: Model, d: Data, efc: Efc, warmstart=None):
    """Newton solve for qacc.  Returns (qacc, qfrc_constraint, efc_force,
    niter)."""
    dtype, dev = d.qacc_smooth.dtype, d.qacc_smooth.device
    M = d.qM
    a0 = d.qacc_smooth
    nv = m.nv
    start = efc.neq + efc.nf + efc.nl

    def total_cost(x):
        jar = linalg.matvec(efc.J, x) - efc.aref
        c = _cost_terms(efc, jar)[0]
        dx = x - a0
        return 0.5 * linalg.dot(dx, linalg.matvec(M, dx)) + c

    # warm start: the better of the warm start and qacc_smooth
    if warmstart is None:
        x = a0
    else:
        x = torch.where(total_cost(warmstart) < total_cost(a0), warmstart, a0)

    f32 = dtype == torch.float32
    # the model's tolerance (1e-8) is below float32 resolution: floor it
    tol = max(m.solver_tolerance, 64 * float(torch.finfo(dtype).eps))
    max_iters = min(m.solver_iterations, 10) if f32 else m.solver_iterations
    ls_len = 6 if f32 else max(m.ls_iterations, 25)
    bracket_len = 5 if f32 else 16
    scale = 1.0 / (max(m.stat_meaninertia, MINVAL_) * max(1, nv))
    zero = torch.zeros((), dtype=dtype, device=dev)
    # per-row constants of the line search's derivative
    D_s, D_c = _split(efc, efc.D)
    isf, isl = efc.is_floss[:start], efc.is_limit[:start]
    fl_s = efc.floss[:start]
    rows = dict(
        D_s=D_s, D_c=D_c, fl_s=fl_s, lim=fl_s * efc.R[:start], isf=isf, iseq=~(isf | isl),
        us=efc.con_uscale, mu=efc.con_mu, nmu=-efc.con_mu, Dpos=efc.con_Dn > 0,
        k=efc.con_Dn / (1 + efc.con_mu * efc.con_mu),
        neg1=-torch.ones(efc.con_mu.shape[0], 1, dtype=dtype, device=dev))

    def body(x):
        jar = linalg.matvec(efc.J, x) - efc.aref
        cost, gcon, H = _assemble(efc, M, jar)
        dx = x - a0
        Mdx = linalg.matvec(M, dx)
        cost = cost + 0.5 * linalg.dot(dx, Mdx)            # with the smooth term
        grad = Mdx + gcon
        Htot = M + H
        dirn = -linalg.chol_solve(linalg.chol_factor(Htot, eps=1e-12), grad)
        # descent guard: where roundoff makes the Cholesky direction ascend
        # (near-singular Hessian), Jacobi-scaled steepest descent
        sd = -grad / torch.clamp(torch.diagonal(Htot), min=MINVAL_)
        dirn = torch.where(linalg.dot(grad, dirn) < 0, dirn, sd)

        # exact line search on phi(alpha) = f(x + alpha dirn), phi convex
        djar = linalg.matvec(efc.J, dirn)
        c1 = linalg.dot(dirn, Mdx)
        c2 = linalg.dot(dirn, linalg.matvec(M, dirn))
        dj_s, dj_c = djar[:start], djar[start:].reshape(-1, CDIM)
        js0, jc0 = jar[:start], jar[start:].reshape(-1, CDIM)

        def phi_d(alpha):
            """phi'(alpha): the row gradients of `_cost_terms` at jar +
            alpha djar along djar (the search reads no cost or curvature)."""
            js = js0 + alpha * dj_s
            Dj = rows["D_s"] * js
            grad_f = torch.where(torch.abs(js) <= rows["lim"], Dj,
                                 rows["fl_s"] * torch.sign(js))
            gs = torch.where(rows["isf"], grad_f,
                             torch.where(rows["iseq"], Dj, torch.where(js < 0, Dj, 0.0)))
            jc = jc0 + alpha * dj_c
            u = jc * rows["us"]
            un, ut = u[:, 0], u[:, 1:]
            Traw = torch.sqrt((ut * ut).sum(-1))
            muT = rows["mu"] * Traw
            top0 = Traw <= rows["nmu"] * un
            middle = ~((muT <= un) | top0) & rows["Dpos"]
            top = top0 & rows["Dpos"]
            uhat = ut / torch.clamp(Traw, min=1e-30)[:, None]
            g_mid_u = torch.cat([rows["neg1"], rows["mu"][:, None] * uhat], -1)
            gc = (top[:, None] * rows["D_c"] * jc
                  + middle[:, None] * (rows["k"] * (muT - un))[:, None] * g_mid_u * rows["us"])
            return c1 + alpha * c2 + (gs * dj_s).sum() + (gc * dj_c).sum()

        # bracket: expand hi until phi'(hi) > 0
        hi = torch.ones((), dtype=dtype, device=dev)
        ok = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(bracket_len):
            d_hi = phi_d(hi)
            ok2 = d_hi > 0
            ok = ok | ok2
            if bool(ok):
                break       # bracketed: the remaining steps keep hi
            hi = hi * 2.0
        else:
            d_hi = phi_d(hi)
        dhi = d_hi
        dlo = phi_d(zero)

        # Illinois regula falsi on the monotone phi' over [lo, hi]
        def secant(lo, hi, dlo, dhi):
            den = dhi - dlo
            big = torch.abs(den) > MINVAL_
            return torch.where(big, lo - dlo * (hi - lo) / torch.where(big, den, 1.0),
                               0.5 * (lo + hi))

        lo, dlo_i, dhi_i = zero, dlo, dhi
        for _ in range(ls_len):
            a = torch.clamp(secant(lo, hi, dlo_i, dhi_i), lo + 1e-14, hi - 1e-14)
            da = phi_d(a)
            neg = da < 0
            # halve the stale endpoint's derivative against stalling
            lo, hi, dlo_i, dhi_i = (torch.where(neg, a, lo), torch.where(neg, hi, a),
                                    torch.where(neg, da, 0.5 * dlo_i),
                                    torch.where(neg, 0.5 * dhi_i, da))
        alpha = secant(lo, hi, dlo_i, dhi_i)
        # phi'(0) >= 0: the current point is already optimal along dirn
        alpha = torch.where(dlo >= 0, 0.0, alpha)

        x_new = x + alpha * dirn
        cost_new = total_cost(x_new)
        improvement = (cost - cost_new) * scale
        gradnorm = torch.linalg.vector_norm(grad) * scale
        done_new = (improvement < tol) | (gradnorm < tol)
        return torch.where(cost_new < cost, x_new, x), done_new

    niter = torch.zeros((), dtype=torch.int32, device=dev)
    if f32:
        # fixed-length masked loop: a finished solve keeps x
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(max_iters):
            x2, done2 = body(x)
            x = torch.where(done, x, x2)
            niter = torch.where(done, niter, niter + 1)
            done = done | done2
            if bool(done):
                break       # frozen: the remaining iterations keep x
    else:
        for _ in range(max_iters):
            x, done = body(x)
            niter = niter + 1
            if bool(done):
                break

    jar = linalg.matvec(efc.J, x) - efc.aref
    _, grad_s, _, grad_c, _, _ = _cost_terms(efc, jar)
    force = -torch.cat([grad_s, grad_c.reshape(-1)])
    return x, linalg.matvec_t(efc.J, force), force, niter
