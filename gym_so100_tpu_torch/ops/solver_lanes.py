"""Batch-last (lanes) Newton constraint solver.

The port of `gym_so100_tpu/ops/solver_lanes.py`.  It minimizes, per env,
the constraint cost over equality (quadratic), friction-loss (Huber), limit
(one-sided) and elliptic-cone contact rows (top/middle/bottom zones) plus
1/2 (x - a0)' M (x - a0): Newton directions from an nv x nv Cholesky with a
steepest-descent guard, an exact line search on the directional derivative
(bracket expansion, then regula falsi), a masked stop at `tol`, and a fixed
f32 budget of 10 Newton / 5 bracket / 6 line-search steps.

`solve_lanes` dispatches: CPU tensors run `solve_plain` (the JAX package's
scan path, solver_lanes.py:739-891, with Python loops for the scans); CUDA
float32 tensors launch kernel 2 of the port, `csrc/newton_solve.cu` (the
whole solve in one kernel, replacing the Pallas kernel
`_solve_fused_pallas`), through `solve_fused`.
"""

from __future__ import annotations

import torch

from ..models.scene import Model
from .constraint import CDIM
from .constraint_lanes import EfcLanes
from .smooth_lanes import _chol_lanes, _chol_solve_lanes

MINVAL_ = 1e-15
NEWTON_ITERS = 10   # f32 budgets of the JAX package (GST_NEWTON/GST_BRACKET/GST_LS)
BRACKET_ITERS = 5
LS_ITERS = 6


def _cost_terms(efc: EfcLanes, jar):
    """Constraint cost pieces at jar (NE, B): cost (B,), scalar-row
    gradient and Hessian weights (ns, B), contact gradient (K, CDIM, B),
    D_c (K, CDIM, B) and the cone zone quantities."""
    neq, nf, nl = efc.neq, efc.nf, efc.nl
    start = neq + nf + nl
    D_s = efc.D[:start]
    jar_s = jar[:start]
    jar_c = jar[start:].reshape(-1, CDIM, jar.shape[-1])
    D_c = efc.D[start:].reshape(jar_c.shape)

    # equality rows: always-active quadratic
    ge = D_s[:neq] * jar_s[:neq]
    he = D_s[:neq]
    ce = 0.5 * ge * jar_s[:neq]
    # friction loss: Huber
    jf = jar_s[neq:neq + nf]
    Df = D_s[neq:neq + nf]
    fl = efc.floss
    lim = fl * efc.R[neq:neq + nf]
    quad = torch.abs(jf) <= lim
    cf = torch.where(quad, 0.5 * Df * jf * jf, fl * torch.abs(jf) - 0.5 * fl * lim)
    gf = torch.where(quad, Df * jf, fl * torch.sign(jf))
    hf = torch.where(quad, Df, 0.0)
    # limits: one-sided quadratic (D already gated by pos < 0)
    jl = jar_s[neq + nf:]
    Dl = D_s[neq + nf:]
    actl = jl < 0
    cl = torch.where(actl, 0.5 * Dl * jl * jl, 0.0)
    gl = torch.where(actl, Dl * jl, 0.0)
    hl = torch.where(actl, Dl, 0.0)

    grad_s = torch.cat([ge, gf, gl])
    hess_s = torch.cat([he, hf, hl])
    cost_s = ce.sum(0) + cf.sum(0) + cl.sum(0)

    # contact cones (scaled circular cone)
    u = jar_c * efc.con_uscale                    # (K, CDIM, B)
    un = u[:, 0]
    ut = u[:, 1:]
    Traw = torch.sqrt((ut * ut).sum(1))
    T = torch.clamp(Traw, min=1e-30)
    mu = efc.con_mu
    Dn = efc.con_Dn
    bottom = mu * Traw <= un
    top = Traw <= -mu * un
    middle = ~(bottom | top) & (Dn > 0)
    top = top & (Dn > 0)

    w = mu * Traw - un
    k = Dn / (1 + mu * mu)
    cost_c = torch.where(top, 0.5 * (D_c * jar_c * jar_c).sum(1), 0.0)
    cost_c = cost_c + torch.where(middle, 0.5 * k * w * w, 0.0)
    uhat = ut / T[:, None]
    g_mid_u = torch.cat([-torch.ones_like(un)[:, None], mu[:, None] * uhat], 1)
    grad_c = (top[:, None] * D_c * jar_c
              + middle[:, None] * (k * w)[:, None] * g_mid_u * efc.con_uscale)

    cost = cost_s + cost_c.sum(0)
    cone = dict(middle=middle, top=top, k=k, w=w, mu=mu, uhat=uhat, T=T)
    return cost, grad_s, hess_s, grad_c, D_c, cone


def _assemble(efc: EfcLanes, jar):
    """cost (B,), gradient J'g (nv, B) and constraint Hessian (nv, nv, B)."""
    cost, grad_s, hess_s, grad_c, D_c, cone = _cost_terms(efc, jar)
    start = efc.neq + efc.nf + efc.nl
    B = jar.shape[-1]
    nv = efc.J.shape[0]
    J = efc.J                                      # (nv, NE, B)
    Jc = J[:, start:].reshape(nv, -1, CDIM, B)     # (nv, K, CDIM, B)

    g_all = torch.cat([grad_s, grad_c.reshape(-1, B)])
    grad = (J * g_all).sum(1)                      # (nv, B)

    # diag-weight gram over all rows (scalar hessians + top-zone weights)
    w_top = (cone["top"][:, None] * D_c).reshape(-1, B)
    w_diag = torch.cat([hess_s, w_top])            # (NE, B)
    g1 = torch.einsum("inb,jnb->ijb", w_diag * J, J)

    # middle zone: rank-1 kk a a' plus curvature wmu Jt'(I - uhat uhat')Jt/T
    us = efc.con_uscale
    g_u = torch.cat([-torch.ones_like(cone["w"])[:, None],
                     cone["mu"][:, None] * cone["uhat"]], dim=1) * us
    kk = cone["k"] * cone["middle"]                # (K, B)
    a = (g_u * Jc).sum(2)                          # (nv, K, B)
    uh = cone["uhat"]                              # (K, 3, B)
    wmu = kk * cone["w"] * cone["mu"] / cone["T"]  # (K, B)
    SJt = us[:, 1:] * Jc[:, :, 1:]                 # (nv, K, 3, B)
    proj = (uh * SJt).sum(2)                       # (nv, K, B)
    g2 = torch.einsum("kb,ikb,jkb->ijb", kk, a, a)
    g3 = (torch.einsum("kb,iktb,jktb->ijb", wmu, SJt, SJt)
          - torch.einsum("kb,ikb,jkb->ijb", wmu, proj, proj))
    return cost, grad, g1 + g2 + g3


def budgets(m: Model, dtype):
    """(Newton iterations, line-search steps, bracket steps, tol) of a solve
    in `dtype`: float32 runs the fixed budget of the JAX package's fused
    path; float64 takes the model's iteration limits."""
    tol = max(m.solver_tolerance, 64 * torch.finfo(dtype).eps)
    if dtype == torch.float64:
        return m.solver_iterations, max(m.ls_iterations, 25), 16, tol
    return NEWTON_ITERS, LS_ITERS, BRACKET_ITERS, tol


def solve_plain(m: Model, qM, a0, efc: EfcLanes, warmstart=None):
    """The plain PyTorch Newton solve (scan path of the JAX package).

    qM (nv, nv, B); a0 (B, nv) qacc_smooth; warmstart (B, nv) or None.
    Returns (qacc (B, nv), qfrc_constraint (B, nv), niter (B,) int32).
    The budgets come from `budgets(m, a0.dtype)`; float32 runs all of them
    masked, float64 stops once every lane has converged."""
    dtype = a0.dtype
    B, nv = a0.shape
    f64 = dtype == torch.float64
    max_iters, ls_len, bracket_len, tol = budgets(m, dtype)
    scale = 1.0 / (max(m.stat_meaninertia, MINVAL_) * max(1, nv))
    J = efc.J
    x0 = a0.T                                      # (nv, B)
    start = efc.neq + efc.nf + efc.nl

    jar_of = lambda x: (J * x[:, None]).sum(0) - efc.aref
    matvec = lambda x: (qM * x[None]).sum(1)       # qM @ x, (nv, B)

    def total_cost(x):
        c, *_ = _cost_terms(efc, jar_of(x))
        dx = x - x0
        return c + 0.5 * (dx * matvec(dx)).sum(0)

    x = x0
    if warmstart is not None:
        w = warmstart.T
        x = torch.where(total_cost(w) < total_cost(x0), w, x0)

    def phi_d(jar, djar, c1, c2, alpha):
        """Directional derivative of the cost along djar at step alpha."""
        jar_a = jar + alpha[None] * djar
        _, gs, _, gc, _, _ = _cost_terms(efc, jar_a)
        dj_c = djar[start:].reshape(-1, CDIM, B)
        return c1 + alpha * c2 + (gs * djar[:start]).sum(0) + (gc * dj_c).sum((0, 1))

    def falsi(lo, hi, dlo, dhi):
        denom = dhi - dlo
        big = torch.abs(denom) > MINVAL_
        return torch.where(big, lo - dlo * (hi - lo) / torch.where(big, denom, 1.0),
                           0.5 * (lo + hi))

    niter = torch.zeros(B, dtype=torch.int32, device=a0.device)
    done = torch.zeros(B, dtype=torch.bool, device=a0.device)
    for _ in range(max_iters):
        if f64 and bool(done.all()):
            break
        # masked iteration: lanes already done keep x and niter
        jar = jar_of(x)
        cost, gcon, H = _assemble(efc, jar)
        dx = x - x0
        Mdx = matvec(dx)
        cost = cost + 0.5 * (dx * Mdx).sum(0)
        grad = Mdx + gcon
        Htot = qM + H
        dirn = -_chol_solve_lanes(_chol_lanes(Htot), grad)
        # descent guard: fall back to Jacobi-scaled steepest descent where
        # the Cholesky direction does not descend
        desc = (grad * dirn).sum(0) < 0
        diagH = torch.diagonal(Htot, dim1=0, dim2=1).T
        dirn = torch.where(desc, dirn, -grad / torch.clamp(diagH, min=MINVAL_))

        djar = (J * dirn[:, None]).sum(0)          # (NE, B)
        c1 = (dirn * Mdx).sum(0)
        c2 = (dirn * matvec(dirn)).sum(0)

        hi = torch.ones(B, dtype=dtype, device=a0.device)
        ok = torch.zeros(B, dtype=torch.bool, device=a0.device)
        for _ in range(bracket_len):
            ok2 = phi_d(jar, djar, c1, c2, hi) > 0
            hi = torch.where(ok | ok2, hi, hi * 2.0)
            ok = ok | ok2
        dhi = phi_d(jar, djar, c1, c2, hi)
        lo = torch.zeros(B, dtype=dtype, device=a0.device)
        dlo = dlo0 = phi_d(jar, djar, c1, c2, lo)
        for _ in range(ls_len):
            a_ = torch.minimum(torch.maximum(falsi(lo, hi, dlo, dhi), lo + 1e-14),
                               hi - 1e-14)
            da = phi_d(jar, djar, c1, c2, a_)
            neg = da < 0
            lo, dlo, hi, dhi = (torch.where(neg, a_, lo), torch.where(neg, da, 0.5 * dlo),
                                torch.where(neg, hi, a_), torch.where(neg, 0.5 * dhi, da))
        alpha = torch.where(dlo0 >= 0, 0.0, falsi(lo, hi, dlo, dhi))

        x_new = x + alpha * dirn
        cost_new = total_cost(x_new)
        improvement = (cost - cost_new) * scale
        gradnorm = torch.sqrt((grad * grad).sum(0)) * scale
        done_new = (improvement < tol) | (gradnorm < tol)
        x_out = torch.where(cost_new < cost, x_new, x)
        x = torch.where(done, x, x_out)
        niter = torch.where(done, niter, niter + 1)
        done = done | done_new

    _, grad_s, _, grad_c, _, _ = _cost_terms(efc, jar_of(x))
    force = torch.cat([grad_s, grad_c.reshape(-1, B)])
    qfrc = -(J * force).sum(1)
    return x.T, qfrc.T, niter


def pack_fused_inputs(m: Model, qM, a0, efc: EfcLanes, warmstart=None):
    """The kernel's (rows, B) inputs, as the Pallas kernel took them:
    J (nv*NE, B) and aref, D (NE, B) with contact rows COMPONENT-major
    (row ns + j*K + k); aux rows [floss (nf) | R_f (nf) | mu (K) | Dn (K) |
    scale]; uscale (CDIM*K, B) component-major; the lower triangle of qM
    (nv(nv+1)/2, B) row by row; x0 and the warmstart (nv, B)."""
    B, nv = a0.shape
    neq, nf = efc.neq, efc.nf
    ns = neq + nf + efc.nl
    K = efc.con_mu.shape[0]

    def cmajor(A):                                 # (..., NE, B)
        con = A[..., ns:, :].reshape(*A.shape[:-2], K, CDIM, B)
        return torch.cat([A[..., :ns, :], con.transpose(-3, -2).reshape(
            *A.shape[:-2], CDIM * K, B)], dim=-2)

    scale = 1.0 / (max(m.stat_meaninertia, MINVAL_) * max(1, nv))
    aux = torch.cat([efc.floss, efc.R[neq:neq + nf], efc.con_mu, efc.con_Dn,
                     torch.full((1, B), scale, dtype=a0.dtype, device=a0.device)])
    tri = torch.tril_indices(nv, nv)
    x0 = a0.T
    return dict(
        J=cmajor(efc.J).reshape(nv * efc.J.shape[1], B).contiguous(),
        aref=cmajor(efc.aref).contiguous(),
        D=cmajor(efc.D).contiguous(),
        aux=aux.contiguous(),
        us=efc.con_uscale.transpose(0, 1).reshape(CDIM * K, B).contiguous(),
        qM=qM[tri[0], tri[1]].contiguous(),
        x0=x0.contiguous(),
        warm=(warmstart.T if warmstart is not None else x0).contiguous(),
    )


NV_MAX = 16     # the largest nv the solver kernel takes (csrc/newton_solve.cu)


def solve_fused(m: Model, qM, a0, efc: EfcLanes, warmstart=None):
    """Launch the whole-solve CUDA kernel (float32, nv <= NV_MAX).  Same
    arguments and results as `solve_plain`.

    The kernel runs one warp per env, four envs per 128-thread block.  It
    stages each env's inputs into shared memory once and keeps every
    intermediate there (jar, djar, row weights, x, the direction) or in
    registers (the Hessian's entries and their Cholesky factor, owned by
    the lanes that assembled them), so the only device memory it touches
    is the packed inputs and the (2*nv + 1, B) output allocated here.  It
    is built for nv = 12, 15 and 16; another nv runs on the next larger
    build, padded inside the kernel."""
    from .. import kernels

    B, nv = a0.shape
    if nv > NV_MAX:
        raise NotImplementedError(
            f"the solver kernel takes nv <= {NV_MAX}, got {nv}")
    NE = efc.aref.shape[0]
    K = efc.con_mu.shape[0]
    inp = pack_fused_inputs(m, qM, a0, efc, warmstart)
    f32 = torch.float32
    kernels.check(inp["J"], (nv * NE, B), f32, "J")
    kernels.check(inp["aref"], (NE, B), f32, "aref")
    kernels.check(inp["D"], (NE, B), f32, "D")
    kernels.check(inp["aux"], (2 * efc.nf + 2 * K + 1, B), f32, "aux")
    kernels.check(inp["us"], (CDIM * K, B), f32, "uscale")
    kernels.check(inp["qM"], (nv * (nv + 1) // 2, B), f32, "qM")
    kernels.check(inp["x0"], (nv, B), f32, "x0")
    kernels.check(inp["warm"], (nv, B), f32, "warmstart")
    out = torch.empty(2 * nv + 1, B, dtype=f32, device=a0.device)
    kernels.launch(
        "gst_newton_solve", inp["J"], inp["aref"], inp["D"], inp["aux"],
        inp["us"], inp["qM"], inp["x0"], inp["warm"], out,
        nv, NE, efc.neq, efc.nf, efc.nl, K, B, *budgets(m, f32),
    )
    solve_fused.launches += 1
    return out[:nv].T, out[nv:2 * nv].T, out[2 * nv].to(torch.int32)


solve_fused.launches = 0


def solve_lanes(m: Model, qM, a0, efc: EfcLanes, warmstart=None):
    """Newton solve, lanes form: qM (nv, nv, B), a0 (B, nv), warmstart
    (B, nv) or None.  Returns (qacc (B, nv), qfrc_constraint (B, nv),
    niter (B,)).  CPU tensors run the plain version; CUDA tensors launch
    the kernel, which takes float32 only."""
    if a0.device.type == "cpu":
        return solve_plain(m, qM, a0, efc, warmstart)
    if a0.dtype != torch.float32:
        raise TypeError(f"the CUDA solver kernel takes float32, got {a0.dtype}")
    return solve_fused(m, qM, a0, efc, warmstart)
