"""Unrolled small-matrix linear algebra for the single-env engine.

The port of `gym_so100_tpu/ops/linalg.py`: Cholesky factor and solve of
the nv = 12 mass and Hessian systems, and small matrix-vector products,
unrolled over the static size n with every intermediate a (...,)-shaped
tensor.  The operation order is the JAX module's, so float64 results agree
with it to roundoff.
"""

from __future__ import annotations

import torch


def chol_factor(A, eps=0.0):
    """Cholesky factor of SPD A (..., n, n) -> lower L (..., n, n), unrolled.

    `eps` adds a diagonal regularizer.  Diagonal pivots are clamped to
    sqrt(tiny) so that a degenerate system cannot produce NaN."""
    n = A.shape[-1]
    a = [[A[..., i, j] for j in range(n)] for i in range(n)]
    L = [[None] * n for _ in range(n)]
    tiny = torch.finfo(A.dtype).tiny ** 0.5
    for j in range(n):
        s = a[j][j] + eps
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=tiny))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = a[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    zero = torch.zeros_like(a[0][0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1)
            for i in range(n)]
    return torch.stack(rows, dim=-2)


def chol_solve(L, b):
    """Solve (L L^T) x = b with L lower-triangular (..., n, n), b (..., n)."""
    n = L.shape[-1]
    Ls = [[L[..., i, j] for j in range(i + 1)] for i in range(n)]
    bs = [b[..., i] for i in range(n)]
    y = [None] * n
    for i in range(n):
        s = bs[i]
        for k in range(i):
            s = s - Ls[i][k] * y[k]
        y[i] = s / Ls[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - Ls[k][i] * x[k]
        x[i] = s / Ls[i][i]
    return torch.stack(x, dim=-1)


_UNROLL_MAX = 16


def matvec(A, x):
    """(..., m, n) @ (..., n) -> (..., m): n multiply-adds on (..., m)
    slices when n is small, else a broadcast product and a sum."""
    n = A.shape[-1]
    if n == 0:
        return torch.zeros(A.shape[:-1], dtype=A.dtype, device=A.device)
    if n <= _UNROLL_MAX:
        s = A[..., :, 0] * x[..., 0:1]
        for j in range(1, n):
            s = s + A[..., :, j] * x[..., j:j + 1]
        return s
    return (A * x[..., None, :]).sum(-1)


def matvec_t(A, x):
    """A^T @ x for A (..., m, n), x (..., m) -> (..., n)."""
    m = A.shape[-2]
    if m == 0:
        return torch.zeros(A.shape[:-2] + A.shape[-1:], dtype=A.dtype, device=A.device)
    if m <= _UNROLL_MAX:
        s = A[..., 0, :] * x[..., 0:1]
        for i in range(1, m):
            s = s + A[..., i, :] * x[..., i:i + 1]
        return s
    return (A * x[..., :, None]).sum(-2)


def dot(a, b):
    """(..., n) . (..., n) -> (...,), unrolled."""
    n = a.shape[-1]
    s = a[..., 0] * b[..., 0]
    for i in range(1, n):
        s = s + a[..., i] * b[..., i]
    return s
