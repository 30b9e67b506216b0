"""Convex-convex narrowphase of the single-env engine: GJK distance and EPA
penetration depth (float64), or the direction sweep (float32).

The port of `gym_so100_tpu/ops/collision/gjk.py`.  JAX vmaps the collider
over pairs; here every function takes a leading pair axis N: poses p (N, 3),
R (N, 3, 3), and hull vertices as component tuples (vx, vy, vz), each
(N, V) in the geom frame.  The trip counts are JAX's (GJK_ITERS, EPA_ITERS,
EPA_FACES): a finished pair keeps its state through the remaining
iterations as in JAX's masked scans, and the loop ends early once every
pair is finished, which changes no result (one host read per iteration).
EPA runs only on the pairs GJK found intersecting, the only ones whose EPA
result is read.

Conventions: `normal` points from geom1 toward geom2; `depth` is negative
when penetrating; `pos` is the midpoint of the witness points.

Ties and branch predicates, kept as JAX has them: argmax/argmin return the
first extremum (as torch's do); the sorts of the EPA horizon are stable
(`stable=True`); the EPA's degenerate-simplex test and winding take the
sign of a 3x3 determinant computed by LU (`torch.linalg.det`, as
`jnp.linalg.det`), and a slice of the packed hull array clamps its start as
`lax.dynamic_slice` does.
"""

from __future__ import annotations

import torch

from .hull_lanes import HULL_BLOCK, N_PEN_DIRS, _dir_set_np

GJK_ITERS = 20
EPA_ITERS = 20
EPA_FACES = 64
NVERT = 4 + EPA_ITERS

_FACES0 = ((0, 1, 2), (1, 3, 2), (0, 2, 3), (0, 3, 1))


def _mv(A, v):
    return torch.einsum("nij,nj->ni", A, v)


def _dot(a, b):
    return (a * b).sum(-1)


def _rows(x, idx):
    """x (N, M, ...) gathered at per-pair indices idx (N, ...) on axis 1."""
    n = torch.arange(x.shape[0], device=x.device).reshape((-1,) + (1,) * (idx.dim() - 1))
    return x[n, idx]


def convex_convex(p1, R1, v1, p2, R2, v2, margin=0.0):
    """Collide N hull pairs from world poses and geom-frame vertices
    (N, V, 3)."""
    return _convex_core(p1, R1, v1.unbind(-1), p2, R2, v2.unbind(-1), margin)


def make_blocked_convex_convex(v_allT):
    """A collider reading hulls from `v_allT` (3, nblocks * HULL_BLOCK),
    each geom's hull padded to HULL_BLOCK vertices, addressed by per-pair
    block start offsets (N,).  The start is clamped so that the window
    stays in bounds (`lax.dynamic_slice`)."""
    L = v_allT.shape[1]
    win = torch.arange(HULL_BLOCK, device=v_allT.device)

    def collide(p1, R1, start1, p2, R2, start2, margin=0.0):
        def comp(start):
            idx = torch.clamp(start, 0, L - HULL_BLOCK)[:, None] + win
            return tuple(v_allT[c][idx] for c in range(3))

        return _convex_core(p1, R1, comp(start1), p2, R2, comp(start2), margin)

    return collide


def _convex_core(p1, R1, v1c, p2, R2, v2c, margin):
    dtype = p1.dtype
    if dtype == torch.float32:
        # the throughput path: the direction sweep alone gives the overlap
        # certificate and the depth, normal and witness
        depth, n, pos = _dir_penetration(p1, R1, v1c, p2, R2, v2c, dtype)
        return dict(pos=pos, normal=n, depth=depth, active=depth < margin)

    sup = _make_support(p1, R1, v1c, p2, R2, v2c)
    S, W, nsimp, dist2, lam, intersect = _gjk(sup, p1, R1, v1c, p2, R2, v2c)

    # separated: witnesses from the barycentric combination
    wa = (lam[:, :, None] * W[:, :, :3]).sum(1)
    wb = (lam[:, :, None] * W[:, :, 3:]).sum(1)
    sep_dist = torch.sqrt(torch.clamp(dist2, min=1e-300))
    sep_n = (wb - wa) / torch.clamp(sep_dist, min=1e-12)[:, None]

    # the EPA result is read only where GJK found an intersection, so only
    # those pairs run it
    depth_pen = torch.zeros_like(sep_dist)
    n_pen = torch.zeros_like(p1)
    pos_pen = torch.zeros_like(p1)
    sel = intersect.nonzero()[:, 0]
    if sel.numel():
        sub = lambda c: tuple(x[sel] for x in c)
        out = _epa(_make_support(p1[sel], R1[sel], sub(v1c), p2[sel], R2[sel], sub(v2c)),
                   S[sel], W[sel], nsimp[sel], dtype)
        depth_pen[sel], n_pen[sel], pos_pen[sel] = out

    it = intersect[:, None]
    return dict(
        pos=torch.where(it, pos_pen, 0.5 * (wa + wb)),
        normal=torch.where(it, n_pen, sep_n),
        depth=torch.where(intersect, depth_pen, sep_dist),
        active=intersect & (depth_pen < margin),
    )


def _make_support(p1, R1, v1c, p2, R2, v2c):
    v1 = torch.stack(v1c, -1)                        # (N, V, 3)
    v2 = torch.stack(v2c, -1)

    def support(d):
        """Support point of the Minkowski difference along d (N, 3): (a - b,
        [a, b])."""
        dl1 = _mv(R1.transpose(-1, -2), d)
        dl2 = _mv(R2.transpose(-1, -2), -d)
        s1 = v1c[0] * dl1[:, 0:1] + v1c[1] * dl1[:, 1:2] + v1c[2] * dl1[:, 2:3]
        s2 = v2c[0] * dl2[:, 0:1] + v2c[1] * dl2[:, 1:2] + v2c[2] * dl2[:, 2:3]
        a = p1 + _mv(R1, _rows(v1, torch.argmax(s1, -1)))
        b = p2 + _mv(R2, _rows(v2, torch.argmax(s2, -1)))
        return a - b, torch.cat([a, b], -1)

    return support


def _gjk(sup, p1, R1, v1c, p2, R2, v2c):
    """GJK distance loop.  Returns (S (N, 4, 3) simplex, W (N, 4, 6)
    witnesses, nsimp (N,), dist2 to the origin, lam (N, 4), intersect)."""
    dtype, dev = p1.dtype, p1.device
    N = p1.shape[0]
    c1 = torch.stack([c.mean(-1) for c in v1c], -1)
    c2 = torch.stack([c.mean(-1) for c in v2c], -1)
    d0 = (p1 + _mv(R1, c1)) - (p2 + _mv(R2, c2))
    ex = torch.tensor([1.0, 0, 0], dtype=dtype, device=dev)
    d0 = torch.where((torch.linalg.vector_norm(d0, dim=-1) < 1e-12)[:, None], ex, d0)
    s0, ws0 = sup(-d0)

    S = torch.zeros(N, 4, 3, dtype=dtype, device=dev)
    W = torch.zeros(N, 4, 6, dtype=dtype, device=dev)
    S[:, 0] = s0
    W[:, 0] = ws0
    eps = torch.finfo(dtype).eps
    scale2 = torch.clamp((s0 * s0).sum(-1), min=1.0)
    slots = torch.arange(4, device=dev)

    n = torch.ones(N, dtype=torch.int64, device=dev)
    v = s0
    lam = torch.zeros(N, 4, dtype=dtype, device=dev)
    lam[:, 0] = 1.0
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    intersect = torch.zeros(N, dtype=torch.bool, device=dev)
    iters = 13 if dtype == torch.float32 else GJK_ITERS
    for _ in range(iters):
        s, ws = sup(-v)
        # no closer support along -v: converged (separated)
        vv = _dot(v, v)
        no_progress = vv - _dot(v, s) < 64 * eps * torch.clamp(vv, min=1.0)
        stop = done | no_progress
        if bool(stop.all()):
            break       # every pair frozen: the remaining iterations keep all
        # append s at the first free slot
        at = (slots[None] == torch.clamp(n, max=3)[:, None])[:, :, None]
        S2 = torch.where(at, s[:, None], S)
        W2 = torch.where(at, ws[:, None], W)
        n2 = torch.clamp(n + 1, max=4)
        lam2 = _closest_barycentric(S2, n2)
        v2 = (lam2[:, :, None] * S2).sum(1)
        # touching when the closest point reaches the origin (relative to
        # the shape scale), or when a full simplex has all four weights
        # positive (it contains the origin)
        inter2 = (_dot(v2, v2) < 1e-16 * scale2) | (lam2 > 0).all(-1)
        # keep the positive-weight vertices at the front, in order
        keep = lam2 > 0
        dest = torch.cumsum(keep.to(torch.int64), -1) - 1
        oh = ((dest[:, :, None] == slots[None, None]) & keep[:, :, None]).to(dtype)
        ohT = oh.transpose(-1, -2)
        S3 = ohT @ S2
        W3 = ohT @ W2
        lam3 = (ohT @ lam2[:, :, None])[:, :, 0]
        n3 = keep.sum(-1)
        st, st3 = stop[:, None], stop[:, None, None]
        S = torch.where(st3, S, S3)
        W = torch.where(st3, W, W3)
        n = torch.where(stop, n, n3)
        v = torch.where(st, v, v2)
        lam = torch.where(st, lam, lam3)
        done = torch.where(stop, done, stop | inter2)
        intersect = torch.where(stop, intersect, intersect | inter2)
    return S, W, n, _dot(v, v), lam, intersect


def _solve3(G, b):
    """Closed-form (cofactor) solve of 3x3 systems G (N, 3, 3) x = b (N, 3)."""
    g = lambda i, j: G[:, i, j]
    c00 = g(1, 1) * g(2, 2) - g(1, 2) * g(2, 1)
    c01 = g(1, 2) * g(2, 0) - g(1, 0) * g(2, 2)
    c02 = g(1, 0) * g(2, 1) - g(1, 1) * g(2, 0)
    det = g(0, 0) * c00 + g(0, 1) * c01 + g(0, 2) * c02
    adj = torch.stack([
        torch.stack([c00, g(0, 2) * g(2, 1) - g(0, 1) * g(2, 2),
                     g(0, 1) * g(1, 2) - g(0, 2) * g(1, 1)], -1),
        torch.stack([c01, g(0, 0) * g(2, 2) - g(0, 2) * g(2, 0),
                     g(0, 2) * g(1, 0) - g(0, 0) * g(1, 2)], -1),
        torch.stack([c02, g(0, 1) * g(2, 0) - g(0, 0) * g(2, 1),
                     g(0, 0) * g(1, 1) - g(0, 1) * g(1, 0)], -1),
    ], -2)
    return _mv(adj, b) / det[:, None]


# support subsets of the 4-slot simplex in bitmask order 1..15, grouped by
# size; the closest-point solve runs each group as one batch
_SUBSETS = [tuple(i for i in range(4) if (mask >> i) & 1) for mask in range(1, 16)]
_GROUPS = {k: [ids for ids in _SUBSETS if len(ids) == k] for k in (1, 2, 3, 4)}
# the 16 3x3 minors of the 4x4 Cramer expansion: (row r, column col) removed
_MINORS = [(r, col) for col in range(4) for r in range(4)]


def _det3(M):
    """Cofactor-expanded determinants of (..., 3, 3)."""
    m = lambda i, j: M[..., i, j]
    return (m(0, 0) * (m(1, 1) * m(2, 2) - m(1, 2) * m(2, 1))
            - m(0, 1) * (m(1, 0) * m(2, 2) - m(1, 2) * m(2, 0))
            + m(0, 2) * (m(1, 0) * m(2, 1) - m(1, 1) * m(2, 0)))


def _subset_weights(g, k):
    """Unnormalized weights (N, G, k) of the equality-constrained closest
    point of every size-k subset (G of them, bitmask order): the closed-form
    solve of G lam = 1 on the Gram scalars g (N, 4, 4)."""
    ids = torch.tensor(_GROUPS[k], device=g.device)          # (G, k)
    if k == 1:
        return torch.ones(g.shape[0], ids.shape[0], 1, dtype=g.dtype, device=g.device)
    gg = lambda a, b: g[:, ids[:, a], ids[:, b]]              # (N, G)
    if k == 2:
        return torch.stack([gg(1, 1) - gg(0, 1), gg(0, 0) - gg(0, 1)], -1)
    if k == 3:
        A, B, C = gg(0, 0), gg(0, 1), gg(0, 2)
        D, E = gg(1, 1), gg(1, 2)
        F = gg(2, 2)
        return torch.stack([
            (D * F - E * E) - (B * F - C * E) + (B * E - C * D),
            -(B * F - C * E) + (A * F - C * C) - (A * E - B * C),
            (B * E - C * D) - (A * E - B * C) + (A * D - B * B),
        ], -1)
    # k == 4: Cramer with a right-hand side of ones, expanded along the
    # replaced column: lam_col = sum_r (-1)^(r+col) det(minor(r, col))
    rows = torch.tensor([[x for x in range(4) if x != r] for r, _ in _MINORS], device=g.device)
    cols = torch.tensor([[c for c in range(4) if c != col] for _, col in _MINORS],
                        device=g.device)
    minors = _det3(g[:, rows[:, :, None], cols[:, None, :]]).reshape(-1, 4, 4)  # (N, col, r)
    sign = torch.tensor([[(-1.0) ** (r + col) for r in range(4)] for col in range(4)],
                        dtype=g.dtype, device=g.device)
    terms = sign * minors
    lam = terms[..., 0]
    for r in range(1, 4):
        lam = lam + terms[..., r]
    return lam[:, None]                                         # (N, 1, 4)


def _closest_barycentric(S, n):
    """Barycentric weights (N, 4) of the point of conv(S[:n]) closest to the
    origin: every support subset's equality-constrained solution (closed
    form on the Gram scalars g_ij = S_i.S_j + 1), keeping the best feasible
    one in bitmask order."""
    dtype, dev = S.dtype, S.device
    N = S.shape[0]
    finfo = torch.finfo(dtype)
    reps = 64 * finfo.eps
    feps = finfo.eps ** 0.5
    g = (S[:, :, None, :] * S[:, None, :, :]).sum(-1) + 1.0    # (N, 4, 4)

    cand = {}
    for k in (1, 2, 3, 4):
        lams = _subset_weights(g, k)                           # (N, G, k)
        ssum = lams[..., 0]
        for c in range(1, k):
            ssum = ssum + lams[..., c]
        denom = torch.where(torch.abs(ssum) < reps, reps, ssum)
        lam_n = lams / denom[..., None]
        maxid = torch.tensor([max(ids) for ids in _GROUPS[k]], device=dev)
        feas = (maxid[None] < n[:, None]) & ((lam_n >= -feps) & torch.isfinite(lam_n)).all(-1)
        lam_full = torch.zeros(N, len(_GROUPS[k]), 4, dtype=dtype, device=dev)
        lam_full.scatter_(2, torch.tensor(_GROUPS[k], device=dev).expand(N, -1, -1), lam_n)
        pt = lam_full[..., 0:1] * S[:, None, 0]
        for i in range(1, 4):
            pt = pt + lam_full[..., i:i + 1] * S[:, None, i]
        d2 = (pt * pt).sum(-1)
        for gi, ids in enumerate(_GROUPS[k]):
            cand[ids] = (feas[:, gi], d2[:, gi], lam_full[:, gi])

    best_d2 = torch.full((N,), torch.inf, dtype=dtype, device=dev)
    best_lam = torch.zeros(N, 4, dtype=dtype, device=dev)
    best_lam[:, 0] = 1.0
    for ids in _SUBSETS:
        feas, d2, lam_full = cand[ids]
        better = feas & (d2 < best_d2 * (1 - 4 * finfo.eps) - finfo.tiny)
        best_d2 = torch.where(better, d2, best_d2)
        best_lam = torch.where(better[:, None], lam_full, best_lam)
    return torch.clamp(best_lam, min=0.0)


def _dir_penetration(p1, R1, v1c, p2, R2, v2c, dtype):
    """Minimal-translation penetration by a support sweep over the fixed
    direction set: exact for any direction in the set, so the error is
    bounded by its angular resolution.  Returns (depth (N,), normal (N, 3)
    from geom1 toward geom2, pos (N, 3))."""
    D = torch.as_tensor(_dir_set_np(N_PEN_DIRS), dtype=dtype, device=p1.device)
    dl1 = D @ R1                                     # (N, ND, 3) rows R1^T d
    dl2 = D @ R2
    s1 = (dl1[:, :, 0:1] * v1c[0][:, None] + dl1[:, :, 1:2] * v1c[1][:, None]
          + dl1[:, :, 2:3] * v1c[2][:, None])
    s2 = (dl2[:, :, 0:1] * v2c[0][:, None] + dl2[:, :, 1:2] * v2c[1][:, None]
          + dl2[:, :, 2:3] * v2c[2][:, None])
    i1 = torch.argmax(s1, -1)                        # (N, ND) max of A along +d
    i2 = torch.argmin(s2, -1)                        # min of B along +d
    maxA = s1.max(-1).values + p1 @ D.T
    minB = s2.min(-1).values + p2 @ D.T
    h = maxA - minB                                  # overlap extent along d
    best = torch.argmin(h, -1)
    N = p1.shape[0]
    rows = torch.arange(N, device=p1.device)
    depth = -h[rows, best]
    n = D[best]
    va = torch.stack([c[rows, i1[rows, best]] for c in v1c], -1)
    vb = torch.stack([c[rows, i2[rows, best]] for c in v2c], -1)
    a = p1 + _mv(R1, va)
    b = p2 + _mv(R2, vb)
    return depth, n, 0.5 * (a + b)


def _normals_dists(faces, verts, fvalid):
    """Unit normals (N, F, 3) and origin distances (N, F) of the polytope's
    faces; degenerate or invalid faces get distance +inf."""
    a = _rows(verts, faces[..., 0])
    b = _rows(verts, faces[..., 1])
    c = _rows(verts, faces[..., 2])
    nr = torch.linalg.cross(b - a, c - a, dim=-1)
    nn = torch.linalg.vector_norm(nr, dim=-1, keepdim=True)
    nr = nr / torch.clamp(nn, min=1e-30)
    dist = (nr * a).sum(-1)
    bad = (nn[..., 0] < 1e-15) | ~fvalid
    return nr, torch.where(bad, torch.inf, dist)


def _epa(sup, S, W, nsimp, dtype):
    """Expanding polytope from the GJK simplex (the origin inside or on the
    Minkowski difference).  Returns (depth (N,) negative, normal (N, 3) from
    geom1 toward geom2, pos (N, 3))."""
    dev = S.device
    N = S.shape[0]
    eps = torch.finfo(dtype).eps
    # initial tetrahedron: the GJK simplex, missing slots filled with axis
    # supports; a flat one rebuilt from the axis supports alone
    dirs = torch.tensor([[1.0, 0, 0], [0, 1, 0], [0, 0, 1], [-1.0, -1, -1]],
                        dtype=dtype, device=dev)
    ax = [sup(dirs[k].expand(N, 3)) for k in range(4)]
    Sax = torch.stack([a[0] for a in ax], 1)
    Wax = torch.stack([a[1] for a in ax], 1)
    use = (torch.arange(4, device=dev)[None] >= nsimp[:, None])[:, :, None]
    Sfill = torch.where(use, Sax, S)
    Wfill = torch.where(use, Wax, W)
    vol = torch.linalg.det(Sfill[:, 1:] - Sfill[:, :1])
    degen = (torch.abs(vol) < (eps * 64) ** 3)[:, None, None]
    Sfill = torch.where(degen, Sax, Sfill)
    Wfill = torch.where(degen, Wax, Wfill)
    # outward winding of the faces below: det(S1-S0, S2-S0, S3-S0) < 0
    vol = torch.linalg.det(Sfill[:, 1:] - Sfill[:, :1])
    swap = (vol > 0)[:, None]
    S0 = torch.where(swap, Sfill[:, 1], Sfill[:, 0])
    S1 = torch.where(swap, Sfill[:, 0], Sfill[:, 1])
    W0 = torch.where(swap, Wfill[:, 1], Wfill[:, 0])
    W1 = torch.where(swap, Wfill[:, 0], Wfill[:, 1])

    verts = torch.zeros(N, NVERT, 3, dtype=dtype, device=dev)
    wits = torch.zeros(N, NVERT, 6, dtype=dtype, device=dev)
    verts[:, 0], verts[:, 1], verts[:, 2:4] = S0, S1, Sfill[:, 2:4]
    wits[:, 0], wits[:, 1], wits[:, 2:4] = W0, W1, Wfill[:, 2:4]
    faces = torch.zeros(N, EPA_FACES, 3, dtype=torch.int64, device=dev)
    faces[:, :4] = torch.tensor(_FACES0, device=dev)
    fvalid = torch.zeros(N, EPA_FACES, dtype=torch.bool, device=dev)
    fvalid[:, :4] = True
    nvert = torch.full((N,), 4, dtype=torch.int64, device=dev)
    done = torch.zeros(N, dtype=torch.bool, device=dev)

    F = EPA_FACES
    nE = 3 * F
    vslots = torch.arange(NVERT, device=dev)
    fslots = torch.arange(F, device=dev)
    uniq_pad = NVERT * NVERT + torch.arange(nE, device=dev)
    rows = torch.arange(N, device=dev)
    for _ in range(EPA_ITERS):
        nr, dist = _normals_dists(faces, verts, fvalid)
        fi = torch.argmin(dist, -1)
        d = nr[rows, fi]
        s, ws = sup(d)
        growth = _dot(s, d) - dist[rows, fi]
        stop = done | (growth < 512 * eps)
        if bool(stop.all()):
            break       # every pair frozen: the remaining iterations keep all

        at = (vslots[None] == nvert[:, None])[:, :, None]
        verts2 = torch.where(at, s[:, None], verts)
        wits2 = torch.where(at, ws[:, None], wits)
        a = _rows(verts, faces[..., 0])
        visible = ((nr * (s[:, None] - a)).sum(-1) > 64 * eps) & fvalid
        # horizon: edges of visible faces whose twin is not visible, i.e.
        # whose undirected key appears once among the visible edges
        edges = torch.cat([faces[..., [0, 1]], faces[..., [1, 2]], faces[..., [2, 0]]], 1)
        evis = torch.cat([visible] * 3, 1)
        ekey = (torch.minimum(edges[..., 0], edges[..., 1]) * NVERT
                + torch.maximum(edges[..., 0], edges[..., 1]))
        skey = torch.where(evis, ekey, uniq_pad[None])
        sk, order = torch.sort(skey, dim=-1, stable=True)
        dup = torch.zeros_like(evis)
        dup[:, 1:] = sk[:, 1:] == sk[:, :-1]
        dup[:, :-1] |= sk[:, :-1] == sk[:, 1:]
        horizon = evis & ~torch.empty_like(dup).scatter_(1, order, dup)

        fvalid2 = fvalid & ~visible
        slot_order = torch.argsort(fvalid2.to(torch.int8), dim=-1, stable=True)  # free slots first
        hor_order = torch.argsort((~horizon).to(torch.int8), dim=-1, stable=True)
        nhor = horizon.sum(-1)
        he = _rows(edges, hor_order[:, :F])
        new_faces = torch.stack([he[..., 0], he[..., 1], nvert[:, None].expand(N, F)], -1)
        take = fslots[None] < nhor[:, None]
        slots = slot_order[:, :F]
        old = _rows(faces, slots)
        faces2 = faces.clone()
        faces2[rows[:, None], slots] = torch.where(take[..., None], new_faces, old)
        fvalid3 = fvalid2.clone()
        fvalid3[rows[:, None], slots] = take | _rows(fvalid2, slots)

        st, st3 = stop[:, None], stop[:, None, None]
        verts = torch.where(st3, verts, verts2)
        wits = torch.where(st3, wits, wits2)
        nvert = torch.where(stop, nvert, torch.clamp(nvert + 1, max=NVERT - 1))
        faces = torch.where(st3, faces, faces2)
        fvalid = torch.where(st, fvalid, fvalid3)
        done = stop

    nr, dist = _normals_dists(faces, verts, fvalid)
    fi = torch.argmin(dist, -1)
    n = nr[rows, fi]
    df = dist[rows, fi]
    # witness: the origin projected on the closest face, barycentric
    # combination of its vertices' witness pairs
    fv = faces[rows, fi]                             # (N, 3)
    tri = _rows(verts, fv)
    twit = _rows(wits, fv)
    lam = _tri_barycentric(tri, n * df[:, None])
    wa = (lam[:, :, None] * twit[:, :, :3]).sum(1)
    wb = (lam[:, :, None] * twit[:, :, 3:]).sum(1)
    return -df, n, 0.5 * (wa + wb)


def _tri_barycentric(tri, p):
    """Clamped barycentric coordinates (N, 3) of p (N, 3) in the triangles
    tri (N, 3, 3)."""
    dtype = tri.dtype
    T = tri - p[:, None]
    eye = torch.eye(3, dtype=dtype, device=tri.device)
    G = T @ T.transpose(-1, -2) + 1.0 + 64 * torch.finfo(dtype).eps * eye
    lam = torch.clamp(_solve3(G, torch.ones_like(p)), min=0.0)
    s = lam.sum(-1)
    return lam / torch.where(s < 1e-13, 1e-13, s)[:, None]
