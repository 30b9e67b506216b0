"""Multi-point contact manifolds for the pairs MuJoCo resolves with its
native convex collider (at least one mesh geom): the float64 single-env
path's equivalent of MuJoCo's "nativeccd" manifold.

The port of `gym_so100_tpu/ops/collision/manifold.py`.  JAX vmaps the
per-pair function over the pair table and runs its two polygon loops as
`lax.scan`s over the padded polygon size; here the pairs are a leading axis
N and the loops are Python loops that stop after the longest polygon of the
batch (the padded steps keep every pair's state).  Only the pairs whose
bounding spheres come close run GJK/EPA, and only those whose EPA contact
is active are expanded: no other pair's contacts are read.

Expansion rules of the EPA result (reverse-engineered from MuJoCo 3.10 by
the JAX package):
* a hull face is aligned with the contact normal when its outward normal
  lies within ALIGN_ANGLE of (+/-) the EPA normal;
* both faces aligned: clip geom2's face polygon against geom1's (projected
  along the normal); the points are the clipped polygon's vertices on
  geom2's face plane, shifted by -dist/2 along the normal; at most 4 kept;
* one face aligned: the other geom's support edge, when it lies within
  ALIGN_ANGLE of the contact plane, clipped against the aligned face
  polygon (2 points, shifted half the depth toward the other geom);
  otherwise one point;
* neither aligned: the single EPA witness midpoint.
All points of a pair share the EPA depth and normal.  The geometry is the
exact (non-decimated) convex hulls and their coplanar-merged face polygons
that `build_model(ccd_manifolds=True)` packs.
"""

from __future__ import annotations

import math

import torch

from ...models.scene import Model, static_tables
from . import gjk as gjk_mod

ALIGN_ANGLE = 1.6e-3    # rad, face/edge alignment gate
MAXCON = 4              # manifold points per pair
CLIP_SLOTS = 100        # the intersection of two <= 49-gons has <= 98 vertices


_rows = gjk_mod._rows


def _live_edges(na):
    """Edge steps that can change a result: the masks are prefixes, so the
    steps past the longest polygon keep every pair's state."""
    return int(na.max()) if na.numel() else 0


def _clip_polygon(a2d, na_mask, b2d, nb_mask):
    """Sutherland-Hodgman: clip polygons b (N, Pb, 2), mask nb_mask, by the
    convex polygons a (N, Pa, 2) (CCW, mask na_mask; padded edges skipped).
    Returns (pts (N, CLIP_SLOTS, 2), valid (N, CLIP_SLOTS))."""
    N, Pa, _ = a2d.shape
    dtype, dev = a2d.dtype, a2d.device
    CS = CLIP_SLOTS
    pts = torch.zeros(N, CS, 2, dtype=dtype, device=dev)
    pts[:, :b2d.shape[1]] = b2d
    valid = torch.zeros(N, CS, dtype=torch.bool, device=dev)
    valid[:, :nb_mask.shape[1]] = nb_mask
    na = na_mask.sum(-1)
    idx = torch.arange(CS, device=dev)
    rows = torch.arange(N, device=dev)

    for i in range(_live_edges(na)):
        j = torch.where(i + 1 >= na, 0, i + 1)
        ea = a2d[:, i]
        ed = a2d[rows, j] - ea
        live = na_mask[:, i]
        # signed distance to the inside (left of the CCW edge)
        h = ((pts[..., 0] - ea[:, 0:1]) * ed[:, 1:2]
             - (pts[..., 1] - ea[:, 1:2]) * ed[:, 0:1])
        inside = h <= 0.0
        # one pass over the current polygon: each vertex k emits itself if
        # inside, then the crossing of edge (k, k2) if it straddles
        cnt = valid.sum(-1)
        k2 = torch.where(idx[None] + 1 >= cnt[:, None], 0, idx[None] + 1)
        pk2 = pts.gather(1, k2[..., None].expand(N, CS, 2))
        hk2 = h.gather(1, k2)
        denom = h - hk2
        t = h / torch.where(torch.abs(denom) < 1e-300, 1e-300, denom)
        cross_pt = pts + t[..., None] * (pk2 - pts)
        keep_v = valid & inside
        keep_x = valid & (idx[None] < cnt[:, None]) & ((h <= 0.0) != (hk2 <= 0.0))

        # compact [vertex k, crossing k, ...] by prefix sums; rows past the
        # buffer drop (a scatter into a spare last slot)
        emit = torch.stack([keep_v, keep_x], -1).reshape(N, 2 * CS)
        src = torch.stack([pts, cross_pt], 2).reshape(N, 2 * CS, 2)
        dest = torch.cumsum(emit.to(torch.int64), -1) - 1
        dest = torch.where(emit & (dest < CS), dest, CS)
        newpts = torch.zeros(N, CS + 1, 2, dtype=dtype, device=dev).scatter_(
            1, dest[..., None].expand(N, 2 * CS, 2), src)[:, :CS]
        newvalid = torch.zeros(N, CS + 1, dtype=torch.bool, device=dev).scatter_(
            1, dest, emit)[:, :CS]
        pts = torch.where(live[:, None, None], newpts, pts)
        valid = torch.where(live[:, None], newvalid, valid)
    return pts, valid


def _reduce4(pts2d, valid, pts3d):
    """At most 4 points per pair: all of them when <= 4 are valid, in clip
    order, else a max-spread subset (duplicates deactivated)."""
    N, CS, _ = pts2d.shape
    dev = pts2d.device
    k = valid.sum(-1)
    x, y = pts2d[..., 0], pts2d[..., 1]

    i0 = torch.argmax(torch.where(valid, x * 1e3 + y, -torch.inf), -1)
    p0 = _rows(pts2d, i0)
    d1 = torch.where(valid, ((pts2d - p0[:, None]) ** 2).sum(-1), -torch.inf)
    i1 = torch.argmax(d1, -1)
    e = _rows(pts2d, i1) - p0
    cr = (x - p0[:, 0:1]) * e[:, 1:2] - (y - p0[:, 1:2]) * e[:, 0:1]
    i2 = torch.argmax(torch.where(valid, cr, -torch.inf), -1)
    i3 = torch.argmax(torch.where(valid, -cr, -torch.inf), -1)
    sel = torch.stack([i0, i1, i2, i3], -1)

    # the first 4 valid slots in clip order
    order_idx = torch.cumsum(valid.to(torch.int64), -1) - 1
    slot = torch.where(valid & (order_idx < MAXCON), order_idx, MAXCON)
    src = torch.arange(CS, device=dev).expand(N, CS)
    firstk = torch.zeros(N, MAXCON + 1, dtype=torch.int64, device=dev).scatter_(
        1, slot, src)[:, :MAXCON]
    use_first = k <= MAXCON
    sel = torch.where(use_first[:, None], firstk, sel)
    slots = torch.arange(MAXCON, device=dev)
    act = torch.where(use_first[:, None], slots[None] < k[:, None], True)
    same = torch.zeros(N, MAXCON, dtype=torch.bool, device=dev)
    for a in range(MAXCON):
        for b in range(a):
            same[:, a] |= ~use_first & (sel[:, a] == sel[:, b])
    return _rows(pts3d, sel), act & ~same


def _clip_segment(s0, s1, a2d, na_mask, t1, t2):
    """Clip the 3D segments (s0, s1) (N, 3) against the convex polygons a
    (2D, CCW) in the (t1, t2) plane.  Returns ((N, 2, 3) points, (N, 2)
    valid)."""
    N, Pa, _ = a2d.shape
    dev = a2d.device
    dot = lambda u, v: (u * v).sum(-1)
    p0 = torch.stack([dot(s0, t1), dot(s0, t2)], -1)
    p1 = torch.stack([dot(s1, t1), dot(s1, t2)], -1)
    na = na_mask.sum(-1)
    rows = torch.arange(N, device=dev)
    lo = torch.zeros(N, dtype=p0.dtype, device=dev)
    hi = torch.ones(N, dtype=p0.dtype, device=dev)
    ok = torch.ones(N, dtype=torch.bool, device=dev)
    for i in range(_live_edges(na)):
        j = torch.where(i + 1 >= na, 0, i + 1)
        ea = a2d[:, i]
        ed = a2d[rows, j] - ea
        h0 = (p0[:, 0] - ea[:, 0]) * ed[:, 1] - (p0[:, 1] - ea[:, 1]) * ed[:, 0]
        h1 = (p1[:, 0] - ea[:, 0]) * ed[:, 1] - (p1[:, 1] - ea[:, 1]) * ed[:, 0]
        # inside: h <= 0; along x(t) = p0 + t (p1 - p0), h(t) is linear
        dh = h1 - h0
        t_cross = h0 / torch.where(torch.abs(dh) < 1e-300, 1e-300, dh)
        lo2 = torch.where((h0 > 0) & (h1 <= 0), torch.maximum(lo, t_cross), lo)
        hi2 = torch.where((h0 <= 0) & (h1 > 0), torch.minimum(hi, t_cross), hi)
        ok2 = ok & ~((h0 > 0) & (h1 > 0))
        live = na_mask[:, i]
        lo = torch.where(live, lo2, lo)
        hi = torch.where(live, hi2, hi)
        ok = torch.where(live, ok2, ok)
    ok = ok & (lo <= hi)
    pa = s0 + lo[:, None] * (s1 - s0)
    pb = s0 + hi[:, None] * (s1 - s0)
    return torch.stack([pa, pb], 1), torch.stack([ok, ok], 1)


def _support_edge(w, nv, score):
    """The two highest-scoring valid vertices of each hull: (v0, v1, unit
    edge direction)."""
    V = w.shape[1]
    sc = torch.where(torch.arange(V, device=w.device)[None] < nv[:, None], score, -torch.inf)
    i0 = torch.argmax(sc, -1)
    i1 = torch.argmax(sc.scatter(1, i0[:, None], -torch.inf), -1)
    v0, v1 = _rows(w, i0), _rows(w, i1)
    e = v1 - v0
    return v0, v1, e / torch.clamp(torch.linalg.vector_norm(e, dim=-1), min=1e-30)[:, None]


def _pair_manifold(w1, nv1, pn1, pvid1, pnv1, w2, nv2, pn2, pvid2, pnv2, core):
    """Expand each pair's EPA result into a <= 4-point manifold.

    w: (N, Vmax, 3) world-frame hull vertices (padded by repeating v0); nv:
    (N,) vertex counts; pn: (N, Pmax, 3) world-frame polygon normals; pvid:
    (N, Pmax, PVmax) polygon vertex ids; pnv: (N, Pmax) polygon sizes;
    core: the dict of gjk._convex_core."""
    dtype, dev = w1.dtype, w1.device
    N = w1.shape[0]
    n = core["normal"]
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1), min=1e-30)[:, None]
    depth = core["depth"]
    cos_tol = math.cos(ALIGN_ANGLE)
    sin_tol = math.sin(ALIGN_ANGLE)
    dot = lambda u, v: (u * v).sum(-1)

    # contact-plane basis
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=dev)
    ref = torch.where((torch.abs(n[:, 0]) < 0.9)[:, None], ex, ey)
    t1 = torch.linalg.cross(n, ref, dim=-1)
    t1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1), min=1e-30)[:, None]
    t2 = torch.linalg.cross(n, t1, dim=-1)

    # best faces
    s1 = torch.where(pnv1 > 0, dot(pn1, n[:, None]), -torch.inf)
    f1 = torch.argmax(s1, -1)
    aligned1 = _rows(s1, f1) >= cos_tol
    s2 = torch.where(pnv2 > 0, -dot(pn2, n[:, None]), -torch.inf)
    f2 = torch.argmax(s2, -1)
    aligned2 = _rows(s2, f2) >= cos_tol

    # face polygons in world coordinates
    PV = pvid1.shape[2]
    pv = torch.arange(PV, device=dev)[None]
    m1 = pv < _rows(pnv1, f1)[:, None]
    poly1 = _rows(w1, torch.clamp(_rows(pvid1, f1), 0, w1.shape[1] - 1).long())
    m2 = pv < _rows(pnv2, f2)[:, None]
    poly2 = _rows(w2, torch.clamp(_rows(pvid2, f2), 0, w2.shape[1] - 1).long())
    to2d = lambda poly: torch.stack([dot(poly, t1[:, None]), dot(poly, t2[:, None])], -1)
    a2d, b2d = to2d(poly1), to2d(poly2)

    # case A: face-face clip, points on geom2's face plane
    pts2d, cvalid = _clip_polygon(a2d, m1, b2d, m2)
    n2w = _rows(pn2, f2)
    q3 = pts2d[..., 0:1] * t1[:, None] + pts2d[..., 1:2] * t2[:, None]
    nn2 = dot(n, n2w)
    denom = torch.where(torch.abs(nn2) < 1e-12, 1e-12, nn2)
    lam = dot(poly2[:, :1] - q3, n2w[:, None]) / denom[:, None]
    pts3d = q3 + lam[..., None] * n[:, None]
    ff_pts, ff_act = _reduce4(pts2d, cvalid, pts3d)
    half = (0.5 * depth)[:, None, None] * n[:, None]
    ff_pts = ff_pts - half
    ff_ok = cvalid.sum(-1) > 0

    # case B: geom2's support edge on geom1's face
    b0, b1, eBn = _support_edge(w2, nv2, -dot(w2, n[:, None]))
    edge2_ok = torch.abs(dot(eBn, n)) <= sin_tol
    e2_pts, e2_act = _clip_segment(b0, b1, a2d, m1, t1, t2)
    e2_pts = e2_pts - half

    # case C: geom1's support edge on geom2's face
    a0, a1, eAn = _support_edge(w1, nv1, dot(w1, n[:, None]))
    edge1_ok = torch.abs(dot(eAn, n)) <= sin_tol
    e1_pts, e1_act = _clip_segment(a0, a1, b2d, m2, t1, t2)
    e1_pts = e1_pts + half

    # select
    z2 = torch.zeros(N, 2, 3, dtype=dtype, device=dev)
    f2b = torch.zeros(N, 2, dtype=torch.bool, device=dev)
    single = torch.cat([core["pos"][:, None], torch.zeros(N, 3, 3, dtype=dtype, device=dev)], 1)
    single_act = torch.tensor([True, False, False, False], device=dev).expand(N, 4)
    e2_pts4, e2_act4 = torch.cat([e2_pts, z2], 1), torch.cat([e2_act, f2b], 1)
    e1_pts4, e1_act4 = torch.cat([e1_pts, z2], 1), torch.cat([e1_act, f2b], 1)
    use_ff = aligned1 & aligned2 & ff_ok
    use_e2 = aligned1 & ~aligned2 & edge2_ok & e2_act4[:, 0]
    use_e1 = ~aligned1 & aligned2 & edge1_ok & e1_act4[:, 0]
    pick = lambda ff, e2, e1, one: torch.where(
        use_ff.reshape((N,) + (1,) * (ff.dim() - 1)), ff,
        torch.where(use_e2.reshape((N,) + (1,) * (ff.dim() - 1)), e2,
                    torch.where(use_e1.reshape((N,) + (1,) * (ff.dim() - 1)), e1, one)))
    pts = pick(ff_pts, e2_pts4, e1_pts4, single)
    act = pick(ff_act, e2_act4, e1_act4, single_act) & core["active"][:, None]
    return dict(pos=pts, normal=n[:, None].expand(N, MAXCON, 3),
                depth=depth[:, None].expand(N, MAXCON), active=act)


def _exact_radius(m: Model):
    """(GX,) each exact hull's largest vertex distance from its geom
    origin."""
    return torch.stack([torch.linalg.vector_norm(m.exact_verts[i, :n], dim=-1).max()
                        for i, n in enumerate(m.exact_nvert)])


def ccd_chunk(m: Model, d, dtype):
    """Manifold contacts of every nativeccd pair (m.pairs.ccd).  Returns
    (pos (P*4, 3), normal (P*4, 3), depth (P*4,), active (P*4,), pair_ids
    (P*4,)) for the narrowphase's selection."""
    pairs = m.pairs.ccd            # ((g1, g2, flat_pair_id, slot1, slot2), ...)
    P = len(pairs)
    dev = d.geom_xpos.device
    g1 = [p[0] for p in pairs]
    g2 = [p[1] for p in pairs]
    s1 = [p[3] for p in pairs]
    s2 = [p[4] for p in pairs]
    ev = m.exact_verts.to(dtype)                     # (GX, Vmax, 3) geom frame
    pnl = m.exact_polyn.to(dtype)                    # (GX, Pmax, 3)
    nv = torch.tensor(m.exact_nvert, dtype=torch.int64, device=dev)
    pvid, pnv = m.exact_polyvid, m.exact_polynv

    # an inactive pair's contacts are never selected or read, so only the
    # pairs whose bounding spheres (about the geom origins) come within
    # 1 um run GJK/EPA, and only the active ones are expanded; the others
    # stay zero and inactive
    radius = static_tables(m, "exact_radius", _exact_radius).to(dtype)
    p1, p2 = d.geom_xpos[g1], d.geom_xpos[g2]
    near = (torch.linalg.vector_norm(p1 - p2, dim=-1)
            <= radius[s1] + radius[s2] + 1e-6).nonzero()[:, 0].tolist()
    out = dict(pos=p1.new_zeros(P, MAXCON, 3), normal=p1.new_zeros(P, MAXCON, 3),
               depth=p1.new_zeros(P, MAXCON),
               active=torch.zeros(P, MAXCON, dtype=torch.bool, device=dev))
    ia, ib = [s1[i] for i in near], [s2[i] for i in near]
    ga, gb = [g1[i] for i in near], [g2[i] for i in near]
    p1, R1, p2, R2 = p1[near], d.geom_xmat[ga], p2[near], d.geom_xmat[gb]
    v1, v2 = ev[ia], ev[ib]
    core = gjk_mod._convex_core(p1, R1, v1.unbind(-1), p2, R2, v2.unbind(-1), 0.0)
    act = core["active"].nonzero()[:, 0]
    if act.numel():
        sel = act.tolist()
        ja, jb = [ia[i] for i in sel], [ib[i] for i in sel]
        R1s, R2s = R1[act], R2[act]
        part = _pair_manifold(
            v1[act] @ R1s.transpose(-1, -2) + p1[act, None], nv[ja],
            pnl[ja] @ R1s.transpose(-1, -2), pvid[ja], pnv[ja],
            v2[act] @ R2s.transpose(-1, -2) + p2[act, None], nv[jb],
            pnl[jb] @ R2s.transpose(-1, -2), pvid[jb], pnv[jb],
            {k: v[act] for k, v in core.items()},
        )
        rows = torch.tensor(near, device=dev)[act]
        for k in out:
            out[k][rows] = part[k]
    pair_ids = torch.tensor([p[2] for p in pairs], dtype=torch.int64,
                            device=dev).repeat_interleave(MAXCON)
    return (
        out["pos"].reshape(P * MAXCON, 3),
        out["normal"].reshape(P * MAXCON, 3),
        out["depth"].reshape(P * MAXCON),
        out["active"].reshape(P * MAXCON),
        pair_ids,
    )
