"""Box-box narrowphase of the single-env engine: SAT over 15 axes and
reference-face clipping.

The port of `gym_so100_tpu/ops/collision/boxbox.py`.  Where JAX vmaps
`box_box` over the static pair table, every function here takes a leading
pair axis N: centers (N, 3), rotations (N, 3, 3) (columns = box axes),
half sizes (N, 3).  Output size is fixed (MAXP = 8 candidate points and an
active mask per pair), with no data-dependent control flow: the clip runs
for all six candidate reference faces and the winner is selected, as in
JAX.  Face-face contact gives the clipped polygon's corners (4 for a box
resting on the table); edge-edge contact one closest-point contact.
"""

from __future__ import annotations

import torch

MAXP = 8  # max contact points per box pair

# prefer face axes over edge axes (avoids flickering between nearly tied
# face and edge axes on resting contact)
_EDGE_FUDGE = 1.05


def _mv(A, v):
    """(N, 3, 3) @ (N, 3) -> (N, 3)."""
    return torch.einsum("nij,nj->ni", A, v)


def _dot(a, b):
    return (a * b).sum(-1)


def box_box(p1, R1, s1, p2, R2, s2, margin=0.0):
    """Collide N box pairs.  Returns dict of pos (N, MAXP, 3), normal (N, 3)
    from box1 toward box2, depth (N, MAXP) (negative = penetrating) and
    active (N, MAXP) bool."""
    dtype, dev = p1.dtype, p1.device
    N = p1.shape[0]
    RT1 = R1.transpose(-1, -2)
    C = RT1 @ R2                      # box2 axes in box1 coords
    t = _mv(RT1, p2 - p1)             # box2 center in box1 coords
    absC = torch.abs(C) + 1e-12

    # SAT, 6 face axes
    sep1 = torch.abs(t) - (s1 + _mv(absC, s2))
    t2 = _mv(C.transpose(-1, -2), t)
    sep2 = torch.abs(t2) - (s2 + _mv(absC.transpose(-1, -2), s1))

    # SAT, 9 edge-edge axes a = e_i x C_j
    zero = torch.zeros(N, dtype=dtype, device=dev)
    edge_seps, edge_axes = [], []
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            comps = [zero, zero, zero]
            comps[i1] = -C[:, i2, j]
            comps[i2] = C[:, i1, j]
            a = torch.stack(comps, -1)
            norm = torch.linalg.vector_norm(a, dim=-1)
            a = a / torch.clamp(norm, min=1e-12)[:, None]
            r1 = s1[:, i1] * torch.abs(a[:, i1]) + s1[:, i2] * torch.abs(a[:, i2])
            aC = torch.einsum("ni,nij->nj", a, C)
            r2 = s2[:, j1] * torch.abs(aC[:, j1]) + s2[:, j2] * torch.abs(aC[:, j2])
            sep = torch.abs(_dot(a, t)) - (r1 + r2)
            # parallel edges give no separating evidence: never selected
            edge_seps.append(torch.where(norm < 1e-9, -torch.inf, sep))
            edge_axes.append(a)
    edge_seps = torch.stack(edge_seps, -1)            # (N, 9)
    edge_axes = torch.stack(edge_axes, 1)             # (N, 9, 3)

    face_seps = torch.cat([sep1, sep2], -1)           # (N, 6)
    separated = torch.maximum(face_seps.max(-1).values,
                              edge_seps.max(-1).values) >= margin
    best_face = torch.argmax(face_seps, -1)
    face_sep = face_seps.gather(1, best_face[:, None])[:, 0]
    best_edge = torch.argmax(edge_seps, -1)
    edge_sep = edge_seps.gather(1, best_edge[:, None])[:, 0]
    use_edge = edge_sep * _EDGE_FUDGE > face_sep

    rows = torch.arange(N, device=dev)
    outs = [_clip_face(ref_box, ax, C, t, s1, s2)
            for ref_box in (0, 1) for ax in range(3)]
    f_pos, f_nrm, f_dep, f_act = (torch.stack([o[k] for o in outs], 1)[rows, best_face]
                                  for k in range(4))
    e_pos, e_nrm, e_dep, e_act = _edge_contact(
        best_edge, edge_axes[rows, best_edge], C, t, s1, s2)

    ue = use_edge
    pos_l = torch.where(ue[:, None, None], e_pos, f_pos)
    normal_l = torch.where(ue[:, None], e_nrm, f_nrm)
    depth = torch.where(ue[:, None], e_dep, f_dep)
    active = torch.where(ue[:, None], e_act, f_act)
    active = active & ~separated[:, None] & (depth < margin)
    pos = p1[:, None] + pos_l @ RT1
    normal = _mv(R1, normal_l)
    return dict(pos=pos, normal=normal, depth=depth, active=active)


def _clip_face(ref_box, ax, C, t, s1, s2):
    """Clip the incident face of the other box against reference face `ax`
    of `ref_box` (static), in box1 coords.  Returns (pos (N, MAXP, 3),
    normal (N, 3), depth (N, MAXP), active (N, MAXP))."""
    dtype, dev = t.dtype, t.device
    N = t.shape[0]
    if ref_box == 0:
        sr, Ri, si, tc = s1, C, s2, t
    else:
        CT = C.transpose(-1, -2)
        sr, Ri, si, tc = s2, CT, s1, -_mv(CT, t)

    # reference face normal +/- e_ax, pointing toward the incident box
    nsign = torch.where(tc[:, ax] >= 0, 1.0, -1.0).to(dtype)
    n_ref = torch.zeros(N, 3, dtype=dtype, device=dev)
    n_ref[:, ax] = nsign

    # incident face: the incident box's face most anti-parallel to n_ref
    dots = torch.einsum("ni,nij->nj", n_ref, Ri)
    inc_ax = torch.argmax(torch.abs(dots), -1)
    inc_sign = -torch.sign(dots.gather(1, inc_ax[:, None])[:, 0])
    inc_sign = torch.where(inc_sign == 0, 1.0, inc_sign)

    e = torch.eye(3, dtype=dtype, device=dev)
    onehot = e[inc_ax]                               # (N, 3)
    u_hot = torch.roll(onehot, 1, -1)                # cyclic next axes
    v_hot = torch.roll(onehot, 2, -1)
    si_n = (si * onehot).sum(-1)
    si_u = (si * u_hot).sum(-1)
    si_v = (si * v_hot).sum(-1)
    face_center = tc + _mv(Ri, (inc_sign * si_n)[:, None] * onehot)
    du = _mv(Ri, si_u[:, None] * u_hot)
    dv = _mv(Ri, si_v[:, None] * v_hot)
    corners = torch.stack([face_center + du + dv, face_center - du + dv,
                           face_center - du - dv, face_center + du - dv], 1)

    # clip against the 4 side planes of the reference face
    u1, u2 = (ax + 1) % 3, (ax + 2) % 3
    poly = torch.cat([corners, torch.zeros(N, MAXP - 4, 3, dtype=dtype, device=dev)], 1)
    valid = torch.zeros(N, MAXP, dtype=torch.bool, device=dev)
    valid[:, :4] = True
    for pl_ax, pl_sign in ((u1, 1.0), (u1, -1.0), (u2, 1.0), (u2, -1.0)):
        poly, valid = _clip_plane(poly, valid, pl_ax, pl_sign, sr[:, pl_ax])

    # depth below the reference plane; the contact point is midway between
    # the incident point and its projection on the reference surface
    depth = nsign[:, None] * poly[:, :, ax] - sr[:, ax:ax + 1]
    pos_work = poly - 0.5 * depth[:, :, None] * n_ref[:, None]
    active = valid & (depth < 0)
    if ref_box == 0:
        return pos_work, n_ref, depth, active
    pos = (C @ pos_work.transpose(-1, -2)).transpose(-1, -2) + t[:, None]
    return pos, -_mv(C, n_ref), depth, active


def _clip_plane(poly, valid, ax, sign, limit):
    """One Sutherland-Hodgman step against sign * x[ax] <= limit (N,) on a
    fixed MAXP-slot vertex ring with a validity mask; kept points are
    compacted to the front in order."""
    N = poly.shape[0]
    dev = poly.device
    n = valid.sum(-1)
    d = sign * poly[:, :, ax] - limit[:, None]       # > 0 outside
    inside = d <= 0

    idx = torch.arange(MAXP, device=dev)
    nxt = torch.where(idx[None] + 1 >= n[:, None], 0, idx[None] + 1)
    d_n = d.gather(1, nxt)
    inside_n = inside.gather(1, nxt)
    poly_n = poly.gather(1, nxt[:, :, None].expand(N, MAXP, 3))

    # edge (i -> next) emits point i if inside, and the crossing if it
    # straddles the plane
    den = d - d_n
    tpar = d / torch.where(torch.abs(den) < 1e-14, 1e-14, den)
    inter = poly + tpar[:, :, None] * (poly_n - poly)
    emit_pt = inside & valid
    emit_ix = (inside ^ inside_n) & valid & (idx[None] < n[:, None])

    cand = torch.stack([poly, inter], 2).reshape(N, 2 * MAXP, 3)
    keep = torch.stack([emit_pt, emit_ix], 2).reshape(N, 2 * MAXP)
    cand = torch.where(keep[:, :, None], cand, 0.0)
    dest = torch.cumsum(keep.to(torch.int64), -1) - 1
    onehot = (dest[:, :, None] == idx[None, None]) & keep[:, :, None]
    out = torch.einsum("nij,nik->njk", onehot.to(cand.dtype), cand)
    return out, idx[None] < keep.sum(-1)[:, None]


def _edge_contact(edge_id, axis, C, t, s1, s2):
    """Closest points between the two penetrating edges: one contact in
    slot 0.  edge_id (N,), axis (N, 3)."""
    dtype, dev = t.dtype, t.device
    N = t.shape[0]
    i = edge_id // 3                                 # box1 edge direction
    j = edge_id % 3                                  # box2 edge direction
    n = axis * torch.where(_dot(axis, t) >= 0, 1.0, -1.0).to(dtype)[:, None]

    e = torch.eye(3, dtype=dtype, device=dev)
    ar = torch.arange(3, device=dev)[None]
    # supporting edge of box1 (maximizes n.x, free coordinate i) and of box2
    # (minimizes n.x, free coordinate j, box2 coords)
    sgn1 = torch.where(n >= 0, 1.0, -1.0).to(dtype)
    c1 = torch.where(ar == i[:, None], 0.0, sgn1 * s1)
    n2 = _mv(C.transpose(-1, -2), n)
    sgn2 = torch.where(n2 >= 0, -1.0, 1.0).to(dtype)
    c2_local = torch.where(ar == j[:, None], 0.0, sgn2 * s2)
    c2 = t + _mv(C, c2_local)

    d1 = e[i]
    d2 = C.gather(2, j[:, None, None].expand(N, 3, 1))[:, :, 0]
    # closest points between the lines c1 + a d1 and c2 + b d2
    r = c2 - c1
    a_ = _dot(d1, d1)
    b_ = _dot(d1, d2)
    c_ = _dot(d2, d2)
    dd = a_ * c_ - b_ * b_
    dd = torch.where(torch.abs(dd) < 1e-12, 1e-12, dd)
    ta = (c_ * _dot(d1, r) - b_ * _dot(d2, r)) / dd
    tb = (b_ * _dot(d1, r) - a_ * _dot(d2, r)) / dd
    pa = c1 + ta[:, None] * d1
    pb = c2 + tb[:, None] * d2

    pos = torch.zeros(N, MAXP, 3, dtype=dtype, device=dev)
    pos[:, 0] = 0.5 * (pa + pb)
    depth = torch.full((N, MAXP), torch.inf, dtype=dtype, device=dev)
    depth[:, 0] = _dot(n, pb - pa)                   # negative when penetrating
    active = torch.zeros(N, MAXP, dtype=torch.bool, device=dev)
    active[:, 0] = True
    return pos, n, depth, active
