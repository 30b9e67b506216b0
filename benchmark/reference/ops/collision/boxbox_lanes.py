"""Box-box narrowphase in batch-last "lanes" form.

The port of `gym_so100_tpu/ops/collision/boxbox_lanes.py`: SAT over the 15
axes, then one Sutherland-Hodgman clip of the incident face against the
winning reference face in a canonicalized frame (reference box selected by
mask, reference axis permuted to z), or a single edge-edge point.  Every
quantity is a flat (N,) tensor, N = pairs x batch; vectors and matrices are
tuples of such tensors.  Slot counts grow 4 -> 8 through the four clip
planes, and polygon compaction is a masked add over the static slots, so
there is no data-dependent control flow.
"""

from __future__ import annotations

import torch

MAXP = 8            # max contact points per box pair
_EDGE_FUDGE = 1.05  # edge axis must beat the best face axis by 5%
_DEG = 1e-12


def _sel3(ix, v0, v1, v2):
    """Per-lane 3-way select by int tensor ix in {0,1,2}."""
    return torch.where(ix == 0, v0, torch.where(ix == 1, v1, v2))


def _argmax(vals):
    """(best, idx) over a static list of (N,) tensors, first-max ties."""
    best = vals[0]
    idx = torch.zeros_like(vals[0], dtype=torch.int32)
    for k in range(1, len(vals)):
        m = vals[k] > best
        best = torch.where(m, vals[k], best)
        idx = torch.where(m, k, idx)
    return best, idx


def _matvec(C, v):
    return tuple(C[i][0] * v[0] + C[i][1] * v[1] + C[i][2] * v[2] for i in range(3))


def _matTvec(C, v):
    return tuple(C[0][i] * v[0] + C[1][i] * v[1] + C[2][i] * v[2] for i in range(3))


def box_box_lanes(p1, R1, s1, p2, R2, s2, margin=0.0):
    """Collide box pairs, one pair per lane.

    Args: p1/p2 = tuples of 3 (N,) center components; R1/R2 = 3x3 nested
    tuples of (N,) world-rotation entries (columns = box axes); s1/s2 =
    tuples of 3 (N,) half sizes.  A pair is separated where its largest
    SAT separation reaches `margin`, and a slot is active below it.
    Returns dict:
      pos    list of MAXP tuples of 3 (N,) world coords
      normal tuple of 3 (N,) (from box1 toward box2)
      depth  list of MAXP (N,) (negative = penetrating)
      active list of MAXP (N,) bool
    """
    one = torch.ones_like(p1[0])
    zero = torch.zeros_like(p1[0])

    # --- box2 in box1 frame: C = R1^T R2, t = R1^T (p2 - p1) ---
    C = [[R1[0][i] * R2[0][j] + R1[1][i] * R2[1][j] + R1[2][i] * R2[2][j]
          for j in range(3)] for i in range(3)]
    dp = (p2[0] - p1[0], p2[1] - p1[1], p2[2] - p1[2])
    t = tuple(R1[0][i] * dp[0] + R1[1][i] * dp[1] + R1[2][i] * dp[2] for i in range(3))
    absC = [[torch.abs(C[i][j]) + _DEG for j in range(3)] for i in range(3)]

    # --- SAT: 6 face axes ---
    sep_face = []
    for i in range(3):
        r = s1[i] + absC[i][0] * s2[0] + absC[i][1] * s2[1] + absC[i][2] * s2[2]
        sep_face.append(torch.abs(t[i]) - r)
    t2 = _matTvec(C, t)
    for j in range(3):
        r = s2[j] + absC[0][j] * s1[0] + absC[1][j] * s1[1] + absC[2][j] * s1[2]
        sep_face.append(torch.abs(t2[j]) - r)

    # --- SAT: 9 edge-edge axes a = e_i x C_col_j ---
    sep_edge = []
    axes_edge = []
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            a = [zero, zero, zero]
            a[i1] = -C[i2][j]
            a[i2] = C[i1][j]
            norm = torch.sqrt(C[i2][j] * C[i2][j] + C[i1][j] * C[i1][j])
            inv = 1.0 / torch.clamp(norm, min=_DEG)
            a = [a[0] * inv, a[1] * inv, a[2] * inv]
            r1 = s1[i1] * torch.abs(a[i1]) + s1[i2] * torch.abs(a[i2])
            aC = [a[i1] * C[i1][k] + a[i2] * C[i2][k] for k in range(3)]
            r2 = s2[j1] * torch.abs(aC[j1]) + s2[j2] * torch.abs(aC[j2])
            at = a[i1] * t[i1] + a[i2] * t[i2]
            sep = torch.abs(at) - (r1 + r2)
            sep = torch.where(norm < 1e-9, -torch.inf, sep)
            sep_edge.append(sep)
            axes_edge.append(tuple(a))

    face_sep, best_face = _argmax(sep_face)
    edge_sep, best_edge = _argmax(sep_edge)
    separated = torch.maximum(face_sep, edge_sep) >= margin
    use_edge = edge_sep * _EDGE_FUDGE > face_sep

    # =====================================================================
    # Face contact: canonicalize (ref box, ref axis -> z), single clip
    # =====================================================================
    is1 = best_face < 3
    ax = torch.where(is1, best_face, best_face - 3)

    Ci = [[torch.where(is1, C[i][j], C[j][i]) for j in range(3)] for i in range(3)]
    tc = tuple(torch.where(is1, t[i], -t2[i]) for i in range(3))
    sr = tuple(torch.where(is1, s1[i], s2[i]) for i in range(3))
    si = tuple(torch.where(is1, s2[i], s1[i]) for i in range(3))

    # permute reference rows so the reference axis is canonical z
    Rp = [
        [_sel3(ax, Ci[1][j], Ci[2][j], Ci[0][j]) for j in range(3)],
        [_sel3(ax, Ci[2][j], Ci[0][j], Ci[1][j]) for j in range(3)],
        [_sel3(ax, Ci[0][j], Ci[1][j], Ci[2][j]) for j in range(3)],
    ]
    tp = (
        _sel3(ax, tc[1], tc[2], tc[0]),
        _sel3(ax, tc[2], tc[0], tc[1]),
        _sel3(ax, tc[0], tc[1], tc[2]),
    )
    srp = (
        _sel3(ax, sr[1], sr[2], sr[0]),
        _sel3(ax, sr[2], sr[0], sr[1]),
        _sel3(ax, sr[0], sr[1], sr[2]),
    )

    nsign = torch.where(tp[2] >= 0, one, -one)

    # incident face: column of Rp most anti-parallel to the ref normal
    dots = [Rp[2][j] for j in range(3)]
    _, jstar = _argmax([torch.abs(d) for d in dots])
    dstar = _sel3(jstar, dots[0], dots[1], dots[2]) * nsign
    inc_sign = torch.where(dstar > 0, -one, one)

    si_n = _sel3(jstar, si[0], si[1], si[2])
    si_u = _sel3(jstar, si[1], si[2], si[0])
    si_v = _sel3(jstar, si[2], si[0], si[1])
    col_n = [_sel3(jstar, Rp[r][0], Rp[r][1], Rp[r][2]) for r in range(3)]
    col_u = [_sel3(jstar, Rp[r][1], Rp[r][2], Rp[r][0]) for r in range(3)]
    col_v = [_sel3(jstar, Rp[r][2], Rp[r][0], Rp[r][1]) for r in range(3)]
    center = [tp[r] + inc_sign * si_n * col_n[r] for r in range(3)]
    du = [si_u * col_u[r] for r in range(3)]
    dv = [si_v * col_v[r] for r in range(3)]

    # ring of clip points in canonical (x, y); z is recovered afterwards
    # from the incident face plane
    px, py = [], []
    for su, sv in ((1, 1), (-1, 1), (-1, -1), (1, -1)):
        px.append(center[0] + su * du[0] + sv * dv[0])
        py.append(center[1] + su * du[1] + sv * dv[1])
    count = torch.full_like(ax, 4)

    # Sutherland-Hodgman against the 4 side planes +/-x <= srp[0],
    # +/-y <= srp[1]; slot capacity grows by one per plane
    for plane_ax, plane_sign in ((0, 1.0), (0, -1.0), (1, 1.0), (1, -1.0)):
        n = len(px)
        cap = min(n + 1, MAXP)
        limit = srp[plane_ax]
        coords = px if plane_ax == 0 else py
        d = [plane_sign * coords[k] - limit for k in range(n)]
        inside = [d[k] <= 0 for k in range(n)]
        valid = [count > k for k in range(n)]

        cand_x, cand_y, keep = [], [], []
        for k in range(n):
            # ring-next: slot k+1 while k+1 < count, else slot 0
            wrap = count <= k + 1
            if k + 1 < n:
                nx = torch.where(wrap, px[0], px[k + 1])
                ny = torch.where(wrap, py[0], py[k + 1])
                nd = torch.where(wrap, d[0], d[k + 1])
                nin = torch.where(wrap, inside[0], inside[k + 1])
            else:
                nx, ny, nd, nin = px[0], py[0], d[0], inside[0]
            denom = d[k] - nd
            denom = torch.where(torch.abs(denom) < 1e-14, 1e-14, denom)
            tt = d[k] / denom
            keep_pt = inside[k] & valid[k]
            keep_ix = (inside[k] ^ nin) & valid[k]
            cand_x.append(torch.where(keep_pt, px[k], 0.0))
            cand_y.append(torch.where(keep_pt, py[k], 0.0))
            keep.append(keep_pt)
            cand_x.append(torch.where(keep_ix, px[k] + tt * (nx - px[k]), 0.0))
            cand_y.append(torch.where(keep_ix, py[k] + tt * (ny - py[k]), 0.0))
            keep.append(keep_ix)

        # stable masked compaction: dest_c = prefix-count - 1
        run = torch.zeros_like(count)
        dest = []
        for c in range(2 * n):
            run = run + keep[c].to(run.dtype)
            dest.append(run - 1)
        npx = [zero] * cap
        npy = [zero] * cap
        for c in range(2 * n):
            for k in range(cap):
                hit = keep[c] & (dest[c] == k)
                npx[k] = npx[k] + torch.where(hit, cand_x[c], 0.0)
                npy[k] = npy[k] + torch.where(hit, cand_y[c], 0.0)
        px, py = npx, npy
        count = run

    # recover z on the incident-face plane
    det = du[0] * dv[1] - du[1] * dv[0]
    det = torch.where(torch.abs(det) < _DEG,
                      torch.where(det < 0, -_DEG * one, _DEG * one), det)
    inv_det = 1.0 / det
    pz = []
    for k in range(MAXP):
        rx = px[k] - center[0]
        ry = py[k] - center[1]
        su = (dv[1] * rx - dv[0] * ry) * inv_det
        sv = (-du[1] * rx + du[0] * ry) * inv_det
        pz.append(center[2] + du[2] * su + dv[2] * sv)

    face_valid = [count > k for k in range(MAXP)]
    face_depth = [nsign * pz[k] - srp[2] for k in range(MAXP)]
    face_active = [face_valid[k] & (face_depth[k] < 0) for k in range(MAXP)]
    # contact point: midway between the incident point and its projection
    # on the reference face plane
    pzc = [pz[k] - 0.5 * face_depth[k] * nsign for k in range(MAXP)]

    def unpermute(x, y, z):
        return (_sel3(ax, z, y, x), _sel3(ax, x, z, y), _sel3(ax, y, x, z))

    face_pos = []
    for k in range(MAXP):
        ref = unpermute(px[k], py[k], pzc[k])
        b2 = _matvec(C, ref)
        face_pos.append(tuple(torch.where(is1, ref[i], t[i] + b2[i]) for i in range(3)))
    n_ref = unpermute(zero, zero, nsign)
    n_rot = _matvec(C, n_ref)
    face_normal = tuple(torch.where(is1, n_ref[i], -n_rot[i]) for i in range(3))

    # =====================================================================
    # Edge-edge contact (single point)
    # =====================================================================
    ei = best_edge // 3
    ej = best_edge % 3
    a = []
    for c in range(3):
        acc = zero
        for k, axk in enumerate(axes_edge):
            acc = torch.where(best_edge == k, axk[c], acc)
        a.append(acc)
    adott = a[0] * t[0] + a[1] * t[1] + a[2] * t[2]
    sgn = torch.where(adott >= 0, one, -one)
    n_e = [a[c] * sgn for c in range(3)]

    # supporting edges: corner of box1 maximizing n . x (free coord ei),
    # corner of box2 minimizing n . x (free coord ej, box2 coords)
    c1 = [torch.where(ei == c, zero, torch.where(n_e[c] >= 0, s1[c], -s1[c]))
          for c in range(3)]
    n2 = _matTvec(C, n_e)
    c2l = [torch.where(ej == c, zero, torch.where(n2[c] >= 0, -s2[c], s2[c]))
           for c in range(3)]
    Cc2 = _matvec(C, c2l)
    c2 = [t[c] + Cc2[c] for c in range(3)]
    d1 = [torch.where(ei == c, one, zero) for c in range(3)]
    d2 = [_sel3(ej, C[c][0], C[c][1], C[c][2]) for c in range(3)]
    r = [c2[c] - c1[c] for c in range(3)]
    a_ = d1[0] * d1[0] + d1[1] * d1[1] + d1[2] * d1[2]
    b_ = d1[0] * d2[0] + d1[1] * d2[1] + d1[2] * d2[2]
    c_ = d2[0] * d2[0] + d2[1] * d2[1] + d2[2] * d2[2]
    dd = a_ * c_ - b_ * b_
    dd = torch.where(torch.abs(dd) < _DEG, _DEG, dd)
    d1r = d1[0] * r[0] + d1[1] * r[1] + d1[2] * r[2]
    d2r = d2[0] * r[0] + d2[1] * r[1] + d2[2] * r[2]
    ta = (c_ * d1r - b_ * d2r) / dd
    tb = (b_ * d1r - a_ * d2r) / dd
    pa = [c1[c] + ta * d1[c] for c in range(3)]
    pb = [c2[c] + tb * d2[c] for c in range(3)]
    e_depth = (n_e[0] * (pb[0] - pa[0]) + n_e[1] * (pb[1] - pa[1])
               + n_e[2] * (pb[2] - pa[2]))
    e_pos = tuple(0.5 * (pa[c] + pb[c]) for c in range(3))

    # =====================================================================
    # merge + world transform
    # =====================================================================
    not_sep = ~separated
    pos_out, depth_out, active_out = [], [], []
    for k in range(MAXP):
        if k == 0:
            pk = tuple(torch.where(use_edge, e_pos[c], face_pos[0][c]) for c in range(3))
            dk = torch.where(use_edge, e_depth, face_depth[0])
            ak = use_edge | face_active[0]
        else:
            pk = face_pos[k]
            dk = torch.where(use_edge, torch.inf, face_depth[k])
            ak = face_active[k] & ~use_edge
        ak = ak & not_sep & (dk < margin)
        pos_out.append(tuple(
            p1[c] + R1[c][0] * pk[0] + R1[c][1] * pk[1] + R1[c][2] * pk[2]
            for c in range(3)
        ))
        depth_out.append(dk)
        active_out.append(ak)

    nb1 = tuple(torch.where(use_edge, n_e[c], face_normal[c]) for c in range(3))
    normal_w = tuple(
        R1[c][0] * nb1[0] + R1[c][1] * nb1[1] + R1[c][2] * nb1[2] for c in range(3)
    )
    return dict(pos=pos_out, normal=normal_w, depth=depth_out, active=active_out)
