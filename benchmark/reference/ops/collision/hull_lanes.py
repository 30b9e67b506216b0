"""Convex-hull narrowphase in batch-last "lanes" form (f32 batched path).

The port of `gym_so100_tpu/ops/collision/hull_lanes.py`.  For every hull
geom of the pair list, the support heights max_v d.v and min_v d.v over a
fixed direction set (plus d.p) form two (G, ND) tables per env; a pair's
overlap along d is h[d] = Ttop[g1][d] - Tbot[g2][d], its depth -min_d h
and its normal the winning direction (first index on ties).  The witness
point and the AABB activity mask follow on (P, B) lanes.

A frozen copy of the port's module: the support sweep plus per-pair min
runs `sweep_h_plain`, the plain PyTorch version of the port's hull kernel,
on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from ...models.scene import static_tables

HULL_BLOCK = 64  # uniform per-geom vertex window of Model.hull_vertsT
N_PEN_DIRS = 126  # Fibonacci-sphere directions; +6 axes gives ND = 132


def _dir_set_np(n):
    """The fixed direction set (6 axes then n Fibonacci-sphere points),
    float32, (n + 6, 3); a copy of `gjk._dir_set_np` of the JAX package."""
    i = np.arange(n)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    y = 1 - 2 * (i + 0.5) / n
    r = np.sqrt(np.maximum(0, 1 - y * y))
    dirs = np.stack([r * np.cos(phi * i), y, r * np.sin(phi * i)], -1)
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    return np.concatenate([axes, dirs]).astype(np.float32)


def _static_hull_tables(m):
    """Per-geom static vertex/AABB tables for the geoms in the hull pair
    list, geoms ordered by true vertex count (one bucket per distinct
    count, so each support chain runs exactly as deep as its geom needs;
    the builder pads hulls by repeating vertex 0, which never wins a
    strict comparison, so truncation is exact).

    Returns (gidx (G,) geom ids in bucket order, buckets [(lo, hi, V)],
    counts (G,) true vertex counts, verts (3, Vmax, G) padded with vertex
    0, lcen/lhalf (G, 3), i1/i2 (P,) pair indices into the ordering)."""
    hulls = m.pairs.hull_box + m.pairs.hull_hull
    gset = sorted({g for p in hulls for g in p})
    vt = m.hull_vertsT.detach().cpu().double().numpy()

    def nverts(g):
        st = m.hull_start[g]
        blk = vt[:, st: st + HULL_BLOCK]
        diff = np.any(blk != blk[:, :1], axis=0)
        return int(np.max(np.nonzero(diff)[0])) + 1 if diff.any() else 1

    rows_of = {g: m.hull_start[g] // HULL_BLOCK for g in gset}
    gset = sorted(gset, key=nverts)
    counts = [nverts(g) for g in gset]
    pos_in_set = {g: i for i, g in enumerate(gset)}
    buckets = []
    lo = 0
    for i in range(1, len(gset) + 1):
        if i == len(gset) or counts[i] != counts[lo]:
            buckets.append((lo, i, counts[lo]))
            lo = i
    Vmax = max(counts)
    verts = np.zeros((3, Vmax, len(gset)))
    for k, g in enumerate(gset):
        st = m.hull_start[g]
        verts[:, : counts[k], k] = vt[:, st: st + counts[k]]
        verts[:, counts[k]:, k] = vt[:, st: st + 1]
    rows = [rows_of[g] for g in gset]
    lcen = m.hull_lcen.detach().cpu().double().numpy()[rows]
    lhalf = m.hull_lhalf.detach().cpu().double().numpy()[rows]
    i1 = np.asarray([pos_in_set[p[0]] for p in hulls], np.int32)
    i2 = np.asarray([pos_in_set[p[1]] for p in hulls], np.int32)
    gidx = np.asarray(gset, np.int32)
    return gidx, buckets, np.asarray(counts), verts, lcen, lhalf, i1, i2


class HullTables:
    """The static tables on the model's device, in the layouts both sweep
    versions take: verts (G, 3*Vmax) with column v*3+k = component k of
    vertex v, directions D (ND, 3), per-geom vertex counts, pair indices."""

    def __init__(self, m):
        (gidx, _, counts, verts, lcen, lhalf, i1, i2) = _static_hull_tables(m)
        dev, dtype = m.device, m.dtype
        G = len(gidx)
        self.G, self.P = G, len(i1)
        as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
        self.gidx = as_t(gidx, torch.long)
        self.verts = as_t(np.transpose(verts, (2, 1, 0)).reshape(G, -1), dtype)
        self.D = as_t(_dir_set_np(N_PEN_DIRS), dtype)
        self.counts = as_t(counts, torch.int32)
        self.vtot = int(counts.sum())
        self.i1 = as_t(i1, torch.int32)
        self.i2 = as_t(i2, torch.int32)
        self.lcen = as_t(lcen, dtype)
        self.lhalf = as_t(lhalf, dtype)
        self.pair_ids = as_t(len(m.pairs.box_box) + np.arange(self.P), torch.long)
        # witness groups: pair subsets by side-geom vertex count
        self.groups = {}
        for side, idx in (("1", i1), ("2", i2)):
            grp = []
            side_counts = counts[idx]
            for V in sorted(set(side_counts.tolist())):
                sub = np.nonzero(side_counts == V)[0]
                gsub = idx[sub]
                grp.append((V, as_t(sub, torch.long), as_t(gsub, torch.long),
                            [as_t(verts[c][:, gsub], dtype) for c in range(3)]))
            self.groups[side] = grp


def hull_tables(m) -> HullTables:
    return static_tables(m, "hull", HullTables)


# ---------------------------------------------------------------------------
# kernel 1: support sweep + per-pair depth/normal
# ---------------------------------------------------------------------------


def sweep_h_plain(p_pack, R_pack, verts, D, counts, i1, i2):
    """Plain PyTorch version of the sweep (the JAX package's XLA lanes path,
    hull_lanes.py:279-350), on the kernel's packed inputs.

    p_pack (3G, B) rows j*G+g; R_pack (9G, B) rows (j*3+k)*G+g; verts
    (G, 3*Vmax); D (ND, 3); counts (G,) true vertex counts, ascending;
    i1/i2 (P,).  Returns (4P, B): depth rows, then the three normal
    component row blocks."""
    G = verts.shape[0]
    Vmax = verts.shape[1] // 3
    p = [p_pack[j * G:(j + 1) * G] for j in range(3)]                 # (G, B)
    R = [[R_pack[(j * 3 + k) * G:(j * 3 + k + 1) * G] for k in range(3)]
         for j in range(3)]
    Dj = [D[:, j] for j in range(3)]                                   # (ND,)
    # local direction components ld[k] (ND, G, B) = sum_j D_j R[j][k]
    ld = [Dj[0][:, None, None] * R[0][k][None]
          + Dj[1][:, None, None] * R[1][k][None]
          + Dj[2][:, None, None] * R[2][k][None] for k in range(3)]
    dp = (Dj[0][:, None, None] * p[0][None] + Dj[1][:, None, None] * p[1][None]
          + Dj[2][:, None, None] * p[2][None])
    vx, vy, vz = (verts.view(G, Vmax, 3)[..., c].T for c in range(3))  # (Vmax, G)
    cnt = counts.tolist()
    smax_parts, smin_parts = [], []
    lo = 0
    while lo < G:                       # one bucket per distinct count
        hi = lo
        while hi < G and cnt[hi] == cnt[lo]:
            hi += 1
        ldb = [c[:, lo:hi] for c in ld]
        s = lambda v: (ldb[0] * vx[v, lo:hi][:, None] + ldb[1] * vy[v, lo:hi][:, None]
                       + ldb[2] * vz[v, lo:hi][:, None])
        smax = smin = s(0)
        for v in range(1, cnt[lo]):
            sv = s(v)
            smax = torch.maximum(smax, sv)
            smin = torch.minimum(smin, sv)
        smax_parts.append(smax)
        smin_parts.append(smin)
        lo = hi
    Ttop = torch.cat(smax_parts, dim=1) + dp                           # (ND, G, B)
    Tbot = torch.cat(smin_parts, dim=1) + dp
    h = Ttop[:, i1.long()] - Tbot[:, i2.long()]                        # (ND, P, B)
    bd = torch.argmin(h, dim=0)        # first index of the minimum on ties
    hmin = torch.gather(h, 0, bd[None])[0]
    nrm = D[bd]                                                        # (P, B, 3)
    return torch.cat([-hmin, nrm[..., 0], nrm[..., 1], nrm[..., 2]], dim=0)


def sweep_h(p_pack, R_pack, tb):
    """Hull support sweep + per-pair depth and normal, (4P, B), for the
    static tables `tb` (a HullTables), by the plain version on every
    device."""
    return sweep_h_plain(p_pack, R_pack, tb.verts, tb.D, tb.counts, tb.i1, tb.i2)


# ---------------------------------------------------------------------------
# the collider
# ---------------------------------------------------------------------------


def collide_hulls_lanes(m, d, margin=0.0, lanes_out=False):
    """All hull pairs for a batched Data (geom poses (B, NG, ...)).

    Returns (pos (B, P, 3), normal (B, P, 3), depth (B, P), active (B, P),
    pair_ids (P,)), the batch-first candidate chunk of `collide_batched`;
    with `lanes_out` the fields stay batch-last instead (pos and normal 3 x
    (P, B), depth and active (P, B), pair_ids a numpy (P,)), the candidate
    rows of `collide_batched_lanes`.  A pair is active where its AABBs meet
    and its depth is below `margin`."""
    tb = hull_tables(m)
    gx = d.geom_xpos[:, tb.gidx, :]                 # (B, G, 3)
    gm = d.geom_xmat[:, tb.gidx, :, :]              # (B, G, 3, 3)
    p = [gx[..., k].T for k in range(3)]            # (G, B)
    R = [[gm[..., j, k].T for k in range(3)] for j in range(3)]
    p_pack = torch.cat(p, dim=0).contiguous()
    R_pack = torch.cat([R[j][k] for j in range(3) for k in range(3)], dim=0).contiguous()
    out = sweep_h(p_pack, R_pack, tb)
    P = tb.P
    depth = out[:P]
    nrm = [out[(1 + j) * P:(2 + j) * P] for j in range(3)]
    pos, nrm, depth, active, pair_ids = _witness_and_pack(m, tb, p, R, depth, nrm, margin)
    if lanes_out:
        return pos, nrm, depth, active, pair_ids
    return (torch.stack(pos, dim=-1).transpose(0, 1), torch.stack(nrm, dim=-1).transpose(0, 1),
            depth.T, active.T, tb.pair_ids)


def _witness_and_pack(m, tb, p, R, depth, nrm, margin=0.0):
    """Witness points (the extreme vertex of each geom along the winning
    direction, midpoint of the two), the activity mask (AABBs meet, depth
    below `margin`), and the lanes-form output."""
    P, B = depth.shape

    def extreme(side, sign):
        """World position of argmax_v sign * (d_local . v) per pair."""
        out = [depth.new_zeros(P, B) for _ in range(3)]
        for V, sub, gsub, vg in tb.groups[side]:
            Rp = [[R[j][k][gsub] for k in range(3)] for j in range(3)]
            ldk = [sum(sign * nrm[j][sub] * Rp[j][k] for j in range(3))
                   for k in range(3)]                       # (Ps, B)
            vxg, vyg, vzg = vg                              # (Vmax, Ps)
            best = (ldk[0] * vxg[0][:, None] + ldk[1] * vyg[0][:, None]
                    + ldk[2] * vzg[0][:, None])
            wx = vxg[0][:, None].expand_as(best)
            wy = vyg[0][:, None].expand_as(best)
            wz = vzg[0][:, None].expand_as(best)
            for v in range(1, V):
                s = (ldk[0] * vxg[v][:, None] + ldk[1] * vyg[v][:, None]
                     + ldk[2] * vzg[v][:, None])
                better = s > best
                best = torch.where(better, s, best)
                wx = torch.where(better, vxg[v][:, None], wx)
                wy = torch.where(better, vyg[v][:, None], wy)
                wz = torch.where(better, vzg[v][:, None], wz)
            for k in range(3):
                out[k][sub] = (p[k][gsub] + Rp[k][0] * wx + Rp[k][1] * wy
                               + Rp[k][2] * wz)
        return out

    a = extreme("1", 1.0)    # max of geom1 along +d
    b = extreme("2", -1.0)   # min of geom2 along +d
    pos = [0.5 * (a[k] + b[k]) for k in range(3)]

    # AABB activity mask
    lc = [tb.lcen[:, k] for k in range(3)]
    lh = [tb.lhalf[:, k] for k in range(3)]
    wc = [p[k] + R[k][0] * lc[0][:, None] + R[k][1] * lc[1][:, None]
          + R[k][2] * lc[2][:, None] for k in range(3)]
    wh = [torch.abs(R[k][0]) * lh[0][:, None] + torch.abs(R[k][1]) * lh[1][:, None]
          + torch.abs(R[k][2]) * lh[2][:, None] for k in range(3)]
    j1 = tb.i1.long()
    j2 = tb.i2.long()
    ov = None
    for k in range(3):
        lo = torch.maximum(wc[k][j1] - wh[k][j1], wc[k][j2] - wh[k][j2])
        hi = torch.minimum(wc[k][j1] + wh[k][j1], wc[k][j2] + wh[k][j2])
        e = hi - lo
        ov = e if ov is None else torch.minimum(ov, e)
    active = (depth < margin) & (ov > 0)
    pair_ids = len(m.pairs.box_box) + np.arange(P, dtype=np.int32)
    return tuple(pos), tuple(nrm), depth, active, pair_ids
