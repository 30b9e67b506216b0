"""Narrowphase of the float32 batched path: the static pair table -> the
deepest `max_contacts` contacts as `ContactLanes` (fields (K, B)).

A frozen copy of the port's `collide_batched_lanes` (box pairs through
`boxbox_lanes`, hull pairs through `hull_lanes`' plain sweep, K rounds of
argmin, first minimum wins), without the single-env and float64 routes.
"""

from __future__ import annotations

import numpy as np
import torch

from ...models.scene import ContactLanes, Model, static_tables
from ..constraint import _body_dof_masks
from . import boxbox_lanes, hull_lanes


def _pair_tables_np(m: Model):
    """Static per-pair constant tables (numpy)."""
    all_pairs = m.pairs.box_box + m.pairs.hull_box + m.pairs.hull_hull
    npairs = len(all_pairs)
    pair_geom_np = np.asarray([list(p) for p in all_pairs], np.int32)
    gb_np = np.asarray(m.geom_bodyid, np.int32)
    b1_np = gb_np[pair_geom_np[:, 0]]
    b2_np = gb_np[pair_geom_np[:, 1]]
    masks_np = _body_dof_masks(m)                           # (nbody, nv)
    dmask_np = masks_np[b2_np] - masks_np[b1_np]            # (npairs, nv)
    binv_np = m.body_invweight0.detach().cpu().double().numpy()[:, 0]
    invw_np = binv_np[b1_np] + binv_np[b2_np]               # (npairs,)
    host = lambda t: t.detach().cpu().double().numpy()[:npairs]
    return dict(
        npairs=npairs,
        pair_geom=pair_geom_np,
        fric=host(m.pair_friction),
        solref=host(m.pair_solref),
        solimp=host(m.pair_solimp),
        condim=np.asarray(m.pair_condim, np.int32)[:npairs],
        dmask=dmask_np,
        invw=invw_np,
    )


class _PairTables:
    """Device copies of the per-pair tables, gathered by selected pair id."""

    def __init__(self, m: Model):
        tbl = _pair_tables_np(m)
        dev, dtype = m.device, m.dtype
        as_t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
        self.geom1 = as_t(tbl["pair_geom"][:, 0], torch.int32)
        self.geom2 = as_t(tbl["pair_geom"][:, 1], torch.int32)
        self.condim = as_t(tbl["condim"], torch.int32)
        self.fric = as_t(tbl["fric"], dtype)
        self.solref = as_t(tbl["solref"], dtype)
        self.solimp = as_t(tbl["solimp"], dtype)
        self.invw = as_t(tbl["invw"], dtype)
        self.dmask = as_t(tbl["dmask"], dtype)                # (npairs, nv)
        bb = m.pairs.box_box
        self.bb_g1 = as_t([p[0] for p in bb], torch.long)
        self.bb_g2 = as_t([p[1] for p in bb], torch.long)
        # pair id of each candidate row: MAXP slots per box pair, then one
        # row per hull pair
        nhull = len(m.pairs.hull_box + m.pairs.hull_hull)
        self.rows = as_t(np.concatenate([
            np.repeat(np.arange(len(bb)), boxbox_lanes.MAXP),
            len(bb) + np.arange(nhull)]), torch.long)


def _make_frame_lanes(nx, ny, nz):
    """Contact frame rows from normal components (each (K, B)), mju_makeFrame
    convention: t1 = (least-aligned world axis) x n, normalized; t2 = n x t1.
    The least-aligned axis is argmin-first over (|nx|, |ny|, |nz|)."""
    ax, ay, az = torch.abs(nx), torch.abs(ny), torch.abs(nz)
    use_x = (ax <= ay) & (ax <= az)
    use_y = ~use_x & (ay <= az)
    zero = torch.zeros_like(nx)
    t1x = torch.where(use_x, zero, torch.where(use_y, nz, -ny))
    t1y = torch.where(use_x, -nz, torch.where(use_y, zero, nx))
    t1z = torch.where(use_x, ny, torch.where(use_y, -nx, zero))
    nrm = torch.sqrt(t1x * t1x + t1y * t1y + t1z * t1z)
    inv = 1.0 / torch.clamp(nrm, min=1e-12)
    t1x, t1y, t1z = t1x * inv, t1y * inv, t1z * inv
    t2x = ny * t1z - nz * t1y
    t2y = nz * t1x - nx * t1z
    t2z = nx * t1y - ny * t1x
    return ((nx, ny, nz), (t1x, t1y, t1z), (t2x, t2y, t2z))


def collide_batched_lanes(m: Model, d) -> ContactLanes:
    """Batched narrowphase on a batched Data (geom poses (B, NG, ...)),
    returning the selected contacts as ContactLanes (fields (K, B))."""
    B = d.geom_xpos.shape[0]
    tbl = static_tables(m, "pairs", _PairTables)
    dep_l, act_l, px_l, py_l, pz_l, nx_l, ny_l, nz_l = ([] for _ in range(8))

    bb = m.pairs.box_box
    if bb:
        P, K = len(bb), boxbox_lanes.MAXP
        vec = lambda a: tuple(a[..., i].T for i in range(3))            # 3 x (P, B)
        mat = lambda a: tuple(tuple(a[..., i, j].T for j in range(3)) for i in range(3))
        size = lambda sz: tuple(sz[:, i][:, None].expand(P, B) for i in range(3))
        out = boxbox_lanes.box_box_lanes(
            vec(d.geom_xpos[:, tbl.bb_g1]), mat(d.geom_xmat[:, tbl.bb_g1]),
            size(m.geom_size[tbl.bb_g1]),
            vec(d.geom_xpos[:, tbl.bb_g2]), mat(d.geom_xmat[:, tbl.bb_g2]),
            size(m.geom_size[tbl.bb_g2]),
        )
        # pair-major slot-minor candidate rows: row p*K + k
        stackPK = lambda parts: torch.stack(parts, dim=1).reshape(P * K, B)
        dep_l.append(stackPK(out["depth"]))
        act_l.append(stackPK(out["active"]))
        px_l.append(stackPK([pk[0] for pk in out["pos"]]))
        py_l.append(stackPK([pk[1] for pk in out["pos"]]))
        pz_l.append(stackPK([pk[2] for pk in out["pos"]]))
        for comp, lst in zip(out["normal"], (nx_l, ny_l, nz_l)):
            lst.append(comp[:, None, :].expand(P, K, B).reshape(P * K, B))

    if m.pairs.hull_box + m.pairs.hull_hull:
        hpos, hnrm, hdep, hact, _ = hull_lanes.collide_hulls_lanes(m, d, lanes_out=True)
        dep_l.append(hdep)
        act_l.append(hact)
        px_l.append(hpos[0]); py_l.append(hpos[1]); pz_l.append(hpos[2])
        nx_l.append(hnrm[0]); ny_l.append(hnrm[1]); nz_l.append(hnrm[2])

    depth = torch.cat(dep_l, dim=0)                 # (M, B)
    active = torch.cat(act_l, dim=0)
    px, py, pz = torch.cat(px_l), torch.cat(py_l), torch.cat(pz_l)
    nx, ny, nz = torch.cat(nx_l), torch.cat(ny_l), torch.cat(nz_l)
    K = m.max_contacts

    valid = active & torch.isfinite(depth)
    key = torch.where(valid, depth, torch.inf)
    ncand = valid.sum(dim=0).to(torch.int32)

    # deepest-K: K rounds of argmin, masking each winner.  torch.argmin
    # returns the FIRST index of the minimum, the same tie rule as the JAX
    # package's masked argmin (a row whose key is +inf, i.e. no candidate
    # left, is picked in row order and comes out inactive).
    sel = []
    k = key
    for _ in range(K):
        i = torch.argmin(k, dim=0)                  # (B,)
        sel.append(i)
        k = k.scatter(0, i[None], torch.inf)
    idx = torch.stack(sel, dim=0)                   # (K, B)
    pick = lambda a: torch.gather(a, 0, idx)
    act = pick(active)
    dist = torch.where(act, pick(depth), 0.0)
    posx = torch.where(act, pick(px), 0.0)
    posy = torch.where(act, pick(py), 0.0)
    posz = torch.where(act, pick(pz), 0.0)
    nxs = torch.where(act, pick(nx), 0.0)
    nys = torch.where(act, pick(ny), 0.0)
    nzs = torch.where(act, pick(nz), 1.0)           # inactive -> ez
    pair_k = tbl.rows[idx]                          # (K, B) selected pair ids

    dmask = tbl.dmask[pair_k]                       # (K, B, nv)
    frame = _make_frame_lanes(nxs, nys, nzs)
    return ContactLanes(
        dist=dist,
        pos=(posx, posy, posz),
        frame=frame,
        friction0=tbl.fric[pair_k, 0],
        friction1=tbl.fric[pair_k, 1],
        solref0=tbl.solref[pair_k, 0],
        solref1=tbl.solref[pair_k, 1],
        solimp=tuple(tbl.solimp[pair_k, c] for c in range(5)),
        geom1=tbl.geom1[pair_k],
        geom2=tbl.geom2[pair_k],
        condim=tbl.condim[pair_k],
        active=act,
        dof_dmask=tuple(dmask[..., v] for v in range(m.nv)),
        invw_diag=tbl.invw[pair_k],
        ncand=ncand,
    )
