"""Narrowphase: static pair table -> the deepest `max_contacts`
contacts, as a `Contact` buffer (single env, or batch-first) or as
`ContactLanes` (fields (K, B)).

The port of `gym_so100_tpu/ops/collision/narrowphase.py`.  Every candidate
pair runs narrowphase (the float64 hull colliders skip the pairs that
cannot touch, whose contacts would be inactive) and the deepest K
penetrating points are kept.  Three entry points, as in JAX:

* `collide`, the single-env engine's: box pairs through `boxbox.box_box`;
  with `pairs.ccd` (the float64 parity model) every pair MuJoCo resolves
  with its native convex collider runs the exact-hull manifold path
  (`manifold.ccd_chunk`), otherwise the hull pairs run `_hull_chunk` (AABB
  cull to K/2 slots, then GJK/EPA in float64 or the direction sweep in
  float32).
* `collide_batched`, batch-first: box pairs through `boxbox_lanes`, hull
  pairs through the per-env `_hull_chunk` in float64 and through
  `hull_lanes` (the hull-sweep kernel) in float32.
* `collide_batched_lanes`, the float32 throughput path: box pairs through
  `boxbox_lanes`, hull pairs through `hull_lanes`, candidates (M, B) with B
  minor; in float64 it is `collide_batched` converted by
  `contact_to_lanes`, the JAX package's parity route.

Selection: float64 sorts the keys with a stable sort (JAX's `lax.top_k`
returns the lower index first among equal keys, and every inactive slot
ties at +inf, so the pair ids of inactive slots match); float32 takes K
rounds of argmin, first minimum wins.
"""

from __future__ import annotations

import numpy as np
import torch

from ...models.scene import Contact, ContactLanes, Data, Model, static_tables
from ..constraint import _body_dof_masks
from . import boxbox, boxbox_lanes, hull_lanes
from . import gjk as gjk_mod


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


# ---------------------------------------------------------------------------
# selection and frames
# ---------------------------------------------------------------------------


def _select_smallest_batched(key, K):
    """Indices (B, K) of the K smallest entries of each row of `key` (B, M)
    (NaN-free).  float64: a stable sort, the order of JAX's
    `lax.top_k(-key, K)` (lower index first among equal keys); float32: K
    rounds of argmin, first minimum wins."""
    if key.dtype == torch.float64:
        return torch.sort(key, dim=-1, stable=True).indices[:, :K]
    out = []
    k = key
    for _ in range(K):
        i = torch.argmin(k, dim=-1)
        out.append(i)
        k = k.scatter(1, i[:, None], torch.inf)
    return torch.stack(out, dim=-1)


def _select_smallest(key, K):
    """Indices (K,) of the K smallest entries of the 1-D `key`."""
    return _select_smallest_batched(key[None], K)[0]


def _make_frame(n):
    """Contact frame rows [normal, t1, t2] (..., 3, 3) from normals (..., 3),
    mju_makeFrame convention: the auxiliary axis is the world axis least
    aligned with n (first minimum), t1 = aux x n normalized, t2 = n x t1."""
    aux = torch.nn.functional.one_hot(torch.argmin(torch.abs(n), dim=-1), 3).to(n.dtype)
    t1 = torch.linalg.cross(aux, n, dim=-1)
    t1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1, keepdim=True), min=1e-12)
    t2 = torch.linalg.cross(n, t1, dim=-1)
    return torch.stack([n, t1, t2], dim=-2)


# ---------------------------------------------------------------------------
# per-env hull pairs and the batch-first entry points
# ---------------------------------------------------------------------------


class _HullChunkTables:
    """Static index tables of `_hull_chunk` (per Model)."""

    def __init__(self, m: Model):
        dev = m.device
        hulls = m.pairs.hull_box + m.pairs.hull_hull
        lt = lambda a: torch.tensor(a, dtype=torch.long, device=dev)
        self.g1 = lt([p[0] for p in hulls])
        self.g2 = lt([p[1] for p in hulls])
        self.st1 = lt([m.hull_start[p[0]] for p in hulls])
        self.st2 = lt([m.hull_start[p[1]] for p in hulls])
        gset = sorted({g for p in hulls for g in p})
        pos_in_set = {g: i for i, g in enumerate(gset)}
        self.gidx = lt(gset)
        self.rows = lt([m.hull_start[g] // gjk_mod.HULL_BLOCK for g in gset])
        self.i1 = lt([pos_in_set[p[0]] for p in hulls])
        self.i2 = lt([pos_in_set[p[1]] for p in hulls])


def _hull_chunk_batched(m: Model, geom_xpos, geom_xmat, dtype):
    """Hull-pair candidates of each env (poses (B, NG, ...)): an AABB cull
    over the hull pairs keeps the K/2 most-overlapping slots, of which
    those whose AABBs meet run narrowphase.  Returns pos (B, KH, 3), normal (B, KH, 3), depth
    (B, KH), active (B, KH) and pair ids (B, KH)."""
    tb = static_tables(m, "hull_chunk", _HullChunkTables)
    B = geom_xpos.shape[0]
    R = geom_xmat[:, tb.gidx]
    wc = geom_xpos[:, tb.gidx] + torch.einsum(
        "bgij,gj->bgi", R, m.hull_lcen[tb.rows].to(dtype))
    wh = torch.einsum("bgij,gj->bgi", torch.abs(R), m.hull_lhalf[tb.rows].to(dtype))
    lo = torch.maximum(wc[:, tb.i1] - wh[:, tb.i1], wc[:, tb.i2] - wh[:, tb.i2])
    hi = torch.minimum(wc[:, tb.i1] + wh[:, tb.i1], wc[:, tb.i2] + wh[:, tb.i2])
    overlap = (hi - lo).min(-1).values               # (B, P) > 0: AABBs meet

    KH = min(m.max_contacts // 2, tb.g1.shape[0])
    slot = _select_smallest_batched(-overlap, KH)    # (B, KH)
    ov = overlap.gather(1, slot)
    # a slot whose AABBs do not meet is inactive whatever its narrowphase
    # gives, so only the meeting ones run it
    meet = (ov > 0).reshape(-1).nonzero()[:, 0]
    flat = lambda x: x.reshape((B * KH,) + x.shape[2:])[meet]
    b = torch.arange(B, device=slot.device)[:, None]
    ga, gb = tb.g1[slot], tb.g2[slot]
    out = gjk_mod.make_blocked_convex_convex(m.hull_vertsT.to(dtype))(
        flat(geom_xpos[b, ga]), flat(geom_xmat[b, ga]), flat(tb.st1[slot]),
        flat(geom_xpos[b, gb]), flat(geom_xmat[b, gb]), flat(tb.st2[slot]))
    full = lambda x: x.new_zeros((B * KH,) + x.shape[1:]).index_copy_(0, meet, x).reshape(
        (B, KH) + x.shape[1:])
    return (full(out["pos"]), full(out["normal"]), full(out["depth"]), full(out["active"]),
            len(m.pairs.box_box) + slot)


def _hull_chunk(m: Model, d: Data, dtype):
    """`_hull_chunk_batched` for one env's Data (poses (NG, ...))."""
    out = _hull_chunk_batched(m, d.geom_xpos[None], d.geom_xmat[None], dtype)
    return tuple(x[0] for x in out)


def collide(m: Model, d: Data) -> Contact:
    """One env's narrowphase (geom poses (NG, ...)): every candidate pair,
    then the deepest max_contacts points.

    With pairs.ccd (build_model(ccd_manifolds=True)), every pair MuJoCo
    resolves with its native convex collider (the hull pairs and the box
    pairs whose partner is an original mesh) runs the exact-hull manifold
    path; only true box-box pairs stay on the SAT clip collider."""
    dtype, dev = d.geom_xpos.dtype, d.geom_xpos.device
    chunks = []  # (pos (N, 3), normal (N, 3), depth (N,), active (N,), pair (N,))
    ccd_set = {(p[0], p[1]) for p in m.pairs.ccd}

    bb = m.pairs.box_box
    bb_keep = [i for i, p in enumerate(bb) if p not in ccd_set]
    if bb_keep:
        g1 = [bb[i][0] for i in bb_keep]
        g2 = [bb[i][1] for i in bb_keep]
        out = boxbox.box_box(d.geom_xpos[g1], d.geom_xmat[g1], m.geom_size[g1],
                             d.geom_xpos[g2], d.geom_xmat[g2], m.geom_size[g2])
        P, K = len(bb_keep), boxbox.MAXP
        chunks.append((
            out["pos"].reshape(P * K, 3),
            out["normal"].repeat_interleave(K, dim=0),
            out["depth"].reshape(P * K),
            out["active"].reshape(P * K),
            torch.tensor(bb_keep, dtype=torch.int64, device=dev).repeat_interleave(K),
        ))
    if m.pairs.ccd:
        from . import manifold

        chunks.append(manifold.ccd_chunk(m, d, dtype))
    if (m.pairs.hull_box + m.pairs.hull_hull) and not m.pairs.ccd:
        chunks.append(_hull_chunk(m, d, dtype))

    pos, normal, depth, active, pair = (torch.cat([c[i] for c in chunks]) for i in range(5))
    K = m.max_contacts
    if pos.shape[0] < K:     # fewer candidates than the buffer
        padn = K - pos.shape[0]
        pos = torch.cat([pos, pos.new_zeros(padn, 3)])
        normal = torch.cat([normal, normal.new_zeros(padn, 3)])
        depth = torch.cat([depth, depth.new_full((padn,), torch.inf)])
        active = torch.cat([active, active.new_zeros(padn)])
        pair = torch.cat([pair, pair.new_zeros(padn)])
    # inactive narrowphase slots may carry inf/NaN depths
    valid = active & torch.isfinite(depth)
    idx = _select_smallest(torch.where(valid, depth, torch.inf), K)
    tbl = static_tables(m, "pairs", _PairTables)
    pair_k = pair[idx]
    act = active[idx]
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
    return Contact(
        dist=torch.where(act, depth[idx], 0.0),
        pos=torch.where(act[:, None], pos[idx], 0.0),
        frame=_make_frame(torch.where(act[:, None], normal[idx], ez)),
        friction=m.pair_friction[pair_k],
        solref=m.pair_solref[pair_k],
        solimp=m.pair_solimp[pair_k],
        geom1=tbl.geom1[pair_k],
        geom2=tbl.geom2[pair_k],
        condim=tbl.condim[pair_k],
        active=act,
        ncand=valid.sum().to(torch.int32),
    )


def collide_batched(m: Model, d: Data) -> Contact:
    """The batched narrowphase (geom poses (B, NG, ...)) -> a batch-first
    Contact (fields (B, K, ...)) with the per-contact statics.  Box pairs
    run the lanes box collider.  Hull pairs run, in float64, the per-env
    `_hull_chunk` (exact GJK/EPA); in float32, `hull_lanes` over every hull
    pair (one hull-sweep kernel launch on the card), with no per-env slot
    cull: the deepest-K selection is the only one.  Candidates are
    pair-major, slot-minor.  In float32 the result is
    `collide_batched_lanes`' transposed."""
    dtype, dev = d.geom_xpos.dtype, d.geom_xpos.device
    B = d.geom_xpos.shape[0]
    tbl = static_tables(m, "pairs", _PairTables)
    chunks = []  # (pos (B, N, 3), normal (B, N, 3), depth (B, N), active, pair (B, N))

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
        # (B, P * K), pair-major slot-minor
        bpk = lambda parts: torch.stack(parts, dim=-1).permute(1, 0, 2).reshape(B, P * K)
        pos = torch.stack([bpk([pk[c] for pk in out["pos"]]) for c in range(3)], -1)
        normal = torch.stack([c.T for c in out["normal"]], -1).repeat_interleave(K, dim=1)
        pair_ids = torch.arange(P, device=dev).repeat_interleave(K).expand(B, P * K)
        chunks.append((pos, normal, bpk(out["depth"]), bpk(out["active"]), pair_ids))

    if m.pairs.hull_box + m.pairs.hull_hull:
        if dtype == torch.float64:
            chunks.append(_hull_chunk_batched(m, d.geom_xpos, d.geom_xmat, dtype))
        else:
            hpos, hnrm, hdep, hact, hpair = hull_lanes.collide_hulls_lanes(m, d)
            chunks.append((hpos, hnrm, hdep, hact, hpair.expand(B, -1)))

    pos, normal, depth, active, pair = (torch.cat([c[i] for c in chunks], dim=1)
                                        for i in range(5))
    K = m.max_contacts
    valid = active & torch.isfinite(depth)
    idx = _select_smallest_batched(torch.where(valid, depth, torch.inf), K)   # (B, K)
    sel = lambda a: a.gather(1, idx) if a.dim() == 2 else a.gather(
        1, idx[..., None].expand(B, K, a.shape[-1]))
    pair_k = sel(pair)
    act = sel(active)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
    return Contact(
        dist=torch.where(act, sel(depth), 0.0),
        pos=torch.where(act[..., None], sel(pos), 0.0),
        frame=_make_frame(torch.where(act[..., None], sel(normal), ez)),
        friction=tbl.fric[pair_k],
        solref=tbl.solref[pair_k],
        solimp=tbl.solimp[pair_k],
        geom1=tbl.geom1[pair_k],
        geom2=tbl.geom2[pair_k],
        condim=tbl.condim[pair_k],
        active=act,
        dof_dmask=tbl.dmask[pair_k],
        invw_diag=tbl.invw[pair_k],
        ncand=valid.sum(-1).to(torch.int32),
    )


def contact_to_lanes(m: Model, con: Contact) -> ContactLanes:
    """A batch-first Contact (fields (B, K, ...)) as ContactLanes (fields
    (K, B)).  Absent per-contact statics (dof_dmask, invw_diag) are derived
    from the geom ids."""
    T = lambda a: a.movedim(0, -1)
    nv = m.nv
    if con.dof_dmask is not None:
        dof_dmask = tuple(T(con.dof_dmask[..., v]) for v in range(nv))
        invw_diag = T(con.invw_diag)
    else:
        gb = torch.tensor(m.geom_bodyid, dtype=torch.long, device=con.dist.device)
        b1i = T(gb[con.geom1.long()])
        b2i = T(gb[con.geom2.long()])
        masks = torch.as_tensor(_body_dof_masks(m), dtype=con.dist.dtype,
                                device=con.dist.device)           # (nbody, nv)
        dof_dmask = tuple(masks[b2i, v] - masks[b1i, v] for v in range(nv))
        binv = m.body_invweight0[:, 0]
        invw_diag = binv[b1i] + binv[b2i]
    ncand = con.ncand if con.ncand is not None else con.active.sum(-1).to(torch.int32)
    return ContactLanes(
        dist=T(con.dist),
        pos=tuple(T(con.pos[..., c]) for c in range(3)),
        frame=tuple(tuple(T(con.frame[..., r, c]) for c in range(3)) for r in range(3)),
        friction0=T(con.friction[..., 0]),
        friction1=T(con.friction[..., 1]),
        solref0=T(con.solref[..., 0]),
        solref1=T(con.solref[..., 1]),
        solimp=tuple(T(con.solimp[..., c]) for c in range(5)),
        geom1=T(con.geom1),
        geom2=T(con.geom2),
        condim=T(con.condim),
        active=T(con.active),
        dof_dmask=dof_dmask,
        invw_diag=invw_diag,
        ncand=ncand,
    )


def collide_batched_lanes(m: Model, d) -> ContactLanes:
    """Batched narrowphase on a batched Data (geom poses (B, NG, ...)),
    returning the selected contacts as ContactLanes (fields (K, B)).  In
    float64 it runs `collide_batched` (per-env exact hull colliders, stable
    top-K), as the JAX package does."""
    if d.geom_xpos.dtype == torch.float64:
        return contact_to_lanes(m, collide_batched(m, d))
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
