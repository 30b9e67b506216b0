"""Constraint assembly: impedance, stiffness/damping, dof masks, and the
single-env constraint rows.

The port of `gym_so100_tpu/ops/constraint.py`: the helpers the lanes
assembly (`constraint_lanes.py`) uses, and `make_efc`, the single-env
engine's row assembly, with the fixed row layout

  [ equality | dof friction loss | joint limits | contacts (K slots x CDIM) ]

in which every slot always exists and inactive rows are masked (D = 0).
Conventions follow MuJoCo's constraint model
(mj_makeImpedance): sigmoid impedance from solimp=(d0, dwidth, width, mid,
power) with endpoints clamped to [0.0001, 0.9999]; solref=(tc, zeta) > 0 gives
K = 1/(dmax^2 tc^2 zeta^2), B = 2/(dmax tc), negative solref is direct
stiffness/damping; aref = -B*vel - K*imp*pos; R = max(MINVAL,
(1-imp)/imp * diagApprox), D = 1/R.

`equality_rows` assembles the weld and joint equality rows (the EE and
Panda scenes) for a batch of envs.  Elliptic cones: friction row i gets D_i
= D_normal impratio (mu_i / mu_0)^2, and the solver sees a circular cone
with mu = mu_0 / sqrt(impratio) in the scaled coordinates u_i = jar_i mu_i
sqrt(impratio) / mu_0.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..models.scene import JNT_FREE, JNT_HINGE, Contact, Data, Model, State, static_tables
from . import quat

MINVAL = 1e-15
MINIMP = 0.0001
MAXIMP = 0.9999
CDIM = 4  # contact rows per slot (normal + 2 tangent + torsion; condim<=4)


@dataclass(frozen=True)
class Efc:
    """Assembled constraint rows of one env (static shapes)."""

    J: torch.Tensor           # (NE, nv)
    aref: torch.Tensor        # (NE,)
    D: torch.Tensor           # (NE,) inverse regularization (0 = inactive row)
    R: torch.Tensor           # (NE,)
    pos: torch.Tensor         # (NE,) constraint violation (contacts: dist)
    floss: torch.Tensor       # (NE,) frictionloss (friction rows only)
    # scalar block [equality | frictionloss | limits]: a row with neither
    # mask set is an equality row
    is_floss: torch.Tensor    # (NE,) bool
    is_limit: torch.Tensor    # (NE,) bool
    # contact rows [neq + nf + nl :] in K blocks of CDIM
    con_mu: torch.Tensor      # (K,) circular-cone friction mu0 / sqrt(impratio)
    con_uscale: torch.Tensor  # (K, CDIM) jar -> u scaling (row 0 = 1)
    con_active: torch.Tensor  # (K,) bool
    con_Dn: torch.Tensor      # (K,) normal-row D
    neq: int = 0              # equality rows (6 per weld, 1 per joint coupling)
    nf: int = 0
    nl: int = 0

    def replace(self, **kw) -> "Efc":
        return dataclasses.replace(self, **kw)


def impedance_comps(d0, dw, width, mid, power, pos):
    """MuJoCo constraint impedance d(pos), unpacked solimp components.
    Endpoints are clamped before interpolation, with no final clamp."""
    d0 = torch.clamp(d0, MINIMP, MAXIMP)
    dw = torch.clamp(dw, MINIMP, MAXIMP)
    x = torch.clamp(torch.abs(pos) / torch.clamp(width, min=MINVAL), 0.0, 1.0)
    pw = torch.clamp(power, min=1.0)
    a = 1.0 / torch.clamp(mid, min=MINVAL) ** (pw - 1)
    b = 1.0 / torch.clamp(1 - mid, min=MINVAL) ** (pw - 1)
    y = torch.where(x <= mid, a * x ** pw, 1 - b * (1 - x) ** pw)
    return d0 + y * (dw - d0)


def impedance(solimp, pos):
    """MuJoCo constraint impedance d(pos) from solimp (components last)."""
    return impedance_comps(
        solimp[..., 0], solimp[..., 1], solimp[..., 2], solimp[..., 3],
        solimp[..., 4], pos,
    )


def kb_comps(tc, dr, dmax):
    """Stiffness/damping (K, B) from unpacked solref given max impedance."""
    std = tc > 0
    K_std = 1.0 / torch.clamp((dmax * tc * dr) ** 2, min=MINVAL)
    B_std = 2.0 / torch.clamp(dmax * tc, min=MINVAL)
    K_dir = -tc / torch.clamp(dmax * dmax, min=MINVAL)
    B_dir = -dr / torch.clamp(dmax, min=MINVAL)
    return torch.where(std, K_std, K_dir), torch.where(std, B_std, B_dir)


def kb(solref, dmax):
    """Stiffness/damping (K, B) from solref given max impedance dmax."""
    return kb_comps(solref[..., 0], solref[..., 1], dmax)


def _body_dof_masks(m: Model):
    """(nbody, nv) 0/1 ancestor-dof mask (numpy), from static topology."""
    mask = np.zeros((m.nbody, m.nv))
    for b in range(m.nbody):
        bb = b
        while bb != 0:
            ja, jn = m.body_jntadr[bb], m.body_jntnum[bb]
            for ji in range(ja, ja + jn):
                base = m.jnt_dofadr[ji]
                n = 6 if m.jnt_type[ji] == JNT_FREE else 1
                mask[b, base: base + n] = 1.0
            bb = m.body_parentid[bb]
    return mask


def point_jacobians(d: Data, mk, points):
    """Translational and rotational Jacobians of world `points` (B, N, 3)
    attached to bodies whose ancestor-dof masks are `mk` (N, nv), from the
    com-frame cdof axes.  Returns (Jt, Jr), each (B, N, 3, nv)."""
    ang = d.cdof[..., :3]                                   # (B, nv, 3)
    lin = d.cdof[..., 3:]
    offset = points - d.subtree_com[:, :1]                  # (B, N, 3)
    cross = torch.linalg.cross(ang[:, None], offset[:, :, None].expand(
        -1, -1, ang.shape[1], -1), dim=-1)                  # (B, N, nv, 3)
    Jt = (lin[:, None] + cross) * mk[None, :, :, None]
    Jr = ang[:, None] * mk[None, :, :, None]
    return Jt.transpose(-1, -2), Jr.transpose(-1, -2)


class _EqualityTables:
    """The static tables of `equality_rows` on the model's device (per
    Model and dtype): weld sites, their bodies and those bodies' dof
    masks, the coupled joints' qpos and dof addresses.  Indexing with
    tensors already on the device keeps host-to-device copies out of the
    substep, which a CUDA graph could not capture."""

    def __init__(self, m: Model, dtype):
        dev = m.device
        lt = lambda a: torch.tensor(list(a), dtype=torch.long, device=dev)
        sb1 = [m.site_bodyid[i] for i in m.eq_site1]
        sb2 = [m.site_bodyid[i] for i in m.eq_site2]
        masks = _body_dof_masks(m)
        self.s1, self.s2, self.sb1, self.sb2 = lt(m.eq_site1), lt(m.eq_site2), lt(sb1), lt(sb2)
        self.mk1 = torch.as_tensor(masks[sb1], dtype=dtype, device=dev)      # (NEQ, nv)
        self.mk2 = torch.as_tensor(masks[sb2], dtype=dtype, device=dev)
        self.q1a, self.q2a = lt(m.eq_jnt_q1), lt(m.eq_jnt_q2)
        self.v1a, self.v2a = lt(m.eq_jnt_v1), lt(m.eq_jnt_v2)


def equality_rows(m: Model, d: Data, s: State):
    """Weld and joint equality rows for a batch: a list of (J (B, n, nv),
    aref, D, R, pos (each (B, n))) blocks.

    Site welds (6 rows each): residual [site1_xpos - site2_xpos ;
    vec(conj(q2) q1)], J = J(site1) - J(site2) with the exact quaternion
    derivative on the rotation rows.  Joint couplings q1 - q01 =
    polycoef(q2 - q02), one row each."""
    dtype, dev = s.qpos.dtype, s.qpos.device
    nv = m.nv
    B = s.qpos.shape[0]
    blocks = []

    neq = len(m.eq_site1)
    njeq = len(m.eq_jnt_q1)
    if neq or njeq:
        tb = static_tables(m, f"equality_rows.{dtype}", lambda m: _EqualityTables(m, dtype))
    if neq:
        sb1, sb2 = tb.sb1, tb.sb2
        p1 = d.site_xpos[:, tb.s1]                          # (B, NEQ, 3)
        p2 = d.site_xpos[:, tb.s2]
        res_t = p1 - p2
        q1 = quat.from_mat(d.site_xmat[:, tb.s1])
        q2 = quat.from_mat(d.site_xmat[:, tb.s2])
        res_r = quat.mul(quat.conj(q2), q1)[..., 1:]
        Jt1, Jr1 = point_jacobians(d, tb.mk1, p1)
        Jt2, Jr2 = point_jacobians(d, tb.mk2, p2)
        # M[:, k] = vec(conj(q2) (0, e_k) q1); d res_r / d omega1 = 0.5 M
        eye = torch.eye(3, dtype=dtype, device=dev)
        cols = []
        for k in range(3):
            ek = torch.cat([torch.zeros(1, dtype=dtype, device=dev), eye[k]])
            cols.append(quat.mul(quat.mul(quat.conj(q2), ek.expand_as(q1)), q1)[..., 1:])
        Mrot = torch.stack(cols, -1)                        # (B, NEQ, 3, 3)
        Jrot = 0.5 * torch.einsum("beij,bejv->beiv", Mrot, Jr1 - Jr2)
        Jeq = torch.cat([Jt1 - Jt2, Jrot], dim=2)           # (B, NEQ, 6, nv)
        res = torch.cat([res_t, res_r], dim=2)              # (B, NEQ, 6)
        imp = impedance(m.eq_solimp[:, None, :].expand(neq, 6, 5), res)
        K, Bk = kb(m.eq_solref, m.eq_solimp[:, 1])
        vel = torch.einsum("berv,bv->ber", Jeq, s.qvel)
        aref = -Bk[:, None] * vel - K[:, None] * imp * res
        binv = m.body_invweight0
        diag_t = binv[sb1, 0] + binv[sb2, 0]
        diag_r = binv[sb1, 1] + binv[sb2, 1]
        diag = torch.cat([diag_t[:, None].expand(neq, 3), diag_r[:, None].expand(neq, 3)], 1)
        R = torch.clamp((1 - imp) / imp * diag, min=MINVAL)
        n = neq * 6
        blocks.append((Jeq.reshape(B, n, nv), aref.reshape(B, n), (1.0 / R).reshape(B, n),
                       R.reshape(B, n), res.reshape(B, n)))

    if njeq:
        q1a, q2a, v1a, v2a = tb.q1a, tb.q2a, tb.v1a, tb.v2a
        c = m.eq_jnt_poly                                   # (NJEQ, 5)
        x = s.qpos[:, q2a] - m.qpos0[q2a]
        poly = c[:, 0] + x * (c[:, 1] + x * (c[:, 2] + x * (c[:, 3] + x * c[:, 4])))
        dpoly = c[:, 1] + x * (2 * c[:, 2] + x * (3 * c[:, 3] + x * 4 * c[:, 4]))
        res = (s.qpos[:, q1a] - m.qpos0[q1a]) - poly        # (B, NJEQ)
        rows = torch.arange(njeq, device=dev)
        J = torch.zeros(B, njeq, nv, dtype=dtype, device=dev)
        J[:, rows, v1a] = torch.ones((), dtype=dtype, device=dev)
        J[:, rows, v2a] -= dpoly
        vel = s.qvel[:, v1a] - dpoly * s.qvel[:, v2a]
        imp = impedance(m.eq_jnt_solimp, res)
        K, Bk = kb(m.eq_jnt_solref, m.eq_jnt_solimp[:, 1])
        aref = -Bk * vel - K * imp * res
        diag = m.dof_invweight0[v1a] + m.dof_invweight0[v2a]
        R = torch.clamp((1 - imp) / imp * diag, min=MINVAL)
        blocks.append((J, aref, 1.0 / R, R, res))

    return blocks


def point_jacobians_single(m: Model, d: Data, body_ids, points):
    """One env's translational and rotational Jacobians (each (N, 3, nv)) of
    world `points` (N, 3) attached to bodies `body_ids` (N,) (a tensor)."""
    masks = torch.as_tensor(_body_dof_masks(m), dtype=d.cdof.dtype, device=d.cdof.device)
    mk = masks[body_ids]                                    # (N, nv)
    ang = d.cdof[:, :3]                                     # (nv, 3)
    lin = d.cdof[:, 3:]
    offset = points - d.subtree_com[0][None]                # (N, 3)
    cross = quat.cross(ang[None], offset[:, None])          # (N, nv, 3)
    Jt = (lin[None] + cross) * mk[:, :, None]
    Jr = ang[None].expand_as(cross) * mk[:, :, None]
    return Jt.transpose(1, 2), Jr.transpose(1, 2)


def make_efc(m: Model, d: Data, s: State, con: Contact) -> Efc:
    """One env's constraint rows from its Data (no env axis) and contact
    buffer; the per-contact body masks and diagonal come from geom1/geom2."""
    dtype, dev = s.qpos.dtype, s.qpos.device
    nv = m.nv
    rows_J, rows_aref, rows_D, rows_R = [], [], [], []
    rows_pos, rows_floss, rows_isf, rows_isl = [], [], [], []
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=dev)
    flags = lambda n, v: torch.full((n,), v, dtype=torch.bool, device=dev)

    def add(J, aref, D, R, pos, floss, isf, isl):
        n = J.shape[0]
        rows_J.append(J)
        rows_aref.append(aref)
        rows_D.append(D)
        rows_R.append(R)
        rows_pos.append(pos)
        rows_floss.append(floss)
        rows_isf.append(flags(n, isf))
        rows_isl.append(flags(n, isl))

    # equality rows (weld site pairs, joint couplings): the batched helper
    # on a batch of one
    if len(m.eq_site1) or len(m.eq_jnt_q1):
        db = Data(site_xpos=d.site_xpos[None], site_xmat=d.site_xmat[None],
                  cdof=d.cdof[None], subtree_com=d.subtree_com[None, :1])
        for J, aref, D, R, pos in equality_rows(m, db, s.index(None)):
            add(J[0], aref[0], D[0], R[0], pos[0], zeros(J.shape[1]), False, False)

    # dof friction loss rows
    nf = len(m.fl_dofs)
    if nf:
        ids = list(m.fl_dofs)
        J = zeros((nf, nv))
        J[torch.arange(nf), ids] = 1.0
        imp = impedance(m.dof_solimp[ids], zeros(nf))
        K, B = kb(m.dof_solref[ids], m.dof_solimp[ids][:, 1])
        R = torch.clamp((1 - imp) / imp * m.dof_invweight0[ids], min=MINVAL)
        add(J, -B * s.qvel[ids], 1.0 / R, R, zeros(nf), m.dof_frictionloss[ids], True, False)

    # joint limit rows (limited hinges)
    lim = [j for j in range(len(m.jnt_type)) if m.jnt_limited[j] and m.jnt_type[j] == JNT_HINGE]
    nl = len(lim)
    if nl:
        qadr = [m.jnt_qposadr[j] for j in lim]
        vadr = [m.jnt_dofadr[j] for j in lim]
        q = s.qpos[qadr]
        dist_lo = q - m.jnt_range[lim, 0]
        dist_hi = m.jnt_range[lim, 1] - q
        use_lo = dist_lo < dist_hi
        dist = torch.where(use_lo, dist_lo, dist_hi)
        sign = torch.where(use_lo, 1.0, -1.0).to(dtype)
        J = zeros((nl, nv))
        J[torch.arange(nl), vadr] = sign
        imp = impedance(m.jnt_solimp[lim], dist)
        K, B = kb(m.jnt_solref[lim], m.jnt_solimp[lim][:, 1])
        aref = -B * (sign * s.qvel[vadr]) - K * imp * dist
        R = torch.clamp((1 - imp) / imp * m.dof_invweight0[vadr], min=MINVAL)
        add(J, aref, torch.where(dist < 0, 1.0 / R, 0.0), R, dist, zeros(nl), False, True)

    # contact rows: K slots x CDIM
    Kslots = con.dist.shape[0]
    gb = torch.tensor(m.geom_bodyid, dtype=torch.long, device=dev)
    b1 = gb[con.geom1.long()]
    b2 = gb[con.geom2.long()]
    Jt1, Jr1 = point_jacobians_single(m, d, b1, con.pos)
    Jt2, Jr2 = point_jacobians_single(m, d, b2, con.pos)
    dJt = Jt2 - Jt1                                        # (K, 3, nv)
    dJr = Jr2 - Jr1
    frame = con.frame                                      # rows n, t1, t2
    proj = lambda f, Jx: torch.einsum("ki,kiv->kv", f, Jx)
    Jcon = torch.stack([proj(frame[:, 0], dJt), proj(frame[:, 1], dJt),
                        proj(frame[:, 2], dJt), proj(frame[:, 0], dJr)], 1)  # (K, CDIM, nv)

    imp = impedance(con.solimp, con.dist)
    Kk, Bk = kb(con.solref, con.solimp[:, 1])
    vel = torch.einsum("krv,v->kr", Jcon, s.qvel)
    aref_con = torch.cat([(-Bk * vel[:, 0] - Kk * imp * con.dist)[:, None],
                          -Bk[:, None] * vel[:, 1:]], 1)
    binv = m.body_invweight0[:, 0]
    Rn = torch.clamp((1 - imp) / imp * (binv[b1] + binv[b2]), min=MINVAL)
    Dn = 1.0 / Rn
    ip = m.impratio
    mu0 = con.friction[:, 0]
    # friction coefficient per friction row [slide, slide, torsion]; the
    # torsion row is off for condim 3
    mus = torch.stack([con.friction[:, 0], con.friction[:, 0],
                       torch.where(con.condim >= 4, con.friction[:, 1], 0.0)], 1)
    Df = Dn[:, None] * ip * (mus / torch.clamp(mu0[:, None], min=MINVAL)) ** 2
    active = con.active & (con.dist < 0)
    Dcon = torch.cat([Dn[:, None], Df], 1) * active[:, None]
    sip = torch.sqrt(torch.tensor(ip, dtype=dtype, device=dev))
    uscale = torch.cat([torch.ones(Kslots, 1, dtype=dtype, device=dev),
                        mus * sip / torch.clamp(mu0[:, None], min=MINVAL)], 1)
    add(Jcon.reshape(Kslots * CDIM, nv), aref_con.reshape(-1), Dcon.reshape(-1),
        Rn[:, None].expand(Kslots, CDIM).reshape(-1),
        torch.cat([con.dist[:, None], zeros((Kslots, CDIM - 1))], 1).reshape(-1),
        zeros(Kslots * CDIM), False, False)

    return Efc(
        J=torch.cat(rows_J),
        aref=torch.cat(rows_aref),
        D=torch.cat(rows_D),
        R=torch.cat(rows_R),
        pos=torch.cat(rows_pos),
        floss=torch.cat(rows_floss),
        is_floss=torch.cat(rows_isf),
        is_limit=torch.cat(rows_isl),
        con_mu=mu0 / sip,
        con_uscale=uscale,
        con_active=active,
        con_Dn=Dn * active,
        neq=len(m.eq_site1) * 6 + len(m.eq_jnt_q1),
        nf=nf,
        nl=nl,
    )
