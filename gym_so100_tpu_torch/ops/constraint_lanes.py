"""Batch-last (lanes) constraint assembly.

The port of `gym_so100_tpu/ops/constraint_lanes.py`: friction-loss, joint
limit and contact rows for a batch of envs, every row array (NE, B) with
the env batch minor.  Row order is static:

  [ equality | dof friction loss | joint limits | K contact slots x CDIM ]

with the contact block slot-major (row start + k*CDIM + j).  Because both
bodies of a contact share the contact point, its Jacobian row for dof v is
dir . (lin_v + ang_v x off) * (mask2[v] - mask1[v]).

`make_efc_from_lanes` takes ContactLanes; `make_efc_lanes` and
`make_efc_batched` take a batch-first Contact, the latter returning the
batch-first `Efc` of `constraint.make_efc` per env.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.scene import JNT_HINGE, Contact, ContactLanes, Data, Model, State, static_tables
from .constraint import (
    CDIM,
    MINVAL,
    Efc,
    equality_rows,
    impedance,
    impedance_comps,
    kb,
    kb_comps,
)
from .collision.narrowphase import contact_to_lanes


@dataclass(frozen=True)
class EfcLanes:
    """Constraint rows in batch-last form (env batch minor).

    J is one (nv, NE, B) tensor (the JAX package keeps a list of nv (NE, B)
    arrays).  Rows [0:neq] are equality, [neq:neq+nf] friction loss,
    [neq+nf:neq+nf+nl] limits, the rest K x CDIM contact rows."""

    J: torch.Tensor           # (nv, NE, B)
    aref: torch.Tensor        # (NE, B)
    D: torch.Tensor           # (NE, B)
    R: torch.Tensor           # (NE, B)
    pos: torch.Tensor         # (NE, B)
    floss: torch.Tensor       # (nf, B) frictionloss magnitudes
    con_mu: torch.Tensor      # (K, B)
    con_uscale: torch.Tensor  # (K, CDIM, B)
    con_active: torch.Tensor  # (K, B) bool
    con_Dn: torch.Tensor      # (K, B)
    neq: int = 0
    nf: int = 0
    nl: int = 0


def make_efc_lanes(m: Model, d: Data, s: State, con: Contact) -> EfcLanes:
    """`make_efc_from_lanes` for a batch-first Contact (fields (B, K, ...))."""
    return make_efc_from_lanes(m, d, s, contact_to_lanes(m, con))


class _RowTables:
    """The static tables of the friction-loss and limit rows on the model's
    device (per Model and dtype): the dofs and joints they index and their
    one-hot Jacobians (nv, n, 1).  Indexing with tensors already on the
    device keeps host-to-device copies out of the substep, which a CUDA
    graph could not capture."""

    def __init__(self, m: Model, dtype):
        dev = m.device
        lt = lambda a: torch.tensor(list(a), dtype=torch.long, device=dev)
        lim = [j for j in range(len(m.jnt_type))
               if m.jnt_limited[j] and m.jnt_type[j] == JNT_HINGE]
        vadr = [m.jnt_dofadr[j] for j in lim]

        def onehot(dofs):
            out = np.zeros((m.nv, len(dofs), 1))
            out[np.asarray(dofs, dtype=np.int64), np.arange(len(dofs)), 0] = 1.0
            return torch.as_tensor(out, dtype=dtype, device=dev)

        self.fl_dofs = lt(m.fl_dofs)
        self.fl_onehot = onehot(list(m.fl_dofs))
        self.lim_jnts, self.lim_vadr = lt(lim), lt(vadr)
        self.lim_qadr = lt(m.jnt_qposadr[j] for j in lim)
        self.lim_onehot = onehot(vadr)


def make_efc_from_lanes(m: Model, d: Data, s: State, cl: ContactLanes) -> EfcLanes:
    """Batched constraint assembly: d/s carry a leading env axis B, the
    contacts arrive as ContactLanes ((K, B) fields), the rows come out
    batch-last.  Feed to solver_lanes.solve_lanes."""
    dtype, dev = s.qpos.dtype, s.qpos.device
    nv = m.nv
    B = s.qpos.shape[0]
    K = cl.dist.shape[0]

    Jv, arefs, Ds, Rs, poss = [], [], [], [], []

    # ---- equality rows (absent on the training scenes) ----
    neqr = 0
    for J, aref, D, R, pos in equality_rows(m, d, s):
        Jv.append(J.permute(2, 1, 0))                      # (nv, n, B)
        arefs.append(aref.T)
        Ds.append(D.T)
        Rs.append(R.T)
        poss.append(pos.T)
        neqr += aref.shape[1]

    tb = static_tables(m, f"efc_lanes.{dtype}", lambda m: _RowTables(m, dtype))

    # ---- dof friction loss rows (static one-hot J, per-dof constants) ----
    nf = len(m.fl_dofs)
    if nf:
        ids = tb.fl_dofs
        imp = impedance(m.dof_solimp[ids], torch.zeros(nf, dtype=dtype, device=dev))
        Kk, Bk = kb(m.dof_solref[ids], m.dof_solimp[ids][:, 1])
        aref = -Bk[None] * s.qvel[:, ids]                  # (B, nf)
        R = torch.clamp((1 - imp) / imp * m.dof_invweight0[ids], min=MINVAL)
        Jv.append(tb.fl_onehot.expand(nv, nf, B))
        arefs.append(aref.T)
        Ds.append((1.0 / R)[:, None].expand(nf, B))
        Rs.append(R[:, None].expand(nf, B))
        poss.append(torch.zeros(nf, B, dtype=dtype, device=dev))
        floss = m.dof_frictionloss[ids][:, None].expand(nf, B)
    else:
        floss = torch.zeros(0, B, dtype=dtype, device=dev)

    # ---- joint limit rows ----
    nl = tb.lim_jnts.shape[0]
    if nl:
        lim_jnts, qadr, vadr = tb.lim_jnts, tb.lim_qadr, tb.lim_vadr
        q = s.qpos[:, qadr].T                              # (nl, B)
        lo = m.jnt_range[lim_jnts, 0][:, None]
        hi = m.jnt_range[lim_jnts, 1][:, None]
        dist_lo = q - lo
        dist_hi = hi - q
        use_lo = dist_lo < dist_hi
        dist = torch.where(use_lo, dist_lo, dist_hi)
        sign = torch.where(use_lo, 1.0, -1.0).to(dtype)
        Jv.append(sign[None] * tb.lim_onehot)
        active = dist < 0
        imp = impedance(m.jnt_solimp[lim_jnts][:, None, :], dist)
        Kk, Bk = kb(m.jnt_solref[lim_jnts], m.jnt_solimp[lim_jnts][:, 1])
        vel = sign * s.qvel[:, vadr].T
        aref = -Bk[:, None] * vel - Kk[:, None] * imp * dist
        R = torch.clamp((1 - imp) / imp * m.dof_invweight0[vadr][:, None], min=MINVAL)
        arefs.append(aref)
        Ds.append(torch.where(active, 1.0 / R, 0.0))
        Rs.append(R)
        poss.append(dist)

    # ---- contact rows ----
    dist = cl.dist                                         # (K, B)
    px, py, pz = cl.pos
    fr = cl.frame
    cd = d.cdof.permute(1, 2, 0)                           # (nv, 6, B)
    com = d.subtree_com[:, 0]                              # (B, 3) root com
    off = [px - com[:, 0], py - com[:, 1], pz - com[:, 2]]

    Jrows = [[None] * nv for _ in range(CDIM)]             # [row][v] -> (K, B)
    for v in range(nv):
        ax, ay, az = cd[v, 0], cd[v, 1], cd[v, 2]
        lx, ly, lz = cd[v, 3], cd[v, 4], cd[v, 5]
        wx = lx + ay * off[2] - az * off[1]
        wy = ly + az * off[0] - ax * off[2]
        wz = lz + ax * off[1] - ay * off[0]
        mk = cl.dof_dmask[v]
        Jrows[0][v] = (fr[0][0] * wx + fr[0][1] * wy + fr[0][2] * wz) * mk
        Jrows[1][v] = (fr[1][0] * wx + fr[1][1] * wy + fr[1][2] * wz) * mk
        Jrows[2][v] = (fr[2][0] * wx + fr[2][1] * wy + fr[2][2] * wz) * mk
        Jrows[3][v] = (fr[0][0] * ax + fr[0][1] * ay + fr[0][2] * az) * mk

    qv = [s.qvel[:, v] for v in range(nv)]
    vel = [sum(Jrows[r][v] * qv[v] for v in range(nv)) for r in range(CDIM)]

    imp = impedance_comps(*cl.solimp, dist)                # (K, B)
    Kk, Bk = kb_comps(cl.solref0, cl.solref1, cl.solimp[1])
    aref = [-Bk * vel[0] - Kk * imp * dist, -Bk * vel[1], -Bk * vel[2], -Bk * vel[3]]

    Rn = torch.clamp((1 - imp) / imp * cl.invw_diag, min=MINVAL)
    Dn = 1.0 / Rn
    ip = m.impratio
    fric0 = cl.friction0
    mu0 = torch.clamp(fric0, min=MINVAL)
    mus = [fric0, fric0, torch.where(cl.condim >= 4, cl.friction1, 0.0)]
    Drows = [Dn] + [Dn * ip * (mu / mu0) ** 2 for mu in mus]
    active = cl.active & (dist < 0)
    Drows = [Dr * active for Dr in Drows]
    mu = fric0 / (ip ** 0.5)
    uscale = [torch.ones_like(fric0)] + [mu_ * (ip ** 0.5) / mu0 for mu_ in mus]

    # contact blocks -> (K*CDIM, B), slot-major row-minor
    tocon = lambda rows: torch.stack(rows, dim=1).reshape(K * CDIM, B)
    Jv.append(torch.stack([tocon([Jrows[r][v] for r in range(CDIM)])
                           for v in range(nv)]))
    arefs.append(tocon(aref))
    Ds.append(tocon(Drows))
    Rs.append(tocon([Rn] * CDIM))
    zero = torch.zeros_like(dist)
    poss.append(tocon([dist, zero, zero, zero]))

    return EfcLanes(
        J=torch.cat(Jv, dim=1),
        aref=torch.cat(arefs, dim=0),
        D=torch.cat(Ds, dim=0),
        R=torch.cat(Rs, dim=0),
        pos=torch.cat(poss, dim=0),
        floss=floss,
        con_mu=mu,
        con_uscale=torch.stack(uscale, dim=1),             # (K, CDIM, B)
        con_active=active,
        con_Dn=Dn * active,
        neq=neqr,
        nf=nf,
        nl=nl,
    )


def make_efc_batched(m: Model, d: Data, s: State, con: Contact) -> Efc:
    """Batch-first Efc (leaves (B, ...)) for a batch-first Contact, assembled
    by `make_efc_lanes` and transposed; `is_floss`/`is_limit` mark the
    static scalar blocks and `floss` is zero outside the friction-loss rows."""
    el = make_efc_lanes(m, d, s, con)
    B = s.qpos.shape[0]
    NE = el.aref.shape[0]
    dev = el.aref.device
    fl = slice(el.neq, el.neq + el.nf)
    isf = torch.zeros(NE, dtype=torch.bool, device=dev)
    isf[fl] = True
    isl = torch.zeros(NE, dtype=torch.bool, device=dev)
    isl[el.neq + el.nf:el.neq + el.nf + el.nl] = True
    floss = torch.zeros(B, NE, dtype=el.aref.dtype, device=dev)
    floss[:, fl] = el.floss.T
    return Efc(
        J=el.J.permute(2, 1, 0),                           # (B, NE, nv)
        aref=el.aref.T,
        D=el.D.T,
        R=el.R.T,
        pos=el.pos.T,
        floss=floss,
        is_floss=isf.expand(B, NE),
        is_limit=isl.expand(B, NE),
        con_mu=el.con_mu.T,
        con_uscale=el.con_uscale.permute(2, 0, 1),         # (B, K, CDIM)
        con_active=el.con_active.T,
        con_Dn=el.con_Dn.T,
        neq=el.neq,
        nf=el.nf,
        nl=el.nl,
    )
