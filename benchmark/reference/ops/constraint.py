"""Constraint helpers of the lanes assembly: impedance, stiffness and
damping, dof masks and the equality rows (a frozen copy of the port's).

Conventions follow MuJoCo's constraint model (mj_makeImpedance): sigmoid
impedance from solimp=(d0, dwidth, width, mid, power) with endpoints
clamped to [0.0001, 0.9999]; solref=(tc, zeta) > 0 gives K = 1/(dmax^2
tc^2 zeta^2), B = 2/(dmax tc), negative solref is direct stiffness/damping;
aref = -B*vel - K*imp*pos; R = max(MINVAL, (1-imp)/imp * diagApprox), D =
1/R.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.scene import JNT_FREE, JNT_HINGE, Data, Model, State
from . import quat

MINVAL = 1e-15
MINIMP = 0.0001
MAXIMP = 0.9999
CDIM = 4  # contact rows per slot (normal + 2 tangent + torsion; condim<=4)


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


def point_jacobians(m: Model, d: Data, body_ids, points):
    """Translational and rotational Jacobians of world `points` (B, N, 3)
    attached to `body_ids` (N,), from the com-frame cdof axes.  Returns
    (Jt, Jr), each (B, N, 3, nv)."""
    mk = torch.as_tensor(_body_dof_masks(m)[list(body_ids)], dtype=points.dtype,
                         device=points.device)              # (N, nv)
    ang = d.cdof[..., :3]                                   # (B, nv, 3)
    lin = d.cdof[..., 3:]
    offset = points - d.subtree_com[:, :1]                  # (B, N, 3)
    cross = torch.linalg.cross(ang[:, None], offset[:, :, None].expand(
        -1, -1, ang.shape[1], -1), dim=-1)                  # (B, N, nv, 3)
    Jt = (lin[:, None] + cross) * mk[None, :, :, None]
    Jr = ang[:, None] * mk[None, :, :, None]
    return Jt.transpose(-1, -2), Jr.transpose(-1, -2)


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
    if neq:
        s1, s2 = list(m.eq_site1), list(m.eq_site2)
        sb1 = [m.site_bodyid[i] for i in s1]
        sb2 = [m.site_bodyid[i] for i in s2]
        p1 = d.site_xpos[:, s1]                             # (B, NEQ, 3)
        p2 = d.site_xpos[:, s2]
        res_t = p1 - p2
        q1 = quat.from_mat(d.site_xmat[:, s1])
        q2 = quat.from_mat(d.site_xmat[:, s2])
        res_r = quat.mul(quat.conj(q2), q1)[..., 1:]
        Jt1, Jr1 = point_jacobians(m, d, sb1, p1)
        Jt2, Jr2 = point_jacobians(m, d, sb2, p2)
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

    njeq = len(m.eq_jnt_q1)
    if njeq:
        q1a, q2a = list(m.eq_jnt_q1), list(m.eq_jnt_q2)
        v1a, v2a = list(m.eq_jnt_v1), list(m.eq_jnt_v2)
        c = m.eq_jnt_poly                                   # (NJEQ, 5)
        x = s.qpos[:, q2a] - m.qpos0[q2a]
        poly = c[:, 0] + x * (c[:, 1] + x * (c[:, 2] + x * (c[:, 3] + x * c[:, 4])))
        dpoly = c[:, 1] + x * (2 * c[:, 2] + x * (3 * c[:, 3] + x * 4 * c[:, 4]))
        res = (s.qpos[:, q1a] - m.qpos0[q1a]) - poly        # (B, NJEQ)
        rows = torch.arange(njeq, device=dev)
        J = torch.zeros(B, njeq, nv, dtype=dtype, device=dev)
        J[:, rows, v1a] = 1.0
        J[:, rows, v2a] -= dpoly
        vel = s.qvel[:, v1a] - dpoly * s.qvel[:, v2a]
        imp = impedance(m.eq_jnt_solimp, res)
        K, Bk = kb(m.eq_jnt_solref, m.eq_jnt_solimp[:, 1])
        aref = -Bk * vel - K * imp * res
        diag = m.dof_invweight0[v1a] + m.dof_invweight0[v2a]
        R = torch.clamp((1 - imp) / imp * diag, min=MINVAL)
        blocks.append((J, aref, 1.0 / R, R, res))

    return blocks
