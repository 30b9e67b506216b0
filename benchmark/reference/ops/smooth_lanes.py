"""Smooth dynamics in batch-last "lanes" form.

The port of `gym_so100_tpu/ops/smooth_lanes.py`: FK, CoM quantities, CRBA,
RNE, affine actuation and semi-implicit Euler, with the env batch as the
minor axis of every quantity (vectors (3, B), quaternions (4, B), matrices
(3, 3, B), per-dof stacks (nv, B)).  Loops over the 13 bodies and 12 dofs
are Python loops over the static tree, as in the JAX package; each step is
one elementwise tensor op over the batch.

`kinematics` is the batched counterpart of `gym_so100_tpu/ops/smooth.py::
kinematics` (body, geom and site world poses, batch-first), used by the
env layer after the substeps and for the reset observation.
"""

from __future__ import annotations

import torch

from ..models.scene import JNT_FREE, JNT_HINGE, JNT_SLIDE, Data, Model, State

# ---------------------------------------------------------------------------
# lanes algebra: v = (3, B), q = (4, B), M = (3, 3, B) (nested lists)
# ---------------------------------------------------------------------------


def _cross(a, b):
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def _qmul(q, p):
    w1, x1, y1, z1 = q
    w2, x2, y2, z2 = p
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _qrot(q, v):
    """Rotate v by quaternion q (MuJoCo convention, w first)."""
    w = q[0]
    u = q[1:]
    t = 2.0 * _cross(u, v)
    return v + w * t + _cross(u, t)


def _qnormalize(q, eps=1e-12):
    n = torch.sqrt(q[0] ** 2 + q[1] ** 2 + q[2] ** 2 + q[3] ** 2)
    return q / torch.clamp(n, min=eps)


def _qmat(q):
    """Quaternion -> rotation matrix (3, 3, B)."""
    w, x, y, z = q
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])


def _axis_angle_q(axis, angle):
    """axis: (3,) model constant; angle: (B,)."""
    half = 0.5 * angle
    s = torch.sin(half)
    return torch.stack([torch.cos(half), axis[0] * s, axis[1] * s, axis[2] * s])


def _col(v):
    """(k,) model constant -> broadcastable (k, 1) lanes column."""
    return v[:, None]


def _motion_cross(v, m):
    """Spatial motion cross v x m on 6-row lanes stacks (6, B)."""
    vang, vlin = v[:3], v[3:]
    mang, mlin = m[:3], m[3:]
    return torch.cat([
        _cross(vang, mang),
        _cross(vlin, mang) + _cross(vang, mlin),
    ])


def _force_cross(v, f):
    vang, vlin = v[:3], v[3:]
    fang, flin = f[:3], f[3:]
    return torch.cat([
        _cross(vang, fang) + _cross(vlin, flin),
        _cross(vang, flin),
    ])


def _inert_mul(I, h, mass, v):
    """Spatial inertia (I (3,3,B), h (3,B), mass) x motion (6,B)."""
    w, vl = v[:3], v[3:]
    Iw = torch.stack([
        I[0][0] * w[0] + I[0][1] * w[1] + I[0][2] * w[2],
        I[1][0] * w[0] + I[1][1] * w[1] + I[1][2] * w[2],
        I[2][0] * w[0] + I[2][1] * w[1] + I[2][2] * w[2],
    ])
    fang = Iw + _cross(h, vl)
    flin = mass * vl - _cross(h, w)
    return torch.cat([fang, flin])


# ---------------------------------------------------------------------------
# forward kinematics
# ---------------------------------------------------------------------------


def _fk_lanes(m: Model, s: State):
    """Body frames in lanes form: lists of xpos (3, B) and xquat (4, B)."""
    dtype, dev = s.qpos.dtype, s.qpos.device
    B = s.qpos.shape[0]
    nb = m.nbody
    qp = s.qpos.T
    xpos = [None] * nb
    xquat = [None] * nb
    xpos[0] = torch.zeros(3, B, dtype=dtype, device=dev)
    xquat[0] = torch.cat([
        torch.ones(1, B, dtype=dtype, device=dev),
        torch.zeros(3, B, dtype=dtype, device=dev),
    ])
    if m.nmocap:
        mocap_pos = s.mocap_pos.permute(1, 2, 0)     # (nmocap, 3, B)
        mocap_quat = s.mocap_quat.permute(1, 2, 0)
    for b in range(1, nb):
        p = m.body_parentid[b]
        if m.body_mocapid[b] >= 0:
            mid = m.body_mocapid[b]
            xpos[b] = mocap_pos[mid]
            xquat[b] = mocap_quat[mid]
            continue
        pos = xpos[p] + _qrot(xquat[p], _col(m.body_pos[b]))
        qt = _qmul(xquat[p], _col(m.body_quat[b]).expand(4, B))
        jadr, jnum = m.body_jntadr[b], m.body_jntnum[b]
        for ji in range(jadr, jadr + jnum):
            jt = m.jnt_type[ji]
            qadr = m.jnt_qposadr[ji]
            if jt == JNT_FREE:
                pos = qp[qadr: qadr + 3]
                qt = _qnormalize(qp[qadr + 3: qadr + 7])
            elif jt == JNT_HINGE:
                qloc = _axis_angle_q(m.jnt_axis[ji], qp[qadr])
                anchor = pos + _qrot(qt, _col(m.jnt_pos[ji]))
                qt = _qmul(qt, qloc)
                pos = anchor - _qrot(qt, _col(m.jnt_pos[ji]))
            elif jt == JNT_SLIDE:
                pos = pos + _qrot(qt, _col(m.jnt_axis[ji])) * qp[qadr]
            else:
                raise NotImplementedError("ball joints not supported")
        xpos[b] = pos
        xquat[b] = qt
    return xpos, xquat


def _frames_for(xpos, xquat, bodyids, pos_c, quat_c, B, dtype, dev):
    """World frames of geoms or sites attached to `bodyids`, batch-first:
    positions (B, N, 3) and rotation matrices (B, N, 3, 3)."""
    if len(bodyids) == 0:
        return (torch.zeros(B, 0, 3, dtype=dtype, device=dev),
                torch.zeros(B, 0, 3, 3, dtype=dtype, device=dev))
    px, mx = [], []
    for k, b in enumerate(bodyids):
        px.append(xpos[b] + _qrot(xquat[b], _col(pos_c[k])))
        mx.append(_qmat(_qmul(xquat[b], _col(quat_c[k]))))
    return (torch.stack(px).permute(2, 0, 1),
            torch.stack(mx).permute(3, 0, 1, 2))


def kinematics(m: Model, s: State) -> Data:
    """Body/geom/site world poses for a batched State (leaves (B, ...)):
    the batched counterpart of `smooth.kinematics` in the JAX package."""
    dtype, dev = s.qpos.dtype, s.qpos.device
    B = s.qpos.shape[0]
    xpos, xquat = _fk_lanes(m, s)
    nb = m.nbody
    xipos = [xpos[b] + _qrot(xquat[b], _col(m.body_ipos[b])) for b in range(nb)]
    ximat = [_qmat(_qmul(xquat[b], _col(m.body_iquat[b]))) for b in range(nb)]
    geom_xpos, geom_xmat = _frames_for(
        xpos, xquat, m.geom_bodyid, m.geom_pos, m.geom_quat, B, dtype, dev)
    site_xpos, site_xmat = _frames_for(
        xpos, xquat, m.site_bodyid, m.site_pos, m.site_quat, B, dtype, dev)
    return Data(
        xpos=torch.stack(xpos).permute(2, 0, 1),
        xquat=torch.stack(xquat).permute(2, 0, 1),
        xipos=torch.stack(xipos).permute(2, 0, 1),
        ximat=torch.stack(ximat).permute(3, 0, 1, 2),
        geom_xpos=geom_xpos,
        geom_xmat=geom_xmat,
        site_xpos=site_xpos,
        site_xmat=site_xmat,
    )


# ---------------------------------------------------------------------------
# forward pipeline
# ---------------------------------------------------------------------------


def forward_smooth_lanes(m: Model, s: State):
    """Full smooth pipeline on a batched State (leaves (B, ...)).

    Returns a dict with the batch-first views the later stages consume:
      geom_xpos (B, NG, 3), geom_xmat (B, NG, 3, 3), site_xpos/site_xmat,
      xipos (B, NB, 3), cdof (B, nv, 6), subtree_com0 (B, 3),
      qM (B, nv, nv), qacc_smooth, qfrc_actuator/passive/bias/smooth (B, nv),
    and qM_lanes, the (nv, nv, B) mass matrix the solver reads."""
    dtype, dev = s.qpos.dtype, s.qpos.device
    B = s.qpos.shape[0]
    nb, nv = m.nbody, m.nv
    qp = s.qpos.T            # (nq, B)
    qv = s.qvel.T            # (nv, B)
    zeros = lambda *shape: torch.zeros(*shape, dtype=dtype, device=dev)

    # ---- kinematics ----
    xpos, xquat = _fk_lanes(m, s)
    xipos = [xpos[b] + _qrot(xquat[b], _col(m.body_ipos[b])) for b in range(nb)]
    ximat = [_qmat(_qmul(xquat[b], _col(m.body_iquat[b]))) for b in range(nb)]
    geom_xpos, geom_xmat = _frames_for(
        xpos, xquat, m.geom_bodyid, m.geom_pos, m.geom_quat, B, dtype, dev)
    site_xpos, site_xmat = _frames_for(
        xpos, xquat, m.site_bodyid, m.site_pos, m.site_quat, B, dtype, dev)

    # ---- subtree com ----
    mass = [m.body_mass[b] for b in range(nb)]
    sub_mass = list(mass)
    sub_mpos = [mass[b] * xipos[b] for b in range(nb)]
    for b in range(nb - 1, 0, -1):
        p = m.body_parentid[b]
        sub_mass[p] = sub_mass[p] + sub_mass[b]
        sub_mpos[p] = sub_mpos[p] + sub_mpos[b]
    root_com = sub_mpos[0] / torch.clamp(sub_mass[0], min=1e-12)

    # ---- spatial inertia about the root com ----
    eye = torch.eye(3, dtype=dtype, device=dev)
    cI, ch = [], []
    for b in range(nb):
        R = ximat[b]                      # (3,3,B)
        diag = m.body_inertia[b]          # (3,)
        Irot = [[
            R[i][0] * diag[0] * R[j][0]
            + R[i][1] * diag[1] * R[j][1]
            + R[i][2] * diag[2] * R[j][2]
            for j in range(3)] for i in range(3)]
        c = xipos[b] - root_com
        c2 = c[0] * c[0] + c[1] * c[1] + c[2] * c[2]
        cI.append(torch.stack([
            torch.stack([
                Irot[i][j] + mass[b] * (c2 * eye[i, j] - c[i] * c[j])
                for j in range(3)
            ])
            for i in range(3)
        ]))
        ch.append(mass[b] * c)

    # ---- cdof ----
    cdof = [None] * nv
    for j in range(len(m.jnt_type)):
        jt = m.jnt_type[j]
        b = m.jnt_bodyid[j]
        vadr = m.jnt_dofadr[j]
        if jt == JNT_FREE:
            for k in range(3):
                cdof[vadr + k] = torch.cat([zeros(3, B), eye[:, k:k + 1].expand(3, B)])
            anchor = xpos[b] + _qrot(xquat[b], _col(m.jnt_pos[j]))
            offset = anchor - root_com
            Rb = _qmat(xquat[b])
            for k in range(3):
                ax = torch.stack([Rb[0][k], Rb[1][k], Rb[2][k]])
                cdof[vadr + 3 + k] = torch.cat([ax, _cross(ax, -offset)])
        elif jt == JNT_HINGE:
            ax = _qrot(xquat[b], _col(m.jnt_axis[j]))
            anchor = xpos[b] + _qrot(xquat[b], _col(m.jnt_pos[j]))
            offset = anchor - root_com
            cdof[vadr] = torch.cat([ax, _cross(ax, -offset)])
        elif jt == JNT_SLIDE:
            ax = _qrot(xquat[b], _col(m.jnt_axis[j]))
            cdof[vadr] = torch.cat([zeros(3, B), ax])
        else:
            raise NotImplementedError

    # ---- CRBA ----
    crb_I = list(cI)
    crb_h = list(ch)
    crb_m = [mass[b].expand(B) for b in range(nb)]
    for b in range(nb - 1, 0, -1):
        p = m.body_parentid[b]
        crb_I[p] = crb_I[p] + crb_I[b]
        crb_h[p] = crb_h[p] + crb_h[b]
        crb_m[p] = crb_m[p] + crb_m[b]

    F = [
        _inert_mul(crb_I[m.dof_bodyid[i]], crb_h[m.dof_bodyid[i]],
                   crb_m[m.dof_bodyid[i]], cdof[i])
        for i in range(nv)
    ]
    amask = _ancestor_mask(m)
    qM = [[None] * nv for _ in range(nv)]
    for i in range(nv):
        for j in range(i + 1):
            if amask[i][j] or amask[j][i] or i == j:
                v = (
                    F[i][0] * cdof[j][0] + F[i][1] * cdof[j][1]
                    + F[i][2] * cdof[j][2] + F[i][3] * cdof[j][3]
                    + F[i][4] * cdof[j][4] + F[i][5] * cdof[j][5]
                )
            else:
                v = zeros(B)
            if i == j:
                v = v + m.dof_armature[i]
            qM[i][j] = v
            qM[j][i] = v

    # ---- RNE (bias forces incl. gravity) ----
    cvel = [zeros(6, B)] * nb
    cdof_dot = [zeros(6, B)] * nv
    for b in range(1, nb):
        p = m.body_parentid[b]
        v = cvel[p]
        jadr, jnum = m.body_jntadr[b], m.body_jntnum[b]
        for ji in range(jadr, jadr + jnum):
            base = m.jnt_dofadr[ji]
            n = 6 if m.jnt_type[ji] == JNT_FREE else 1
            if m.jnt_type[ji] == JNT_FREE:
                v_trans = v
                for k in range(3):
                    v_trans = v_trans + cdof[base + k] * qv[base + k]
                for k in range(3, 6):
                    cdof_dot[base + k] = _motion_cross(v_trans, cdof[base + k])
            else:
                cdof_dot[base] = _motion_cross(v, cdof[base])
            for k in range(n):
                v = v + cdof[base + k] * qv[base + k]
        cvel[b] = v

    grav = torch.cat([zeros(3, B), (-m.gravity)[:, None].expand(3, B)])
    cacc = [grav] * nb
    for b in range(1, nb):
        p = m.body_parentid[b]
        a = cacc[p]
        jadr, jnum = m.body_jntadr[b], m.body_jntnum[b]
        for ji in range(jadr, jadr + jnum):
            base = m.jnt_dofadr[ji]
            n = 6 if m.jnt_type[ji] == JNT_FREE else 1
            for k in range(n):
                a = a + cdof_dot[base + k] * qv[base + k]
        cacc[b] = a

    cfrc = []
    for b in range(nb):
        cfrc.append(
            _inert_mul(cI[b], ch[b], mass[b], cacc[b])
            + _force_cross(cvel[b], _inert_mul(cI[b], ch[b], mass[b], cvel[b]))
        )
    for b in range(nb - 1, 0, -1):
        p = m.body_parentid[b]
        cfrc[p] = cfrc[p] + cfrc[b]

    qfrc_bias = [
        torch.sum(cdof[i] * cfrc[m.dof_bodyid[i]], dim=0) for i in range(nv)
    ]

    # ---- actuation + passive ----
    qfrc_act = [zeros(B) for _ in range(nv)]
    for ai in range(m.nu):
        di = m.actuator_dofid[ai]
        ctrl = torch.clamp(
            s.ctrl[:, ai], m.actuator_ctrlrange[ai, 0], m.actuator_ctrlrange[ai, 1]
        )
        force = (
            m.actuator_kp[ai] * ctrl + m.actuator_bias0[ai]
            + m.actuator_bias1[ai] * qp[di] - m.actuator_kv[ai] * qv[di]
        )
        force = torch.clamp(
            force, m.actuator_forcerange[ai, 0], m.actuator_forcerange[ai, 1]
        )
        qfrc_act[di] = qfrc_act[di] + force
    qfrc_pass = [-m.dof_damping[i] * qv[i] for i in range(nv)]
    qfrc_smooth = [qfrc_pass[i] + qfrc_act[i] - qfrc_bias[i] for i in range(nv)]

    # ---- qacc_smooth = M^-1 qfrc_smooth (batched Cholesky) ----
    qM_lanes = torch.stack([torch.stack(row) for row in qM])   # (nv, nv, B)
    L = _chol_lanes(qM_lanes)
    qacc_smooth = _chol_solve_lanes(L, torch.stack(qfrc_smooth))

    to_vec = lambda rows: torch.stack(rows, dim=-1)            # (B, nv)
    return dict(
        geom_xpos=geom_xpos,
        geom_xmat=geom_xmat,
        site_xpos=site_xpos,
        site_xmat=site_xmat,
        xipos=torch.stack(xipos).permute(2, 0, 1),
        subtree_com0=root_com.T,
        cdof=torch.stack(cdof).permute(2, 0, 1),
        qM=qM_lanes.permute(2, 0, 1),
        qM_lanes=qM_lanes,
        qacc_smooth=qacc_smooth.T,
        qfrc_actuator=to_vec(qfrc_act),
        qfrc_passive=to_vec(qfrc_pass),
        qfrc_bias=to_vec(qfrc_bias),
        qfrc_smooth=to_vec(qfrc_smooth),
    )


def _ancestor_mask(m: Model):
    """Static (nv, nv) ancestor-dof mask."""
    nv = m.nv

    def dofs_of_body_chain(b):
        dofs = []
        while b != 0:
            ja, jn = m.body_jntadr[b], m.body_jntnum[b]
            for ji in range(ja, ja + jn):
                base = m.jnt_dofadr[ji]
                n = 6 if m.jnt_type[ji] == JNT_FREE else 1
                dofs.extend(range(base, base + n))
            b = m.body_parentid[b]
        return set(dofs)

    mask = []
    for i in range(nv):
        chain = dofs_of_body_chain(m.dof_bodyid[i])
        mask.append(tuple(j in chain for j in range(nv)))
    return tuple(mask)


def _chol_lanes(A):
    """Lower Cholesky factor of symmetric A (n, n, B), column by column.

    Same recurrence and pivot clamp (sqrt(tiny)) as the JAX package's
    unrolled scalar form; each column is one batched update instead of
    O(n) scalar ones."""
    n = A.shape[0]
    tiny = torch.finfo(A.dtype).tiny ** 0.5
    L = torch.zeros_like(A)
    for j in range(n):
        Lj = L[j, :j]                                   # (j, B)
        d = torch.sqrt(torch.clamp(A[j, j] - (Lj * Lj).sum(0), min=tiny))
        L[j, j] = d
        if j + 1 < n:
            col = A[j + 1:, j] - (L[j + 1:, :j] * Lj[None]).sum(1)
            L[j + 1:, j] = col * (1.0 / d)
    return L


def _chol_solve_lanes(L, b):
    """Solve (L L^T) x = b for b (n, B) by forward and back substitution."""
    n = L.shape[0]
    y = torch.zeros_like(b)
    for i in range(n):
        y[i] = (b[i] - (L[i, :i] * y[:i]).sum(0)) / L[i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        x[i] = (y[i] - (L[i + 1:, i] * x[i + 1:]).sum(0)) / L[i, i]
    return x


def integrate_lanes(m: Model, s: State, qacc):
    """Semi-implicit Euler on the batched State (qacc (B, nv))."""
    h = m.timestep
    qvel = s.qvel + h * qacc
    qp = s.qpos.T
    qv = qvel.T
    out = [qp[i] for i in range(qp.shape[0])]
    for j in range(len(m.jnt_type)):
        jt = m.jnt_type[j]
        qadr, vadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
        if jt == JNT_FREE:
            for k in range(3):
                out[qadr + k] = out[qadr + k] + h * qv[vadr + k]
            quat = torch.stack([out[qadr + 3 + k] for k in range(4)])
            omega = qv[vadr + 3: vadr + 6]
            # q * exp(h/2 * omega) (MuJoCo mju_quatIntegrate)
            angle = torch.sqrt(omega[0] ** 2 + omega[1] ** 2 + omega[2] ** 2)
            half = 0.5 * h * angle
            sc = torch.where(
                angle > 1e-12,
                torch.sin(half) / torch.clamp(angle, min=1e-12),
                torch.full_like(angle, 0.5 * h),
            )
            dq = torch.stack([torch.cos(half), omega[0] * sc, omega[1] * sc,
                              omega[2] * sc])
            newq = _qnormalize(_qmul(quat, dq))
            for k in range(4):
                out[qadr + 3 + k] = newq[k]
        else:
            out[qadr] = out[qadr] + h * qv[vadr]
    return s.replace(qpos=torch.stack(out, dim=-1), qvel=qvel)
