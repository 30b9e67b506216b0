"""Smooth (constraint-free) dynamics of one env: kinematics, CRBA, RNE,
actuation, semi-implicit Euler.

The port of `gym_so100_tpu/ops/smooth.py`, the single-env engine of the
Gymnasium adapter (`envs/gym_env.py`).  State and Data leaves have no env
axis; the loops over the 13 bodies and 12 dofs are Python loops over the
static tree, each step a small tensor op.  `smooth_lanes.py` is the batched
counterpart.

Conventions follow MuJoCo: quaternions (w, x, y, z); spatial 6-vectors are
[angular(3); linear(3)] in the world frame about the whole system's CoM;
free-joint linear velocity is world-frame, angular velocity body-local.
"""

from __future__ import annotations

import torch

from ..models.scene import JNT_FREE, JNT_HINGE, JNT_SLIDE, Data, Model, State
from . import linalg
from . import quat as quat_ops

# ---------------------------------------------------------------------------
# spatial algebra (6-vectors [ang, lin])
# ---------------------------------------------------------------------------


def motion_cross(v, m):
    """Spatial motion cross product v x m (both motion vectors)."""
    vang, vlin = v[..., :3], v[..., 3:]
    mang, mlin = m[..., :3], m[..., 3:]
    ang = quat_ops.cross(vang, mang)
    lin = quat_ops.cross(vlin, mang) + quat_ops.cross(vang, mlin)
    return torch.cat([ang, lin], dim=-1)


def force_cross(v, f):
    """Spatial force cross product v x* f (motion vector v, force vector f)."""
    vang, vlin = v[..., :3], v[..., 3:]
    fang, flin = f[..., :3], f[..., 3:]
    ang = quat_ops.cross(vang, fang) + quat_ops.cross(vlin, flin)
    lin = quat_ops.cross(vang, flin)
    return torch.cat([ang, lin], dim=-1)


def inert_mul(inr, v):
    """Spatial inertia (I about the origin, h = m c, m) times a motion vector:
    f_ang = I w + h x v_lin, f_lin = m v_lin - h x w."""
    I, h, mass = inr
    w, vl = v[..., :3], v[..., 3:]
    fang = torch.einsum("...ij,...j->...i", I, w) + quat_ops.cross(h, vl)
    flin = mass[..., None] * vl - quat_ops.cross(h, w)
    return torch.cat([fang, flin], dim=-1)


# ---------------------------------------------------------------------------
# forward kinematics
# ---------------------------------------------------------------------------


def kinematics(m: Model, s: State) -> Data:
    """Body, geom and site world poses from qpos (mj_kinematics)."""
    nb = m.nbody
    dtype, dev = s.qpos.dtype, s.qpos.device
    xpos = [None] * nb
    xquat = [None] * nb
    xpos[0] = torch.zeros(3, dtype=dtype, device=dev)
    xquat[0] = torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=dev)

    for b in range(1, nb):
        p = m.body_parentid[b]
        if m.body_mocapid[b] >= 0:
            mid = m.body_mocapid[b]
            xpos[b] = s.mocap_pos[mid]
            xquat[b] = s.mocap_quat[mid]
            continue
        pos = xpos[p] + quat_ops.rotate(xquat[p], m.body_pos[b])
        qt = quat_ops.mul(xquat[p], m.body_quat[b])
        jadr, jnum = m.body_jntadr[b], m.body_jntnum[b]
        for ji in range(jadr, jadr + jnum):
            jt = m.jnt_type[ji]
            qadr = m.jnt_qposadr[ji]
            if jt == JNT_FREE:
                pos = s.qpos[qadr:qadr + 3]
                qt = quat_ops.normalize(s.qpos[qadr + 3:qadr + 7])
            elif jt == JNT_HINGE:
                # rotation about the joint axis through its anchor
                qloc = quat_ops.from_axis_angle(m.jnt_axis[ji], s.qpos[qadr])
                anchor = pos + quat_ops.rotate(qt, m.jnt_pos[ji])
                qt = quat_ops.mul(qt, qloc)
                pos = anchor - quat_ops.rotate(qt, m.jnt_pos[ji])
            elif jt == JNT_SLIDE:
                pos = pos + quat_ops.rotate(qt, m.jnt_axis[ji]) * s.qpos[qadr]
            else:
                raise NotImplementedError("ball joints not supported")
        xpos[b] = pos
        xquat[b] = qt

    xpos = torch.stack(xpos)
    xquat = torch.stack(xquat)
    xipos = xpos + quat_ops.rotate(xquat, m.body_ipos)
    ximat = quat_ops.to_mat(quat_ops.mul(xquat, m.body_iquat))
    gb = list(m.geom_bodyid)
    sb = list(m.site_bodyid)
    return Data(
        xpos=xpos,
        xquat=xquat,
        xipos=xipos,
        ximat=ximat,
        geom_xpos=xpos[gb] + quat_ops.rotate(xquat[gb], m.geom_pos),
        geom_xmat=quat_ops.to_mat(quat_ops.mul(xquat[gb], m.geom_quat)),
        site_xpos=xpos[sb] + quat_ops.rotate(xquat[sb], m.site_pos),
        site_xmat=quat_ops.to_mat(quat_ops.mul(xquat[sb], m.site_quat)),
    )


# ---------------------------------------------------------------------------
# CoM quantities: subtree com, spatial inertias, dof motion axes
# ---------------------------------------------------------------------------


def _subtree_com(m: Model, d: Data) -> torch.Tensor:
    """(NB, 3) mass-weighted CoM of each body's subtree (mj_comPos)."""
    nb = m.nbody
    mass = m.body_mass
    sub_mass = [mass[b] for b in range(nb)]
    sub_mpos = [mass[b] * d.xipos[b] for b in range(nb)]
    for b in range(nb - 1, 0, -1):
        p = m.body_parentid[b]
        sub_mass[p] = sub_mass[p] + sub_mass[b]
        sub_mpos[p] = sub_mpos[p] + sub_mpos[b]
    return torch.stack([sub_mpos[b] / torch.clamp(sub_mass[b], min=1e-12)
                        for b in range(nb)])


def com_quantities(m: Model, d: Data):
    """subtree_com, each body's spatial inertia about the root com in the
    world frame (cinr), and the per-dof motion axes (cdof); mj_comPos.
    Returns (Data, cinr)."""
    subtree_com = _subtree_com(m, d)
    root_com = subtree_com[0]
    dtype, dev = d.xpos.dtype, d.xpos.device

    # I_world = R diag(inertia) R^T + m (c.c 1 - c c^T) (parallel axis)
    R = d.ximat
    I_rot = R @ torch.diag_embed(m.body_inertia) @ R.transpose(-1, -2)
    c = d.xipos - root_com
    cc = torch.einsum("bi,bj->bij", c, c)
    c2 = (c * c).sum(-1)
    eye = torch.eye(3, dtype=dtype, device=dev)
    I_full = I_rot + m.body_mass[:, None, None] * (c2[:, None, None] * eye - cc)
    cinr = (I_full, m.body_mass[:, None] * c, m.body_mass)

    cdof = [None] * m.nv
    zero3 = torch.zeros(3, dtype=dtype, device=dev)
    for j in range(len(m.jnt_type)):
        jt = m.jnt_type[j]
        b = m.jnt_bodyid[j]
        vadr = m.jnt_dofadr[j]
        if jt == JNT_FREE:
            for k in range(3):
                cdof[vadr + k] = torch.cat([zero3, eye[k]])
            # rotation dofs: the body frame's world axes (qvel angular is
            # body-local), anchored at the joint position
            anchor = d.xpos[b] + quat_ops.rotate(d.xquat[b], m.jnt_pos[j])
            offset = anchor - root_com
            Rb = quat_ops.to_mat(d.xquat[b])
            for k in range(3):
                ax = Rb[:, k]
                cdof[vadr + 3 + k] = torch.cat([ax, quat_ops.cross(ax, -offset)])
        elif jt == JNT_HINGE:
            ax = quat_ops.rotate(d.xquat[b], m.jnt_axis[j])
            anchor = d.xpos[b] + quat_ops.rotate(d.xquat[b], m.jnt_pos[j])
            offset = anchor - root_com
            cdof[vadr] = torch.cat([ax, quat_ops.cross(ax, -offset)])
        elif jt == JNT_SLIDE:
            ax = quat_ops.rotate(d.xquat[b], m.jnt_axis[j])
            cdof[vadr] = torch.cat([zero3, ax])
        else:
            raise NotImplementedError
    return d.replace(subtree_com=subtree_com, cdof=torch.stack(cdof)), cinr


# ---------------------------------------------------------------------------
# mass matrix (CRBA) and bias forces (RNE)
# ---------------------------------------------------------------------------


def _ancestor_mask(m: Model) -> list:
    """mask[i][j]: dof j lies on the path from dof i's body to the root."""
    def chain_dofs(b):
        dofs = set()
        while b != 0:
            jadr, jnum = m.body_jntadr[b], m.body_jntnum[b]
            for ji in range(jadr, jadr + jnum):
                base = m.jnt_dofadr[ji]
                n = 6 if m.jnt_type[ji] == JNT_FREE else 1
                dofs.update(range(base, base + n))
            b = m.body_parentid[b]
        return dofs

    out = []
    for i in range(m.nv):
        chain = chain_dofs(m.dof_bodyid[i])
        out.append([j in chain for j in range(m.nv)])
    return out


def crba(m: Model, d: Data, cinr) -> Data:
    """Dense mass matrix by the composite rigid body algorithm, and its
    Cholesky factor."""
    nb, nv = m.nbody, m.nv
    I, h, mass = cinr
    crb_I = [I[b] for b in range(nb)]
    crb_h = [h[b] for b in range(nb)]
    crb_m = [mass[b] for b in range(nb)]
    for b in range(nb - 1, 0, -1):
        p = m.body_parentid[b]
        crb_I[p] = crb_I[p] + crb_I[b]
        crb_h[p] = crb_h[p] + crb_h[b]
        crb_m[p] = crb_m[p] + crb_m[b]
    F = torch.stack([
        inert_mul((crb_I[m.dof_bodyid[i]], crb_h[m.dof_bodyid[i]],
                   crb_m[m.dof_bodyid[i]]), d.cdof[i])
        for i in range(nv)
    ])                                                   # (nv, 6)
    # Mfull[i, j] = F_i . cdof_j, as 6 multiply-adds on (nv, nv) slices
    Mfull = F[:, None, 0] * d.cdof[None, :, 0]
    for k in range(1, 6):
        Mfull = Mfull + F[:, None, k] * d.cdof[None, :, k]
    mask = torch.tensor(_ancestor_mask(m), device=Mfull.device)
    qM = torch.where(mask, Mfull, 0.0)
    qM = torch.where(mask.T, Mfull.T, qM)                # symmetrize
    qM = qM + torch.diag(m.dof_armature)
    return d.replace(qM=qM, qLD=linalg.chol_factor(qM))


def rne(m: Model, d: Data, s: State, cinr) -> Data:
    """Bias force C(qpos, qvel) by recursive Newton-Euler (mj_rne with
    flg_acc = 0), gravity included."""
    nb, nv = m.nbody, m.nv
    dtype, dev = s.qpos.dtype, s.qpos.device
    I, h, mass = cinr
    zero6 = torch.zeros(6, dtype=dtype, device=dev)

    # body velocities: cvel[b] = cvel[parent] + sum cdof_i qvel_i; cdof_dot
    # uses the velocity accumulated before the joint's own dofs
    cvel = [zero6] * nb
    cdof_dot = [zero6] * nv
    for b in range(1, nb):
        v = cvel[m.body_parentid[b]]
        jadr, jnum = m.body_jntadr[b], m.body_jntnum[b]
        for ji in range(jadr, jadr + jnum):
            base = m.jnt_dofadr[ji]
            n = 6 if m.jnt_type[ji] == JNT_FREE else 1
            if m.jnt_type[ji] == JNT_FREE:
                # translation dofs are constant; rotation dofs turn with the
                # body: derivative = v_after_translation x cdof
                v_trans = v
                for k in range(3):
                    v_trans = v_trans + d.cdof[base + k] * s.qvel[base + k]
                for k in range(3, 6):
                    cdof_dot[base + k] = motion_cross(v_trans, d.cdof[base + k])
            else:
                cdof_dot[base] = motion_cross(v, d.cdof[base])
            for k in range(n):
                v = v + d.cdof[base + k] * s.qvel[base + k]
        cvel[b] = v

    grav = torch.cat([torch.zeros(3, dtype=dtype, device=dev), -m.gravity.to(dtype)])
    cacc = [grav] * nb
    for b in range(1, nb):
        a = cacc[m.body_parentid[b]]
        jadr, jnum = m.body_jntadr[b], m.body_jntnum[b]
        for ji in range(jadr, jadr + jnum):
            base = m.jnt_dofadr[ji]
            n = 6 if m.jnt_type[ji] == JNT_FREE else 1
            for k in range(n):
                a = a + cdof_dot[base + k] * s.qvel[base + k]
        cacc[b] = a

    # f[b] = I a + v x* (I v), accumulated leaf to root
    cfrc = []
    for b in range(nb):
        inr_b = (I[b], h[b], mass[b])
        cfrc.append(inert_mul(inr_b, cacc[b])
                    + force_cross(cvel[b], inert_mul(inr_b, cvel[b])))
    for b in range(nb - 1, 0, -1):
        p = m.body_parentid[b]
        cfrc[p] = cfrc[p] + cfrc[b]
    qfrc_bias = torch.stack([torch.dot(d.cdof[i], cfrc[m.dof_bodyid[i]])
                             for i in range(nv)])
    return d.replace(qfrc_bias=qfrc_bias)


# ---------------------------------------------------------------------------
# actuation, passive forces, smooth acceleration
# ---------------------------------------------------------------------------


def actuation(m: Model, d: Data, s: State) -> Data:
    """Joint actuators with affine gain and bias: force = gain ctrl + b0 +
    b1 length - kv velocity, clipped to the force range (position servos:
    gain kp, b0 0, b1 -kp)."""
    dtype, dev = s.qpos.dtype, s.qpos.device
    if m.nu == 0:
        return d.replace(qfrc_actuator=torch.zeros(m.nv, dtype=dtype, device=dev))
    dofid = torch.tensor(m.actuator_dofid, dtype=torch.long, device=dev)
    # joint transmissions with gear 1; for 1-dof joints dofadr == qposadr
    length = s.qpos[dofid]
    velocity = s.qvel[dofid]
    ctrl = torch.clamp(s.ctrl, m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1])
    force = (m.actuator_kp * ctrl + m.actuator_bias0 + m.actuator_bias1 * length
             - m.actuator_kv * velocity)
    force = torch.clamp(force, m.actuator_forcerange[:, 0], m.actuator_forcerange[:, 1])
    qfrc = torch.zeros(m.nv, dtype=dtype, device=dev).index_add(0, dofid, force)
    return d.replace(qfrc_actuator=qfrc)


def passive(m: Model, d: Data, s: State) -> Data:
    """Passive joint damping (frictionloss is a constraint row)."""
    return d.replace(qfrc_passive=-m.dof_damping * s.qvel)


def cho_solve(L, b):
    """Solve (L L^T) x = b for a dense lower-triangular L, unrolled."""
    return linalg.chol_solve(L, b)


def smooth_acc(m: Model, d: Data) -> Data:
    """qacc_smooth = M^-1 (actuator + passive - bias)."""
    qfrc_smooth = d.qfrc_passive + d.qfrc_actuator - d.qfrc_bias
    return d.replace(qfrc_smooth=qfrc_smooth,
                     qacc_smooth=cho_solve(d.qLD, qfrc_smooth))


def forward_smooth(m: Model, s: State) -> Data:
    """FK -> com -> CRBA -> RNE -> actuation -> passive -> qacc_smooth."""
    d = kinematics(m, s)
    d, cinr = com_quantities(m, d)
    d = crba(m, d, cinr)
    d = rne(m, d, s, cinr)
    d = actuation(m, d, s)
    d = passive(m, d, s)
    return smooth_acc(m, d)


# ---------------------------------------------------------------------------
# integration (semi-implicit Euler, mj_Euler)
# ---------------------------------------------------------------------------


def integrate(m: Model, s: State, qacc: torch.Tensor) -> State:
    """qvel += h qacc, then qpos from the new qvel (free-joint quaternions
    by the exponential map, renormalized)."""
    h = m.timestep
    qvel = s.qvel + h * qacc
    qpos = s.qpos.clone()
    for j in range(len(m.jnt_type)):
        qadr, vadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
        if m.jnt_type[j] == JNT_FREE:
            qpos[qadr:qadr + 3] = qpos[qadr:qadr + 3] + h * qvel[vadr:vadr + 3]
            newq = quat_ops.integrate(qpos[qadr + 3:qadr + 7], qvel[vadr + 3:vadr + 6], h)
            qpos[qadr + 3:qadr + 7] = quat_ops.normalize(newq)
        else:
            qpos[qadr] = qpos[qadr] + h * qvel[vadr]
    return s.replace(qpos=qpos, qvel=qvel)
