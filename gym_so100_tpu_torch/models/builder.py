"""MJCF -> Model compiler, with no JAX in it.

The counterpart of `gym_so100_tpu/models/builder.py`: `_build` flattens the
parsed body tree (numpy), and `_compute_derived_on_host` fills the
quantities MuJoCo's compiler derives from the smooth dynamics at qpos0
(`stat_meaninertia`, dof/body invweight0, actuator kv from dampratio).
Those run the port's own smooth pass (`ops.smooth_lanes`) in float64 on the
CPU with a batch of one, then the finished Model moves to the requested
device and dtype.  The result equals the JAX package's Model leaf for leaf
(tests/test_torch_model.py).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from . import mjcf
from .scene import (
    GEOM_BOX,
    GEOM_MESH,
    JNT_FREE,
    JNT_HINGE,
    JNT_SLIDE,
    CollisionPairs,
    Model,
    State,
)

# The scene the batched env trains on, read in place from the JAX package's
# asset folder (the port keeps no copy of the assets).
ASSETS_XML = str(
    Path(__file__).resolve().parents[2]
    / "gym_so100_tpu" / "assets" / "so100_transfer_cube.xml"
)
# The Franka Panda end-effector scene (.obj meshes, general actuators, the
# finger-coupling joint equality and a mocap weld), read in place as well.
# It has nv = 15: it runs on the single-env engine (`ops/forward.py`
# `step`, `n_steps`); the CUDA Newton kernel is built for the SO100's nv = 12.
PANDA_XML = str(Path(ASSETS_XML).with_name("pandas_transfer_cube_ee.xml"))

_JNT_CODE = {"free": JNT_FREE, "hinge": JNT_HINGE, "slide": JNT_SLIDE}
_GEOM_CODE = {"box": GEOM_BOX, "mesh": GEOM_MESH, "sphere": 2, "capsule": 3,
              "cylinder": 5, "plane": 0}

_DEFAULT_SOLREF = np.array([0.02, 1.0])
_DEFAULT_SOLIMP = np.array([0.9, 0.95, 0.001, 0.5, 2.0])

HULL_BLOCK = 64
HULL_MAX = 64


def build_model(
    path: str = ASSETS_XML, max_contacts: int = 32, device="cuda",
    dtype=torch.float32, ccd_manifolds: bool = False,
) -> tuple[Model, dict]:
    """Compile an MJCF file into a Model on `device` with float leaves in
    `dtype`.

    Returns (model, aux) where aux holds build-only products (keyframes,
    meshes, render geoms, welds).  `device` defaults to the GPU and raises
    when there is none; pass device="cpu" to build for the CPU.
    ccd_manifolds=True also packs the exact hull/face-polygon tables of the
    strict-parity path (see the JAX builder)."""
    device = resolve_device(device)
    doc = mjcf.parse_mjcf(path)
    model, aux = _build(doc, max_contacts, ccd_manifolds)
    return model.to(device, dtype), aux


def _dfs(body: mjcf.Body):
    """Yield bodies in MuJoCo's DFS pre-order (world first)."""
    yield body
    for c in body.children:
        yield from _dfs(c)


def _build(doc, max_contacts, ccd_manifolds=False):
    bodies = list(_dfs(doc.worldbody))
    nbody = len(bodies)
    body_index = {id(b): i for i, b in enumerate(bodies)}
    body_name_to_id = {b.name: i for i, b in enumerate(bodies)}

    body_parentid = [0] * nbody
    for i, b in enumerate(bodies):
        for c in b.children:
            body_parentid[body_index[id(c)]] = i

    # ---- joints / dofs ----
    jnt_type, jnt_bodyid, jnt_axis, jnt_pos, jnt_range, jnt_limited = (
        [], [], [], [], [], [])
    jnt_qposadr, jnt_dofadr, jnt_names = [], [], []
    body_jntadr = [-1] * nbody
    body_jntnum = [0] * nbody
    dof_bodyid, dof_jntid, dof_armature, dof_damping, dof_frictionloss = (
        [], [], [], [], [])
    nq = nv = 0
    for bi, b in enumerate(bodies):
        if b.joints:
            body_jntadr[bi] = len(jnt_type)
            body_jntnum[bi] = len(b.joints)
        for j in b.joints:
            code = _JNT_CODE[j.type]
            jnt_type.append(code)
            jnt_bodyid.append(bi)
            jnt_axis.append(j.axis)
            jnt_pos.append(j.pos)
            jnt_range.append(j.range)
            jnt_limited.append(bool(j.limited))
            jnt_names.append(j.name)
            jnt_qposadr.append(nq)
            jnt_dofadr.append(nv)
            ndof = {JNT_FREE: 6, JNT_HINGE: 1, JNT_SLIDE: 1}[code]
            nqj = {JNT_FREE: 7, JNT_HINGE: 1, JNT_SLIDE: 1}[code]
            for _ in range(ndof):
                dof_bodyid.append(bi)
                dof_jntid.append(len(jnt_type) - 1)
                dof_armature.append(j.armature)
                dof_damping.append(j.damping)
                dof_frictionloss.append(j.frictionloss)
            nq += nqj
            nv += ndof

    # ---- weld ids (body welded to parent when jointless) ----
    body_weldid = [0] * nbody
    for bi in range(1, nbody):
        body_weldid[bi] = (
            bi if body_jntnum[bi] > 0 else body_weldid[body_parentid[bi]]
        )

    # ---- mocap ----
    body_mocapid = [-1] * nbody
    nmocap = 0
    for bi, b in enumerate(bodies):
        if b.mocap:
            body_mocapid[bi] = nmocap
            nmocap += 1

    # ---- geoms (with mesh->box canonicalization) ----
    g_type, g_bodyid, g_pos, g_quat, g_size = [], [], [], [], []
    g_friction, g_solref, g_solimp, g_condim, g_rgba = [], [], [], [], []
    g_contype, g_conaffinity, g_names, g_meshname = [], [], [], []
    g_origmesh = []
    render_geoms = []
    for bi, b in enumerate(bodies):
        for g in b.geoms:
            collidable = g.contype != 0 or g.conaffinity != 0
            gtype = _GEOM_CODE[g.type]
            pos, quat, size, meshname = g.pos, g.quat, g.size, g.mesh
            if gtype == GEOM_MESH:
                box = _detect_box(doc.meshes[g.mesh].verts)
                if box is not None:
                    center, half = box
                    pos = g.pos + _qrot(g.quat, center)
                    size = half
                    gtype = GEOM_BOX
                    meshname = None
            render_geoms.append(
                dict(body=bi, type=g.type, mesh=g.mesh, pos=g.pos,
                     quat=g.quat, size=g.size, rgba=g.rgba, group=g.group,
                     name=g.name)
            )
            if not collidable:
                continue
            g_type.append(gtype)
            g_bodyid.append(bi)
            g_pos.append(pos)
            g_quat.append(quat)
            g_size.append(size)
            g_friction.append(g.friction)
            g_solref.append(g.solref)
            g_solimp.append(g.solimp)
            g_condim.append(g.condim)
            g_rgba.append(g.rgba)
            g_contype.append(g.contype)
            g_conaffinity.append(g.conaffinity)
            g_names.append(g.name)
            g_meshname.append(meshname)
            g_origmesh.append(g.type == "mesh")
    ngeom = len(g_type)

    # ---- pack collision-mesh convex hulls (decimated to <= HULL_MAX) ----
    mesh_vert_list = []
    geom_vertadr = [-1] * ngeom
    geom_vertnum = [0] * ngeom
    geom_meshid = [-1] * ngeom
    mesh_ids = {}
    for gi in range(ngeom):
        mn = g_meshname[gi]
        if mn is None:
            continue
        if mn not in mesh_ids:
            hull = _convex_hull(doc.meshes[mn].verts)
            vadr = sum(len(v) for v in mesh_vert_list)
            mesh_ids[mn] = (len(mesh_ids), vadr, len(hull))
            mesh_vert_list.append(hull)
        mid, vadr, vnum = mesh_ids[mn]
        geom_meshid[gi] = mid
        geom_vertadr[gi] = vadr
        geom_vertnum[gi] = vnum
    mesh_verts = (
        np.concatenate(mesh_vert_list, axis=0) if mesh_vert_list
        else np.zeros((0, 3))
    )

    # ---- sites / cameras ----
    s_bodyid, s_pos, s_quat, s_names = [], [], [], []
    c_bodyid, c_pos, c_quat, c_fovy, c_mode, c_target, c_names = (
        [], [], [], [], [], [], [])
    for bi, b in enumerate(bodies):
        for st in b.sites:
            s_bodyid.append(bi)
            s_pos.append(st.pos)
            s_quat.append(st.quat)
            s_names.append(st.name)
        for cam in b.cameras:
            c_bodyid.append(bi)
            c_pos.append(cam.pos)
            c_quat.append(cam.quat)
            c_fovy.append(cam.fovy)
            c_mode.append(cam.mode)
            c_target.append(cam.target)
            c_names.append(cam.name)
    cam_targetbodyid = tuple(
        body_name_to_id[t] if t is not None else -1 for t in c_target
    )

    # ---- inertials ----
    body_mass = np.zeros(nbody)
    body_ipos = np.zeros((nbody, 3))
    body_iquat = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
    body_inertia = np.zeros((nbody, 3))
    for bi, b in enumerate(bodies):
        if b.inertial is not None:
            body_mass[bi] = b.inertial.mass
            body_ipos[bi] = b.inertial.pos
            body_iquat[bi] = b.inertial.quat
            body_inertia[bi] = b.inertial.diaginertia
        elif bi > 0 and body_jntnum[bi] == 0:
            # massless jointless body: MuJoCo's compiled ipos equals the
            # body's pos-in-parent (only body_invweight0 depends on this)
            body_ipos[bi] = b.pos
        elif body_jntnum[bi] > 0:
            raise NotImplementedError(
                f"body {b.name!r} is jointed but has no <inertial>"
            )

    # ---- actuators ----
    jnt_name_to_id = {n: i for i, n in enumerate(jnt_names)}
    a_dofid, a_kp, a_kv_spec, a_dampratio, a_fr, a_cr, a_names = (
        [], [], [], [], [], [], [])
    a_bias0, a_bias1 = [], []
    for a in doc.actuators:
        ji = jnt_name_to_id[a.joint]
        a_dofid.append(jnt_dofadr[ji])
        a_kp.append(a.kp)
        a_kv_spec.append(a.kv)
        a_dampratio.append(a.dampratio)
        # MuJoCo semantics: a (0, 0) force/ctrl range means unlimited
        fr = np.asarray(a.forcerange, dtype=float)
        if fr[0] == 0.0 and fr[1] == 0.0:
            fr = np.array([-np.inf, np.inf])
        a_fr.append(fr)
        cr = np.array(jnt_range[ji]) if a.inheritrange else np.asarray(
            a.ctrlrange, dtype=float
        )
        if cr[0] == 0.0 and cr[1] == 0.0:
            cr = np.array([-np.inf, np.inf])
        a_cr.append(cr)
        a_names.append(a.name)
        # affine bias: force = kp*ctrl + bias0 + bias1*length - kv*velocity
        if a.kind == "general":
            a_bias0.append(float(a.biasprm[0]))
            a_bias1.append(float(a.biasprm[1]))
        else:
            a_bias0.append(0.0)
            a_bias1.append(-a.kp)
    nu = len(a_dofid)

    # ---- joint equality couplings ----
    jeq = doc.joint_eqs
    jeq_q1 = tuple(jnt_qposadr[jnt_name_to_id[e.joint1]] for e in jeq)
    jeq_q2 = tuple(jnt_qposadr[jnt_name_to_id[e.joint2]] for e in jeq)
    jeq_v1 = tuple(jnt_dofadr[jnt_name_to_id[e.joint1]] for e in jeq)
    jeq_v2 = tuple(jnt_dofadr[jnt_name_to_id[e.joint2]] for e in jeq)

    # ---- qpos0 ----
    qpos0 = np.zeros(nq)
    for ji in range(len(jnt_type)):
        if jnt_type[ji] == JNT_FREE:
            adr = jnt_qposadr[ji]
            b = jnt_bodyid[ji]
            qpos0[adr: adr + 3] = bodies[b].pos
            qpos0[adr + 3: adr + 7] = bodies[b].quat

    # ---- collision pairs ----
    pairs = _collision_pairs(
        ngeom, g_type, g_bodyid, g_contype, g_conaffinity,
        body_weldid, body_parentid, doc.excludes, body_name_to_id,
    )
    pair_list = pairs.box_box + pairs.hull_box + pairs.hull_hull
    np_pairs = len(pair_list)
    pair_friction = np.zeros((np_pairs, 3))
    pair_solref = np.zeros((np_pairs, 2))
    pair_solimp = np.zeros((np_pairs, 5))
    pair_condim = []
    for pi, (g1, g2) in enumerate(pair_list):
        pair_friction[pi] = np.maximum(g_friction[g1], g_friction[g2])
        pair_solref[pi] = 0.5 * (np.asarray(g_solref[g1]) + np.asarray(g_solref[g2]))
        pair_solimp[pi] = 0.5 * (np.asarray(g_solimp[g1]) + np.asarray(g_solimp[g2]))
        pair_condim.append(max(g_condim[g1], g_condim[g2]))

    # ---- hull-pair collision blocks (packed, HULL_BLOCK per geom) ----
    hull_geoms = sorted({g for p in pairs.hull_box + pairs.hull_hull for g in p})
    hull_start = [-1] * ngeom
    blocks, lcens, lhalves = [], [], []
    for hg in hull_geoms:
        if g_type[hg] == GEOM_BOX:
            corners = np.array(
                [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                 for sz in (-1, 1)], dtype=np.float64,
            )
            v = np.asarray(g_size[hg])[None] * corners
        else:
            adr, num = geom_vertadr[hg], geom_vertnum[hg]
            v = mesh_verts[adr: adr + num]
        assert len(v) <= HULL_BLOCK, (hg, len(v))
        hull_start[hg] = len(blocks) * HULL_BLOCK
        blocks.append(np.concatenate([v, np.tile(v[:1], (HULL_BLOCK - len(v), 1))]))
        lo_, hi_ = v.min(0), v.max(0)
        lcens.append((lo_ + hi_) / 2)
        lhalves.append((hi_ - lo_) / 2)
    hull_vertsT = np.concatenate(blocks).T if blocks else np.zeros((3, 0))
    hull_lcen = np.asarray(lcens) if lcens else np.zeros((0, 3))
    hull_lhalf = np.asarray(lhalves) if lhalves else np.zeros((0, 3))

    exact = _exact_tables(doc, pairs, pair_list, g_origmesh, g_meshname,
                          g_size) if ccd_manifolds else None
    if exact is not None:
        pairs = dataclasses.replace(pairs, ccd=exact.pop("ccd"))
    else:
        exact = dict(
            exact_verts=np.zeros((0, 0, 3)), exact_polyn=np.zeros((0, 0, 3)),
            exact_polyvid=np.zeros((0, 0, 0), np.int32),
            exact_polynv=np.zeros((0, 0), np.int32), exact_nvert=(),
        )

    def f(x, shape=None):
        a = np.asarray(x, dtype=np.float64)
        if a.size == 0 and shape is not None:
            a = a.reshape(shape)
        return torch.from_numpy(a.copy())

    model = Model(
        nq=nq, nv=nv, nu=nu, nbody=nbody, ngeom=ngeom,
        nsite=len(s_bodyid), ncam=len(c_bodyid), nmocap=nmocap,
        body_parentid=tuple(body_parentid),
        body_jntadr=tuple(body_jntadr),
        body_jntnum=tuple(body_jntnum),
        body_weldid=tuple(body_weldid),
        body_mocapid=tuple(body_mocapid),
        jnt_type=tuple(jnt_type),
        jnt_bodyid=tuple(jnt_bodyid),
        jnt_qposadr=tuple(jnt_qposadr),
        jnt_dofadr=tuple(jnt_dofadr),
        jnt_limited=tuple(jnt_limited),
        dof_bodyid=tuple(dof_bodyid),
        dof_jntid=tuple(dof_jntid),
        geom_type=tuple(g_type),
        geom_bodyid=tuple(g_bodyid),
        geom_condim=tuple(g_condim),
        geom_meshid=tuple(geom_meshid),
        geom_vertadr=tuple(geom_vertadr),
        geom_vertnum=tuple(geom_vertnum),
        site_bodyid=tuple(s_bodyid),
        cam_bodyid=tuple(c_bodyid),
        cam_mode=tuple(c_mode),
        cam_targetbodyid=cam_targetbodyid,
        actuator_dofid=tuple(a_dofid),
        names_body=tuple(b.name for b in bodies),
        names_joint=tuple(jnt_names),
        names_geom=tuple(g_names),
        names_site=tuple(s_names),
        names_cam=tuple(c_names),
        names_actuator=tuple(a_names),
        timestep=doc.option.timestep,
        impratio=doc.option.impratio,
        cone=doc.option.cone,
        solver_iterations=doc.option.iterations,
        solver_tolerance=doc.option.tolerance,
        ls_iterations=doc.option.ls_iterations,
        pairs=pairs,
        max_contacts=max_contacts,
        fl_dofs=tuple(i for i in range(nv) if dof_frictionloss[i] > 0),
        hull_start=tuple(hull_start),
        eq_site1=tuple(s_names.index(w.site1) for w in doc.welds),
        eq_site2=tuple(s_names.index(w.site2) for w in doc.welds),
        eq_jnt_q1=jeq_q1,
        eq_jnt_q2=jeq_q2,
        eq_jnt_v1=jeq_v1,
        eq_jnt_v2=jeq_v2,
        pair_condim=tuple(pair_condim),
        exact_nvert=exact.pop("exact_nvert"),
        gravity=f(doc.option.gravity),
        body_pos=f([b.pos for b in bodies]),
        body_quat=f([b.quat for b in bodies]),
        body_ipos=f(body_ipos),
        body_iquat=f(body_iquat),
        body_mass=f(body_mass),
        body_inertia=f(body_inertia),
        body_invweight0=f(np.zeros((nbody, 2))),
        jnt_axis=f(jnt_axis, (0, 3)),
        jnt_pos=f(jnt_pos, (0, 3)),
        jnt_range=f(jnt_range, (0, 2)),
        jnt_solref=f(np.tile(_DEFAULT_SOLREF, (len(jnt_type), 1))),
        jnt_solimp=f(np.tile(_DEFAULT_SOLIMP, (len(jnt_type), 1))),
        dof_armature=f(dof_armature),
        dof_damping=f(dof_damping),
        dof_frictionloss=f(dof_frictionloss),
        dof_invweight0=f(np.zeros(nv)),
        dof_solref=f(np.tile(_DEFAULT_SOLREF, (nv, 1))),
        dof_solimp=f(np.tile(_DEFAULT_SOLIMP, (nv, 1))),
        geom_pos=f(g_pos, (0, 3)),
        geom_quat=f(g_quat, (0, 4)),
        geom_size=f(g_size, (0, 3)),
        geom_friction=f(g_friction, (0, 3)),
        geom_solref=f(g_solref, (0, 2)),
        geom_solimp=f(g_solimp, (0, 5)),
        geom_rgba=f(g_rgba, (0, 4)),
        mesh_verts=f(mesh_verts),
        exact_verts=f(exact["exact_verts"]),
        exact_polyn=f(exact["exact_polyn"]),
        exact_polyvid=torch.from_numpy(np.asarray(exact["exact_polyvid"], np.int32)),
        exact_polynv=torch.from_numpy(np.asarray(exact["exact_polynv"], np.int32)),
        site_pos=f(s_pos, (0, 3)),
        site_quat=f(s_quat, (0, 4)),
        cam_pos=f(c_pos, (0, 3)),
        cam_quat=f(c_quat, (0, 4)),
        cam_fovy=f(c_fovy, (0,)),
        actuator_kp=f(a_kp, (0,)),
        actuator_kv=f(np.zeros(nu)),
        actuator_bias0=f(a_bias0, (0,)),
        actuator_bias1=f(a_bias1, (0,)),
        actuator_forcerange=f(a_fr, (0, 2)),
        actuator_ctrlrange=f(a_cr, (0, 2)),
        qpos0=f(qpos0),
        pair_friction=f(pair_friction),
        pair_solref=f(pair_solref),
        pair_solimp=f(pair_solimp),
        pair_margin=f(np.zeros(np_pairs)),
        hull_vertsT=f(hull_vertsT),
        hull_lcen=f(hull_lcen),
        hull_lhalf=f(hull_lhalf),
        eq_solref=f([w.solref for w in doc.welds], (0, 2)),
        eq_solimp=f([w.solimp for w in doc.welds], (0, 5)),
        eq_jnt_poly=f([e.polycoef for e in jeq], (0, 5)),
        eq_jnt_solref=f([e.solref for e in jeq], (0, 2)),
        eq_jnt_solimp=f([e.solimp for e in jeq], (0, 5)),
    )

    model = _compute_derived_on_host(model, a_kp, a_kv_spec, a_dampratio)

    aux = dict(
        keyframes={k.name: (k.qpos, k.ctrl) for k in doc.keyframes},
        meshes=doc.meshes,
        render_geoms=render_geoms,
        welds=doc.welds,
    )
    return model, aux


def _exact_tables(doc, pairs, pair_list, g_origmesh, g_meshname, g_size):
    """Exact (non-decimated) hulls and coplanar-merged face polygons for
    every pair MuJoCo resolves with its native convex collider (the
    strict-parity manifold path of the JAX package)."""
    from . import hullpoly

    flat_id = {pg: i for i, pg in enumerate(pair_list)}
    ccd_list = [pg for pg in pair_list if g_origmesh[pg[0]] or g_origmesh[pg[1]]]
    xgeoms = sorted({g for pg in ccd_list for g in pg})
    xslot = {g: i for i, g in enumerate(xgeoms)}
    hv_list, poly_list = [], []
    for g in xgeoms:
        if g_meshname[g] is not None:
            hv, polys = hullpoly.hull_polygons(doc.meshes[g_meshname[g]].verts)
        else:
            hv, polys = hullpoly.box_polygons(np.asarray(g_size[g]))
        hv_list.append(np.asarray(hv, np.float64))
        poly_list.append(polys)
    VX = max(len(h) for h in hv_list)
    PX = max(len(p) for p in poly_list)
    PVX = max(max(len(loop) for _, loop in p) for p in poly_list)
    GX = len(xgeoms)
    exact_verts = np.zeros((GX, VX, 3))
    exact_polyn = np.zeros((GX, PX, 3))
    exact_polyvid = np.zeros((GX, PX, PVX), dtype=np.int32)
    exact_polynv = np.zeros((GX, PX), dtype=np.int32)
    nvert = []
    for i, (hv, polys_i) in enumerate(zip(hv_list, poly_list)):
        exact_verts[i, : len(hv)] = hv
        exact_verts[i, len(hv):] = hv[0]  # support-safe padding
        nvert.append(len(hv))
        for pi, (pnrm, loop) in enumerate(polys_i):
            exact_polyn[i, pi] = pnrm
            exact_polyvid[i, pi, : len(loop)] = loop
            exact_polynv[i, pi] = len(loop)
    return dict(
        exact_verts=exact_verts, exact_polyn=exact_polyn,
        exact_polyvid=exact_polyvid, exact_polynv=exact_polynv,
        exact_nvert=tuple(nvert),
        ccd=tuple(
            (pg[0], pg[1], flat_id[pg], xslot[pg[0]], xslot[pg[1]])
            for pg in ccd_list
        ),
    )


def _compute_derived_on_host(model: Model, kp, kv_spec, dampratio) -> Model:
    """kv from dampratio, stat_meaninertia and dof/body invweight0 from the
    smooth dynamics at qpos0 (MuJoCo compiler's mj_setConst stage), in
    float64 on the CPU: the port's smooth pass with a batch of one gives
    qM (CRBA), the inertial frames and cdof."""
    from ..ops import smooth_lanes

    m = model.to("cpu", torch.float64)
    nv, nu = m.nv, m.nu
    f64 = torch.float64
    s0 = State(
        qpos=m.qpos0[None],
        qvel=torch.zeros(1, nv, dtype=f64),
        ctrl=torch.zeros(1, nu, dtype=f64),
        mocap_pos=torch.zeros(1, m.nmocap, 3, dtype=f64),
        mocap_quat=torch.tensor([1.0, 0, 0, 0], dtype=f64).repeat(1, m.nmocap, 1),
    )
    sl = smooth_lanes.forward_smooth_lanes(m, s0)
    qM = sl["qM"][0].numpy()
    meaninertia = float(np.trace(qM) / m.nv)
    Minv = np.linalg.inv(qM)
    dof_invweight0 = np.diag(Minv)

    # body invweight0: mean diagonal of J M^-1 J^T for the point jacobian
    # at xipos (translation) and the rotation jacobian, like mj_setConst
    xipos = sl["xipos"][0].numpy()
    cdof = sl["cdof"][0].numpy()
    com0 = sl["subtree_com0"][0].numpy()
    body_invw = np.zeros((m.nbody, 2))
    for b in range(1, m.nbody):
        if m.body_weldid[b] == 0:
            continue
        Jt = np.zeros((3, nv))
        Jr = np.zeros((3, nv))
        bb = b
        chain = []
        while bb != 0:
            ja, jn = m.body_jntadr[bb], m.body_jntnum[bb]
            for ji in range(ja, ja + jn):
                base = m.jnt_dofadr[ji]
                n = 6 if m.jnt_type[ji] == JNT_FREE else 1
                chain.extend(range(base, base + n))
            bb = m.body_parentid[bb]
        offset = xipos[b] - com0
        for i in chain:
            ang = cdof[i, :3]
            lin = cdof[i, 3:] + np.cross(ang, offset)
            Jt[:, i] = lin
            Jr[:, i] = ang
        body_invw[b, 0] = np.trace(Jt @ Minv @ Jt.T) / 3.0
        body_invw[b, 1] = np.trace(Jr @ Minv @ Jr.T) / 3.0

    # kv = 2 * dampratio * sqrt(kp * M_ii(qpos0)), M including armature
    kv = np.zeros(nu)
    for ai in range(nu):
        if kv_spec[ai] != 0:
            kv[ai] = kv_spec[ai]
        elif dampratio[ai] > 0:
            i = m.actuator_dofid[ai]
            kv[ai] = 2.0 * dampratio[ai] * np.sqrt(kp[ai] * qM[i, i])

    return dataclasses.replace(
        model,
        stat_meaninertia=meaninertia,
        dof_invweight0=torch.from_numpy(dof_invweight0.copy()),
        body_invweight0=torch.from_numpy(body_invw),
        actuator_kv=torch.from_numpy(kv),
    )


def _convex_hull(verts: np.ndarray) -> np.ndarray:
    """Convex hull vertices, decimated to <= HULL_MAX support points.

    Decimation keeps the argmax-support vertex along a Fibonacci-sphere
    direction set, which bounds the support-function error of the
    sampled-direction narrowphase while keeping vertex counts small."""
    from scipy.spatial import ConvexHull

    if len(verts) > 3:
        try:
            hull = verts[np.unique(ConvexHull(verts).vertices)]
        except Exception:  # degenerate (flat) point set: keep every vertex
            hull = verts
    else:
        hull = verts
    if len(hull) <= HULL_MAX:
        return np.asarray(hull, dtype=np.float64)
    n = 4 * HULL_MAX
    i = np.arange(n)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    y = 1 - 2 * (i + 0.5) / n
    r = np.sqrt(np.maximum(0, 1 - y * y))
    dirs = np.stack([r * np.cos(phi * i), y, r * np.sin(phi * i)], -1)
    support = np.unique(np.argmax(dirs @ hull.T, axis=1))
    pts = hull[support]
    if len(pts) > HULL_MAX:
        # greedy farthest-point thinning
        keep = [0]
        d = np.linalg.norm(pts - pts[0], axis=1)
        for _ in range(HULL_MAX - 1):
            j = int(np.argmax(d))
            keep.append(j)
            d = np.minimum(d, np.linalg.norm(pts - pts[j], axis=1))
        pts = pts[sorted(keep)]
    return np.asarray(pts, dtype=np.float64)


def _detect_box(verts: np.ndarray):
    """(center, half_extents) if the vertex set is exactly the 8 corners of
    an axis-aligned box in mesh frame, else None."""
    if len(verts) != 8:
        return None
    lo, hi = verts.min(0), verts.max(0)
    center, half = (lo + hi) / 2, (hi - lo) / 2
    if np.any(half <= 0):
        return None
    corners = center + half * np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    )
    d = np.abs(verts[:, None, :] - corners[None, :, :]).sum(-1)
    if (d.min(0) < 1e-9 * max(1.0, np.abs(hi).max())).all():
        return center, half
    return None


def _qrot(q, v):
    w, x, y, z = q
    t = 2 * np.cross([x, y, z], v)
    return v + w * t + np.cross([x, y, z], t)


def _collision_pairs(
    ngeom, g_type, g_bodyid, g_contype, g_conaffinity,
    body_weldid, body_parentid, excludes, body_name_to_id,
) -> CollisionPairs:
    """Candidate pairs with MuJoCo's filtering semantics (contype/
    conaffinity, weld and parent-child filtering with the world exemption,
    explicit excludes)."""
    excl = set()
    for b1, b2 in excludes:
        i, j = body_name_to_id[b1], body_name_to_id[b2]
        excl.add((min(i, j), max(i, j)))

    box_box, hull_box, hull_hull = [], [], []
    for a in range(ngeom):
        for b in range(a + 1, ngeom):
            b1, b2 = g_bodyid[a], g_bodyid[b]
            if b1 == b2:
                continue
            w1, w2 = body_weldid[b1], body_weldid[b2]
            if w1 == w2:
                continue
            wp1 = body_weldid[body_parentid[w1]] if w1 else 0
            wp2 = body_weldid[body_parentid[w2]] if w2 else 0
            if w1 != 0 and w2 != 0 and (wp1 == w2 or wp2 == w1):
                continue
            if (min(b1, b2), max(b1, b2)) in excl:
                continue
            if not ((g_contype[a] & g_conaffinity[b])
                    or (g_contype[b] & g_conaffinity[a])):
                continue
            t1, t2 = g_type[a], g_type[b]
            if t1 == GEOM_BOX and t2 == GEOM_BOX:
                box_box.append((a, b))
            elif t1 == GEOM_MESH and t2 == GEOM_BOX:
                hull_box.append((a, b))
            elif t1 == GEOM_BOX and t2 == GEOM_MESH:
                hull_box.append((b, a))  # mesh first
            elif t1 == GEOM_MESH and t2 == GEOM_MESH:
                hull_hull.append((a, b))
            else:
                raise NotImplementedError(
                    f"collision pair types {t1},{t2} not supported"
                )
    return CollisionPairs(
        box_box=tuple(box_box), hull_box=tuple(hull_box),
        hull_hull=tuple(hull_hull),
    )
