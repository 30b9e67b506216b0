"""The single-env engine's narrowphase against the JAX package's, on the CPU.

Same inputs on both sides: the Models through the bridge
(`convert.model_from_numpy`), the geom poses of two scene states from the
JAX kinematics: "touchdown" (the cube tilted 2.6 degrees, pressing 0.5 mm
into the table), "resting" (the cube flat, 0.5 mm into the table: a
face-face manifold of 4 points) and "gripper" (the cube between the finger
pads, with the jaws half open: pad-box and jaw-mesh contacts, 27
candidates for K = 32).

Tolerances: float64 to 1e-10 (absolute and relative) on every active
contact's depth, position and normal, and on the Contact buffer slot by
slot; float32 to 1e-5.  Active masks, candidate counts (ncand), pair ids
and the integer fields are equal.  Where two active slots tie in depth the
selection may order them differently, so the buffer is also compared as a
set of (pair, value) rows (as `test_torch_ee_float32.py` does); the
selection is stable (lower candidate index first) on both sides, so the
slot-by-slot comparison holds here.

Also: the port-built float64 ccd Model (build_model(ccd_manifolds=True))
equals the bridged JAX one leaf by leaf, and the batched collider's float64
hull route (per-env `_hull_chunk`, GJK/EPA) matches JAX's `collide_batched`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.envs.gym_env import ASSETS_XML
from gym_so100_tpu.models.builder import build_model as jax_build_model
from gym_so100_tpu.ops import forward as jax_fwd
from gym_so100_tpu.ops import smooth as jax_smooth
from gym_so100_tpu.ops.collision import boxbox as jax_boxbox
from gym_so100_tpu.ops.collision import gjk as jax_gjk
from gym_so100_tpu.ops.collision import manifold as jax_manifold
from gym_so100_tpu.ops.collision import narrowphase as jax_np
from gym_so100_tpu_torch.models.builder import build_model
from gym_so100_tpu_torch.models.convert import model_from_numpy
from gym_so100_tpu_torch.ops.collision import boxbox, gjk, manifold, narrowphase

K = 32
STATES = ("touchdown", "resting", "gripper")
TOL = {jnp.float64: 1e-10, jnp.float32: 1e-5}
START = [0.0, -0.96, 1.16, 0.0, 0.0, 0.02239]


def _leaves(obj):
    return {f.name: (np.asarray(v) if hasattr(v, "shape") and hasattr(v, "dtype") else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, tol, name):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol, err_msg=name)


@pytest.fixture(scope="module")
def models():
    out = {}
    for ccd in (True, False):
        mj, _ = jax_build_model(ASSETS_XML, max_contacts=K, ccd_manifolds=ccd)
        for dt in (jnp.float64, jnp.float32):
            m = mj.astype(dt)
            out[ccd, dt] = (m, model_from_numpy(_leaves(m)))
    return out


def _qpos(mj, state):
    q = np.asarray(mj.qpos0, np.float64).copy()
    q[:6] = START
    if state == "touchdown":
        q[6:9] = [-0.2, 0.45, 0.0195]
        quat = np.array([0.999, 0.02, 0.01, 0.0])
        q[9:13] = quat / np.linalg.norm(quat)
    elif state == "resting":
        q[6:9] = [-0.2, 0.45, 0.0195]
        q[9:13] = [1.0, 0.0, 0.0, 0.0]
    else:
        # the cube midway between the fixed and the moving finger pads
        q[5] = 0.3
        s = jax_fwd.make_state(mj, qpos=jnp.asarray(q))
        d = jax_smooth.kinematics(mj, s)
        pads = [[mj.geom_id(f"{side}_jaw_pad_{i}") for i in range(1, 5)]
                for side in ("fixed", "moving")]
        xpos = np.asarray(d.geom_xpos, np.float64)
        q[6:9] = 0.5 * (xpos[pads[0]].mean(0) + xpos[pads[1]].mean(0))
    return q


@pytest.fixture(scope="module")
def poses(models):
    """{(ccd, dtype, state): (JAX Data, port Data)}: kinematics of the same
    qpos on each side (JAX's geom poses bridged, so both colliders see the
    same bits)."""
    from gym_so100_tpu_torch.models.scene import Data

    out = {}
    for (ccd, dt), (mj, mt) in models.items():
        for state in STATES:
            s = jax_fwd.make_state(mj, qpos=jnp.asarray(_qpos(mj, state), dt))
            dj = jax.jit(lambda s, mj=mj: jax_smooth.kinematics(mj, s))(s)
            dt_ = Data(geom_xpos=t(dj.geom_xpos), geom_xmat=t(dj.geom_xmat))
            out[ccd, dt, state] = (dj, dt_)
    return out


DTYPES = pytest.mark.parametrize("dt", [jnp.float64, jnp.float32], ids=["f64", "f32"])


def test_ccd_model_bridge_equals_the_port_build(models):
    """The port's build_model(ccd_manifolds=True) and the bridged JAX ccd
    Model are equal leaf by leaf (floats to 1e-12)."""
    mj, mb = models[True, jnp.float64]
    mt, _ = build_model(ASSETS_XML, max_contacts=K, device="cpu", dtype=torch.float64,
                        ccd_manifolds=True)
    assert len(mt.pairs.ccd) == 138 and mt.pairs == mb.pairs
    for f in dataclasses.fields(mt):
        a, b = getattr(mt, f.name), getattr(mb, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            if a.is_floating_point():
                close(a.numpy(), b.numpy(), 1e-12, f.name)
            else:
                assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("state", STATES)
@DTYPES
def test_box_box_matches_jax(models, poses, dt, state):
    """Every box pair of the table through `boxbox.box_box`."""
    mj, mt = models[False, dt]
    dj, dtt = poses[False, dt, state]
    bb = mj.pairs.box_box
    g1 = [p[0] for p in bb]
    g2 = [p[1] for p in bb]
    oj = jax.jit(jax.vmap(jax_boxbox.box_box))(
        dj.geom_xpos[np.array(g1)], dj.geom_xmat[np.array(g1)], mj.geom_size[np.array(g1)],
        dj.geom_xpos[np.array(g2)], dj.geom_xmat[np.array(g2)], mj.geom_size[np.array(g2)])
    ot = boxbox.box_box(dtt.geom_xpos[g1], dtt.geom_xmat[g1], mt.geom_size[g1],
                        dtt.geom_xpos[g2], dtt.geom_xmat[g2], mt.geom_size[g2])
    act = np.asarray(oj["active"])
    np.testing.assert_array_equal(ot["active"].numpy(), act)
    assert act.sum() > 0
    tol = TOL[dt]
    close(ot["depth"].numpy()[act], np.asarray(oj["depth"])[act], tol, "depth")
    close(ot["pos"].numpy()[act], np.asarray(oj["pos"])[act], tol, "pos")
    has = act.any(1)
    close(ot["normal"].numpy()[has], np.asarray(oj["normal"])[has], tol, "normal")


@pytest.mark.parametrize("state", STATES)
@DTYPES
def test_blocked_convex_convex_matches_jax(models, poses, dt, state):
    """Every hull pair through the blocked collider of the packed hulls
    (GJK/EPA in float64, the direction sweep in float32)."""
    mj, mt = models[False, dt]
    dj, dtt = poses[False, dt, state]
    hulls = mj.pairs.hull_box + mj.pairs.hull_hull
    g1 = [p[0] for p in hulls]
    g2 = [p[1] for p in hulls]
    st1 = [mj.hull_start[g] for g in g1]
    st2 = [mj.hull_start[g] for g in g2]
    fj = jax_gjk.make_blocked_convex_convex(mj.hull_vertsT)
    oj = jax.jit(jax.vmap(fj))(
        dj.geom_xpos[np.array(g1)], dj.geom_xmat[np.array(g1)], jnp.asarray(st1),
        dj.geom_xpos[np.array(g2)], dj.geom_xmat[np.array(g2)], jnp.asarray(st2))
    ot = gjk.make_blocked_convex_convex(mt.hull_vertsT)(
        dtt.geom_xpos[g1], dtt.geom_xmat[g1], torch.tensor(st1),
        dtt.geom_xpos[g2], dtt.geom_xmat[g2], torch.tensor(st2))
    act = np.asarray(oj["active"])
    np.testing.assert_array_equal(ot["active"].numpy(), act)
    tol = TOL[dt]
    for k in ("depth", "pos", "normal"):
        close(ot[k].numpy()[act], np.asarray(oj[k])[act], tol, k)
    if dt == jnp.float64:
        # separated pairs: GJK's distance (their witness points are read
        # nowhere, and are not unique where the closest features are an
        # edge or a face)
        sep = ~act
        close(ot["depth"].numpy()[sep], np.asarray(oj["depth"])[sep], tol, "distance")


@pytest.mark.parametrize("state", STATES)
def test_convex_convex_exact_hulls_matches_jax(models, poses, state):
    """The ccd pairs' exact hulls through `gjk.convex_convex` (GJK/EPA,
    float64)."""
    mj, mt = models[True, jnp.float64]
    dj, dtt = poses[True, jnp.float64, state]
    ccd = mj.pairs.ccd
    g1, g2 = [p[0] for p in ccd], [p[1] for p in ccd]
    s1, s2 = [p[3] for p in ccd], [p[4] for p in ccd]
    oj = jax.jit(jax.vmap(jax_gjk.convex_convex))(
        dj.geom_xpos[np.array(g1)], dj.geom_xmat[np.array(g1)], mj.exact_verts[np.array(s1)],
        dj.geom_xpos[np.array(g2)], dj.geom_xmat[np.array(g2)], mj.exact_verts[np.array(s2)])
    ot = gjk.convex_convex(dtt.geom_xpos[g1], dtt.geom_xmat[g1], mt.exact_verts[s1],
                           dtt.geom_xpos[g2], dtt.geom_xmat[g2], mt.exact_verts[s2])
    act = np.asarray(oj["active"])
    np.testing.assert_array_equal(ot["active"].numpy(), act)
    assert act.sum() > 0
    for k in ("depth", "pos", "normal"):
        close(ot[k].numpy()[act], np.asarray(oj[k])[act], 1e-10, k)
    close(ot["depth"].numpy()[~act], np.asarray(oj["depth"])[~act], 1e-10, "distance")


@pytest.mark.parametrize("state", STATES)
def test_ccd_chunk_matches_jax(models, poses, state):
    """The manifold expansion of every ccd pair (float64): active points,
    their depth, position and normal, and the pair ids."""
    mj, mt = models[True, jnp.float64]
    dj, dtt = poses[True, jnp.float64, state]
    oj = jax.jit(lambda d: jax_manifold.ccd_chunk(mj, d, jnp.float64))(dj)
    ot = manifold.ccd_chunk(mt, dtt, torch.float64)
    act = np.asarray(oj[3])
    np.testing.assert_array_equal(ot[3].numpy(), act)
    np.testing.assert_array_equal(ot[4].numpy(), np.asarray(oj[4]))
    assert act.sum() > 0
    for i, k in ((0, "pos"), (1, "normal"), (2, "depth")):
        close(ot[i].numpy()[act], np.asarray(oj[i])[act], 1e-10, k)
    if state == "resting":
        # the face-face manifold of the cube on the table: 4 points
        assert act.reshape(-1, manifold.MAXCON).sum(1).max() == manifold.MAXCON


def _contact_rows(con, fields):
    """(pair, values) of the active slots, sorted."""
    act = np.asarray(con.active)
    rows = []
    for k in np.nonzero(act)[0]:
        key = (int(np.asarray(con.geom1)[k]), int(np.asarray(con.geom2)[k]))
        rows.append((key, np.concatenate([np.ravel(np.asarray(getattr(con, f))[k])
                                          for f in fields])))
    return sorted(rows, key=lambda r: (r[0], tuple(np.round(r[1], 6))))


FIELDS = ("dist", "pos", "frame", "friction", "solref", "solimp")


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("ccd,dt", [(True, jnp.float64), (False, jnp.float64),
                                    (False, jnp.float32)], ids=["f64-ccd", "f64", "f32"])
def test_collide_matches_jax(models, poses, ccd, dt, state):
    """`narrowphase.collide`: the K-slot buffer slot by slot, and as a set
    of (pair, values) rows; ncand and the active count equal."""
    mj, mt = models[ccd, dt]
    dj, dtt = poses[ccd, dt, state]
    cj = jax.jit(lambda d: jax_np.collide(mj, d))(dj)
    ct = narrowphase.collide(mt, dtt)
    tol = TOL[dt]
    assert int(ct.ncand) == int(cj.ncand)
    np.testing.assert_array_equal(ct.active.numpy(), np.asarray(cj.active))
    assert int(ct.active.sum()) > 0
    for k in ("geom1", "geom2", "condim"):
        np.testing.assert_array_equal(getattr(ct, k).numpy(), np.asarray(getattr(cj, k)), k)
    for k in FIELDS:
        close(getattr(ct, k).numpy(), np.asarray(getattr(cj, k)), tol, k)
    rows_t, rows_j = _contact_rows(ct, FIELDS), _contact_rows(cj, FIELDS)
    assert [r[0] for r in rows_t] == [r[0] for r in rows_j]
    for (key, a), (_, b) in zip(rows_t, rows_j):
        close(a, b, tol, str(key))


def test_collide_batched_f64_hull_route_matches_jax(models, poses):
    """The batched float64 collider (box pairs in lanes form, hull pairs by
    the per-env `_hull_chunk` with GJK/EPA, stable top-K) on both states
    as a batch of two, and its lanes form."""
    from gym_so100_tpu.models.scene import Data as JaxData

    mj, mt = models[False, jnp.float64]
    from gym_so100_tpu_torch.models.scene import Data

    dj = JaxData(**{k: jnp.stack([getattr(poses[False, jnp.float64, s][0], k) for s in STATES])
                    for k in ("geom_xpos", "geom_xmat")})
    dtt = Data(geom_xpos=t(dj.geom_xpos), geom_xmat=t(dj.geom_xmat))
    cj = jax.jit(lambda d: jax_np.collide_batched(mj, d))(dj)
    ct = narrowphase.collide_batched(mt, dtt)
    np.testing.assert_array_equal(ct.ncand.numpy(), np.asarray(cj.ncand))
    np.testing.assert_array_equal(ct.active.numpy(), np.asarray(cj.active))
    for k in ("geom1", "geom2", "condim"):
        np.testing.assert_array_equal(getattr(ct, k).numpy(), np.asarray(getattr(cj, k)), k)
    for k in FIELDS + ("dof_dmask", "invw_diag"):
        close(getattr(ct, k).numpy(), np.asarray(getattr(cj, k)), 1e-10, k)
    act = np.asarray(cj.active)
    nbox = len(mj.pairs.box_box)
    # the gripper state has active hull contacts (jaw meshes on the cube)
    pair_ids = {(p[0], p[1]): i for i, p in enumerate(mj.pairs.box_box + mj.pairs.hull_box
                                                         + mj.pairs.hull_hull)}
    ids = np.vectorize(lambda a, b: pair_ids[(int(a), int(b))])(
        np.asarray(cj.geom1), np.asarray(cj.geom2))
    assert (act & (ids >= nbox)).any()
    lanes = narrowphase.collide_batched_lanes(mt, dtt)
    np.testing.assert_array_equal(lanes.active.numpy(), ct.active.numpy().T)
    close(lanes.dist.numpy(), ct.dist.numpy().T, 0, "lanes dist")
