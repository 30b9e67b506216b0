"""The batch-first float32 narrowphase and the last public functions of the
JAX package, held to JAX on the same inputs (B = 16, K = 16, the state
recipe of tests/test_lanes.py with seed 7: random arm poses, the cube
tipped at random near the table):

* `collide_batched` in float32 (box pairs in lanes form, every hull pair
  through `hull_lanes`, K rounds of argmin) against JAX's on the same geom
  poses, with JAX's tolerances (tests/test_lanes.py), and against the
  port's `collide_batched_lanes`, transposed;
* `position_stage_batched` against JAX's;
* `make_efc_lanes` and `make_efc_batched` against JAX's fed the same
  contacts, in float32 (2e-5, as tests/test_efc_lanes.py) and float64
  (1e-12), and `make_efc_batched` against the per-env `make_efc`;
* `box_box_lanes` and `collide_hulls_lanes` at margin 0.01;
* `rotate_inv`, `from_euler_xyz` and `sub_quat` in float64 to 1e-12;
* the buffers' default device and `build_model(keep_visual=...)`.

JAX's colliders run op by op (`jax_ref` says why), its constraint rows
under jit.  B = 16 is not a multiple of 128, so JAX's hull collider runs
its XLA sweep.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.envs.gym_env import ASSETS_XML
from gym_so100_tpu.models.builder import build_model as jax_build_model
from gym_so100_tpu.models.scene import Contact as JaxContact
from gym_so100_tpu.models.scene import Data as JaxData
from gym_so100_tpu.models.scene import State as JaxState
from gym_so100_tpu.ops import constraint_lanes as jax_efc
from gym_so100_tpu.ops import forward as jax_fwd
from gym_so100_tpu.ops import quat as jax_quat
from gym_so100_tpu.ops.collision import boxbox_lanes as jax_boxbox
from gym_so100_tpu.ops.collision import hull_lanes as jax_hull
from gym_so100_tpu_torch.agents.her import HerBuffer
from gym_so100_tpu_torch.agents.sac import Normalizer, ReplayBuffer
from gym_so100_tpu_torch.models.builder import build_model
from gym_so100_tpu_torch.models.convert import model_from_numpy
from gym_so100_tpu_torch.models.scene import Data, State
from gym_so100_tpu_torch.ops import constraint, constraint_lanes, forward, quat, smooth_lanes
from gym_so100_tpu_torch.ops.collision import boxbox_lanes, hull_lanes, narrowphase

B = 16
K = 16
MARGIN = 0.01
# JAX's float32 contract of the batch-first collider (tests/test_lanes.py)
DIST_TOL = dict(rtol=1e-6, atol=1e-7)
POS_TOL = dict(rtol=1e-6, atol=1e-6)
FRAME_TOL = dict(rtol=1e-5, atol=1e-6)
# kinematics: XLA's and torch's float32 sin/cos differ by an ulp or two,
# which the chain of up to 7 bodies carries into the poses
KIN_TOL = dict(rtol=0, atol=2e-6)
EFC_TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
CONTACT_INTS = ("active", "geom1", "geom2", "condim")


def _leaves(obj):
    return {f.name: (np.asarray(v) if hasattr(v, "shape") and hasattr(v, "dtype") else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def t(x):
    return torch.from_numpy(np.array(x))


def n(x):
    return jnp.asarray(x.numpy())


def _box_inputs(m, gx, gm, size, expand):
    """box_box_lanes' arguments for every box pair of `m`, lanes (P, B),
    from geom poses gx (B, NG, 3), gm (B, NG, 3, 3) and half sizes (NG, 3)
    of either library (`expand(a, shape)` broadcasts)."""
    g1 = np.asarray([p[0] for p in m.pairs.box_box])
    g2 = np.asarray([p[1] for p in m.pairs.box_box])
    shape = (len(g1), gx.shape[0])
    vec = lambda a: tuple(a[..., i].T for i in range(3))
    mat = lambda a: tuple(tuple(a[..., i, j].T for j in range(3)) for i in range(3))
    sz = lambda g: tuple(expand(size[g][:, i][:, None], shape) for i in range(3))
    return (vec(gx[:, g1]), mat(gm[:, g1]), sz(g1), vec(gx[:, g2]), mat(gm[:, g2]), sz(g2))


@pytest.fixture(scope="module")
def models():
    mj, _ = jax_build_model(ASSETS_XML, max_contacts=K)
    mj32 = mj.astype(jnp.float32)
    return {torch.float64: (mj, model_from_numpy(_leaves(mj))),
            torch.float32: (mj32, model_from_numpy(_leaves(mj32)))}


@pytest.fixture(scope="module")
def state(models):
    """tests/test_lanes.py's batch: seed 7, float32 (JAX's State, the port's)."""
    mj32 = models[torch.float32][0]
    rng = np.random.RandomState(7)
    s = jax_fwd.make_state(mj32, dtype=jnp.float32)
    qpos = np.tile(np.asarray(s.qpos), (B, 1))
    qpos[:, :6] += rng.uniform(-1.2, 1.2, (B, 6))
    qpos[:, 6:9] += rng.uniform(-0.08, 0.08, (B, 3))
    quat_ = rng.randn(B, 4)
    quat_ /= np.linalg.norm(quat_, axis=1, keepdims=True)
    qpos[:, 9:13] = quat_
    sj = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (B, *a.shape)), s).replace(
        qpos=jnp.asarray(qpos, jnp.float32))
    return sj, State(**{k: t(v) for k, v in _leaves(sj).items()})


@pytest.fixture(scope="module")
def jax_ref(models, state):
    """JAX's float32 position stage, and its box and hull colliders at
    MARGIN on the same poses, run op by op: the port repeats that float32
    arithmetic, while under jit XLA rounds some fused products otherwise,
    which on this state moves the tiny components of a nearly axis-aligned
    box normal enough to flip mju_makeFrame's least-aligned axis."""
    mj32 = models[torch.float32][0]
    d = jax_fwd.position_stage_batched(mj32, state[0])
    box = jax_boxbox.box_box_lanes(
        *_box_inputs(mj32, d.geom_xpos, d.geom_xmat, mj32.geom_size, jnp.broadcast_to),
        margin=MARGIN)
    hull = jax_hull.collide_hulls_lanes(mj32, d, margin=MARGIN)
    return d, jax.tree_util.tree_map(np.asarray, box), [np.asarray(x) for x in hull]


def _poses(jd):
    return Data(geom_xpos=t(jd.geom_xpos), geom_xmat=t(jd.geom_xmat))


def _assert_contact_matches_jax(ct, cj):
    for k in CONTACT_INTS + ("ncand",):
        np.testing.assert_array_equal(getattr(ct, k).numpy(), np.asarray(getattr(cj, k)),
                                      err_msg=k)
    np.testing.assert_allclose(ct.dist.numpy(), np.asarray(cj.dist), **DIST_TOL)
    np.testing.assert_allclose(ct.pos.numpy(), np.asarray(cj.pos), **POS_TOL)
    np.testing.assert_allclose(ct.frame.numpy(), np.asarray(cj.frame), **FRAME_TOL)
    for k in ("friction", "solref", "solimp"):
        np.testing.assert_allclose(getattr(ct, k).numpy(), np.asarray(getattr(cj, k)),
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(ct.invw_diag.numpy(), np.asarray(cj.invw_diag),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ct.dof_dmask.numpy(), np.asarray(cj.dof_dmask))


def test_collide_batched_float32_matches_jax(models, jax_ref):
    """Same geom poses on both sides: the kernel route's plain version on
    the CPU against JAX's float32 collide_batched."""
    mj32, mt32 = models[torch.float32]
    jd = jax_ref[0]
    ct = narrowphase.collide_batched(mt32, _poses(jd))
    assert ct.dist.dtype == torch.float32 and ct.dist.shape == (B, K)
    _assert_contact_matches_jax(ct, jd.contact)
    # both routes have work here: active box and hull contacts
    nbox = len(mj32.pairs.box_box)
    pair_of = {tuple(p): i for i, p in enumerate(
        mj32.pairs.box_box + mj32.pairs.hull_box + mj32.pairs.hull_hull)}
    act = ct.active.numpy()
    ids = np.vectorize(lambda a, b: pair_of[(int(a), int(b))])(
        ct.geom1.numpy(), ct.geom2.numpy())
    assert (act & (ids < nbox)).any() and (act & (ids >= nbox)).any()


def test_collide_batched_float32_equals_its_lanes_form(models, jax_ref):
    """collide_batched is collide_batched_lanes transposed: the same
    candidates and selection, so the same slots, bit for bit but the
    frame, which the two forms normalize in other orders."""
    mt32 = models[torch.float32][1]
    d = _poses(jax_ref[0])
    con = narrowphase.collide_batched(mt32, d)
    cl = narrowphase.collide_batched_lanes(mt32, d)
    T = lambda a: a.movedim(0, -1)
    assert torch.equal(cl.ncand, con.ncand)
    for k in CONTACT_INTS:
        assert torch.equal(getattr(cl, k), T(getattr(con, k))), k
    assert torch.equal(cl.dist, T(con.dist))
    for c in range(3):
        assert torch.equal(cl.pos[c], T(con.pos[..., c]))
        for r in range(3):
            np.testing.assert_allclose(cl.frame[r][c].numpy(), T(con.frame[..., r, c]).numpy(),
                                       **FRAME_TOL)
    assert torch.equal(cl.friction0, T(con.friction[..., 0]))
    assert torch.equal(cl.solref0, T(con.solref[..., 0]))
    assert torch.equal(cl.invw_diag, T(con.invw_diag))
    for v in range(mt32.nv):
        assert torch.equal(cl.dof_dmask[v], T(con.dof_dmask[..., v]))


def test_position_stage_batched_matches_jax(models, state, jax_ref):
    mt32 = models[torch.float32][1]
    jd = jax_ref[0]
    dt = forward.position_stage_batched(mt32, state[1])
    for k in ("xpos", "xquat", "xipos", "ximat", "geom_xpos", "geom_xmat",
              "site_xpos", "site_xmat"):
        np.testing.assert_allclose(getattr(dt, k).numpy(), np.asarray(getattr(jd, k)),
                                   err_msg=k, **KIN_TOL)
    _assert_contact_matches_jax(dt.contact, jd.contact)


@pytest.fixture(scope="module", params=[torch.float32, torch.float64], ids=["f32", "f64"])
def efc(request, models, state, jax_ref):
    """The rows of both sides from the same kinematics and contacts: the
    port's float32 contacts; for float64 cast, without their float32
    per-contact statics (dof_dmask, invw_diag), which both sides then
    derive from the geom ids in float64."""
    dtype = request.param
    mj, mt = models[dtype]
    s = state[1].to(dtype=dtype)
    sl = smooth_lanes.forward_smooth_lanes(mt, s)
    d = Data(geom_xpos=sl["geom_xpos"], geom_xmat=sl["geom_xmat"], cdof=sl["cdof"],
             subtree_com=sl["subtree_com0"][:, None], site_xpos=sl["site_xpos"],
             site_xmat=sl["site_xmat"])
    con = narrowphase.collide_batched(models[torch.float32][1], _poses(jax_ref[0]))
    if dtype == torch.float64:
        con = con.replace(dof_dmask=None, invw_diag=None).to(dtype=dtype)
    assert bool(con.active.any())
    dj = JaxData(cdof=n(d.cdof), subtree_com=n(d.subtree_com), site_xpos=n(d.site_xpos),
                 site_xmat=n(d.site_xmat))
    sj = JaxState(**{k: jnp.asarray(v) for k, v in _leaves(s).items()})
    cj = JaxContact(**{k: None if v is None else jnp.asarray(v)
                       for k, v in _leaves(con).items()})
    ref = jax.jit(lambda d, s, c: (jax_efc.make_efc_lanes(mj, d, s, c),
                                   jax_efc.make_efc_batched(mj, d, s, c)))(dj, sj, cj)
    return dtype, mt, d, s, con, ref


def test_make_efc_lanes_matches_jax(efc):
    dtype, mt, d, s, con, (ref, _) = efc
    got = constraint_lanes.make_efc_lanes(mt, d, s, con)
    tol = EFC_TOL[dtype]
    assert (got.neq, got.nf, got.nl) == (ref.neq, ref.nf, ref.nl)
    np.testing.assert_allclose(got.J.numpy(), np.stack([np.asarray(x) for x in ref.J]),
                               rtol=tol, atol=tol)
    for k in ("aref", "D", "R", "pos", "floss", "con_mu", "con_uscale", "con_Dn"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                   rtol=tol, atol=tol, err_msg=k)
    np.testing.assert_array_equal(got.con_active.numpy(), np.asarray(ref.con_active))


def _assert_efc_close(got, ref, tol):
    assert (got.neq, got.nf, got.nl) == (ref.neq, ref.nf, ref.nl)
    for k in ("J", "aref", "D", "R", "pos", "floss", "con_mu", "con_uscale", "con_Dn"):
        a, b = getattr(got, k), np.asarray(getattr(ref, k))
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a.numpy(), b, rtol=tol, atol=tol, err_msg=k)
    for k in ("is_floss", "is_limit", "con_active"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                      err_msg=k)


def test_make_efc_batched_matches_jax(efc):
    dtype, mt, d, s, con, (_, ref) = efc
    got = constraint_lanes.make_efc_batched(mt, d, s, con)
    assert got.J.shape == (B, got.aref.shape[1], mt.nv)
    assert got.nf > 0 and got.nl > 0 and bool(got.con_active.any())
    _assert_efc_close(got, ref, EFC_TOL[dtype])


def test_make_efc_batched_matches_per_env_make_efc(efc):
    """The batch-first rows against the single-env engine's, env by env."""
    dtype, mt, d, s, con, _ = efc
    got = constraint_lanes.make_efc_batched(mt, d, s, con)
    for i in range(B):
        one = constraint.make_efc(mt, d.index(i), s.index(i), con.index(i))
        env = dataclasses.replace(got, **{
            f.name: getattr(got, f.name)[i] for f in dataclasses.fields(got)
            if isinstance(getattr(got, f.name), torch.Tensor)})
        _assert_efc_close(env, one, EFC_TOL[dtype])


def test_box_box_lanes_margin_matches_jax(models, jax_ref):
    """At margin 0.01 more slots are active than at 0 (edge contacts of
    pairs less than 1 cm apart), and they are JAX's."""
    mt32 = models[torch.float32][1]
    d, jbox = _poses(jax_ref[0]), jax_ref[1]
    args = _box_inputs(mt32, d.geom_xpos, d.geom_xmat, mt32.geom_size,
                       lambda a, shape: a.expand(shape))
    got = boxbox_lanes.box_box_lanes(*args, margin=MARGIN)
    at0 = boxbox_lanes.box_box_lanes(*args)
    act = np.stack([a.numpy() for a in got["active"]])
    act0 = np.stack([a.numpy() for a in at0["active"]])
    np.testing.assert_array_equal(act, np.stack(jbox["active"]))
    assert act.sum() > act0.sum() and not (act0 & ~act).any()
    for k in range(boxbox_lanes.MAXP):
        live = act[k]
        np.testing.assert_allclose(got["depth"][k].numpy()[live], jbox["depth"][k][live],
                                   **DIST_TOL)
        for c in range(3):
            np.testing.assert_allclose(got["pos"][k][c].numpy()[live],
                                       jbox["pos"][k][c][live], **POS_TOL)


def test_collide_hulls_lanes_margin_matches_jax(models, jax_ref):
    """The batch-first chunk at margin 0.01 against JAX's: more active
    pairs than at 0, the same ones, and the lanes form is its transpose."""
    mj32, mt32 = models[torch.float32]
    d = _poses(jax_ref[0])
    pos, nrm, depth, active, ids = hull_lanes.collide_hulls_lanes(mt32, d, margin=MARGIN)
    P = len(mj32.pairs.hull_box + mj32.pairs.hull_hull)
    assert pos.shape == (B, P, 3) and nrm.shape == (B, P, 3)
    assert depth.shape == (B, P) and active.shape == (B, P) and ids.shape == (P,)
    r_pos, r_nrm, r_dep, r_act, r_ids = jax_ref[2]
    np.testing.assert_array_equal(ids.numpy(), r_ids[0])
    np.testing.assert_array_equal(active.numpy(), r_act)
    act0 = hull_lanes.collide_hulls_lanes(mt32, d)[3]
    assert int(active.sum()) > int(act0.sum()) and not bool((act0 & ~active).any())
    live = r_act
    np.testing.assert_allclose(depth.numpy(), r_dep, **POS_TOL)
    np.testing.assert_allclose(nrm.numpy()[live], r_nrm[live], **POS_TOL)
    np.testing.assert_allclose(pos.numpy()[live], r_pos[live], rtol=1e-5, atol=1e-5)
    lanes = hull_lanes.collide_hulls_lanes(mt32, d, margin=MARGIN, lanes_out=True)
    assert torch.equal(lanes[3], active.T) and torch.equal(lanes[2], depth.T)
    for c in range(3):
        assert torch.equal(lanes[0][c], pos[..., c].T)
    np.testing.assert_array_equal(lanes[4], r_ids[0])


def _unit_quats(rng, n):
    q = rng.randn(n, 4)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_rotate_inv_matches_jax():
    rng = np.random.RandomState(11)
    q, v = _unit_quats(rng, 64), rng.randn(64, 3)
    got = quat.rotate_inv(t(q), t(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_quat.rotate_inv(q, v)), rtol=1e-12,
                               atol=1e-12)
    # it undoes rotate
    np.testing.assert_allclose(quat.rotate_inv(t(q), quat.rotate(t(q), t(v))).numpy(), v,
                               atol=1e-12)


def test_from_euler_xyz_matches_jax():
    rng = np.random.RandomState(12)
    e = rng.uniform(-np.pi, np.pi, (64, 3))
    e[0] = 0.0
    got = quat.from_euler_xyz(t(e)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_quat.from_euler_xyz(jnp.asarray(e))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[0], [1.0, 0.0, 0.0, 0.0], atol=0)


def test_sub_quat_matches_jax():
    """Random pairs (both signs of the relative quaternion's w), a pair one
    small rotation apart, and identical quaternions."""
    rng = np.random.RandomState(13)
    qa, qb = _unit_quats(rng, 64), _unit_quats(rng, 64)
    small = np.concatenate([[np.cos(1e-9)], np.sin(1e-9) * np.array([0.6, 0.0, 0.8])])
    qa[-2] = np.asarray(jax_quat.mul(jnp.asarray(qb[-2]), jnp.asarray(small)))
    qa[-1] = qb[-1]
    w = np.asarray(jax_quat.mul(jax_quat.conj(jnp.asarray(qb)), jnp.asarray(qa)))[:, 0]
    assert (w < 0).any() and (w > 0).any()
    got = quat.sub_quat(t(qa), t(qb)).numpy()
    ref = np.asarray(jax_quat.sub_quat(jnp.asarray(qa), jnp.asarray(qb)))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[-2], 2e-9 * np.array([0.6, 0.0, 0.8]), rtol=1e-6,
                               atol=1e-15)
    np.testing.assert_array_equal(got[-1], 0.0)
    assert np.all(np.linalg.norm(got, axis=1) <= np.pi + 1e-12)   # the shortest arc


@pytest.mark.parametrize("make", [
    lambda: Normalizer.create(4),
    lambda: ReplayBuffer(8, 4, 2),
    lambda: HerBuffer(2, 3, 4, 2),
], ids=["normalizer", "replay", "her"])
def test_buffers_default_to_the_gpu(monkeypatch, make):
    """No buffer lands on the CPU unasked: without a GPU the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_build_model_keep_visual_changes_nothing():
    a, aux_a = build_model(max_contacts=K, device="cpu")
    b, aux_b = build_model(max_contacts=K, device="cpu", keep_visual=True)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
        else:
            assert x == y, f.name
    assert len(aux_a["render_geoms"]) == len(aux_b["render_geoms"])
