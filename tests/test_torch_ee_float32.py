"""The port's Cartesian (mocap-weld) env against the JAX package's lanes path
in float32, on the FULL EE scene: the mocap target's 4 x 12 x 4 cm box lies
in the gripper, so every env has deep box contacts (16 of 16 slots active
at K = 16, 24-38 candidates), the weld's 6 equality rows lead the
constraint rows, and the weld is gained.  B = 4; both sides start from the
same state after one seeded action (JAX's spawns, its reset, then the
port's `apply_action`).  In float32 the JAX package runs its lanes
colliders (it falls back to per-env colliders only in float64, which is
why tests/test_torch_ee.py lifts that box out of reach).

* narrowphase, fed the same geom poses: active slots and candidate counts
  equal, and in every env the same contacts, slot for slot up to the order
  of candidates whose depths tie within an ulp (the box's face contacts
  are four corners at one depth, which the deepest-K selection may order
  either way): each port contact matches its own JAX contact (same geom
  pair) with depth, position and frame within 1e-5;
* constraint rows, fed the same contacts and kinematics: neq = 6, every
  row array within 1e-5 (rel 1e-5), but the weld rows' aref, within 1e-4
  (the weld's stiffness scales a one-ulp residual difference up);
* one substep: the stiff weld and the deep contacts amplify rounding
  through the Newton solve, so the port moves by up to ~0.17 in qvel
  under one-ulp noise on its own qpos and qvel.  The difference from JAX
  is held, per quantity, to twice the worst of 8 such perturbed port
  substeps (the floor rule of chip_smoke.py's solver check); as a negative
  control, the same bound must reject the port's substep with the mocap
  box lifted out of reach (the box contacts dropped).  JAX runs the
  substep op by op (`jax.disable_jit()`, about a minute): its jit compile
  took about 7 minutes on an 8-core CPU beside the suite's other workers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.envs.ee_env import CartesianBatchedEnv as JaxEnv
from gym_so100_tpu.models.builder import build_model as jax_build_model
from gym_so100_tpu.models.scene import ContactLanes as JaxContactLanes
from gym_so100_tpu.models.scene import Data as JaxData
from gym_so100_tpu.models.scene import State as JaxState
from gym_so100_tpu.ops import constraint_lanes as jax_efc
from gym_so100_tpu.ops import forward as jax_fwd
from gym_so100_tpu.ops.collision import narrowphase as jax_np
from gym_so100_tpu_torch.envs.ee_env import EE_XML, CartesianBatchedEnv
from gym_so100_tpu_torch.models.convert import model_from_numpy
from gym_so100_tpu_torch.models.scene import Data
from gym_so100_tpu_torch.ops import constraint_lanes, smooth_lanes
from gym_so100_tpu_torch.ops import forward as fwd
from gym_so100_tpu_torch.ops.collision import narrowphase

B, K = 4, 16
TOL = 1e-5
EPS32 = 1.1920929e-07
FLOOR_SAMPLES = 8


def _leaves(obj):
    return {f.name: (np.asarray(v) if hasattr(v, "shape") and hasattr(v, "dtype") else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _n(x):
    return jnp.asarray(x.numpy())


@pytest.fixture(scope="module")
def scene():
    """Both gained-weld envs on the full float32 scene; the state after one
    seeded action, on the port's side and as JAX leaves."""
    mj, _ = jax_build_model(EE_XML, max_contacts=K)
    mj = mj.astype(jnp.float32)
    env_j = JaxEnv(mj, num_envs=B)
    env_t = CartesianBatchedEnv(model_from_numpy(_leaves(mj)), num_envs=B, device="cpu")
    assert env_t.m.qpos0.dtype == torch.float32
    es_j = env_j.reset(jax.random.PRNGKey(0))
    es_t = env_t.reset(box_pose=np.array(es_j.box_pose))
    acts = torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, (B, 4)).astype(np.float32))
    s = env_t.apply_action(es_t.physics, acts)
    sj = JaxState(qpos=_n(s.qpos), qvel=_n(s.qvel), ctrl=_n(s.ctrl),
                  mocap_pos=_n(s.mocap_pos), mocap_quat=_n(s.mocap_quat),
                  qacc_warmstart=_n(s.qacc_warmstart))
    box = [g for g in range(mj.ngeom)
           if np.asarray(mj.body_mocapid)[np.asarray(mj.geom_bodyid)[g]] >= 0]
    assert len(box) == 1
    return env_j, env_t, s, sj, box[0]


@pytest.fixture(scope="module")
def contacts(scene):
    env_j, env_t, s, _, _ = scene
    sl = smooth_lanes.forward_smooth_lanes(env_t.m, s)
    d = Data(geom_xpos=sl["geom_xpos"], geom_xmat=sl["geom_xmat"],
             site_xpos=sl["site_xpos"], site_xmat=sl["site_xmat"], cdof=sl["cdof"],
             subtree_com=sl["subtree_com0"][:, None])
    cl_t = narrowphase.collide_batched_lanes(env_t.m, d)
    dj = JaxData(geom_xpos=_n(d.geom_xpos), geom_xmat=_n(d.geom_xmat),
                 site_xpos=_n(d.site_xpos), site_xmat=_n(d.site_xmat), cdof=_n(d.cdof),
                 subtree_com=_n(d.subtree_com))
    cl_j = jax.jit(lambda d: jax_np.collide_batched_lanes(env_j.m, d))(dj)
    return d, dj, cl_t, cl_j


def _contact_rows(cl, b):
    """(K, 13) per slot of env b: dist, pos (3), frame (9)."""
    a = lambda x: np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    cols = [a(cl.dist)[:, b]] + [a(cl.pos[c])[:, b] for c in range(3)] + [
        a(cl.frame[r][c])[:, b] for r in range(3) for c in range(3)]
    return np.stack(cols, 1)


def test_full_scene_contacts_match_jax_in_float32(scene, contacts):
    box = scene[4]
    _, _, cl_t, cl_j = contacts
    act = np.asarray(cl_j.active)
    np.testing.assert_array_equal(cl_t.active.numpy(), act)
    np.testing.assert_array_equal(cl_t.ncand.numpy(), np.asarray(cl_j.ncand))
    g1, g2 = np.asarray(cl_j.geom1), np.asarray(cl_j.geom2)
    on_box = ((g1 == box) | (g2 == box)) & act
    assert on_box.sum(0).min() >= 4, "too few box contacts in the test state"
    for b in range(B):
        rows_t, rows_j = _contact_rows(cl_t, b), _contact_rows(cl_j, b)
        free = set(np.flatnonzero(act[:, b]).tolist())
        for k in np.flatnonzero(act[:, b]):
            pair = (int(cl_t.geom1[k, b]), int(cl_t.geom2[k, b]), int(cl_t.condim[k, b]))
            same = [j for j in free
                    if (int(g1[j, b]), int(g2[j, b]), int(np.asarray(cl_j.condim)[j, b]))
                    == pair]
            assert same, f"env {b} slot {k}: no JAX contact of pair {pair}"
            err = {j: float(np.abs(rows_t[k] - rows_j[j]).max()) for j in same}
            j = min(err, key=err.get)
            assert err[j] <= TOL, f"env {b} slot {k}: nearest JAX contact {err[j]:.3g} off"
            free.remove(j)


def test_full_scene_rows_match_jax_in_float32(scene, contacts):
    env_j, env_t, s, sj, _ = scene
    d, dj, cl_t, _ = contacts
    # both sides assemble rows from the very same contacts (the port's)
    cl_j = JaxContactLanes(
        dist=_n(cl_t.dist), pos=tuple(_n(x) for x in cl_t.pos),
        frame=tuple(tuple(_n(x) for x in row) for row in cl_t.frame),
        friction0=_n(cl_t.friction0), friction1=_n(cl_t.friction1),
        solref0=_n(cl_t.solref0), solref1=_n(cl_t.solref1),
        solimp=tuple(_n(x) for x in cl_t.solimp), geom1=_n(cl_t.geom1),
        geom2=_n(cl_t.geom2), condim=_n(cl_t.condim), active=_n(cl_t.active),
        dof_dmask=tuple(_n(x) for x in cl_t.dof_dmask), invw_diag=_n(cl_t.invw_diag),
        ncand=_n(cl_t.ncand))
    e_t = constraint_lanes.make_efc_from_lanes(env_t.m, d, s, cl_t)
    e_j = jax.jit(lambda d, s, c: jax_efc.make_efc_from_lanes(env_j.m, d, s, c))(dj, sj, cl_j)
    assert (e_t.neq, e_t.nf, e_t.nl) == (e_j.neq, e_j.nf, e_j.nl) and e_t.neq == 6
    np.testing.assert_allclose(e_t.J.numpy(), np.stack([np.asarray(x) for x in e_j.J]),
                               rtol=TOL, atol=TOL)
    for name in ("D", "R", "pos", "floss", "con_mu", "con_uscale", "con_Dn"):
        np.testing.assert_allclose(getattr(e_t, name).numpy(), np.asarray(getattr(e_j, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(e_t.con_active.numpy(), np.asarray(e_j.con_active))
    a_t, a_j = e_t.aref.numpy(), np.asarray(e_j.aref)
    np.testing.assert_allclose(a_t[6:], a_j[6:], rtol=TOL, atol=TOL, err_msg="aref")
    # the weld's rotational residual is ~0 after a "follow" action: the
    # port's quaternion product gives 0 where XLA's contracted one gives
    # ~6e-9, which the gained weld's stiffness (~1e4 in K * imp) turns into
    # ~5e-5 of aref; the residual itself agrees to TOL above
    np.testing.assert_allclose(a_t[:6], a_j[:6], rtol=TOL, atol=1e-4, err_msg="weld aref")


def test_full_scene_substep_matches_jax_in_float32(scene):
    env_j, env_t, s, sj, box = scene
    with jax.disable_jit():
        s1j = jax_fwd.step_batched(env_j.m, sj)[0]
    s1t, _ = fwd.step_batched(env_t.m, s)
    keys = ("qpos", "qvel")
    diff = lambda a: {k: float(np.abs(getattr(a, k).numpy() - np.asarray(getattr(s1j, k))).max())
                      for k in keys}
    gen = torch.Generator().manual_seed(5)
    ulp = lambda t: t * (1 + EPS32 * torch.randn(t.shape, generator=gen))
    floor = dict.fromkeys(keys, 0.0)
    for _ in range(FLOOR_SAMPLES):
        s1p, _ = fwd.step_batched(env_t.m, s.replace(qpos=ulp(s.qpos), qvel=ulp(s.qvel)))
        for k in keys:
            floor[k] = max(floor[k], float((getattr(s1p, k) - getattr(s1t, k)).abs().max()))
    err = diff(s1t)
    for k in keys:
        assert err[k] <= 2 * floor[k], (k, err[k], floor[k])
    # negative control: without the box contacts the same bound fails
    gpos = env_t.m.geom_pos.clone()
    gpos[box, 2] += 10.0
    lifted, _ = fwd.step_batched(dataclasses.replace(env_t.m, geom_pos=gpos), s)
    assert diff(lifted)["qvel"] > 2 * floor["qvel"], (diff(lifted), floor)
