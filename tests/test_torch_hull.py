"""The port's hull sweep (kernel 1's plain version and the collider around
it) against the JAX package's Pallas kernel `_sweep_h_pallas`, run in
interpret mode at B = 128 (the narrowest batch that takes the Pallas path).

Both sides get the same float32 geom poses (random arm and cube poses,
seeded numpy, through the port's kinematics) and the same static tables.
Contract of tests/test_hull_pallas.py: active exactly equal, depth and
normal within 1e-6 (abs and rel), witness position within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.envs.gym_env import ASSETS_XML
from gym_so100_tpu.models.builder import build_model as jax_build_model
from gym_so100_tpu.models.scene import Data as JaxData
from gym_so100_tpu.ops.collision import gjk
from gym_so100_tpu.ops.collision import hull_lanes as jax_hull
from gym_so100_tpu_torch.models.convert import model_from_numpy, state_from_numpy
from gym_so100_tpu_torch.models.scene import Data
from gym_so100_tpu_torch.ops import forward as fwd
from gym_so100_tpu_torch.ops import smooth_lanes
from gym_so100_tpu_torch.ops.collision import hull_lanes

B = 128


def _leaves(obj):
    return {f.name: (np.asarray(v) if hasattr(v, "shape") and hasattr(v, "dtype") else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


@pytest.fixture(scope="module")
def setup():
    mj, _ = jax_build_model(ASSETS_XML, max_contacts=16)
    mj32 = mj.astype(jnp.float32)
    mt = model_from_numpy(_leaves(mj32))
    rng = np.random.RandomState(11)
    qpos = np.tile(np.asarray(mj32.qpos0), (B, 1))
    qpos[:, :6] += rng.uniform(-1.2, 1.2, (B, 6))
    qpos[:, 6:9] += rng.uniform(-0.08, 0.08, (B, 3))
    quat = rng.randn(B, 4)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 9:13] = quat
    s1 = fwd.make_state(mt)
    st = state_from_numpy(dict(
        qpos=qpos.astype(np.float32),
        qvel=np.zeros((B, mt.nv), np.float32),
        ctrl=np.zeros((B, mt.nu), np.float32),
        mocap_pos=np.zeros((B, 0, 3), np.float32),
        mocap_quat=np.zeros((B, 0, 4), np.float32),
    ))
    assert s1.mocap_pos.shape[0] == 0
    d = smooth_lanes.kinematics(mt, st)
    gx = d.geom_xpos.numpy()
    gm = d.geom_xmat.numpy()
    return mj32, mt, gx, gm


def test_static_tables_match(setup):
    mj32, mt, _, _ = setup
    jt = jax_hull._static_hull_tables(mj32)
    tt = hull_lanes._static_hull_tables(mt)
    assert jt[1] == tt[1]                                 # buckets
    for a, b in zip(jt[:1] + jt[2:], tt[:1] + tt[2:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    D = hull_lanes._dir_set_np(hull_lanes.N_PEN_DIRS)
    np.testing.assert_array_equal(D, gjk._dir_set_np(gjk.N_PEN_DIRS))
    assert D.shape == (132, 3)


@pytest.fixture(scope="module")
def jax_out(setup):
    """The JAX collider at B = 128: its sweep is the Pallas kernel
    (interpret mode), and it returns depth and normal for every lane."""
    mj32, _, gx, gm = setup
    dj = JaxData(geom_xpos=jnp.asarray(gx), geom_xmat=jnp.asarray(gm))
    out = jax.jit(lambda d: jax_hull.collide_hulls_lanes(mj32, d, lanes_out=True))(dj)
    return jax.tree_util.tree_map(np.asarray, out)


def test_sweep_matches_pallas_interpret(setup, jax_out):
    mj32, mt, gx, gm = setup
    _, r_nrm, r_dep, _, _ = jax_out
    tb = hull_lanes.hull_tables(mt)
    gidx = tb.gidx.numpy()
    p_pack = torch.from_numpy(np.concatenate([gx[:, gidx, k].T for k in range(3)]))
    R_pack = torch.from_numpy(np.concatenate(
        [gm[:, gidx, j, k].T for j in range(3) for k in range(3)]))
    out = hull_lanes.sweep_h(p_pack, R_pack, tb)
    P = tb.P
    assert out.shape == (4 * P, B) and out.dtype == torch.float32
    np.testing.assert_allclose(out[:P].numpy(), r_dep, atol=1e-6, rtol=1e-6)
    for j in range(3):
        np.testing.assert_allclose(out[(1 + j) * P:(2 + j) * P].numpy(), r_nrm[j],
                                   atol=1e-6, rtol=1e-6)


def test_collider_matches_pallas_path(setup, jax_out):
    _, mt, gx, gm = setup
    r_pos, r_nrm, r_dep, r_act, r_ids = jax_out
    t_pos, t_nrm, t_dep, t_act, t_ids = hull_lanes.collide_hulls_lanes(
        mt, Data(geom_xpos=torch.from_numpy(gx), geom_xmat=torch.from_numpy(gm)),
        lanes_out=True)
    np.testing.assert_array_equal(t_ids, r_ids)
    act = r_act
    assert act.any(), "test setup produced no active hull contacts"
    np.testing.assert_array_equal(t_act.numpy(), act)
    np.testing.assert_allclose(t_dep.numpy(), r_dep, atol=1e-6, rtol=1e-6)
    for j in range(3):
        np.testing.assert_allclose(t_nrm[j].numpy()[act], r_nrm[j][act],
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(t_pos[j].numpy()[act], r_pos[j][act],
                                   atol=1e-5, rtol=1e-5)


def test_pallas_path_was_taken():
    """B = 128 float32 is the configuration in which the JAX collider runs
    its Pallas sweep (and the knob that turns it off is unset)."""
    import os

    assert B % 128 == 0
    assert os.environ.get("GST_PALLAS_HULL", "1") == "1"
