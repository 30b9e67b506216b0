"""The port's BatchedEnv with hull contacts off against the JAX package's:
float64, K = 16, B = 4, one control step through touchdown.

`BatchedEnv(hull_contacts=False)` drops the arm-mesh collision pairs (the
reduced-contact mode), leaving the box pairs (cube, table, finger pads,
bin).  Both sides start from JAX's reset with every cube lowered to 1 mm
above the table, so the step's substeps land it: box-box contacts, the
constraint rows and the Newton solve run in every lane.  Same inputs on
both sides (the Model through the bridge, seeded numpy actions).

Tolerance 1e-12 (absolute and relative) on obs, reward and the physics
state; ncon equal in every lane; terminated and truncated equal.  The
task is `so100_cube_to_bin` (the bench configuration's), whose reward no
other batched test holds against JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.envs.gym_env import ASSETS_XML
from gym_so100_tpu.models.builder import build_model as jax_build_model
from gym_so100_tpu.parallel.batch import BatchedEnv as JaxBatchedEnv
from gym_so100_tpu_torch.models.convert import model_from_numpy
from gym_so100_tpu_torch.parallel.batch import BatchedEnv

B = 4
K = 16
TOL = 1e-12


def _leaves(obj):
    return {f.name: (np.asarray(v) if hasattr(v, "shape") and hasattr(v, "dtype") else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


@pytest.fixture(scope="module")
def models():
    mj, _ = jax_build_model(ASSETS_XML, max_contacts=K)
    mj = mj.astype(jnp.float64)
    return mj, model_from_numpy(_leaves(mj))


def test_hulls_off_step_matches_jax(models):
    mj, mt = models
    task = "so100_cube_to_bin"
    env_j = JaxBatchedEnv(mj, task, num_envs=B, hull_contacts=False)
    env_t = BatchedEnv(mt, task, num_envs=B, hull_contacts=False, device="cpu")
    assert env_t.m.pairs.hull_box == env_t.m.pairs.hull_hull == ()
    assert len(env_t.m.pairs.box_box) == len(env_j.m.pairs.box_box) > 0
    es_j = env_j.reset(jax.random.PRNGKey(1))
    qpos = np.array(es_j.physics.qpos)
    qpos[:, 8] = 0.021                       # the cube 1 mm above the table
    es_j = dataclasses.replace(es_j, physics=es_j.physics.replace(qpos=jnp.asarray(qpos)))
    es_t = env_t.reset(box_pose=np.asarray(es_j.box_pose))
    es_t = es_t.replace(physics=es_t.physics.replace(qpos=torch.from_numpy(qpos)))
    actions = np.random.RandomState(3).uniform(-1, 1, (B, 6))

    es_j, obs_j, rew_j, term_j, trunc_j, info_j = env_j.step(es_j, jnp.asarray(actions))
    es_t, obs_t, rew_t, term_t, trunc_t, info_t = env_t.step(es_t, torch.from_numpy(actions))

    ncon = info_t["ncon"].numpy()
    np.testing.assert_array_equal(ncon, np.asarray(info_j["ncon"]))
    assert (ncon > 0).all(), ncon
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), atol=TOL, rtol=TOL)
    assert rew_t.dtype == torch.float64
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), atol=TOL, rtol=TOL)
    for k in ("qpos", "qvel"):
        np.testing.assert_allclose(getattr(es_t.physics, k).numpy(),
                                   np.asarray(getattr(es_j.physics, k)), atol=TOL, rtol=TOL,
                                   err_msg=k)
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j))
