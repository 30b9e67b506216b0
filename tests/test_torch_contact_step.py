"""The port's BatchedEnv against the JAX package's through touchdown: float64,
K = 32 contact slots, B = 8, hulls on, 7 control steps.

The cube spawns above the table and lands in control step 5, so the later
steps run the narrowphase, the deepest-K selection, the constraint rows and
the Newton solve with active contacts (at B = 8 both sides run their plain
lanes paths).  Same inputs on both sides: the Model through the bridge,
the JAX env's cube spawns, seeded numpy actions, and JAX's own spawn for
lane 0, which truncates on the first step (it starts at t = LIMIT - 1).

Tolerance 1e-12 (abs and rel) on obs, final_obs, reward and the physics
state; ncon equal in every lane at every step; terminated and truncated
equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.envs import core as jax_core
from gym_so100_tpu.envs.gym_env import ASSETS_XML
from gym_so100_tpu.models.builder import build_model as jax_build_model
from gym_so100_tpu.parallel.batch import BatchedEnv as JaxBatchedEnv
from gym_so100_tpu_torch.models.convert import model_from_numpy
from gym_so100_tpu_torch.parallel.batch import BatchedEnv

B = 8
K = 32
STEPS = 7
LIMIT = 100
TOL = 1e-12


def _leaves(obj):
    return {f.name: (np.asarray(v) if hasattr(v, "shape") and hasattr(v, "dtype") else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


@pytest.fixture(scope="module")
def rollouts():
    mj, _ = jax_build_model(ASSETS_XML, max_contacts=K)
    mj = mj.astype(jnp.float64)
    mt = model_from_numpy(_leaves(mj))
    assert mt.qpos0.dtype == torch.float64 and mt.max_contacts == K
    task = "so100_touch_cube"
    env_j = JaxBatchedEnv(mj, task, num_envs=B, max_episode_steps=LIMIT)
    env_t = BatchedEnv(mt, task, num_envs=B, max_episode_steps=LIMIT, device="cpu")
    t0 = np.zeros(B, np.int32)
    t0[0] = LIMIT - 1

    es_j = env_j.reset(jax.random.PRNGKey(0))
    es_j = dataclasses.replace(es_j, t=jnp.asarray(t0))
    es_t = env_t.reset(box_pose=np.asarray(es_j.box_pose))
    es_t = es_t.replace(t=torch.from_numpy(t0))

    rng = np.random.RandomState(11)
    out_j, out_t = [], []
    for _ in range(STEPS):
        actions = rng.uniform(-1, 1, (B, 6))
        spawn = jax.vmap(lambda k: jax_core.reset(mj, k).box_pose)(es_j.key)
        es_j, *rest_j = env_j.step(es_j, jnp.asarray(actions))
        es_t, *rest_t = env_t.step(es_t, torch.from_numpy(actions),
                                   reset_box_pose=np.asarray(spawn))
        phys_j = {k: np.asarray(getattr(es_j.physics, k)) for k in ("qpos", "qvel")}
        phys_t = {k: getattr(es_t.physics, k).numpy() for k in ("qpos", "qvel")}
        out_j.append((jax.tree_util.tree_map(np.asarray, rest_j), phys_j))
        out_t.append((rest_t, phys_t))
    return out_j, out_t


def test_contacts_happen(rollouts):
    """Touchdown: lanes 1-7 have contact candidates from control step 5 on,
    lane 0 (a fresh episode since step 1) from step 6, so the comparisons
    below cover contact steps."""
    _, out_t = rollouts
    ncon = np.stack([rest[4]["ncon"].numpy() for rest, _ in out_t])
    assert ncon.max() > 0
    assert (ncon[4:, 1:] > 0).all() and (ncon[5:] > 0).all(), ncon
    assert ncon.max() <= K


@pytest.mark.parametrize("step", range(STEPS))
def test_step_matches_jax(rollouts, step):
    out_j, out_t = rollouts
    (obs_j, rew_j, term_j, trunc_j, info_j), phys_j = out_j[step]
    (obs_t, rew_t, term_t, trunc_t, info_t), phys_t = out_t[step]
    np.testing.assert_array_equal(info_t["ncon"].numpy(), info_j["ncon"])
    np.testing.assert_allclose(obs_t.numpy(), obs_j, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(info_t["final_obs"].numpy(), info_j["final_obs"],
                               atol=TOL, rtol=TOL)
    assert rew_t.dtype == torch.float64
    np.testing.assert_allclose(rew_t.numpy(), rew_j, atol=TOL, rtol=TOL)
    for k in ("qpos", "qvel"):
        np.testing.assert_allclose(phys_t[k], phys_j[k], atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(term_t.numpy(), term_j)
    np.testing.assert_array_equal(trunc_t.numpy(), trunc_j)
    if step == 0:
        assert trunc_t.tolist() == [True] + [False] * (B - 1)
