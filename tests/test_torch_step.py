"""The port's BatchedEnv against the JAX package's, over two control steps
of the full slice (smooth dynamics, box and hull narrowphase, deepest-K
selection, constraint rows, Newton solve, integration, rewards, obs and the
autoreset), at B = 8 in float32, hulls on, K = 16.  At B = 8 both sides run
their plain lanes paths (the Pallas and CUDA kernels need B % 128 == 0 and
a GPU respectively).

Same inputs on both sides: the Model through the bridge, the JAX env's
cube spawns, seeded numpy actions, and the spawn the JAX env draws for the
lane that auto-resets (lane 0 starts at t = 2 with an episode limit of 3,
so it truncates on the first step).  Tolerances: obs, final_obs and reward
within 1e-5 (abs and rel); terminated and truncated equal."""

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
STEPS = 2
LIMIT = 3
TOL = 1e-5


def _leaves(obj):
    return {f.name: (np.asarray(v) if hasattr(v, "shape") and hasattr(v, "dtype") else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


@pytest.fixture(scope="module")
def rollouts():
    mj, _ = jax_build_model(ASSETS_XML, max_contacts=16)
    mj32 = mj.astype(jnp.float32)
    mt = model_from_numpy(_leaves(mj32))
    task = "so100_touch_cube"
    env_j = JaxBatchedEnv(mj32, task, num_envs=B, max_episode_steps=LIMIT)
    env_t = BatchedEnv(mt, task, num_envs=B, max_episode_steps=LIMIT, device="cpu")
    t0 = np.zeros(B, np.int32)
    t0[0] = LIMIT - 1

    es_j = env_j.reset(jax.random.PRNGKey(0))
    es_j = dataclasses.replace(es_j, t=jnp.asarray(t0))
    es_t = env_t.reset(box_pose=np.asarray(es_j.box_pose))
    es_t = es_t.replace(t=torch.from_numpy(t0))

    rng = np.random.RandomState(7)
    out_j, out_t = [], []
    for _ in range(STEPS):
        actions = rng.uniform(-1, 1, (B, 6)).astype(np.float32)
        # the spawn each lane would take if it reset now (JAX's own draw)
        spawn = jax.vmap(lambda k: jax_core.reset(mj32, k).box_pose)(es_j.key)
        es_j, *rest_j = env_j.step(es_j, jnp.asarray(actions))
        es_t, *rest_t = env_t.step(es_t, torch.from_numpy(actions),
                                   reset_box_pose=np.asarray(spawn))
        out_j.append(jax.tree_util.tree_map(np.asarray, rest_j))
        out_t.append(rest_t)
    return out_j, out_t


@pytest.mark.parametrize("step", range(STEPS))
def test_obs_reward_flags_match(rollouts, step):
    out_j, out_t = rollouts
    obs_j, rew_j, term_j, trunc_j, info_j = out_j[step]
    obs_t, rew_t, term_t, trunc_t, info_t = out_t[step]
    assert obs_t.dtype == torch.float32 and obs_t.shape == (B, 15)
    np.testing.assert_allclose(obs_t.numpy(), obs_j, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(info_t["final_obs"].numpy(), info_j["final_obs"],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(rew_t.numpy(), rew_j, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(term_t.numpy(), term_j)
    np.testing.assert_array_equal(trunc_t.numpy(), trunc_j)


def test_autoreset_happened(rollouts):
    """Lane 0 truncated on the first step and came back as a fresh episode
    (its obs differs from its final obs); no other lane did."""
    out_j, out_t = rollouts
    _, _, _, trunc, info = out_t[0]
    assert trunc.tolist() == [True] + [False] * (B - 1)
    obs = out_t[0][0]
    assert not torch.allclose(obs[0], info["final_obs"][0])
    assert torch.equal(obs[1:], info["final_obs"][1:])
    assert out_j[0][3].tolist() == trunc.tolist()
