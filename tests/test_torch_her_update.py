"""The port's HER learning step against the JAX package's HERTrainer:
float64, K = 32 contact slots, hulls on, B = 4, 2-step episodes, utd 2.

Two learning env-batch steps from the shared start of
test_torch_her_step.py (whose helpers this module imports).  JAX's draws
are injected: the policy noise, the four draws of each HER sample (from
JAX's own key splits), the two Gaussian draws of each SAC update (from the
SAC state's key chain), the spawns and goal uniforms of the autoreset.
Step 1 stores no episode yet, so both sides skip their updates; step 2
ends every episode, flushes them and takes two updates on HER samples.
The sampled batches to 1e-10; the updated parameters and log_alpha to 1e-10
of each tensor's largest magnitude; the losses, the env and buffer state
and the diagnostics as in the warm-up test.

The normalizer takes its batch statistics in float32 (see the warm-up
test), so its merge of each step's observations is held to 1e-6 there and
here; for the rest of the step to be held to 1e-10, the port's normalizer
then takes JAX's merged statistics, which the policy and the updates read."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_her_step import (
    B,
    F32,
    close,
    compare_metrics,
    compare_snapshots,
    goal_uniforms,
    make_trainers,
    snapshot,
)

from gym_so100_tpu_torch.agents.convert import to_flax
from gym_so100_tpu_torch.agents.sac import Normalizer

UTD = 2
TOL = 1e-10


def assert_rel(actual, expected, name):
    actual, expected = np.asarray(actual, np.float64), np.asarray(expected, np.float64)
    scale = max(float(np.abs(expected).max()), 1e-30)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=TOL * scale, err_msg=name)


def take_jax_statistics(norm, nj, own):
    """Make the next `norm.update(batch)` store its own result in `own` and
    then set `norm` to JAX's merged statistics `nj`."""
    def update(batch):
        ref = Normalizer(norm.mean.clone(), norm.var.clone(), norm.count.clone())
        ref.update(batch)
        own.update(ref.tensors())
        for k in ("mean", "var", "count"):
            setattr(norm, k, torch.from_numpy(np.array(getattr(nj, k))))
        del norm.update
    norm.update = update


def jax_draws(tj, ts_after, key, sac_key):
    """The draws JAX's `_rollout(ts, key)` made, for the port: the policy
    noise, then per update the HER sample's draws (and JAX's own sampled
    batch) and the SAC update's two normals; returns them and the advanced
    SAC key."""
    cfg, bs = tj.cfg, tj.sac.cfg.batch_size
    k_act, k_sample = jax.random.split(key)
    act_noise = jax.random.normal(k_act, (B, 6), jnp.float64)
    her = ts_after.her
    updates, batches = [], []
    for k_u in jax.random.split(k_sample, UTD):
        k1, k2, k3, k4 = jax.random.split(k_u, 4)
        buf = [jax.random.randint(k1, (bs,), 0, jnp.maximum(her.n_eps, 1)),
               jax.random.randint(k2, (bs,), 0, 1 << 30),
               jax.random.randint(k3, (bs,), 0, 1 << 30),
               jax.random.uniform(k4, (bs,))]
        noise = None
        if int(her.n_eps) > 0:
            sac_key, n1, n2 = jax.random.split(sac_key, 3)
            noise = [torch.from_numpy(np.asarray(jax.random.normal(k, (bs, 6), jnp.float64)))
                     for k in (n1, n2)]
        updates.append(([torch.from_numpy(np.asarray(x)) for x in buf], noise))
        batches.append(her.sample(k_u, bs, cfg.her_ratio, cfg.distance_threshold))
    draws = dict(act_noise=torch.from_numpy(np.asarray(act_noise)),
                 spawn=np.asarray(ts_after.genv.es.box_pose),
                 goal_u=goal_uniforms(ts_after.genv.es.key), updates=updates)
    return draws, batches, sac_key


@pytest.fixture(scope="module")
def learning_steps():
    tj, ts_j, tt, ts_t = make_trainers(utd=UTD)
    sac_key = ts_j.sac.key
    out = []
    for i in range(2):
        key = jax.random.PRNGKey(200 + i)
        ts_j, rew_j, succ_j, m_j = tj._rollout(ts_j, key)
        draws, batches_j, sac_key = jax_draws(tj, ts_j, key, sac_key)
        own = {}
        take_jax_statistics(ts_t.sac.normalizer, ts_j.sac.normalizer, own)
        ts_t, rew_t, succ_t, m_t = tt._do_step(ts_t, learn=True, draws=draws)
        cfg = tt.cfg
        batches_t = [ts_t.her.sample(tt.sac.cfg.batch_size, None, cfg.her_ratio,
                                     cfg.distance_threshold, draws=buf)
                     for buf, _ in draws["updates"]]
        s = ts_j.sac
        out.append(dict(
            jax=jax.tree_util.tree_map(np.asarray, (rew_j, succ_j, m_j, batches_j)),
            port=(rew_t, succ_t, m_t, batches_t),
            params=([to_flax(ts_t.sac.actor), to_flax(ts_t.sac.critic),
                     to_flax(ts_t.sac.target_critic), ts_t.sac.log_alpha.detach().numpy()],
                    jax.tree_util.tree_map(np.asarray, [
                        s.actor_params, s.critic_params, s.target_critic_params,
                        s.log_alpha])),
            steps=(ts_t.sac.step, int(s.step)),
            normalizer=(own, {k: np.asarray(getattr(s.normalizer, k))
                              for k in ("mean", "var", "count")}),
            states=(snapshot(ts_t, True), snapshot(ts_j, False))))
    return out


def test_first_step_skips_its_updates(learning_steps):
    rew_t, _, m_t, _ = learning_steps[0]["port"]
    assert learning_steps[0]["steps"] == (0, 0)
    assert float(m_t["critic_loss"]) == 0.0 and float(m_t["alpha"]) == 1.0
    assert learning_steps[1]["steps"] == (UTD, UTD)
    assert learning_steps[1]["states"][0]["n_eps"] == B


@pytest.mark.parametrize("step", range(2))
def test_learning_step_matches_jax(learning_steps, step):
    o = learning_steps[step]
    rew_j, succ_j, m_j, batches_j = o["jax"]
    rew_t, succ_t, m_t, batches_t = o["port"]
    np.testing.assert_array_equal(rew_t.numpy(), rew_j)
    np.testing.assert_array_equal(succ_t.numpy(), succ_j)
    compare_metrics(m_t, m_j)
    compare_snapshots(*o["states"], f"learning step {step + 1}")
    own, theirs = o["normalizer"]
    for k, v in theirs.items():
        close(own[k], v, f"normalizer.{k}", F32)
    if step == 0:
        return
    for bt, bj in zip(batches_t, batches_j):
        for k in ("obs", "act", "next_obs"):
            close(bt[k], bj[k], f"batch {k}")
        np.testing.assert_array_equal(bt["rew"].numpy(), bj["rew"])
        np.testing.assert_array_equal(bt["done"].numpy(), bj["done"])
    ours, theirs = o["params"]
    for a, b in zip(ours, theirs):
        la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            assert_rel(x, y, "parameters")
