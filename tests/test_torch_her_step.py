"""The port's HER trainer step against the JAX package's HERTrainer: warm-up
steps, float64, K = 32 contact slots, hulls on, B = 4, 2-step episodes.

Same inputs on both sides: the Model through the bridge, JAX's cube spawns
and goal uniforms (from JAX's own key splits, as its reset and autoreset
make them), JAX's uniform warm-up actions, and the learner at float64
(JAX's initial SAC parameters cast, carried over by `agents/convert.py`).
Three env-batch steps: the episodes of all four lanes end at step 2
(truncation), flush into the HER buffer and restart with fresh spawns and
goals.  After every step: reward, success, the staging tensors (obs,
action, next_obs, achieved goal), the goals, the episode steps, the
curriculum clock, the physics state, the HER buffer, the normalizer and the
diagnostics, to 1e-10 (abs and rel); integers and masks exactly.  Two
quantities are float32 reductions on both sides, which XLA and torch sum in
other orders (XLA also contracts products into fused multiply-adds), so
they are held to 1e-6 (a few float32 ulps): the diagnostic goal_dist, and
the normalizer, whose batch mean and variance both take in float32 from
the float32 observations before merging them into the float64 running
statistics.
The learning steps are in tests/test_torch_her_update.py, which imports
this module's helpers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.agents import sac as jax_sac
from gym_so100_tpu.agents.train_her import HERConfig as JaxHERConfig
from gym_so100_tpu.agents.train_her import HERTrainer as JaxHERTrainer
from gym_so100_tpu.envs.gym_env import ASSETS_XML
from gym_so100_tpu.models.builder import build_model as jax_build_model
from gym_so100_tpu_torch.agents.convert import sac_params_from_numpy
from gym_so100_tpu_torch.agents.sac import SAC, SACConfig
from gym_so100_tpu_torch.agents.train_her import HERConfig, HERTrainer
from gym_so100_tpu_torch.models.convert import model_from_numpy

B, K, T, E = 4, 32, 2, 6
STEPS = 3
TOL = 1e-10
F32 = 1e-6     # float32 reductions (see above)
SEED = 0


def _leaves(obj):
    return {f.name: (np.asarray(v) if hasattr(v, "shape") and hasattr(v, "dtype") else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), tree)


def close(a, b, name, tol=TOL):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=tol, atol=tol, err_msg=name)


def goal_uniforms(es_key):
    """JAX's goal uniforms of an autoreset: split(key)[1] of each lane's key."""
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(
        jax.random.split(k)[1], (3,), jnp.float64))(es_key))


def make_trainers(utd=1):
    """The JAX trainer and the port's at the same float64 start: JAX's
    initial SAC parameters (cast) and first episodes on both sides."""
    mj, _ = jax_build_model(ASSETS_XML, max_contacts=K)
    mj = mj.astype(jnp.float64)
    mt = model_from_numpy(_leaves(mj))
    kw = dict(num_envs=B, total_steps=100 * B, learning_starts=100 * B, her_episodes=E,
              max_episode_steps=T, utd=utd)
    sac_kw = dict(obs_dim=18, act_dim=6, lr=1e-4, buffer_size=1, batch_size=16,
                  features=(32, 32))
    tj = JaxHERTrainer(mj, JaxHERConfig(**kw), jax_sac.SACConfig(**sac_kw))
    ts_j = tj.init(SEED)
    s = tj.sac
    actor, critic = (_cast(p, jnp.float64) for p in
                     (ts_j.sac.actor_params, ts_j.sac.critic_params))
    ts_j = dataclasses.replace(ts_j, sac=dataclasses.replace(
        ts_j.sac, actor_params=actor, critic_params=critic, target_critic_params=critic,
        log_alpha=jnp.zeros((), jnp.float64), actor_opt=s.actor_tx.init(actor),
        critic_opt=s.critic_tx.init(critic),
        alpha_opt=s.alpha_tx.init(jnp.zeros((), jnp.float64)),
        normalizer=jax_sac.Normalizer.create(18, jnp.float64)))

    tt = HERTrainer(mt, HERConfig(**kw, max_contacts=K), SACConfig(**sac_kw), device="cpu")
    tt.sac = SAC(tt.sac.cfg, device="cpu", dtype=torch.float64)
    ts_t = tt.init(SEED)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    ts_t.sac = sac_params_from_numpy(tt.sac, np_tree(actor), np_tree(critic),
                                     log_alpha=0.0)
    # JAX's first episodes: spawns from its reset, goal uniforms from
    # split(split(PRNGKey(seed + 1))[1], B)
    k2 = jax.random.split(jax.random.PRNGKey(SEED + 1))[1]
    u0 = jax.vmap(lambda k: jax.random.uniform(k, (3,), jnp.float64))(
        jax.random.split(k2, B))
    ts_t.genv = tt.reset(box_pose=np.asarray(ts_j.genv.es.box_pose), goal_u=np.asarray(u0))
    close(ts_t.genv.goal, ts_j.genv.goal, "initial goals")
    return tj, ts_j, tt, ts_t


@pytest.fixture(scope="module")
def trainers():
    return make_trainers()


def snapshot(ts, port):
    """The compared parts of a HER train state, as numpy arrays."""
    arr = (lambda x: x.detach().cpu().numpy().copy()) if port else np.asarray
    g = ts.genv
    snap = {"goal": g.goal, "t": g.t, "box_pose": g.es.box_pose,
            "st_obs": ts.st_obs, "st_act": ts.st_act, "st_next": ts.st_next,
            "st_agoal": ts.st_agoal}
    snap.update({k: getattr(g.es.physics, k) for k in ("qpos", "qvel", "qacc_warmstart")})
    snap.update({f"her.{k}": getattr(ts.her, k)
                 for k in ("obs", "act", "next_obs", "agoal", "dgoal", "ep_len")})
    snap.update({f"normalizer.{k}": getattr(ts.sac.normalizer, k)
                 for k in ("mean", "var", "count")})
    snap = {k: arr(v) for k, v in snap.items()}
    snap.update(total=int(g.total), ptr=int(ts.her.ptr), n_eps=int(ts.her.n_eps))
    return snap


def compare_metrics(ours, theirs, tol=TOL):
    """The step's metrics: goal_dist to F32 relative (float32 arithmetic),
    the rest to `tol`; the port's contact watch (ncon_max) on top."""
    assert set(ours) == set(theirs) | {"ncon_max"}
    assert 0 <= int(ours["ncon_max"]) <= K
    for k, v in theirs.items():
        if k == "goal_dist":
            np.testing.assert_allclose(float(ours[k]), float(v), rtol=F32, err_msg=k)
        else:
            close(ours[k], v, k, tol)


def compare_snapshots(ours, theirs, label):
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        if isinstance(v, int) or v.dtype.kind in "iub":
            np.testing.assert_array_equal(ours[k], v, err_msg=f"{label}: {k}")
        else:
            close(ours[k], v, f"{label}: {k}", F32 if k.startswith("normalizer") else TOL)


@pytest.fixture(scope="module")
def warmup_steps(trainers):
    """STEPS warm-up steps on each side; per step the outputs and the state
    after it, of both."""
    tj, ts_j, tt, ts_t = trainers
    out = []
    for i in range(STEPS):
        key = jax.random.PRNGKey(100 + i)
        acts = jax.random.uniform(jax.random.split(key)[0], (B, 6), jnp.float32, -1, 1)
        ts_j, rew_j, succ_j, m_j = tj._warmup(ts_j, key)
        draws = dict(actions=np.asarray(acts), spawn=np.asarray(ts_j.genv.es.box_pose),
                     goal_u=goal_uniforms(ts_j.genv.es.key))
        ts_t, rew_t, succ_t, m_t = tt._do_step(ts_t, learn=False, draws=draws)
        out.append(dict(jax=jax.tree_util.tree_map(np.asarray, (rew_j, succ_j, m_j)),
                        port=(rew_t, succ_t, m_t),
                        states=(snapshot(ts_t, True), snapshot(ts_j, False))))
    return out, ts_t


def test_episodes_end_and_flush(warmup_steps):
    out, ts_t = warmup_steps
    assert [float(o["port"][2]["ep_done"]) for o in out] == [0.0, B, 0.0]
    assert (ts_t.her.ptr, ts_t.her.n_eps) == (B, B)
    assert ts_t.her.ep_len.tolist() == [T] * B + [0] * (E - B)
    assert ts_t.genv.t.tolist() == [1] * B and ts_t.genv.total == STEPS * B


@pytest.mark.parametrize("step", range(STEPS))
def test_warmup_step_matches_jax(warmup_steps, step):
    o = warmup_steps[0][step]
    (rew_j, succ_j, m_j), (rew_t, succ_t, m_t) = o["jax"], o["port"]
    assert rew_t.dtype == torch.float32
    np.testing.assert_array_equal(rew_t.numpy(), rew_j)
    np.testing.assert_array_equal(succ_t.numpy(), succ_j)
    compare_metrics(m_t, m_j)
    compare_snapshots(*o["states"], f"warm-up step {step + 1}")
