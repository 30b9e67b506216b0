"""The port's SAC and BC against the JAX package's, on the same inputs.

Inputs are made from seeded numpy draws and given to both sides; the JAX
learner's parameters are carried into the port by `agents/convert.py`,
and JAX's own Gaussian draws (from `jax.random.split(st.key, 3)`, as its
update makes them) are fed to the port's update.  Tolerances, relative to
each tensor's largest magnitude: 1e-10 in float64 on both sides; in
float32 on both sides 1e-5, but for the knife edges of float32 that
test_update_matches_jax names; 1e-12 for the normalizer, the replay buffer
exactly."""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.agents import bc as jax_bc
from gym_so100_tpu.agents import sac as jax_sac
from gym_so100_tpu_torch.agents import bc, sac
from gym_so100_tpu_torch.agents.convert import (
    actor_from_numpy,
    load_flax_,
    sac_params_from_numpy,
    to_flax,
)

OBS, ACT, BATCH = 15, 6, 256
UPDATES = 3
DTYPES = {"f64": (jnp.float64, torch.float64, 1e-10),
          "f32": (jnp.float32, torch.float32, 1e-5)}


def assert_rel(actual, expected, rtol):
    """Equal within rtol of the largest magnitude of `expected`."""
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    scale = max(float(np.abs(expected).max()), 1e-30)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=rtol * scale)


def assert_tree_rel(actual, expected, rtol):
    flat_a = jax.tree_util.tree_leaves_with_path(actual)
    flat_e = jax.tree_util.tree_leaves_with_path(expected)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_e]
    for (path, a), (_, e) in zip(flat_a, flat_e):
        assert np.asarray(a).shape == np.asarray(e).shape, path
        assert_rel(a, e, rtol)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def cast(tree, dtype):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), tree)


def _batches(n, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        obs = rng.randn(BATCH, OBS) * 0.5 + 0.2
        out.append(dict(
            obs=obs, act=rng.uniform(-1, 1, (BATCH, ACT)),
            rew=rng.randn(BATCH), next_obs=obs + 0.05 * rng.randn(BATCH, OBS),
            done=rng.rand(BATCH) < 0.2,
        ))
    return out


# -- pieces ------------------------------------------------------------------


def test_normalizer_matches_jax():
    rng = np.random.RandomState(0)
    nj = jax_sac.Normalizer.create(OBS, jnp.float64)
    nt = sac.Normalizer.create(OBS, torch.float64, device="cpu")
    for n in (128, 7, 64, 300):
        batch = rng.randn(n, OBS) * 3 + 1
        nj = nj.update(jnp.asarray(batch))
        nt.update(torch.from_numpy(batch))
    for k in ("mean", "var", "count"):
        assert_rel(nt.tensors()[k].numpy(), getattr(nj, k), 1e-12)
    obs = rng.randn(50, OBS) * 40
    assert_rel(nt.norm(torch.from_numpy(obs)).numpy(), nj.norm(jnp.asarray(obs)), 1e-12)


def test_replay_ring_matches_jax():
    cap, B = 10, 4
    rng = np.random.RandomState(1)
    bj = jax_sac.ReplayBuffer.create(cap, 3, 2, jnp.float64)
    bt = sac.ReplayBuffer(cap, 3, 2, torch.float64, device="cpu")
    for step in range(4):                    # 16 writes: wraps at 10
        o, a, nx = rng.randn(B, 3), rng.randn(B, 2), rng.randn(B, 3)
        r, d = rng.randn(B), rng.rand(B) < 0.5
        bj = bj.add_batch(*map(jnp.asarray, (o, a, r, nx, d)))
        bt.add_batch(*map(torch.from_numpy, (o, a, r, nx, d)))
        assert (bt.ptr, bt.size) == (int(bj.ptr), int(bj.size))
    assert (bt.ptr, bt.size) == (6, cap)
    for name in sac.ReplayBuffer.FIELDS:
        np.testing.assert_array_equal(getattr(bt, name).numpy(), getattr(bj, name))
    idx = np.array([0, 9, 5, 5])
    taken = bt.take(torch.from_numpy(idx))
    np.testing.assert_array_equal(taken["obs"].numpy(), np.asarray(bj.obs)[idx])


@pytest.fixture(scope="module")
def jax_actor_f64():
    actor = jax_sac.Actor(ACT)
    params = cast(actor.init(jax.random.PRNGKey(4), jnp.zeros((1, OBS))), jnp.float64)
    return actor, params


def test_sample_and_det_action_match_jax(jax_actor_f64):
    actor_j, params = jax_actor_f64
    actor_t = actor_from_numpy(to_np(params), dtype=torch.float64)
    rng = np.random.RandomState(5)
    obs = rng.randn(64, OBS) * 2
    key = jax.random.PRNGKey(6)
    act_j, logp_j = jax_sac.sample_action(params, actor_j, jnp.asarray(obs), key)
    eps = np.asarray(jax.random.normal(key, (64, ACT), jnp.float64))
    act_t, logp_t = sac.sample_action(actor_t, torch.from_numpy(obs), torch.from_numpy(eps))
    assert_rel(act_t.detach().numpy(), act_j, 1e-10)
    assert_rel(logp_t.detach().numpy(), logp_j, 1e-10)
    det_t = sac.det_action(actor_t, torch.from_numpy(obs)).detach().numpy()
    assert_rel(det_t, jax_sac.det_action(params, actor_j, jnp.asarray(obs)), 1e-10)


def test_convert_round_trips(jax_actor_f64):
    _, params = jax_actor_f64
    actor = actor_from_numpy(to_np(params), dtype=torch.float64)
    assert_tree_rel(to_flax(actor), to_np(params), 0.0)
    critic_params = jax_sac.Critic().init(
        jax.random.PRNGKey(7), jnp.zeros((1, OBS)), jnp.zeros((1, ACT)))
    critic = load_flax_(sac.Critic(OBS, ACT, dtype=torch.float32), to_np(critic_params))
    assert_tree_rel(to_flax(critic), to_np(critic_params), 0.0)
    with pytest.raises(ValueError):
        load_flax_(sac.Actor(OBS + 1, ACT), to_np(params))


def test_init_matches_flax_distribution():
    """Kernels LeCun-normal truncated at 2 sigma, biases zero: the port's
    per-layer standard deviations and bounds agree with Flax's init."""
    st = sac.SAC(sac.SACConfig(), device="cpu").init(seed=0)
    pj = jax_sac.Actor(ACT).init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    ours = to_flax(st.actor)["params"]["MLP_0"]
    theirs = to_np(pj)["params"]["MLP_0"]
    for name in ours:
        k_t, k_j = ours[name]["kernel"], theirs[name]["kernel"]
        assert k_t.shape == k_j.shape
        assert not ours[name]["bias"].any()
        assert abs(k_t.std() / k_j.std() - 1) < 0.05, name
        bound = 2 / np.sqrt(k_t.shape[0]) / 0.87962566103423978
        assert np.abs(k_t).max() <= bound * (1 + 1e-6)
        assert np.abs(k_t).max() > 0.9 * bound
    for a, b in zip(st.critic.parameters(), st.target_critic.parameters()):
        assert torch.equal(a, b) and not b.requires_grad


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sac.SAC(sac.SACConfig())


# -- the update against JAX --------------------------------------------------


def _jax_state(dtype):
    """A JAX SACState at `dtype` throughout: its init, cast, with fresh Adam
    states, a log_alpha of 0.1 and a normalizer fed two batches."""
    cfg = jax_sac.SACConfig(buffer_size=1024)
    s = jax_sac.SAC(cfg)
    st = s.init(jax.random.PRNGKey(0))
    actor, critic = cast(st.actor_params, dtype), cast(st.critic_params, dtype)
    norm = jax_sac.Normalizer.create(OBS, dtype)
    rng = np.random.RandomState(2)
    for _ in range(2):
        norm = norm.update(jnp.asarray(rng.randn(128, OBS) * 0.7 + 0.1, dtype))
    log_alpha = jnp.asarray(0.1, dtype)
    st = dataclasses.replace(
        st, actor_params=actor, critic_params=critic, target_critic_params=critic,
        log_alpha=log_alpha, actor_opt=s.actor_tx.init(actor),
        critic_opt=s.critic_tx.init(critic), alpha_opt=s.alpha_tx.init(log_alpha),
        normalizer=norm,
    )
    return s, st


@pytest.fixture(scope="module", params=list(DTYPES))
def update_runs(request):
    """Three consecutive updates on each side from one carried start."""
    jdt, tdt, rtol = DTYPES[request.param]
    s_j, st_j = _jax_state(jdt)
    s_t = sac.SAC(sac.SACConfig(buffer_size=1024), device="cpu", dtype=tdt)
    st_t = sac_params_from_numpy(
        s_t, to_np(st_j.actor_params), to_np(st_j.critic_params),
        to_np(st_j.target_critic_params), log_alpha=np.asarray(st_j.log_alpha),
        normalizer={k: np.asarray(getattr(st_j.normalizer, k))
                    for k in ("mean", "var", "count")})
    runs = []
    for batch in _batches(UPDATES):
        _, k1, k2 = jax.random.split(st_j.key, 3)
        eps = [np.asarray(jax.random.normal(k, (BATCH, ACT), jdt)) for k in (k1, k2)]
        st_j, m_j = s_j.update(st_j, {k: jnp.asarray(v, jdt) if k != "done" else
                                      jnp.asarray(v) for k, v in batch.items()})
        bt = {k: torch.from_numpy(v).to(tdt if k != "done" else torch.bool)
              for k, v in batch.items()}
        st_t, m_t = s_t.update(st_t, bt, noise=[torch.from_numpy(e) for e in eps])
        runs.append(dict(
            m_j=to_np(m_j), m_t={k: v.numpy().copy() for k, v in m_t.items()},
            jax=[to_np(x) for x in (st_j.actor_params, st_j.critic_params,
                                    st_j.target_critic_params, st_j.log_alpha)],
            port=[to_flax(st_t.actor), to_flax(st_t.critic),
                  to_flax(st_t.target_critic), st_t.log_alpha.detach().numpy().copy()],
            step=(st_t.step, int(st_j.step)),
        ))
    return runs, request.param, rtol


@pytest.mark.parametrize("i", range(UPDATES))
def test_update_matches_jax(update_runs, i):
    """Update i of three consecutive ones (Adam's bias correction at steps
    1-3): critic/actor losses, alpha, entropy, the actor, critic and target
    parameters and log_alpha, each within rtol of its largest magnitude.

    Float32 has two knife edges that no float32 implementation can hold to
    1e-5 elementwise: log(1 - tanh^2) near saturation (one ulp of tanh moves
    it by ~1e-3 there), which reaches the critic loss through the target;
    and Adam's first steps, which scale a gradient element to about +-lr
    whatever its size, so a tiny gradient whose sign rounds differently
    moves its parameter by up to 2 lr, and the next updates carry that
    difference on to its neighbours (0.03% of elements after update 2,
    0.06% after update 3 at this seed).  In float32 the losses are
    therefore held to 1e-4, and at most one parameter element in 1,000 may
    differ by more than 1e-5 of its tensor's scale, by no more than 2 lr
    per update taken."""
    runs, dtype, rtol = update_runs
    run = runs[i]
    assert run["step"] == (i + 1, i + 1)
    loss_rtol = rtol if dtype == "f64" else 1e-4
    for k in ("critic_loss", "actor_loss", "alpha", "entropy"):
        assert_rel(run["m_t"][k], run["m_j"][k], loss_rtol)
    if dtype == "f64":
        for ours, theirs in zip(run["port"], run["jax"]):
            assert_tree_rel(ours, theirs, rtol)
        return
    lr = sac.SACConfig().lr
    n_all = n_off = 0
    for ours, theirs in zip(run["port"], run["jax"]):
        for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            off = np.abs(a - b) > rtol * np.abs(b).max()
            assert np.abs(a - b)[off].max(initial=0) <= 2 * lr * (i + 1)
            n_all, n_off = n_all + a.size, n_off + int(off.sum())
    assert n_off <= n_all / 1_000, (n_off, n_all)


def test_train_step_ingests_then_updates():
    s = sac.SAC(sac.SACConfig(obs_dim=4, act_dim=2, batch_size=8, buffer_size=32,
                              features=(16, 16)), device="cpu")
    st = s.init(seed=1)
    rng = np.random.RandomState(0)
    obs = torch.from_numpy(rng.randn(8, 4).astype(np.float32))
    act = torch.from_numpy(rng.uniform(-1, 1, (8, 2)).astype(np.float32))
    st, m = s.train_step(st, obs, act, torch.ones(8), obs, torch.zeros(8, dtype=torch.bool))
    assert st.step == 1 and st.buffer.size == 8
    assert torch.equal(st.buffer.obs[:8], obs)
    assert all(torch.isfinite(v) for v in m.values())
    torch.testing.assert_close(st.normalizer.mean, obs.mean(0))
    a = s.act(st, obs)
    assert a.shape == (8, 2) and bool((a.abs() <= 1).all())


def test_states_loaded_from_one_dict_update_alike():
    """Two states loaded from one state dict are independent: updating one
    leaves the other's optimizer counters as saved, so the same update on
    it gives the same parameters."""
    s = sac.SAC(sac.SACConfig(obs_dim=4, act_dim=2, batch_size=8, buffer_size=32,
                              features=(16, 16)), device="cpu")
    st = s.init(seed=1)
    rng = np.random.RandomState(0)
    obs = torch.from_numpy(rng.randn(8, 4).astype(np.float32))
    act = torch.from_numpy(rng.uniform(-1, 1, (8, 2)).astype(np.float32))
    st, _ = s.train_step(st, obs, act, torch.ones(8), obs, torch.zeros(8, dtype=torch.bool))
    saved = s.state_dict(st)
    a, b = s.load_state_dict(saved), s.load_state_dict(saved)
    a, _ = s.update(a, a.buffer.sample(8, a.generator))
    assert int(b.critic_opt.state_dict()["state"][0]["step"]) == 1
    b, _ = s.update(b, b.buffer.sample(8, b.generator))
    for pa, pb in zip([*a.actor.parameters(), *a.critic.parameters(), a.log_alpha],
                      [*b.actor.parameters(), *b.critic.parameters(), b.log_alpha]):
        assert torch.equal(pa, pb)


# -- behavior cloning --------------------------------------------------------


def test_load_demo_transitions_matches_jax(tmp_path):
    rng = np.random.RandomState(8)
    flat = [{"observations": rng.randn(5, OBS), "actions": rng.randn(4, ACT),
             "rewards": np.zeros(4), "infos": [{}] * 4}]
    dicts = [{"observations": [{"qpos": rng.randn(6), "box": rng.randn(3),
                                "pixels": np.zeros((2, 2, 3), np.uint8)}
                               for _ in range(3)],
              "actions": rng.randn(3, ACT), "rewards": np.zeros(3), "infos": [{}] * 3}]
    paths = []
    for name, eps in (("flat", flat), ("dict", dicts)):
        p = tmp_path / f"{name}.pkl"
        p.write_bytes(pickle.dumps(eps))
        paths.append(str(p))
    for args in (([paths[0]],), ([paths[1]],), ([paths[1]], "qpos")):
        o_t, a_t = bc.load_demo_transitions(*args)
        o_j, a_j = jax_bc.load_demo_transitions(*args)
        np.testing.assert_array_equal(o_t, o_j)
        np.testing.assert_array_equal(a_t, a_j)
        assert o_t.dtype == a_t.dtype == np.float32


class _Actor64(jax_sac.Actor):
    """The JAX actor with float64 parameters (Flax's Dense defaults to
    float32 parameters whatever the input dtype)."""

    def init(self, *args, **kwargs):
        return cast(super().init(*args, **kwargs), jnp.float64)


def test_train_bc_matches_jax(monkeypatch):
    """Two epochs of BC from the same initial actor, the same permutation
    and batches, in float64: losses and final parameters to 1e-10."""
    rng = np.random.RandomState(9)
    n, bs, seed = 48, 16, 3
    obs = rng.randn(n, OBS)
    act = np.clip(rng.uniform(-1.1, 1.1, (n, ACT)), -1, 1)
    log_j, log_t = [], []
    monkeypatch.setattr(jax_bc, "Actor", _Actor64)
    actor_j, params_j = jax_bc.train_bc(obs, act, epochs=2, batch_size=bs, seed=seed,
                                        progress=log_j.append)
    params0 = _Actor64(ACT).init(jax.random.PRNGKey(seed), jnp.asarray(obs[:1]))
    actor0 = actor_from_numpy(to_np(params0), dtype=torch.float64)
    actor_t = bc.train_bc(obs, act, epochs=2, batch_size=bs, seed=seed,
                          progress=log_t.append, device="cpu", dtype=torch.float64,
                          actor=actor0)
    assert [x["epoch"] for x in log_t] == [0, 1]
    for a, b in zip(log_t, log_j):
        assert_rel(a["bc_loss"], b["bc_loss"], 1e-10)
    assert_tree_rel(to_flax(actor_t), to_np(params_j), 1e-10)
    assert np.abs(to_flax(actor_t)["params"]["MLP_0"]["Dense_0"]["kernel"]
                  - to_np(params0)["params"]["MLP_0"]["Dense_0"]["kernel"]).max() > 1e-5


def test_transfer_to_sac():
    s = sac.SAC(sac.SACConfig(features=(32, 32)), device="cpu")
    st = s.init(seed=0)
    rng = np.random.RandomState(10)
    actor = bc.train_bc(rng.randn(32, OBS), rng.uniform(-1, 1, (32, ACT)), epochs=1,
                        batch_size=16, features=(32, 32), device="cpu")
    st = bc.transfer_to_sac(s, st, actor)
    for a, b in zip(st.actor.parameters(), actor.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="differ"):
        bc.transfer_to_sac(s, st, sac.Actor(OBS, ACT, (16, 16)))
