"""The port's pixel SAC and BC against the JAX package's, in float64.

As in tests/test_torch_sac.py: inputs are seeded numpy draws given to both
sides, the JAX learner's parameters are carried into the port by
`agents/convert.py`, and JAX's own Gaussian draws are fed to the port's
update, compiled as the JAX trainer runs it.  Pixels go through float32 on
both sides (uint8 / 255 in float32, then float64), so float64 holds
everything to 1e-10 of each tensor's
largest magnitude, the NatureCNN to 1e-12, the replay ring exactly.  The
last test runs the pixel trainer at B = 4 on the CPU."""

import dataclasses

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

H, W = 24, 32
POS, ACT, BATCH = 6, 6, 4
FEATURES = (32, 32)
UPDATES = 3
RTOL = 1e-10


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


def pixel_obs(rng, n, h=H, w=W):
    return {"pixels": rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
            "agent_pos": (rng.randn(n, POS) * 0.5).astype(np.float32)}


def jax_cfg(**kw):
    return jax_sac.SACConfig(obs_dim=POS, pixels=(H, W), features=FEATURES,
                             batch_size=BATCH, buffer_size=16, **kw)


def torch_cfg(**kw):
    return sac.SACConfig(obs_dim=POS, pixels=(H, W), features=FEATURES,
                         batch_size=BATCH, buffer_size=16, **kw)


# -- the encoder ---------------------------------------------------------------


@pytest.mark.parametrize("size,pads", [
    ((24, 32), None),
    ((20, 28), [((2, 2), (2, 2)), ((1, 2), (1, 2)), ((1, 1), (1, 1))]),
])
def test_nature_cnn_matches_flax(size, pads):
    """NatureCNN against Flax's in float64 to 1e-12, at a size where XLA's
    SAME padding is asymmetric (20x28: the second conv pads 1 before and 2
    after on both axes)."""
    h, w = size
    rng = np.random.RandomState(0)
    img = rng.uniform(0, 1, (5, h, w, 3))
    flax_cnn = jax_sac.NatureCNN()
    params = cast(flax_cnn.init(jax.random.PRNGKey(1), jnp.zeros((1, h, w, 3))), jnp.float64)
    out_j = flax_cnn.apply(params, jnp.asarray(img))
    cnn = sac.NatureCNN(h, w, dtype=torch.float64)
    tree = to_np(params)["params"]
    with torch.no_grad():
        for layer, name in zip(cnn.layers(), ("Conv_0", "Conv_1", "Conv_2", "Dense_0")):
            k = tree[name]["kernel"]
            perm = (3, 2, 0, 1) if k.ndim == 4 else (1, 0)
            layer.weight.copy_(torch.from_numpy(k.transpose(perm).copy()))
            layer.bias.copy_(torch.from_numpy(tree[name]["bias"].copy()))
    out_t = cnn(torch.from_numpy(img)).detach().numpy()
    assert out_t.shape == out_j.shape == (5, 256)
    assert_rel(out_t, out_j, 1e-12)
    if pads is not None:
        got = [(p[2:], p[:2]) for p in cnn.pads]        # (rows, cols)
        assert got == pads
    # a batch of leading axes flattens as Flax's does
    out2 = cnn(torch.from_numpy(img.reshape(5, 1, h, w, 3))).detach().numpy()
    np.testing.assert_array_equal(out2[:, 0], out_t)


def test_unit_pixels_match_compiled_jax():
    """XLA compiles the JAX package's `uint8 / 255.0` in float32 as a
    product with the float32 reciprocal; the port's scaling equals it for
    all 256 values, where a true division differs for 126 of them."""
    x = np.arange(256, dtype=np.uint8)
    theirs = np.asarray(jax.jit(lambda v: jnp.asarray(v, jnp.float32) / 255.0)(x))
    ours = sac.unit_pixels(torch.from_numpy(x), torch.float32).numpy()
    np.testing.assert_array_equal(ours, theirs)
    divided = (torch.from_numpy(x).float() / 255.0).numpy()
    assert int((divided != theirs).sum()) == 126


@pytest.mark.parametrize("size,out", [((48, 64), (6, 8)), ((96, 128), (12, 16)),
                                      ((24, 32), (3, 4)), ((20, 28), (3, 4))])
def test_same_padding_output_sizes(size, out):
    cnn = sac.NatureCNN(*size)
    assert cnn.dense.in_features == 64 * out[0] * out[1]
    assert sac.same_padding(20, 8, 4) == (2, 2) and sac.same_padding(5, 4, 2) == (1, 2)
    assert sac.same_padding(3, 8, 4) == (2, 3) and sac.same_padding(4, 3, 1) == (1, 1)


def test_convert_round_trips_pixel_networks():
    actor_j = jax_sac.Actor(ACT, FEATURES, pixels=True)
    obs0 = {"pixels": jnp.zeros((1, H, W, 3)), "agent_pos": jnp.zeros((1, POS))}
    pa = to_np(actor_j.init(jax.random.PRNGKey(2), obs0))
    assert "Encoder_0" in pa["params"]
    actor = actor_from_numpy(pa, pixels=(H, W), dtype=torch.float64)
    assert_tree_rel(to_flax(actor), pa, 0.0)
    with pytest.raises(ValueError, match="pixels"):
        actor_from_numpy(pa)
    pc = to_np(jax_sac.Critic(FEATURES, pixels=True).init(
        jax.random.PRNGKey(3), obs0, jnp.zeros((1, ACT))))
    critic = load_flax_(sac.Critic(POS, ACT, FEATURES, pixels=(H, W)), pc)
    assert_tree_rel(to_flax(critic), pc, 0.0)
    with pytest.raises(ValueError):
        load_flax_(sac.Critic(POS, ACT, FEATURES), pc)
    with pytest.raises(ValueError):
        load_flax_(sac.Actor(POS, ACT, FEATURES, pixels=(H + 8, W)), pa)


def test_init_matches_flax_distribution():
    """Conv kernels LeCun-normal with fan-in kh * kw * c_in, truncated at 2
    sigma; biases zero."""
    st = sac.SAC(sac.SACConfig(obs_dim=POS, pixels=(48, 64)), device="cpu").init(seed=0)
    obs0 = {"pixels": jnp.zeros((1, 48, 64, 3)), "agent_pos": jnp.zeros((1, POS))}
    pj = to_np(jax_sac.Actor(ACT, pixels=True).init(jax.random.PRNGKey(0), obs0))
    ours = to_flax(st.actor)["params"]["Encoder_0"]["NatureCNN_0"]
    theirs = pj["params"]["Encoder_0"]["NatureCNN_0"]
    for name in ("Conv_0", "Conv_1", "Conv_2", "Dense_0"):
        k_t, k_j = ours[name]["kernel"], theirs[name]["kernel"]
        assert k_t.shape == k_j.shape, name
        assert not ours[name]["bias"].any()
        assert abs(k_t.std() / k_j.std() - 1) < 0.1, name
        bound = 2 / np.sqrt(np.prod(k_t.shape[:-1])) / 0.87962566103423978
        assert np.abs(k_t).max() <= bound * (1 + 1e-6)
    for a, b in zip(st.critic.parameters(), st.target_critic.parameters()):
        assert torch.equal(a, b)
    assert st.buffer.obs["pixels"].dtype == torch.uint8
    assert st.buffer.obs["pixels"].shape == (sac.SACConfig().buffer_size, 48, 64, 3)


# -- the replay ring -------------------------------------------------------------


def test_uint8_replay_ring_matches_jax():
    cap, n = 10, 4
    rng = np.random.RandomState(1)
    s_j = jax_sac.SAC(jax_cfg())
    spec = s_j.obs_spec()
    bj = jax_sac.ReplayBuffer.create(cap, spec, ACT, jnp.float64)
    bt = sac.ReplayBuffer(cap, sac.SAC(torch_cfg(), device="cpu").obs_spec(), ACT,
                          torch.float64, device="cpu")
    for _ in range(4):                        # 16 writes: wraps at 10
        o, nx = pixel_obs(rng, n), pixel_obs(rng, n)
        a, r, d = rng.randn(n, ACT), rng.randn(n), rng.rand(n) < 0.5
        bj = bj.add_batch(jax.tree_util.tree_map(jnp.asarray, o), jnp.asarray(a),
                          jnp.asarray(r), jax.tree_util.tree_map(jnp.asarray, nx),
                          jnp.asarray(d))
        bt.add_batch({k: torch.from_numpy(v) for k, v in o.items()}, torch.from_numpy(a),
                     torch.from_numpy(r), {k: torch.from_numpy(v) for k, v in nx.items()},
                     torch.from_numpy(d))
        assert (bt.ptr, bt.size) == (int(bj.ptr), int(bj.size))
    for name in ("obs", "next_obs"):
        for k in ("pixels", "agent_pos"):
            ours, theirs = getattr(bt, name)[k], np.asarray(getattr(bj, name)[k])
            assert ours.numpy().dtype == theirs.dtype
            np.testing.assert_array_equal(ours.numpy(), theirs)
    for name in ("act", "rew", "done"):
        np.testing.assert_array_equal(getattr(bt, name).numpy(), getattr(bj, name))
    idx = np.array([0, 9, 5, 5])
    taken = bt.take(torch.from_numpy(idx))
    np.testing.assert_array_equal(taken["next_obs"]["pixels"].numpy(),
                                  np.asarray(bj.next_obs["pixels"])[idx])


# -- the update against JAX --------------------------------------------------


def _jax_state():
    """A JAX pixel SACState in float64: its init, cast, with fresh Adam
    states, a log_alpha of 0.1 and a normalizer fed two agent_pos batches."""
    s = jax_sac.SAC(jax_cfg())
    st = s.init(jax.random.PRNGKey(0))
    actor, critic = cast(st.actor_params, jnp.float64), cast(st.critic_params, jnp.float64)
    norm = jax_sac.Normalizer.create(POS, jnp.float64)
    rng = np.random.RandomState(2)
    for _ in range(2):
        norm = norm.update(jnp.asarray(rng.randn(64, POS) * 0.7 + 0.1))
    log_alpha = jnp.asarray(0.1, jnp.float64)
    st = dataclasses.replace(
        st, actor_params=actor, critic_params=critic, target_critic_params=critic,
        log_alpha=log_alpha, actor_opt=s.actor_tx.init(actor),
        critic_opt=s.critic_tx.init(critic), alpha_opt=s.alpha_tx.init(log_alpha),
        normalizer=norm)
    return s, st


@pytest.fixture(scope="module")
def update_runs():
    """Three consecutive pixel updates on each side from one carried start."""
    s_j, st_j = _jax_state()
    s_t = sac.SAC(torch_cfg(), device="cpu", dtype=torch.float64)
    st_t = sac_params_from_numpy(
        s_t, to_np(st_j.actor_params), to_np(st_j.critic_params),
        to_np(st_j.target_critic_params), log_alpha=np.asarray(st_j.log_alpha),
        normalizer={k: np.asarray(getattr(st_j.normalizer, k))
                    for k in ("mean", "var", "count")})
    update_j = jax.jit(s_j.update)        # compiled, as the JAX trainer runs it
    rng = np.random.RandomState(3)
    runs = []
    for _ in range(UPDATES):
        batch = dict(obs=pixel_obs(rng, BATCH), act=rng.uniform(-1, 1, (BATCH, ACT)),
                     rew=rng.randn(BATCH), next_obs=pixel_obs(rng, BATCH),
                     done=rng.rand(BATCH) < 0.3)
        _, k1, k2 = jax.random.split(st_j.key, 3)
        eps = [np.array(jax.random.normal(k, (BATCH, ACT), jnp.float64)) for k in (k1, k2)]
        st_j, m_j = update_j(st_j, jax.tree_util.tree_map(jnp.asarray, batch))
        bt = jax.tree_util.tree_map(torch.from_numpy, batch)
        st_t, m_t = s_t.update(st_t, bt, noise=[torch.from_numpy(e) for e in eps])
        runs.append(dict(
            m_j=to_np(m_j), m_t={k: v.numpy().copy() for k, v in m_t.items()},
            jax=[to_np(x) for x in (st_j.actor_params, st_j.critic_params,
                                    st_j.target_critic_params, st_j.log_alpha)],
            port=[to_flax(st_t.actor), to_flax(st_t.critic),
                  to_flax(st_t.target_critic), st_t.log_alpha.detach().numpy().copy()],
            step=(st_t.step, int(st_j.step))))
    return runs


@pytest.mark.parametrize("i", range(UPDATES))
def test_update_matches_jax(update_runs, i):
    """Update i of three: losses, alpha, entropy, and the actor, critic and
    target parameters (CNN encoders included) and log_alpha, each to 1e-10
    of its largest magnitude."""
    run = update_runs[i]
    assert run["step"] == (i + 1, i + 1)
    for k in ("critic_loss", "actor_loss", "alpha", "entropy"):
        assert_rel(run["m_t"][k], run["m_j"][k], RTOL)
    for ours, theirs in zip(run["port"], run["jax"]):
        assert_tree_rel(ours, theirs, RTOL)


def test_act_and_train_step_on_pixel_obs():
    s = sac.SAC(torch_cfg(), device="cpu")
    st = s.init(seed=1)
    rng = np.random.RandomState(4)
    obs = {k: torch.from_numpy(v) for k, v in pixel_obs(rng, 8).items()}
    act = torch.from_numpy(rng.uniform(-1, 1, (8, ACT)).astype(np.float32))
    st, m = s.train_step(st, obs, act, torch.ones(8), obs, torch.zeros(8, dtype=torch.bool))
    assert st.step == 1 and st.buffer.size == 8
    assert torch.equal(st.buffer.obs["pixels"][:8], obs["pixels"])
    assert all(torch.isfinite(v) for v in m.values())
    torch.testing.assert_close(st.normalizer.mean, obs["agent_pos"].mean(0))
    for deterministic in (False, True):
        a = s.act(st, obs, deterministic=deterministic)
        assert a.shape == (8, ACT) and bool((a.abs() <= 1).all())


# -- behavior cloning --------------------------------------------------------


def test_load_demo_transitions_pixels_matches_jax(tmp_path):
    import pickle

    rng = np.random.RandomState(8)
    eps = [{"observations": [{"agent_pos": rng.randn(POS), "pixels": o}
                             for o in pixel_obs(rng, 3)["pixels"]],
            "actions": rng.randn(3, ACT), "rewards": np.zeros(3), "infos": [{}] * 3},
           {"observations": [{"qpos": rng.randn(POS), "pixels": o}
                             for o in pixel_obs(rng, 2)["pixels"]],
            "actions": rng.randn(2, ACT), "rewards": np.zeros(2), "infos": [{}] * 2}]
    p = tmp_path / "demo.pkl"
    p.write_bytes(pickle.dumps(eps))
    (o_t, a_t), (o_j, a_j) = (f.load_demo_transitions([str(p)], pixels=True)
                              for f in (bc, jax_bc))
    for k in ("pixels", "agent_pos"):
        np.testing.assert_array_equal(o_t[k], o_j[k])
        assert o_t[k].dtype == o_j[k].dtype
    np.testing.assert_array_equal(a_t, a_j)
    assert o_t["pixels"].shape == (5, H, W, 3) and o_t["pixels"].dtype == np.uint8
    flat = tmp_path / "flat.pkl"
    flat.write_bytes(pickle.dumps([{"observations": rng.randn(2, POS),
                                    "actions": rng.randn(2, ACT)}]))
    with pytest.raises(ValueError, match="dict"):
        bc.load_demo_transitions([str(flat)], pixels=True)


class _Actor64(jax_sac.Actor):
    """The JAX actor with float64 parameters."""

    def init(self, *args, **kwargs):
        return cast(super().init(*args, **kwargs), jnp.float64)


def test_pixel_bc_matches_jax_and_transfers(monkeypatch):
    """Two epochs of pixel BC from the same initial actor, the same
    permutation and batches, in float64: losses and final parameters to
    1e-10; the policy then moves into a pixel SAC actor, and a flat SAC
    actor refuses it."""
    rng = np.random.RandomState(9)
    n, bs, seed = 24, 8, 3
    obs = pixel_obs(rng, n)
    act = np.clip(rng.uniform(-1.1, 1.1, (n, ACT)), -1, 1)
    log_j, log_t = [], []
    monkeypatch.setattr(jax_bc, "Actor", _Actor64)
    _, params_j = jax_bc.train_bc(obs, act, epochs=2, batch_size=bs, seed=seed,
                                  features=FEATURES, progress=log_j.append)
    obs0 = {"pixels": jnp.asarray(obs["pixels"][:1], jnp.float32) / 255.0,
            "agent_pos": jnp.asarray(obs["agent_pos"][:1])}
    params0 = _Actor64(ACT, FEATURES, pixels=True).init(jax.random.PRNGKey(seed), obs0)
    actor0 = actor_from_numpy(to_np(params0), pixels=(H, W), dtype=torch.float64)
    actor_t = bc.train_bc(obs, act, epochs=2, batch_size=bs, seed=seed,
                          features=FEATURES, progress=log_t.append, device="cpu",
                          dtype=torch.float64, actor=actor0)
    assert [x["epoch"] for x in log_t] == [0, 1]
    for a, b in zip(log_t, log_j):
        assert_rel(a["bc_loss"], b["bc_loss"], RTOL)
    assert_tree_rel(to_flax(actor_t), to_np(params_j), RTOL)

    s = sac.SAC(torch_cfg(), device="cpu", dtype=torch.float64)
    st = bc.transfer_to_sac(s, s.init(seed=0), actor_t)
    for a, b in zip(st.actor.parameters(), actor_t.parameters()):
        assert torch.equal(a, b)
    a = s.act(st, {k: torch.from_numpy(v[:3]) for k, v in obs.items()})
    assert a.shape == (3, ACT) and bool((a.abs() <= 1).all())
    flat = sac.SAC(sac.SACConfig(obs_dim=POS, features=FEATURES), device="cpu",
                   dtype=torch.float64)
    with pytest.raises(ValueError, match="differ"):
        bc.transfer_to_sac(flat, flat.init(seed=0), actor_t)
    # a fresh pixel BC (its own init) learns
    losses = []
    bc.train_bc(obs, act, epochs=4, batch_size=bs, features=FEATURES, device="cpu",
                progress=lambda x: losses.append(x["bc_loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# -- the trainer -----------------------------------------------------------------


def test_pixel_trainer_saves_and_restores(tmp_path):
    """The pixel trainer at B = 4, 24x32: two warm-up and two learning
    env-batch steps, uint8 frames in the buffer; a checkpoint restores
    bit-equal, buffer frames included, and a resumed run takes one more
    learning step."""
    from gym_so100_tpu_torch.agents.train import TrainConfig, Trainer

    B = 4
    tcfg = TrainConfig(task="so100_touch_cube", num_envs=B, total_steps=4 * B,
                       learning_starts=2 * B, utd=2, log_every=1, obs="pixels_agent_pos",
                       obs_height=H, obs_width=W, max_contacts=16)
    cfg = sac.SACConfig(obs_dim=POS, pixels=(H, W), features=FEATURES, batch_size=8,
                        buffer_size=64)
    tr = Trainer(None, tcfg, cfg, device="cpu")
    lines = []
    st = tr.train(seed=0, progress=lines.append)
    assert [ln["env_steps"] for ln in lines] == [B, 2 * B, 3 * B, 4 * B]
    assert all(np.isfinite(v) for ln in lines for v in ln.values())
    assert "critic_loss" in lines[-1] and st.step == 4
    assert st.buffer.size == 4 * B and st.buffer.obs["pixels"].dtype == torch.uint8
    assert int(st.buffer.obs["pixels"][:4 * B].max()) > 0
    path = tr.save(st, tmp_path, 4 * B)
    st2 = tr.restore(path)
    saved, restored = tr.sac.state_dict(st), tr.sac.state_dict(st2)
    for part in ("actor", "critic", "target_critic", "normalizer"):
        for k, v in saved[part].items():
            assert torch.equal(v, restored[part][k]), (part, k)
    for name in sac.ReplayBuffer.FIELDS:
        v, w = saved["buffer"][name], restored["buffer"][name]
        for key in (v if isinstance(v, dict) else [None]):
            a, b = (v[key], w[key]) if key else (v, w)
            assert a.dtype == b.dtype and torch.equal(a, b), (name, key)
    assert (st2.step, st2.batch_steps, st2.buffer.ptr) == (st.step, st.batch_steps,
                                                           st.buffer.ptr)
    assert Trainer.load_config(path) == cfg
    tr2 = Trainer(tr.env.m, dataclasses.replace(tcfg, total_steps=5 * B,
                                                render_aux=tr.env.render_aux),
                  cfg, device="cpu")
    lines2 = []
    st3 = tr2.train(seed=0, progress=lines2.append, init_state=st2)
    assert [ln["env_steps"] for ln in lines2] == [5 * B]
    assert st3.step == st.step + 2 and st3.buffer.size == 5 * B
