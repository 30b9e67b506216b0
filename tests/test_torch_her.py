"""The port's HER pieces against the JAX package's, and the port's HER
trainer on the CPU.

* `goal_env.compute_reward` against `compute_reward_jnp`: broadcasting over
  leading dims and the threshold edge (a distance of exactly the threshold
  is no success), exactly;
* `train_her.sample_goal` against `_sample_goal` with JAX's uniforms
  injected: early and late curriculum and `goal_min_dist` > 0, float64, to
  1e-12;
* `HerBuffer` against JAX's: episodes added (JAX one lane at a time, the
  port all finished lanes at once, also more finishers than episodes) and
  sampled with JAX's four draws injected: indices exact, values to 1e-12;
* a HER run of the port alone at B = 4 on the CPU: finite metrics, episodes
  stored, save/restore bit-equal, and a resumed run that continues its loop
  counter without re-entering warm-up.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.agents import her as jax_her
from gym_so100_tpu.agents import train_her as jax_train_her
from gym_so100_tpu.envs.goal_env import compute_reward_jnp
from gym_so100_tpu_torch.agents.her import HerBuffer
from gym_so100_tpu_torch.agents.sac import SACConfig
from gym_so100_tpu_torch.agents.train_her import (
    GOAL_DIM,
    HERConfig,
    HERTrainer,
    sample_goal,
)
from gym_so100_tpu_torch.envs import constants as C
from gym_so100_tpu_torch.envs.goal_env import compute_reward

TOL = 1e-12


def test_bin_bounds_match_jax():
    from gym_so100_tpu.envs import constants as jax_C

    for name in ("bin_min", "bin_max"):
        ours, theirs = getattr(C, name), getattr(jax_C, name)
        assert ours.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)


def test_compute_reward_matches_jax():
    rng = np.random.RandomState(0)
    a = rng.uniform(-0.02, 0.02, (5, 7, 3))
    g = rng.uniform(-0.02, 0.02, (7, 3))              # broadcast over the leading dim
    for x, y in ((a, g), (a[0], g), (a[:, 0], g[0])):
        r_t = compute_reward(torch.from_numpy(x), torch.from_numpy(y))
        r_j = compute_reward_jnp(jnp.asarray(x), jnp.asarray(y))
        assert r_t.dtype == torch.float32 and r_t.shape == r_j.shape
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    assert set(np.unique(r_t.numpy())) <= {0.0, -1.0}
    # the edge: exactly the threshold is a miss, just inside it a hit
    for dtype in (np.float32, np.float64):
        edge = np.array([[0.01, 0.0, 0.0], [0.0, np.nextafter(dtype(0.01), dtype(0)), 0.0],
                         [0.0, 0.0, -0.01], [0.006, 0.008, 0.0]], dtype)
        zero = np.zeros(3, dtype)
        for thr in (0.01, 0.02):
            r_t = compute_reward(torch.from_numpy(edge), torch.from_numpy(zero), thr)
            r_j = compute_reward_jnp(jnp.asarray(edge), jnp.asarray(zero), thr)
            np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
        assert compute_reward(torch.from_numpy(edge), torch.from_numpy(zero))[:3].tolist() \
            == [-1.0, 0.0, -1.0]


def _spawns(B, seed):
    rng = np.random.RandomState(seed)
    pose = np.zeros((B, 7))
    pose[:, 0] = rng.uniform(*C.BOX_X_RANGE, B)
    pose[:, 1] = rng.uniform(*C.BOX_Y_RANGE, B)
    pose[:, 2] = C.BOX_Z
    pose[:, 3] = 1.0
    return pose


@pytest.mark.parametrize("total, min_dist", [(0, 0.0), (6000, 0.0), (0, 0.02)],
                         ids=["early", "late", "min_dist"])
def test_sample_goal_matches_jax(total, min_dist):
    B = 64
    box_pose = _spawns(B, 1)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    g_j = jax.vmap(lambda k, bp: jax_train_her._sample_goal(
        k, bp, jnp.int32(total), 5000, jnp.float64, min_dist))(keys, jnp.asarray(box_pose))
    u = jax.vmap(lambda k: jax.random.uniform(k, (3,), jnp.float64))(keys)
    g_t = sample_goal(torch.from_numpy(np.asarray(u)), torch.from_numpy(box_pose),
                      total, 5000, min_dist)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=TOL, atol=TOL)
    if total >= 5000:
        assert (g_t[:, 1] > C.bin_min[1]).all()
    if min_dist:
        rest = box_pose[:, :3] + [0.01, 0.01, 0.0]
        rest[:, 2] = 0.03
        d = np.linalg.norm(g_t.numpy() - rest, axis=1)
        assert (d >= min_dist * (1 - 1e-12)).all()
        assert np.isclose(d, min_dist).sum() > 0, "no goal was pushed out"


E, T, OBS, ACT = 5, 4, 6, 2


def _episodes(rng, B):
    return dict(obs=rng.randn(B, T, OBS), act=rng.randn(B, T, ACT),
                next_obs=rng.randn(B, T, OBS), agoal=rng.randn(B, T, 3) * 0.01,
                dgoal=rng.randn(B, 3) * 0.01, length=rng.randint(1, T + 1, B))


def _add_jax(buf, mask, ep):
    """The JAX trainer's flush: finished lanes one at a time, in lane order."""
    for b in np.nonzero(mask)[0]:
        buf = buf.add_episode(*(jnp.asarray(ep[k][b]) for k in
                                ("obs", "act", "next_obs", "agoal", "dgoal")),
                              jnp.int32(ep["length"][b]))
    return buf


def _add_port(buf, mask, ep):
    t = {k: torch.from_numpy(v) for k, v in ep.items()}
    buf.add_episodes(torch.from_numpy(mask), t["obs"], t["act"], t["next_obs"],
                     t["agoal"], t["dgoal"], t["length"].to(torch.int32))


def _assert_buffers_equal(bt, bj):
    assert (bt.ptr, bt.n_eps) == (int(bj.ptr), int(bj.n_eps))
    for name in HerBuffer.FIELDS:
        np.testing.assert_array_equal(getattr(bt, name).numpy(), np.asarray(getattr(bj, name)),
                                      err_msg=name)


@pytest.fixture(scope="module")
def filled_buffers():
    """Both buffers after four flushes of 4 lanes: 3, then 0, then 4 (all),
    then 3 finishers; E = 5, so the ring wraps."""
    rng = np.random.RandomState(2)
    bj = jax_her.HerBuffer.create(E, T, OBS, ACT, jnp.float64)
    bt = HerBuffer(E, T, OBS, ACT, dtype=torch.float64, device="cpu")
    for mask in ([1, 0, 1, 1], [0, 0, 0, 0], [1, 1, 1, 1], [0, 1, 1, 1]):
        mask = np.array(mask, bool)
        ep = _episodes(rng, 4)
        bj = _add_jax(bj, mask, ep)
        _add_port(bt, mask, ep)
        _assert_buffers_equal(bt, bj)
    assert bt.ptr == 10 and bt.n_eps == E
    return bt, bj


def test_flush_with_more_finishers_than_episodes():
    """7 lanes finish into a 5-episode ring after 2 stored episodes: the
    last 5 finishers (lanes 3-7) survive, the i-th finisher in slot
    (2 + i) mod E, as JAX's one-at-a-time flush leaves them."""
    rng = np.random.RandomState(3)
    bj = jax_her.HerBuffer.create(E, T, OBS, ACT, jnp.float64)
    bt = HerBuffer(E, T, OBS, ACT, dtype=torch.float64, device="cpu")
    first = np.array([1, 0, 1, 0, 0, 0, 0, 0], bool)     # ptr 2 first
    ep = _episodes(rng, 8)
    bj, _ = _add_jax(bj, first, ep), _add_port(bt, first, ep)
    mask = np.array([1, 1, 0, 1, 1, 1, 1, 1], bool)
    ep = _episodes(rng, 8)
    bj = _add_jax(bj, mask, ep)
    _add_port(bt, mask, ep)
    _assert_buffers_equal(bt, bj)
    assert (bt.ptr, bt.n_eps) == (9, E)
    # the 3rd..7th finishers (lanes 3-7) in slots 4, 0, 1, 2, 3
    np.testing.assert_array_equal(bt.dgoal.numpy(), ep["dgoal"][[4, 5, 6, 7, 3]])


@pytest.mark.parametrize("ratio, thr", [(0.8, 0.01), (0.0, 0.01), (1.0, 0.03)])
def test_sample_matches_jax_with_its_draws(filled_buffers, ratio, thr):
    bt, bj = filled_buffers
    bs = 512
    key = jax.random.PRNGKey(9)
    batch_j = bj.sample(key, bs, ratio, thr)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    ne = jnp.maximum(bj.n_eps, 1)
    draws = [jax.random.randint(k1, (bs,), 0, ne),
             jax.random.randint(k2, (bs,), 0, 1 << 30),
             jax.random.randint(k3, (bs,), 0, 1 << 30),
             jax.random.uniform(k4, (bs,))]
    draws = [torch.from_numpy(np.asarray(x)) for x in draws]
    batch_t = bt.sample(bs, her_ratio=ratio, distance_threshold=thr, draws=draws)
    assert batch_t.keys() == batch_j.keys()
    for k in ("obs", "next_obs", "act"):
        np.testing.assert_allclose(batch_t[k].numpy(), np.asarray(batch_j[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    assert batch_t["rew"].dtype == torch.float32
    np.testing.assert_array_equal(batch_t["rew"].numpy(), np.asarray(batch_j["rew"]))
    np.testing.assert_array_equal(batch_t["done"].numpy(), np.asarray(batch_j["done"]))
    # the same indices: each row's obs is the stored one of its (ep, t)
    ep, t = draws[0], draws[1] % bt.ep_len[draws[0]].clamp(min=1)
    np.testing.assert_array_equal(batch_t["obs"][:, :OBS].numpy(), bt.obs[ep, t].numpy())
    if ratio == 1.0:
        assert (batch_t["rew"] == 0).any(), "no relabeled goal was reached"


def test_sample_draws_from_the_generator(filled_buffers):
    bt, _ = filled_buffers
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    a, b = bt.sample(64, g1), bt.sample(64, g2)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert bt.sample(64, g1)["obs"].ne(a["obs"]).any()
    ep = bt.draws(1000, g1)[0]
    assert int(ep.min()) == 0 and int(ep.max()) == E - 1


# -- the port's HER trainer on the CPU ----------------------------------------

B = 4
STEPS = 5


def _trainer(tmp, total_steps=STEPS * B):
    cfg = HERConfig(num_envs=B, total_steps=total_steps, learning_starts=2 * B,
                    her_episodes=6, max_episode_steps=2, utd=2, log_every=1,
                    checkpoint_dir=str(tmp), checkpoint_every=B, max_contacts=16,
                    hull_contacts=False)
    return HERTrainer(None, cfg, SACConfig(obs_dim=15 + GOAL_DIM, act_dim=6, buffer_size=1,
                                           batch_size=32, features=(32, 32)),
                      device="cpu")


@pytest.fixture(scope="module")
def her_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("her")
    tr = _trainer(tmp)
    lines = []
    ts = tr.train(seed=0, progress=lines.append)
    return tr, ts, lines, tmp


def test_her_trainer_runs_on_the_cpu(her_run):
    tr, ts, lines, tmp = her_run
    assert [ln["env_steps"] for ln in lines] == [B * (i + 1) for i in range(STEPS)]
    for ln in lines:
        assert all(np.isfinite(v) for v in ln.values()), ln
    assert {"critic_loss", "actor_loss", "alpha", "entropy", "goal_dist",
            "cube_moved_frac", "episodes_stored", "ep_success_rate"} <= set(lines[-1])
    assert "critic_loss" not in lines[1] and "critic_loss" in lines[2]
    # 2-step episodes: flushes at steps 2 and 4 (8 episodes into a ring of 6)
    assert (ts.her.ptr, ts.her.n_eps) == (2 * B, 6)
    assert [ln["episodes_done"] for ln in lines] == [0, B, 0, B, 0]
    assert ts.sac.step == 3 * tr.cfg.utd
    assert ts.genv.total == STEPS * B
    assert {p.name for p in tmp.iterdir()} == {
        f"her_ckpt_{B * (i + 1)}.pt" for i in range(STEPS)}


def _state_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_her_restore_is_bit_equal(her_run):
    tr, ts, _, tmp = her_run
    saved = tr.state_dict(ts)
    tr2 = _trainer(tmp)
    restored = tr2.state_dict(tr2.restore(tmp / f"her_ckpt_{STEPS * B}.pt"))
    assert _state_equal(saved, restored)


def test_her_resume_continues_the_counter(her_run, tmp_path):
    """A resumed run continues at total // num_envs: no warm-up step (the
    SAC update count grows by utd per step) and checkpoint names go on from
    the restored step."""
    tr, ts, _, tmp = her_run
    tr2 = _trainer(tmp_path, total_steps=(STEPS + 2) * B)
    st = tr2.restore(tmp / f"her_ckpt_{STEPS * B}.pt")
    steps0 = st.sac.step
    lines = []
    st = tr2.train(seed=0, progress=lines.append, init_state=st)
    assert [ln["env_steps"] for ln in lines] == [(STEPS + 1) * B, (STEPS + 2) * B]
    assert all("critic_loss" in ln for ln in lines)
    assert st.sac.step == steps0 + 2 * tr2.cfg.utd
    assert {p.name for p in tmp_path.iterdir()} == {
        f"her_ckpt_{(STEPS + 1) * B}.pt", f"her_ckpt_{(STEPS + 2) * B}.pt"}


def test_her_draws_follow_the_seed(her_run, tmp_path):
    """The same seed gives the same run; the cube spawns, goals and actions
    come from the trainer's generators only."""
    _, ts, _, _ = her_run
    tr = _trainer(tmp_path)
    ts2 = tr.train(seed=0, progress=lambda line: None)
    assert torch.equal(ts.genv.goal, ts2.genv.goal)
    assert torch.equal(ts.her.obs, ts2.her.obs)
    assert torch.equal(ts.genv.es.physics.qpos, ts2.genv.es.physics.qpos)


def test_her_trainer_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HERTrainer(None, HERConfig(num_envs=2))


def test_her_cli_runs_on_the_cpu(tmp_path):
    from gym_so100_tpu_torch.scripts import train_sac_her

    argv = ["--device", "cpu", "--num-envs", "2", "--total-steps", "4",
            "--learning-starts", "2", "--max-contacts", "8", "--no-hull-contacts",
            "--batch-size", "8", "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "2"]
    ts = train_sac_her.main(argv)
    # 300-step episodes: no episode ends, so the learning step skips its update
    assert ts.genv.total == 4 and ts.sac.step == 0 and ts.her.n_eps == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["her_ckpt_2.pt", "her_ckpt_4.pt"]
    ts2 = train_sac_her.main(argv[:5] + ["6"] + argv[6:]
                             + ["--resume", str(tmp_path / "her_ckpt_4.pt")])
    assert ts2.genv.total == 6 and int(ts2.genv.t.max()) == 3
