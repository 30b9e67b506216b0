"""The port's Gymnasium-API adapters against the JAX package's, on the CPU.

`SO100Env(task="so100_touch_cube", obs_type="so100_state")` in float64 on
both sides (the parity configuration: ccd manifolds, K = 32), reset with
the same seed, then 7 control steps with seeded actions; the cube spawns
3 cm above its resting height and lands in step 5, so the last steps run
the manifold contacts, the constraint rows and the Newton solve with
active contacts.

Tolerances: the reset obs to 1e-12; each step's obs, reward, qpos and qvel
to 1e-10 (absolute and relative), terminated equal, and the same number of
active contacts in the position stage's buffer.  The other tasks' rewards
(`so100_touch_cube_sparse`, `so100_cube_to_bin`) on the same trajectory's
Data equal JAX's `task_reward` (to 1e-12).  Pixels at 48x64: at most 0.2%
of a frame's pixels more than 1 apart, as `test_torch_render.py` holds the
renderer.

Also: spaces (bounds, shapes, dtypes) and the Gymnasium seeding contract
(a seeded reset, then an unseeded one, spawn JAX's cubes), `make` with the
registered ids, kwargs and time limits (truncation at the limit), and
`SO100GoalEnv` against JAX's with the goal injected (JAX draws goals from
a space's own unseeded generator, the port from the env's `np_random`):
the flattened pixels within the frame tolerance above, agent_pos and the
achieved goal (float32 copies of float64 values that agree to 1e-10) to
1e-6, reward, success, truncation and `compute_reward` on a batch equal.
The JAX goal env runs on the JAX `SO100Env` above switched to pixel obs
(its task is not read: the goal env computes its own reward).
"""

import gymnasium
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_so100_tpu  # noqa: F401  (registers the JAX envs)
from gym_so100_tpu.envs import core as jax_core
from gym_so100_tpu.envs.gym_env import SO100Env as JaxEnv
from gym_so100_tpu.envs.goal_env import SO100GoalEnv as JaxGoalEnv
from gym_so100_tpu_torch.envs import core
from gym_so100_tpu_torch.envs.gym_env import SO100Env
from gym_so100_tpu_torch.envs.goal_env import SO100GoalEnv
from gym_so100_tpu_torch.envs.registration import REGISTRY, make

SEED = 3
STEPS = 7
TOL = 1e-10
H, W = 48, 64
FRAME_TOL = 0.002


def close(a, b, tol, name):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol, err_msg=name)


@pytest.fixture(scope="module")
def envs():
    kw = dict(task="so100_touch_cube", obs_type="so100_state", observation_height=H,
              observation_width=W)
    return (JaxEnv(dtype=jnp.float64, **kw),
            SO100Env(dtype=torch.float64, device="cpu", **kw))


@pytest.fixture(scope="module")
def trajectory(envs):
    """Both envs reset with SEED, then STEPS control steps with seeded
    float32 actions: per step the 5-tuples, the physics state and the
    position stage's Data of each side."""
    ej, et = envs
    # JAX's env steps through its own core.step, jitted once here so that
    # the position stage's Data (which the adapter drops) is kept too
    core_step = jax.jit(lambda es, a: jax_core.step(ej._m, es, a, ej._ids, ej.task))
    kept = []

    def step_fn(es, a):
        es2, obs, reward, terminated, d = core_step(es, a)
        kept.append(d)
        return es2, obs, reward, terminated

    ej._step_fn = step_fn
    reset = (ej.reset(seed=SEED), et.reset(seed=SEED))
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        a = rng.uniform(-1, 1, 6).astype(np.float32)
        rj, rt = ej.step(a), et.step(a)
        out.append(dict(j=rj, t=rt, es_j=ej._es, es_t=et._es, d_j=kept[-1], d_t=et.data))
    return reset, out


def test_reset_matches_jax(trajectory):
    (oj, ij), (ot, it) = trajectory[0]
    assert ot.shape == (15,) and ot.dtype == np.float32
    close(ot, oj, 1e-12, "obs")
    assert it == ij == {"is_success": False}


@pytest.mark.parametrize("step", range(STEPS))
def test_step_matches_jax(trajectory, step):
    r = trajectory[1][step]
    (oj, rew_j, term_j, trunc_j, info_j), (ot, rew_t, term_t, trunc_t, info_t) = r["j"], r["t"]
    close(ot, oj, TOL, "obs")
    assert isinstance(rew_t, float)
    close(rew_t, rew_j, TOL, "reward")
    assert (term_t, trunc_t, info_t) == (term_j, trunc_j, info_j)
    for k in ("qpos", "qvel"):
        close(getattr(r["es_t"].physics, k).numpy(), getattr(r["es_j"].physics, k), TOL, k)
    assert int(r["es_t"].t) == int(r["es_j"].t) == step + 1
    nj = int(np.asarray(r["d_j"].contact.active).sum())
    assert int(r["d_t"].contact.active.sum()) == nj
    assert int(r["d_t"].contact.ncand) == int(r["d_j"].contact.ncand)


def test_the_cube_lands(trajectory):
    """The trajectory runs through touchdown: no contact in the first
    step, contacts (the cube on the table) in the last."""
    ncon = [int(r["d_t"].contact.active.sum()) for r in trajectory[1]]
    assert ncon[0] == 0 and ncon[-1] > 0, ncon
    z = [float(r["es_t"].physics.qpos[8]) for r in trajectory[1]]
    assert z[0] > 0.04 and abs(z[-1] - 0.02) < 2e-3, z


@pytest.mark.parametrize("task", ["so100_touch_cube", "so100_touch_cube_sparse",
                                  "so100_cube_to_bin"])
def test_task_rewards_match_jax(envs, trajectory, task):
    """Each task's reward and success on every step's position-stage Data
    (the touch flags from the K-slot contact buffer)."""
    ej, et = envs
    ids_j, ids_t = ej._ids, et._ids
    touched_table = False
    for r in trajectory[1]:
        rj, sj = jax_core.task_reward(ej._m, r["d_j"], ids_j, task)
        rt, st = core.task_reward(et._m, r["d_t"], ids_t, task)
        assert rt.shape == () and rt.dtype == torch.float64
        close(rt.numpy(), rj, 1e-12, task)
        assert bool(st) == bool(sj)
        touched_table |= bool(core._contact_flags(et._m, r["d_t"], ids_t)[1])
    assert touched_table


def assert_frames_agree(ours, theirs):
    assert ours.shape == theirs.shape == (H, W, 3)
    assert ours.dtype == theirs.dtype == np.uint8
    off = np.abs(ours.astype(np.int32) - theirs.astype(np.int32)).max(-1) > 1
    assert off.mean() <= FRAME_TOL, (int(off.sum()), off.size)


@pytest.mark.parametrize("camera", ["top", "front_close"])
def test_pixels_match_jax(envs, trajectory, camera):
    """The last state's frames at 48x64 through each env's renderer."""
    ej, et = envs
    r = trajectory[1][-1]
    ours = et._get_renderer().render(r["es_t"].physics, H, W, camera).numpy()
    theirs = np.asarray(ej._get_renderer().render(r["es_j"].physics, H, W, camera))
    assert_frames_agree(ours, theirs)


@pytest.mark.parametrize("obs_type", ["so100_state", "so100_pixels_agent_pos"])
def test_spaces_match_jax(obs_type):
    kw = dict(task="so100_cube_to_bin", obs_type=obs_type)
    ej = JaxEnv(dtype=jnp.float64, **kw)
    et = SO100Env(dtype=torch.float64, device="cpu", **kw)

    def same(a, b):
        assert a.shape == b.shape and np.dtype(a.dtype) == np.dtype(b.dtype)
        np.testing.assert_array_equal(a.low, b.low)
        np.testing.assert_array_equal(a.high, b.high)

    same(et.action_space, ej.action_space)
    if obs_type == "so100_state":
        same(et.observation_space, ej.observation_space)
    else:
        assert set(et.observation_space.spaces) == set(ej.observation_space.spaces)
        for k in et.observation_space.spaces:
            same(et.observation_space[k], ej.observation_space[k])
    assert et.metadata == ej.metadata
    a = et.action_space.sample(np.random.default_rng(0))
    assert et.action_space.contains(a) and a.dtype == np.float32


def test_seeding_matches_jax(envs):
    """A seeded reset spawns the reference's RandomState(seed) cube; the
    unseeded resets after it draw their seeds from np_random, as
    Gymnasium's Generator(PCG64(SeedSequence(seed)))."""
    ej, et = envs
    for seed in (11, None, None):
        ej.reset(seed=seed)
        et.reset(seed=seed)
        close(et._es.box_pose.numpy(), ej._es.box_pose, 0, f"box pose, seed {seed}")
    assert et.np_random.integers(1 << 30) == ej.np_random.integers(1 << 30)
    et.reset(options={"box_pose": [-0.2, 0.5, 0.05, 1, 0, 0, 0]})
    assert et._es.box_pose.tolist() == [-0.2, 0.5, 0.05, 1, 0, 0, 0]


def test_make_matches_the_registry_and_truncates():
    for env_id, spec in REGISTRY.items():
        theirs = gymnasium.spec(env_id)
        assert spec["max_episode_steps"] == theirs.max_episode_steps
        assert spec["kwargs"] == theirs.kwargs
    env = make("gym_so100_tpu/SO100TouchCube-v0", max_episode_steps=2, obs_type="so100_state",
               device="cpu")
    assert env.unwrapped.task == "so100_touch_cube" and env.max_episode_steps == 2
    assert env.unwrapped._dtype == torch.float32
    act = np.zeros(6, np.float32)
    for _ in range(2):
        obs, _ = env.reset(seed=0)
        assert obs.shape == (15,)
        assert env.step(act)[3] is False
        assert env.step(act)[3] is True
    assert make("gym_so100_tpu/SO100CubeToBin-v0", device="cpu").max_episode_steps == 700
    assert make("gym_so100_tpu/SO100TouchCubeSparse-v0",
                device="cpu").unwrapped.obs_type == "so100_pixels_agent_pos"


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SO100Env(task="so100_touch_cube", obs_type="so100_state")


def test_goal_env_matches_jax(envs):
    """SO100GoalEnv at 48x64, float64: JAX's goal injected into the port's
    env; reset and 2 steps: observation (pixels / 255 within the frame
    tolerance, agent_pos), achieved goal, reward, success and truncation;
    compute_reward on a batch of goals."""
    ej, _ = envs
    ej.obs_type = "so100_pixels_agent_pos"
    gj = JaxGoalEnv(observation_width=W, observation_height=H, dtype=jnp.float64)
    gj._inner = ej
    gt = SO100GoalEnv(observation_width=W, observation_height=H, dtype=torch.float64,
                      device="cpu")
    assert gt.max_episode_steps == gj.max_episode_steps == 3 * 100
    (oj, _), (ot, _) = gj.reset(seed=5), gt.reset(seed=5)
    np.testing.assert_array_equal(gt.box_pose, gj.box_pose)
    gt.goal = gj.goal.copy()
    rng = np.random.RandomState(2)
    pairs = [(oj, ot)]
    for _ in range(2):
        a = rng.uniform(-1, 1, 6).astype(np.float32)
        (oj, rj, sj, tj, ij), (ot, rt, st, tt, it) = gj.step(a), gt.step(a)
        assert (rt, st, tt, it) == (rj, sj, tj, ij)
        pairs.append((oj, ot))
    n_pix = H * W * 3
    for i, (oj, ot) in enumerate(pairs):
        assert ot["observation"].shape == (n_pix + 6,) and ot["observation"].dtype == np.float32
        px_t = np.rint(ot["observation"][:n_pix] * 255).astype(np.uint8).reshape(H, W, 3)
        px_j = np.rint(oj["observation"][:n_pix] * 255).astype(np.uint8).reshape(H, W, 3)
        assert_frames_agree(px_t, px_j)
        close(ot["observation"][n_pix:], oj["observation"][n_pix:], 1e-6, "agent_pos")
        close(ot["achieved_goal"], oj["achieved_goal"], 1e-6, "achieved_goal")
        if i:   # the reset obs holds each env's own draw
            np.testing.assert_array_equal(ot["desired_goal"], oj["desired_goal"])
    goals = np.random.RandomState(4).uniform(-0.3, 0.6, (5, 3)).astype(np.float32)
    ach = goals + np.array([0.0, 0.0, 0.005], np.float32) * np.arange(5)[:, None]
    np.testing.assert_array_equal(gt.compute_reward(ach, goals, {}),
                                  gj.compute_reward(ach, goals, {}))
    # the port's goal draw: near the spawn, from np_random
    gt.reset(seed=9)
    assert np.abs(gt.goal[:2] - gt.box_pose[:2]).max() <= 0.03 + 1e-6
    assert gt.observation_space["observation"].shape == (n_pix + 6,)
