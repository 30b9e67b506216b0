"""The port's CartesianBatchedEnv against the JAX package's, float64, the EE
scene (the mocap weld) at K = 16 contact slots (the JAX test's), B = 4.

Same inputs on both sides: the Model through the bridge, JAX's cube spawns
and seeded numpy actions.  Tolerance tiers, as the JAX package's own
batched-vs-single test holds them (tests/test_ee_batched.py):

* reset (the mocap target on the ee site, position and orientation) and
  apply_action ("follow" and "fixed") to 1e-12;
* one physics substep after the action: qpos to 1e-10, qvel to 1e-8;
* three control steps on the scene's own weld (weld_gain=False), both
  sides from JAX's reset state: qpos to 5e-3; the mocap target's position
  to 1e-15 (XLA contracts its multiply-add, position + delta x 0.01, into
  one fused operation, so the sums can part by an ulp) and its orientation
  (which "follow" mode takes from the ee's frame) to 1e-12.  The stiff weld amplifies roundoff
  through the Newton solve's stopping test, so whole control steps are
  held loosely.  The JAX control step is its action transform and ten of
  its batched substeps (`forward.step_batched`), each jitted.

The scene's mocap target carries a 4 x 12 x 4 cm box that lies in the
gripper, so hull-box contacts are active from the first substep.  In
float64 both sides collide hull pairs with the per-env colliders
(`collide_batched_lanes` runs `collide_batched`: the AABB cull to K/2
slots, then GJK/EPA).  Every test runs on two models: the scene with that
box lifted 10 m above its body, out of reach ("lifted"; the weld, the cube
and everything else stay), here, and the scene as it is ("in_place"), in
tests/test_torch_ee_in_place.py, which runs this module's tests on its
own model (each model's JAX substep compiles for minutes; two files let
two workers compile them).

In place, the box lies face to face with jaw hulls, where the EPA's
closest face is not unique: JAX's own collider, its geom poses moved by
one ulp, moves that contact's witness point by up to 2 cm, and the port
parts from JAX there by as much.  The in-place substep and control steps
are therefore held to the floor rule: each compared quantity within the
larger of its tolerance above and twice the largest deviation of JAX's
own run from copies of it whose start moves by one ulp (qpos and the
mocap target's pose up one ulp in a seeded half of their entries): 8
copies of the substep; one copy of the three control steps, whose
largest deviation at any of the steps bounds each step (a copy parts
from JAX's run by 1e-2 to 3e-2 in qpos and 2e-4 to 5e-4 in the target's
orientation, which "follow" mode takes from the arm).  The full scene is
also held against JAX's float32 lanes path in test_torch_ee_float32.py,
and runs in test_torch_ee_tracking.py (the port alone) and on the card.

The port alone: outputs' shapes and dtypes, the weld gain, the refusal of
the joint scene.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.envs.ee_env import CartesianBatchedEnv as JaxEnv
from gym_so100_tpu.models.builder import build_model as jax_build_model
from gym_so100_tpu.ops import forward as jax_fwd
from gym_so100_tpu_torch.envs.ee_env import EE_XML, CartesianBatchedEnv
from gym_so100_tpu_torch.models.convert import model_from_numpy
from gym_so100_tpu_torch.ops import forward as fwd

B, K = 4, 16
TOL = 1e-12


def _leaves(obj):
    return {f.name: (np.asarray(v) if hasattr(v, "shape") and hasattr(v, "dtype") else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def close(a, b, tol, name):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol, err_msg=name)


def _in_place(mj):
    """Whether the mocap target's box is where the scene puts it."""
    bodyid = np.asarray(mj.geom_bodyid)
    box = [g for g in range(mj.ngeom) if np.asarray(mj.body_mocapid)[bodyid[g]] >= 0]
    return float(np.asarray(mj.geom_pos)[box[0], 2]) < 5.0


def _ulp_copies(s, n=3):
    """n copies of the JAX State s with qpos, mocap_pos and mocap_quat each
    moved up one ulp in a seeded half of their entries."""
    out = []
    for seed in range(n):
        rng = np.random.RandomState(seed)
        moved = {}
        for k in ("qpos", "mocap_pos", "mocap_quat"):
            a = np.array(getattr(s, k))
            mask = rng.rand(*a.shape) < 0.5
            a[mask] = np.nextafter(a[mask], np.inf)
            moved[k] = jnp.asarray(a)
        out.append(s.replace(**moved))
    return out


def close_or_floor(ours, theirs, copies, tol, name):
    """ours within max(tol, twice JAX's own one-ulp spread) of theirs."""
    theirs = np.asarray(theirs)
    spread = max(float(np.abs(np.asarray(c) - theirs).max()) for c in copies)
    dev = float(np.abs(ours.numpy() - theirs).max())
    assert dev <= max(tol, 2 * spread), (name, dev, spread)


def build_models(scene):
    """JAX's float64 EE model, its mocap box "lifted" or "in_place", and the
    port's through the bridge."""
    assert Path(EE_XML).name == "so100_transfer_cube_ee.xml"
    mj, _ = jax_build_model(EE_XML, max_contacts=K)
    mj = mj.astype(jnp.float64)
    bodyid = np.asarray(mj.geom_bodyid)
    box = [g for g in range(mj.ngeom) if np.asarray(mj.body_mocapid)[bodyid[g]] >= 0]
    assert len(box) == 1
    if scene == "lifted":
        mj = dataclasses.replace(mj, geom_pos=mj.geom_pos.at[box[0], 2].add(10.0))
    return mj, model_from_numpy(_leaves(mj))


@pytest.fixture(scope="module", params=["lifted"])
def models(request):
    return build_models(request.param)


@pytest.fixture(scope="module")
def start(models):
    """Both envs (scene weld) reset from JAX's spawns; seeded actions."""
    mj, mt = models
    env_j = JaxEnv(mj, num_envs=B, weld_gain=False)
    env_t = CartesianBatchedEnv(mt, num_envs=B, weld_gain=False, device="cpu")
    es_j = env_j.reset(jax.random.PRNGKey(0))
    es_t = env_t.reset(box_pose=np.asarray(es_j.box_pose))
    acts = np.random.RandomState(1).uniform(-1, 1, (B, 4))
    acts[0] = [3.0, -2.0, 0.5, 4.0]           # clipped to [-1, 1]
    return env_j, env_t, es_j, es_t, acts


def test_reset_puts_the_target_on_the_ee(start):
    env_j, env_t, es_j, es_t, _ = start
    for k in ("qpos", "qvel", "ctrl", "mocap_pos", "mocap_quat"):
        close(getattr(es_t.physics, k), getattr(es_j.physics, k), TOL, k)
    assert es_t.physics.mocap_pos.shape == (B, 1, 3)
    np.testing.assert_array_equal(es_t.t.numpy(), np.asarray(es_j.t))


@pytest.mark.parametrize("mode", ["follow", "fixed"])
def test_apply_action_matches_jax(models, start, mode):
    mj, mt = models
    _, _, es_j, es_t, acts = start
    env_j = JaxEnv(mj, num_envs=B, weld_gain=False, orientation_mode=mode)
    env_t = CartesianBatchedEnv(mt, num_envs=B, weld_gain=False, orientation_mode=mode,
                                device="cpu")
    s_j = jax.jit(jax.vmap(env_j.apply_action))(es_j.physics, jnp.asarray(acts))
    s_t = env_t.apply_action(es_t.physics, torch.from_numpy(acts))
    for k in ("qpos", "ctrl", "mocap_pos", "mocap_quat"):
        close(getattr(s_t, k), getattr(s_j, k), TOL, f"{mode}: {k}")
    if mode == "fixed":
        assert torch.equal(s_t.mocap_quat, es_t.physics.mocap_quat)


@pytest.fixture(scope="module")
def substep(models):
    mj, _ = models
    return jax.jit(lambda s: jax_fwd.step_batched(mj, s)[0])


def test_one_substep_after_the_action(models, start, substep):
    mj, mt = models
    env_j, env_t, es_j, es_t, acts = start
    s_a = jax.jit(jax.vmap(env_j.apply_action))(es_j.physics, jnp.asarray(acts))
    s_j = substep(s_a)
    s_t, _ = fwd.step_batched(mt, env_t.apply_action(es_t.physics, torch.from_numpy(acts)))
    if not _in_place(mj):
        close(s_t.qpos, s_j.qpos, 1e-10, "qpos")
        close(s_t.qvel, s_j.qvel, 1e-8, "qvel")
        return
    copies = [substep(c) for c in _ulp_copies(s_a, 8)]
    close_or_floor(s_t.qpos, s_j.qpos, [c.qpos for c in copies], 1e-10, "qpos")
    close_or_floor(s_t.qvel, s_j.qvel, [c.qvel for c in copies], 1e-8, "qvel")


@pytest.fixture(scope="module")
def control_steps(start, substep):
    """Three control steps on each side, both from JAX's reset state (so
    the mocap target starts from the same bits)."""
    env_j, env_t, es_j, es_t, acts = start
    es_t = es_t.replace(physics=es_t.physics.replace(**{
        k: torch.from_numpy(np.array(getattr(es_j.physics, k)))
        for k in ("qpos", "qvel", "ctrl", "mocap_pos", "mocap_quat", "qacc_warmstart")}))
    apply_j = jax.jit(jax.vmap(env_j.apply_action))
    # JAX's run, then (in place) three copies from one-ulp-moved starts
    starts = [es_j.physics] + (_ulp_copies(es_j.physics, 1) if _in_place(env_j.m) else [])
    runs = []
    for s_j in starts:
        run = []
        for _ in range(3):
            s_j = apply_j(s_j, jnp.asarray(acts))
            for _ in range(10):
                s_j = substep(s_j)
            run.append(jax.tree_util.tree_map(np.asarray, s_j))
        runs.append(run)
    out = []
    for i in range(3):
        es_t, *rest = env_t.step(es_t, torch.from_numpy(acts))
        out.append((runs[0][i], es_t, rest, [r[i] for r in runs[1:]]))
    return out


@pytest.mark.parametrize("step", range(3))
def test_control_steps_match_jax(control_steps, step):
    s_j, es_t, _, copies = control_steps[step]
    if copies:
        # JAX's own spread over the run: its copies' largest deviation at
        # any of the three steps
        gap = lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max())
        for k, tol in (("qpos", 5e-3), ("mocap_pos", 1e-15), ("mocap_quat", TOL)):
            spread = max(gap(getattr(c, k), getattr(r[0], k))
                         for r in control_steps for c in r[3])
            dev = gap(getattr(es_t.physics, k).numpy(), getattr(s_j, k))
            assert dev <= max(tol, 2 * spread), (f"step {step}: {k}", dev, spread)
        return
    close(es_t.physics.qpos, s_j.qpos, 5e-3, f"step {step}: qpos")
    np.testing.assert_allclose(es_t.physics.mocap_pos.numpy(), s_j.mocap_pos, rtol=0,
                               atol=1e-15, err_msg=f"step {step}: mocap_pos")
    close(es_t.physics.mocap_quat, s_j.mocap_quat, TOL, f"step {step}: mocap_quat")


def test_step_outputs(control_steps):
    _, es_t, (obs, rew, term, trunc, info), _ = control_steps[-1]
    assert obs.shape == (B, 15) and obs.dtype == torch.float32
    assert rew.shape == (B,) and rew.dtype == torch.float64
    assert term.dtype == trunc.dtype == torch.bool and term.shape == trunc.shape == (B,)
    assert info["ee_err"].shape == (B,) and bool(torch.isfinite(info["ee_err"]).all())
    assert info["ncon"].shape == (B,) and info["ncon"].dtype == torch.int32
    assert es_t.t.tolist() == [3] * B
    assert bool(torch.isfinite(obs).all())


def test_weld_gain_matches_jax(models):
    mj, mt = models
    m_j = JaxEnv(mj, num_envs=B).m
    m_t = CartesianBatchedEnv(mt, num_envs=B, device="cpu").m
    close(m_t.eq_solimp, m_j.eq_solimp, 0, "eq_solimp")
    close(m_t.eq_solref, m_j.eq_solref, 0, "eq_solref")
    assert not torch.equal(m_t.eq_solimp, mt.eq_solimp)
    assert torch.equal(CartesianBatchedEnv(mt, num_envs=B, weld_gain=False,
                                           device="cpu").m.eq_solref, mt.eq_solref)


def test_refuses_the_joint_scene():
    from gym_so100_tpu_torch.models.builder import build_model

    m, _ = build_model(max_contacts=4, device="cpu")
    with pytest.raises(ValueError, match="mocap weld"):
        CartesianBatchedEnv(m, num_envs=2, device="cpu")


def test_refuses_an_unknown_orientation_mode(models):
    with pytest.raises(ValueError):
        CartesianBatchedEnv(models[1], num_envs=2, orientation_mode="free", device="cpu")


def test_defaults_to_the_gpu(models):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CartesianBatchedEnv(models[1], num_envs=2)
