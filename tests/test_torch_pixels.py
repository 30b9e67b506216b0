"""The port's pixel BatchedEnv (obs_mode "pixels_agent_pos") at B = 4 on
the CPU: obs shapes and dtypes, the terminal frame at a truncation, every
returned frame against the port's renderer on the returned state (exactly)
and against the JAX package's renderer on that state (at most 0.2% of the
pixels more than 1 LSB apart, as in tests/test_torch_render.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.envs.gym_env import ASSETS_XML
from gym_so100_tpu.models import scene as jax_scene
from gym_so100_tpu.models.builder import build_model as jax_build_model
from gym_so100_tpu.render.rasterizer import Renderer as JaxRenderer
from gym_so100_tpu_torch.models.builder import build_model
from gym_so100_tpu_torch.parallel.batch import BatchedEnv

B, H, W = 4, 48, 64
TASK = "so100_touch_cube"
FRAME_TOL = 0.002


@pytest.fixture(scope="module")
def env():
    return BatchedEnv(task=TASK, num_envs=B, max_episode_steps=2, device="cpu",
                      obs_mode="pixels_agent_pos", max_contacts=16, seed=3)


@pytest.fixture(scope="module")
def rollout(env):
    """reset, then three control steps at a fixed action (every env
    truncates at step 2): (es, obs, info, terminated, truncated) per step."""
    es = env.reset(seed=0)
    steps = [(es, env.observe(es), None, None, None)]
    acts = torch.full((B, 6), 0.3)
    for _ in range(3):
        es, obs, rew, term, trunc, info = env.step(es, acts)
        steps.append((es, obs, info, term, trunc))
    return steps


@pytest.fixture(scope="module")
def jax_renderer():
    mj, aux = jax_build_model(ASSETS_XML, max_contacts=16)
    return JaxRenderer(mj.astype(jnp.float32), aux, max_tris_per_mesh=100, tri_chunk=128)


def test_obs_shapes_and_dtypes(rollout):
    for es, obs, info, _, _ in rollout:
        assert set(obs) == {"pixels", "agent_pos"}
        assert obs["pixels"].shape == (B, H, W, 3) and obs["pixels"].dtype == torch.uint8
        assert obs["agent_pos"].shape == (B, 6) and obs["agent_pos"].dtype == torch.float32
        assert torch.equal(obs["agent_pos"], es.physics.qpos[:, :6].float())
        if info is not None:
            fo = info["final_obs"]
            assert fo["pixels"].shape == (B, H, W, 3) and fo["pixels"].dtype == torch.uint8
            assert fo["agent_pos"].shape == (B, 6)
            assert info["ncon"].shape == (B,)
    frame = rollout[0][1]["pixels"][0].numpy()
    assert len(np.unique(frame.reshape(-1, 3), axis=0)) > 3


def test_final_obs_is_the_terminal_frame_at_truncation(rollout):
    """At the truncation (step 2) the returned obs is the fresh episode's
    first frame and info["final_obs"] the moved arm's terminal frame: they
    differ.  On the other steps the two are the same obs."""
    _, obs, info, term, trunc = rollout[2]
    assert bool(trunc.all()) and not bool(term.any())
    fo = info["final_obs"]
    assert not torch.allclose(fo["agent_pos"], obs["agent_pos"], atol=1e-4)
    for i in range(B):
        assert (fo["pixels"][i].int() - obs["pixels"][i].int()).abs().max() > 0
    # the fresh episode starts at the reset pose, as the first one did
    torch.testing.assert_close(obs["agent_pos"], rollout[0][1]["agent_pos"])
    for k in (1, 3):
        _, obs, info, _, trunc = rollout[k]
        assert not bool(trunc.any())
        for key in ("pixels", "agent_pos"):
            assert torch.equal(info["final_obs"][key], obs[key])


def test_frames_are_renders_of_the_returned_state(env, rollout, jax_renderer):
    """Each returned frame is the port renderer's frame of the returned
    state, exactly, and agrees with the JAX renderer on that state."""
    for es, obs, _, _, _ in rollout:
        again = env.renderer.render_batch(es.physics, H, W, "top")
        assert torch.equal(obs["pixels"], again)
        for i in range(B):
            s = jax_scene.State(**{
                f.name: jnp.asarray(getattr(es.physics, f.name)[i].numpy())
                for f in dataclasses.fields(es.physics)
                if getattr(es.physics, f.name) is not None})
            theirs = np.asarray(jax_renderer.render(s, H, W, "top")).astype(np.int32)
            off = np.abs(obs["pixels"][i].numpy().astype(np.int32) - theirs).max(-1) > 1
            assert off.mean() <= FRAME_TOL, (int(off.sum()), off.size)


def test_pixel_env_arguments():
    m, aux = build_model(max_contacts=16, device="cpu")
    with pytest.raises(ValueError, match="render_aux"):
        BatchedEnv(m, TASK, 2, device="cpu", obs_mode="pixels_agent_pos")
    with pytest.raises(ValueError, match="obs_mode"):
        BatchedEnv(m, TASK, 2, device="cpu", obs_mode="pixels")
    env = BatchedEnv(m, TASK, 2, device="cpu", obs_mode="pixels_agent_pos",
                     render_aux=aux, obs_height=24, obs_width=32)
    obs = env.observe(env.reset(seed=0))
    assert obs["pixels"].shape == (2, 24, 32, 3)
    assert env.renderer.faces.shape[0] == 896 and env.renderer.npad_valid == 789


def test_obs_tris_override(monkeypatch):
    """GST_OBS_TRIS sets the triangles per mesh of the env's renderer, as in
    the JAX package."""
    monkeypatch.setenv("GST_OBS_TRIS", "200")
    m, aux = build_model(max_contacts=16, device="cpu")
    env = BatchedEnv(m, TASK, 2, device="cpu", obs_mode="pixels_agent_pos",
                     render_aux=aux)
    assert env.renderer.npad_valid > 789
    assert env.renderer.faces.shape[0] % 128 == 0
