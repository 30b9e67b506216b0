"""The batched env step with autoreset and observations (a frozen copy of
the port's `parallel/batch.py` `BatchedEnv.step`, one process, cube spawns
always given by the caller, the episode limit from the configuration)."""

from __future__ import annotations

import dataclasses

import torch

from .envs import core
from .ops import smooth_lanes

class RefEnv:
    """`model` and `aux` from `models.builder.build_model`; obs_mode
    "state" (a (B, 15) float32 vector) or "pixels_agent_pos" (a dict of a
    (B, H, W, 3) uint8 frame of the "top" camera and the (B, 6) arm
    qpos); episodes are truncated at `episode_steps` control steps."""

    def __init__(self, model, aux, task, episode_steps, obs_mode="state",
                 obs_height=48, obs_width=64, tris_per_mesh=100):
        self.m = model
        self.task = task
        self.max_episode_steps = int(episode_steps)
        self.ids = core.TaskIds.from_model(model)
        self.obs_mode = obs_mode
        self.obs_height, self.obs_width = obs_height, obs_width
        self.renderer = None
        if obs_mode == "pixels_agent_pos":
            from .render.rasterizer import Renderer

            self.renderer = Renderer(model, aux, tri_chunk=128,
                                     max_tris_per_mesh=tris_per_mesh)
        elif obs_mode != "state":
            raise ValueError(f"unknown obs_mode {obs_mode!r}")

    def reset(self, box_pose) -> core.EnvState:
        return core.reset(self.m, box_pose.to(self.m.dtype))

    def obs_vector(self, obs):
        return torch.cat(
            [obs["box_position"], obs["bin_position"], obs["ee_position"],
             obs["qpos"]], dim=-1,
        ).to(torch.float32)

    def pixel_obs(self, physics):
        return {
            "pixels": self.renderer.render_batch(
                physics, self.obs_height, self.obs_width, "top"),
            "agent_pos": physics.qpos[:, :6].to(torch.float32),
        }

    def observe(self, es: core.EnvState):
        """The observation of `es` (kinematics only, or the render)."""
        if self.renderer is not None:
            return self.pixel_obs(es.physics)
        d = smooth_lanes.kinematics(self.m, es.physics)
        return self.obs_vector(core.observations(self.m, d, es.physics, self.ids))

    def reward(self, es: core.EnvState):
        """(reward, terminated) of the state `es` as a control step ends."""
        d = smooth_lanes.kinematics(self.m, es.physics)
        flags = core._pair_contact_flags_batched(self.m, d, self.ids)
        reward, _ = core.task_reward(self.m, d, self.ids, self.task, flags)
        return reward, reward == 4.0

    def step(self, es: core.EnvState, actions, reset_box_pose, observe=True):
        """(state, obs, reward, terminated, truncated, final_obs, terminal),
        the first six as the port's `BatchedEnv.step` returns them, and
        `terminal` the state before the autoreset; with observe=False the
        two observations are None."""
        es2, obs, reward, terminated, _ = core.step_batched(
            self.m, es, actions, self.ids, self.task)
        truncated = es2.t >= self.max_episode_steps
        done = terminated | truncated
        final_obs = None
        if observe:
            final_obs = (self.pixel_obs(es2.physics) if self.renderer is not None
                         else self.obs_vector(obs))
        obs_out = final_obs
        terminal = es2
        if bool(done.any()):
            fresh = self.reset(reset_box_pose)
            es2 = where(done, fresh, es2)
            if observe and self.renderer is not None:
                obs_out = self.pixel_obs(es2.physics)
            elif observe:
                obs_out = torch.where(done[:, None], self.observe(fresh), final_obs)
        return es2, obs_out, reward, terminated, truncated, final_obs, terminal


def where(mask, a, b):
    """Per-env select between two batched dataclasses of tensors."""
    if isinstance(a, torch.Tensor):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)
    return dataclasses.replace(a, **{
        f.name: where(mask, getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(a)
    })
