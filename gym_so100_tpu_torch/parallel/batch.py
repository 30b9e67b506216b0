"""Batched lockstep env execution: one device, or one rank's rows of a
batch sharded across processes.

The port of `gym_so100_tpu/parallel/batch.py::BatchedEnv` (state and
pixel observations).  The env batch is one set of tensors with a leading
env axis, stepped together.  Auto-reset follows Gymnasium's vector env
convention: at an episode boundary the returned obs is the fresh episode's
first observation and the terminal one goes to info["final_obs"]; episodes
truncate at the registered limits.  `shard` makes the env one rank's rows
of the batch (`parallel/dist.py`): its envs are exactly those rows of the
one-process batch with the same seed.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..device import resolve_device
from ..envs import constants as C
from ..envs import core
from ..models.scene import Model
from ..ops import smooth_lanes
from ..profiling import annotate

EPISODE_LIMITS = {
    "so100_touch_cube": 300,
    "so100_touch_cube_sparse": 300,
    "so100_cube_to_bin": 700,
}


class BatchedEnv:
    """Batched env bound to (model, task), on `device` (default: the GPU,
    raising when there is none; device="cpu" runs the plain PyTorch path).

    Usage:
        env = BatchedEnv(task="so100_cube_to_bin", num_envs=4096)
        es = env.reset(seed=0)
        es, obs, reward, terminated, truncated, info = env.step(es, actions)
    """

    def __init__(
        self, m: Model | None = None, task: str = "so100_touch_cube",
        num_envs: int = 4096, max_episode_steps=None, hull_contacts=True,
        obs_mode="state", device="cuda", seed: int = 0, max_contacts: int = 16,
        obs_height=48, obs_width=64, render_aux=None,
    ):
        """`m` defaults to the SO100 transfer-cube scene built with
        `max_contacts` contact slots, in float32.  obs_mode "state" gives a
        flat (15,) float32 vector per env (box, bin and ee positions, arm
        qpos); "pixels_agent_pos" gives {"pixels": (obs_height, obs_width, 3)
        uint8 frame of the "top" camera, "agent_pos": (6,) float32 arm qpos}
        per env, rendered on the env's device.  Pixels need the aux dict of
        `build_model` (`render_aux`), which the default scene supplies."""
        self.device = resolve_device(device)
        if obs_mode not in ("state", "pixels_agent_pos"):
            raise ValueError(f"unknown obs_mode {obs_mode!r}")
        if m is None:
            from ..models.builder import build_model

            m, aux = build_model(max_contacts=max_contacts, device=self.device)
            render_aux = aux if render_aux is None else render_aux
        else:
            m = m.to(self.device)
        if not hull_contacts:
            # reduced-contact mode: drop the arm-mesh collision pairs (the
            # task pairs cube/table/pads/bin are all box pairs)
            m = dataclasses.replace(
                m, pairs=dataclasses.replace(m.pairs, hull_box=(), hull_hull=()))
        self.m = m
        self.task = task
        self.num_envs = num_envs
        self.max_episode_steps = max_episode_steps or EPISODE_LIMITS[task]
        self.ids = core.TaskIds.from_model(m)
        self.obs_mode = obs_mode
        self.obs_height, self.obs_width = obs_height, obs_width
        self.render_aux = render_aux
        self.renderer = None
        if obs_mode == "pixels_agent_pos":
            if render_aux is None:
                raise ValueError("pixels obs mode needs render_aux (the aux dict "
                                 "from build_model)")
            from ..render.rasterizer import Renderer

            # 100 triangles per mesh (896 scene triangles) at observation
            # size; GST_OBS_TRIS overrides
            self.renderer = Renderer(
                m, render_aux, tri_chunk=128,
                max_tris_per_mesh=int(os.environ.get("GST_OBS_TRIS", "100")))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # the whole batch and this env's rows of it (all of it until `shard`)
        self.global_envs = num_envs
        self.rows = slice(0, num_envs)
        self.group = None
        self.sharded = False

    def shard(self, group=None):
        """Make this env this rank's rows of its `num_envs`-wide batch in the
        process group `group` (default: every rank); returns the env.

        Afterwards `num_envs` is the rank's share, `global_envs` the whole
        batch and `rows` the rank's slice of it.  Cube spawns are drawn for
        the whole batch from the env's generator, and each rank keeps its
        rows, so a rank's envs are those rows of the one-process batch with
        the same seed, at reset and at autoreset.  The autoreset test is
        taken across ranks (one all-reduce per control step), so every
        rank's generator draws the same spawns."""
        from . import dist

        self.rows = dist.env_rows(self.global_envs, group)
        self.num_envs = self.rows.stop - self.rows.start
        self.group = group
        self.sharded = True
        return self

    def _spawn(self):
        return C.sample_so100_box_poses(
            self.global_envs, self.generator, self.m.dtype, self.device)[self.rows]

    def _poses(self, box_pose):
        """Cube poses as a tensor on the env's device, copied from an array
        (numpy views of JAX arrays are read-only): this env's rows of a
        whole-batch array, or this env's own."""
        if isinstance(box_pose, torch.Tensor):
            box_pose = box_pose.to(dtype=self.m.dtype, device=self.device)
        else:
            box_pose = torch.tensor(np.asarray(box_pose), dtype=self.m.dtype,
                                    device=self.device)
        if box_pose.shape[0] == self.global_envs != self.num_envs:
            box_pose = box_pose[self.rows]
        return box_pose

    def _any(self, done):
        """Whether some env of the whole batch is done."""
        if self.sharded:
            from . import dist

            return dist.any_across(done, self.group)
        return bool(done.any())

    def _obs_vector(self, obs):
        """Flat state observation (box, bin, ee, qpos)."""
        return torch.cat(
            [obs["box_position"], obs["bin_position"], obs["ee_position"],
             obs["qpos"]], dim=-1,
        ).to(torch.float32)

    def reset(self, seed=None, box_pose=None) -> core.EnvState:
        """Fresh episodes for every env.  Cube spawns come from `box_pose`
        (num_envs, 7), or the whole batch's (global_envs, 7) when sharded,
        when given, else from the env's generator (reseeded by `seed`)."""
        if seed is not None:
            self.generator.manual_seed(seed)
        box_pose = self._spawn() if box_pose is None else self._poses(box_pose)
        return core.reset(self.m, box_pose)

    def _pixel_obs(self, physics):
        return {
            "pixels": self.renderer.render_batch(
                physics, self.obs_height, self.obs_width, "top"),
            "agent_pos": physics.qpos[:, :6].to(torch.float32),
        }

    def observe(self, es: core.EnvState):
        """The observation of `es`: the (num_envs, 15) state vector
        (kinematics only), or the pixel obs dict."""
        if self.renderer is not None:
            return self._pixel_obs(es.physics)
        d = smooth_lanes.kinematics(self.m, es.physics)
        return self._obs_vector(core.observations(self.m, d, es.physics, self.ids))

    def step(self, es: core.EnvState, actions, reset_box_pose=None):
        """Returns (state, obs, reward (B,), terminated (B,), truncated (B,),
        info): obs (B, 15) float32, or the pixel obs dict.  At episode
        boundaries obs is the new episode's first observation and
        info["final_obs"] the terminal one.  New episodes spawn the cube at
        `reset_box_pose` (B, 7) when given (the whole batch's when
        sharded), else from the env's generator."""
        es2, obs, reward, terminated, d = core.step_batched(
            self.m, es, actions, self.ids, self.task)
        truncated = es2.t >= self.max_episode_steps
        done = terminated | truncated
        if self.renderer is not None:
            # the terminal frame of the state before the autoreset
            final_obs = self._pixel_obs(es2.physics)
        else:
            final_obs = self._obs_vector(obs)
        obs_out = final_obs
        # The whole autoreset branch runs only when some env (of the whole
        # batch) is done.  The test costs one device-to-host sync per control
        # step.
        with annotate("done_sync"):
            any_done = self._any(done)
        if any_done:
            with annotate("autoreset"):
                fresh = core.reset(self.m, self._spawn() if reset_box_pose is None
                                   else self._poses(reset_box_pose))
                es2 = _where(done, fresh, es2)
                if self.renderer is not None:
                    obs_out = self._pixel_obs(es2.physics)
                else:
                    obs_out = torch.where(done[:, None], self.observe(fresh), final_obs)
        return es2, obs_out, reward, terminated, truncated, {
            "final_obs": final_obs, "ncon": d.ncon,
        }


def _where(mask, a, b):
    """Per-env select between two batched dataclasses of tensors."""
    if isinstance(a, torch.Tensor):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)
    return dataclasses.replace(a, **{
        f.name: _where(mask, getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(a)
    })
