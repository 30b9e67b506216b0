"""The Gymnasium-API adapter: `SO100Env` over the single-env engine.

The port of `gym_so100_tpu/envs/gym_env.py`, without importing Gymnasium
(the card has none): the same constructor, `metadata`, spaces (bounds,
shapes, dtypes; `envs/spaces.py`), `reset(seed, options={"box_pose"})`,
5-tuple `step`, `render`, `raw_observation` and `close`.  numpy in, numpy
out; the physics runs on `device` (default the GPU, raising when there is
none; device="cpu" runs on the CPU).

`dtype` defaults to torch.float32, built with K = GST_MAX_CONTACTS
(default 32) contact slots and single-point hull contacts; torch.float64
is the parity configuration, built with MuJoCo-style multi-point manifold
contacts on every pair MuJoCo resolves with its native convex collider
(`build_model(ccd_manifolds=True)`).

Seeding follows Gymnasium: `np_random` is
Generator(PCG64(SeedSequence(seed))); a seeded reset spawns the cube from
a fresh RandomState(seed), and an unseeded one from a seed drawn as
np_random.integers(2**31 - 1).  terminated = (reward == 4); truncated is
always False here (time limits come from `registration.make`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..models.builder import ASSETS_XML, build_model
from ..ops import forward as fwd
from . import constants as C
from . import core
from .spaces import Box, Dict

_MODEL_CACHE = {}


def _cached_model(xml_path, dtype, device):
    """(Model, aux) of the scene for `dtype` on `device`, built once.
    float32 keeps K = GST_MAX_CONTACTS (default 32) slots and single-point
    hull contacts; float64 adds the exact-hull manifold tables."""
    key = (xml_path, dtype, str(device), os.environ.get("GST_MAX_CONTACTS", "32"))
    if key not in _MODEL_CACHE:
        if dtype == torch.float32:
            K = int(os.environ.get("GST_MAX_CONTACTS", "32"))
            _MODEL_CACHE[key] = build_model(xml_path, max_contacts=K, device=device,
                                            dtype=torch.float32)
        else:
            _MODEL_CACHE[key] = build_model(xml_path, device=device, dtype=dtype,
                                            ccd_manifolds=True)
    return _MODEL_CACHE[key]


def np_random_from_seed(seed=None) -> np.random.Generator:
    """Generator(PCG64(SeedSequence(seed))), Gymnasium's seeding."""
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))


class SO100Env:
    """One SO100 env with the Gymnasium API (`reset`, `step`, `render`,
    `close`, `action_space`, `observation_space`, `np_random`)."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": C.FPS}

    def __init__(
        self,
        task,
        obs_type="pixels",
        render_mode="rgb_array",
        observation_width=640,
        observation_height=480,
        visualization_width=640,
        visualization_height=480,
        xml_path=ASSETS_XML,
        dtype=None,
        device="cuda",
    ):
        if task not in core.TASKS:
            raise NotImplementedError(task)
        self.task = task
        self.obs_type = obs_type
        self.render_mode = render_mode
        self.observation_width = observation_width
        self.observation_height = observation_height
        self.visualization_width = visualization_width
        self.visualization_height = visualization_height
        self.device = resolve_device(device)
        self._dtype = torch.float32 if dtype is None else dtype
        self._m, self._aux = _cached_model(xml_path, self._dtype, self.device)
        self._ids = core.TaskIds.from_model(self._m)
        self._renderer = None
        self._es = None
        self.data = None        # the last step's position stage: poses, contacts
        self._np_random = None

        if obs_type == "so100_pixels_agent_pos":
            self.observation_space = Dict({
                "pixels": Box(0, 255, (observation_height, observation_width, 3), np.uint8),
                "agent_pos": Box(-10.0, 10.0, (len(C.SO100_JOINTS),), np.float32),
            })
        elif obs_type == "so100_state":
            self.observation_space = Box(-100.0, 100.0, (len(C.SO100_JOINTS) + 9,),
                                         np.float32)
        else:
            raise NotImplementedError(obs_type)
        self.action_space = Box(-1, 1, (len(C.SO100_ACTIONS),), np.float32)

    # -- Gymnasium plumbing ---------------------------------------------------

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = np_random_from_seed()
        return self._np_random

    @property
    def unwrapped(self):
        return self

    # -- rendering ------------------------------------------------------------

    def _get_renderer(self):
        if self._renderer is None:
            from ..render.rasterizer import Renderer

            self._renderer = Renderer(self._m, self._aux)
        return self._renderer

    def _frame(self, height, width, camera="top"):
        frame = self._get_renderer().render(self._es.physics, height=height, width=width,
                                            camera=camera)
        return frame.cpu().numpy()

    def render(self):
        """The "top" camera at the visualization size, (H, W, 3) uint8."""
        assert self.render_mode == "rgb_array"
        return self._frame(self.visualization_height, self.visualization_width)

    # -- observations -----------------------------------------------------------

    def _format_obs(self, obs):
        f32 = lambda t: t.cpu().numpy().astype(np.float32)
        if self.obs_type == "so100_pixels_agent_pos":
            return {
                "pixels": self._frame(self.observation_height, self.observation_width),
                "agent_pos": f32(obs["qpos"]),
            }
        return np.concatenate([f32(obs["box_position"]), f32(obs["bin_position"]),
                               f32(obs["ee_position"]), f32(obs["qpos"])])

    def raw_observation(self):
        """The task layer's full raw obs dict: qpos (6), qvel (6), env_state,
        box/bin/ee positions, and renders of the three cameras ("top",
        "angle", and "front_close" under "vis") at the observation size."""
        if self._es is None:
            raise RuntimeError("call reset() first")
        s = self._es.physics
        d = fwd.position_stage(self._m, s)
        out = {k: v.cpu().numpy() for k, v in core.observations(self._m, d, s, self._ids).items()}
        out["images"] = {
            key: self._frame(self.observation_height, self.observation_width, cam)
            for key, cam in (("top", "top"), ("angle", "angle"), ("vis", "front_close"))
        }
        return out

    # -- API --------------------------------------------------------------------

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._np_random = np_random_from_seed(seed)
        if options and "box_pose" in options:
            box_pose = np.asarray(options["box_pose"])
        else:
            # seeded: the reference's RandomState(seed) stream; unseeded: a
            # seed drawn from np_random, so the episodes after a seeded reset
            # are reproducible
            if seed is None:
                seed = int(self.np_random.integers(2**31 - 1))
            box_pose = C.sample_so100_box_pose_np(seed)
        self._es = core.reset(self._m, torch.as_tensor(box_pose, dtype=self._dtype,
                                                       device=self.device))
        d = fwd.forward(self._m, self._es.physics)
        obs = core.observations(self._m, d, self._es.physics, self._ids)
        return self._format_obs(obs), {"is_success": False}

    def step(self, action):
        action = np.asarray(action)
        assert action.ndim == 1
        self._es, obs, reward, terminated, self.data = core.step(
            self._m, self._es, torch.as_tensor(action, dtype=self._dtype, device=self.device),
            self._ids, self.task)
        terminated = bool(terminated)
        return (self._format_obs(obs), float(reward), terminated, False,
                {"is_success": terminated})

    def close(self):
        pass
