"""Goal-conditioned env: the sparse goal reward that HER relabeling
recomputes, and the `SO100GoalEnv` adapter.

The port of `gym_so100_tpu/envs/goal_env.py`, without importing Gymnasium.
`SO100GoalEnv` wraps an `SO100Env` (cube to bin, pixels + agent_pos) and
returns dict obs {observation, achieved_goal, desired_goal}: observation =
the flattened pixels / 255 ++ agent_pos, achieved_goal = the cube site's
position, a sparse 0 / -1 reward within distance_threshold = 0.01,
terminated = success, truncation after 300 steps (with
info["TimeLimit.truncated"]), and the goal curriculum: a goal near the
cube's spawn for the first 5000 steps in all, then one in the bin.  Goals
are drawn from the env's `np_random` (seeded by `reset(seed)`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.builder import ASSETS_XML
from ..ops import smooth
from . import constants as C
from .gym_env import SO100Env, np_random_from_seed
from .spaces import Box, Dict


def goal_distance(a, b):
    """Euclidean distance over the last axis, as sqrt(sum(d * d))."""
    d = torch.as_tensor(a) - torch.as_tensor(b)
    return torch.sqrt((d * d).sum(-1))


def compute_reward(achieved_goal, desired_goal, distance_threshold=0.01):
    """Sparse goal reward: float32 0 where the achieved goal lies within
    `distance_threshold` of the desired one, else -1.  Broadcasts over
    leading batch dims (the HER relabeling contract)."""
    d = goal_distance(achieved_goal, desired_goal)
    return torch.where(d < distance_threshold, 0.0, -1.0).to(torch.float32)


class SO100GoalEnv:
    """The goal-conditioned SO100 env with the Gymnasium GoalEnv API."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": C.FPS}

    def __init__(
        self,
        render_mode="rgb_array",
        observation_width=640,
        observation_height=480,
        visualization_width=640,
        visualization_height=480,
        xml_path=ASSETS_XML,
        dtype=None,
        device="cuda",
    ):
        self.max_episode_steps = 300
        self.current_step = 0
        self.total_steps = 0
        self.render_mode = render_mode
        self.observation_width = observation_width
        self.observation_height = observation_height
        self.visualization_width = visualization_width
        self.visualization_height = visualization_height
        self._inner = SO100Env(
            task="so100_cube_to_bin",
            obs_type="so100_pixels_agent_pos",
            observation_width=observation_width,
            observation_height=observation_height,
            visualization_width=visualization_width,
            visualization_height=visualization_height,
            xml_path=xml_path,
            dtype=dtype,
            device=device,
        )
        obs_size = observation_height * observation_width * 3 + len(C.SO100_JOINTS)
        self.observation_space = Dict({
            "observation": Box(-np.inf, np.inf, (obs_size,), np.float32),
            "achieved_goal": Box(-np.inf, np.inf, (3,), np.float32),
            "desired_goal": Box(-np.inf, np.inf, (3,), np.float32),
        })
        self.action_space = Box(-1, 1, (len(C.SO100_ACTIONS),), np.float32)
        self.bin_goal_space = Box(
            low=np.array([C.bin_min[0] + 0.005, C.bin_min[1] + 0.005, 0.01]),
            high=np.array([C.bin_max[0] - 0.005, C.bin_max[1] - 0.005, 0.05]),
            dtype=np.float32,
        )
        self.distance_threshold = 0.01
        self._np_random = None

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = np_random_from_seed()
        return self._np_random

    @property
    def unwrapped(self):
        return self

    # -- helpers --------------------------------------------------------------

    def render(self):
        return self._inner.render()

    def _flatten_observation(self, base_obs):
        pixels = base_obs["pixels"].reshape(-1).astype(np.float32) / 255.0
        return np.concatenate([pixels, base_obs["agent_pos"].astype(np.float32)])

    def _achieved_goal(self):
        inner = self._inner
        d = smooth.kinematics(inner._m, inner._es.physics)
        return d.site_xpos[inner._ids.cube_site].cpu().numpy().astype(np.float32)

    def _sample_goal(self):
        """Near the cube's spawn for the first 5000 steps, then in the bin;
        drawn from np_random."""
        if self.total_steps < 5000:
            lifted = Box(
                low=np.array([self.box_pose[0] - 0.03, self.box_pose[1] - 0.03, 0.01]),
                high=np.array([self.box_pose[0] + 0.03, self.box_pose[1] + 0.03, 0.05]),
                dtype=np.float32,
            )
            return lifted.sample(self.np_random)
        return self.bin_goal_space.sample(self.np_random)

    def compute_reward(self, achieved_goal, desired_goal, info):
        return compute_reward(torch.as_tensor(achieved_goal), torch.as_tensor(desired_goal),
                              self.distance_threshold).numpy()[()]

    def _is_success(self, achieved_goal, desired_goal):
        return bool(np.linalg.norm(achieved_goal - desired_goal) < self.distance_threshold)

    def _goal_obs(self, base_obs):
        return {
            "observation": self._flatten_observation(base_obs),
            "achieved_goal": self._achieved_goal(),
            "desired_goal": self.goal.copy(),
        }

    # -- API --------------------------------------------------------------------

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._np_random = np_random_from_seed(seed)
        self.current_step = 0
        self.box_pose = C.sample_so100_box_pose_np(seed)
        base_obs, _ = self._inner.reset(seed=seed, options={"box_pose": self.box_pose})
        self.goal = self._sample_goal()
        return self._goal_obs(base_obs), {"is_success": False}

    def step(self, action):
        action = np.asarray(action)
        assert action.ndim == 1
        base_obs, _, _, _, _ = self._inner.step(action)
        observation = self._goal_obs(base_obs)
        info = {"is_success": False}
        reward = self.compute_reward(observation["achieved_goal"],
                                     observation["desired_goal"], info)
        success = self._is_success(observation["achieved_goal"], observation["desired_goal"])
        info["is_success"] = success
        self.current_step += 1
        self.total_steps += 1
        truncated = False
        if self.current_step >= self.max_episode_steps:
            truncated = True
            info["TimeLimit.truncated"] = True
        return observation, float(reward), success, truncated, info

    def close(self):
        self._inner.close()
