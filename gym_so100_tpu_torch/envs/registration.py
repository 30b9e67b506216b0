"""The registered env ids and `make`, without Gymnasium.

The port of `gym_so100_tpu/envs/registration.py`: the same three ids,
tasks, episode limits and kwargs.  `make(id, **kwargs)` builds the
`SO100Env` and applies the time limit as `gymnasium.make`'s `TimeLimit`
does: `truncated` is True once `max_episode_steps` steps have been taken
since the last reset.
"""

from __future__ import annotations

from .gym_env import SO100Env

REGISTRY = {
    f"gym_so100_tpu/{name}": dict(
        max_episode_steps=max_steps,
        kwargs={"obs_type": "so100_pixels_agent_pos", "task": task},
    )
    for name, task, max_steps in (
        ("SO100TouchCube-v0", "so100_touch_cube", 300),
        ("SO100TouchCubeSparse-v0", "so100_touch_cube_sparse", 300),
        ("SO100CubeToBin-v0", "so100_cube_to_bin", 700),
    )
}


class TimeLimit:
    """Truncates an env's episodes after `max_episode_steps` steps; every
    other attribute is the env's."""

    def __init__(self, env, max_episode_steps: int):
        self.env = env
        self.max_episode_steps = max_episode_steps
        self._elapsed_steps = None

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, seed=None, options=None):
        self._elapsed_steps = 0
        return self.env.reset(seed=seed, options=options)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed_steps += 1
        if self._elapsed_steps >= self.max_episode_steps:
            truncated = True
        return obs, reward, terminated, truncated, info


def make(id: str, max_episode_steps=None, **kwargs):
    """The registered env `id` with its kwargs (overridden by `kwargs`),
    wrapped in its time limit (or `max_episode_steps`)."""
    spec = REGISTRY[id]
    env = SO100Env(**{**spec["kwargs"], **kwargs})
    return TimeLimit(env, max_episode_steps or spec["max_episode_steps"])
