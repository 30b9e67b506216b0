"""Goal-conditioned env helpers.

The port of the batched half of `gym_so100_tpu/envs/goal_env.py`: the
sparse goal reward that HER relabeling recomputes.  (The Gymnasium
`SO100GoalEnv` adapter of that module is not ported yet.)
"""

from __future__ import annotations

import torch


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
