"""Env-layer constants and the action scaling of the batched path (a
frozen copy of the port's `envs/constants.py`, the parts the batched step
uses)."""

from __future__ import annotations

import numpy as np
import torch

DT = 0.02
N_SUBSTEPS = 10  # DT / model timestep (0.002)

# per-joint ranges used by the action unnormalizer
JOINT_RANGES = np.array(
    [
        [-1.92, 1.92],    # waist
        [-3.32, 0.174],   # shoulder
        [-0.174, 3.14],   # elbow
        [-1.66, 1.66],    # wrist pitch
        [-2.79, 2.79],    # wrist roll
        [-0.174, 1.75],   # gripper
    ]
)

SO100_START_ARM_POSE = np.array([0.0, -0.96, 1.16, 0.0, 0.0, 0.02239])


def unnormalize_so100(a: torch.Tensor) -> torch.Tensor:
    """[-1, 1]^6 -> radians, clipped to the joint ranges."""
    col = lambda c: torch.as_tensor(np.asarray(c), dtype=a.dtype, device=a.device)
    lo, hi = col(JOINT_RANGES[:, 0]), col(JOINT_RANGES[:, 1])
    return torch.clamp((a + 1.0) / 2.0 * (hi - lo) + lo, lo, hi)
