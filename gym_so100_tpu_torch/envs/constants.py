"""Env-layer constants and action scaling.

The port of `gym_so100_tpu/envs/constants.py`: control period, joint list
and ranges, the bin's interior box (the HER goal curriculum's late goals),
the start pose, cube spawn ranges, the [-1, 1] <-> radians action scaling
and the gym <-> LeRobot unit conversions (each on torch tensors, batched
and on any device, or on numpy arrays and lists), and the single-env
adapters' host-side cube spawns (numpy).
"""

from __future__ import annotations

import numpy as np
import torch

DT = 0.02
FPS = 50
N_SUBSTEPS = 10  # DT / model timestep (0.002)

SO100_JOINTS = [
    "left_arm_waist",
    "left_arm_shoulder",
    "left_arm_elbow",
    "left_arm_forearm_roll",
    "left_arm_wrist_rotate",
    "left_arm_gripper",
]

SO100_ACTIONS = list(SO100_JOINTS)

# per-joint ranges used by the action (un)normalizers
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

bin_min = np.array([-0.25, 0.7, 0.01], dtype=np.float32)
bin_max = np.array([-0.14, 0.76, 0.05], dtype=np.float32)

SO100_START_ARM_POSE = np.array([0.0, -0.96, 1.16, 0.0, 0.0, 0.02239])

# cube spawn ranges
BOX_X_RANGE = (-0.25, -0.15)
BOX_Y_RANGE = (0.3, 0.6)
BOX_Z = 0.05


def _ranges(x, table):
    """(x as a tensor or float array, the table's columns in its dtype and
    on its device, the clip function)."""
    if isinstance(x, torch.Tensor):
        col = lambda c: torch.as_tensor(np.asarray(c), dtype=x.dtype, device=x.device)
        return x, col(table[:, 0]), col(table[:, 1]), torch.clamp
    x = np.asarray(x)
    if not np.issubdtype(x.dtype, np.floating):
        x = x.astype(np.float64)
    return x, table[:, 0].astype(x.dtype), table[:, 1].astype(x.dtype), np.clip


# LeRobot's units: +-100 for the arm joints, 0..100 for the gripper
LEROBOT_RANGES = np.array([[-100.0, 100.0]] * 5 + [[0.0, 100.0]])


def unnormalize_so100(action):
    """[-1, 1]^6 -> radians, clipped to the joint ranges."""
    a, lo, hi, clip = _ranges(action, JOINT_RANGES)
    return clip((a + 1.0) / 2.0 * (hi - lo) + lo, lo, hi)


def normalize_so100(q):
    """radians -> [-1, 1]^6, clipped."""
    q, lo, hi, clip = _ranges(q, JOINT_RANGES)
    return clip((q - lo) / (hi - lo) * 2.0 - 1.0, -1.0, 1.0)


def normalize_gym_so100_to_lerobot(action):
    """radians -> LeRobot units, clipped."""
    a, lo, hi, clip = _ranges(action, JOINT_RANGES)
    _, tmin, tmax, _ = _ranges(a, LEROBOT_RANGES)
    return clip((a - lo) / (hi - lo) * (tmax - tmin) + tmin, tmin, tmax)


def normalize_lerobot_to_gym_so100(action):
    """LeRobot units -> [-1, 1] normalized actions, clipped."""
    a, tmin, tmax, clip = _ranges(action, LEROBOT_RANGES)
    return clip((a - tmin) / (tmax - tmin) * 2.0 - 1.0, -1.0, 1.0)


def sample_so100_box_poses(n: int, generator: torch.Generator, dtype, device):
    """n cube spawns (n, 7), uniform over the spawn ranges (the same
    distribution as the JAX package's jax.random sampler; the streams
    differ).  Drawn on the generator's device, then moved."""
    u = torch.rand(n, 2, generator=generator, dtype=dtype,
                   device=generator.device).to(device)
    x = BOX_X_RANGE[0] + u[:, 0] * (BOX_X_RANGE[1] - BOX_X_RANGE[0])
    y = BOX_Y_RANGE[0] + u[:, 1] * (BOX_Y_RANGE[1] - BOX_Y_RANGE[0])
    pose = torch.zeros(n, 7, dtype=dtype, device=device)
    pose[:, 0] = x
    pose[:, 1] = y
    pose[:, 2] = BOX_Z
    pose[:, 3] = 1.0
    return pose


def sample_so100_box_pose_np(seed=None):
    """One cube spawn (7,) from a fresh np.random.RandomState(seed) per call
    (the reference's stream: uniform over the x and y ranges, z fixed)."""
    rng = np.random.RandomState(seed)
    ranges = np.array([BOX_X_RANGE, BOX_Y_RANGE, (BOX_Z, BOX_Z)])
    pos = rng.uniform(ranges[:, 0], ranges[:, 1])
    return np.concatenate([pos, [1.0, 0, 0, 0]])


def fixed_so100_box_pose_np(seed=None):
    """The fixed cube spawn (7,)."""
    return np.array([-0.2, 0.45, 0.05, 1.0, 0, 0, 0])
