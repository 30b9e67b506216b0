"""End-effector mocap teleop on the SO100 EE scene: keys move the weld
target, the constraint solver does the inverse kinematics.

The counterpart of the JAX package's `scripts/teleop_ee.py` on the port's
single-env engine: wasd/rf translate the target, q/e yaw it, o/p open and
close the gripper (ctrl[5]), x quits; --video writes the rasterizer's
frames (needs imageio).

  python -m gym_so100_tpu_torch.scripts.teleop_ee --seconds 60
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..envs.ee_env import EE_XML
from ..envs.gym_env import _cached_model
from ..ops import forward as fwd
from . import _mocap_teleop


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video", default=None)
    p.add_argument("--seconds", type=float, default=60.0)
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch paths")
    args = p.parse_args(argv)

    m, aux = _cached_model(EE_XML, torch.float32, resolve_device(args.device))
    _mocap_teleop.run(m, aux, fwd.make_state(m), grip_index=5, grip_open=1.75,
                      grip_close=-0.174, seconds=args.seconds, video=args.video)


if __name__ == "__main__":
    main()
