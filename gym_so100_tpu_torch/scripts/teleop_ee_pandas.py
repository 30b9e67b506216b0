"""End-effector mocap teleop for the Franka Panda EE scene.

The counterpart of the JAX package's `scripts/teleop_ee_pandas.py` on the
port's single-env engine: the arm starts at the "home" keyframe; wasd/rf
translate the weld target, q/e yaw it, o/p open and close the gripper
(ctrl[7]), x quits.  The `general` actuators' affine gain and bias and
the finger-coupling joint equality are part of the model.  Prints the
model's diagnostics first; --video writes the rasterizer's frames.

  python -m gym_so100_tpu_torch.scripts.teleop_ee_pandas --seconds 60
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..envs.gym_env import _cached_model
from ..models.builder import PANDA_XML
from ..ops import forward as fwd
from . import _mocap_teleop

GRIP_OPEN = 0.4
GRIP_CLOSE = -0.4


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video", default=None)
    p.add_argument("--seconds", type=float, default=60.0)
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch paths")
    args = p.parse_args(argv)

    m, aux = _cached_model(PANDA_XML, torch.float32, resolve_device(args.device))
    print(f"model: {m.nbody} bodies, {m.nv} dofs, {m.nu} actuators, {m.ngeom} geoms")
    print("actuators:", list(m.names_actuator))
    print("joints:", list(m.names_joint))
    kq, kc = aux["keyframes"]["home"]
    _mocap_teleop.run(m, aux, fwd.make_state(m, qpos=kq, ctrl=kc), grip_index=7,
                      grip_open=GRIP_OPEN, grip_close=GRIP_CLOSE, seconds=args.seconds,
                      video=args.video)


if __name__ == "__main__":
    main()
