"""The keyboard loop shared by `teleop_ee` and `teleop_ee_pandas`: wasd/rf
move the mocap weld target, q/e yaw it, o/p set the gripper's ctrl, x
quits; the constraint solver does the inverse kinematics through the weld.
Runs the port's single-env engine (`ops/forward.py` `n_steps`)."""

from __future__ import annotations

import math
import select
import sys
import time

import numpy as np
import torch

from ..ops import forward as fwd
from ..ops import quat as quat_ops
from ..ops import smooth
from ..teleop.input import KeyboardController

STEP = 0.004  # m per tick
ROT = 0.05    # rad per tick
KEYS = "wasd: xy move, r/f: up/down, q/e: yaw, o/p: gripper, x: quit"


def run(m, aux, s, grip_index, grip_open, grip_close, seconds, video):
    """Drive `s` (a single-env State of the mocap scene `m`) from the
    keyboard for `seconds`; `video` is an mp4 path for the rasterizer's
    frames, or None."""
    ee = m.site_id("ee_site")
    kin = lambda s: smooth.kinematics(m, s).site_xpos[ee]
    s = s.replace(mocap_pos=kin(s)[None].clone())     # the target starts at the ee
    renderer = None
    frames = []
    if video:
        from ..render.rasterizer import Renderer

        renderer = Renderer(m, aux)
    dev, dt = s.qpos.device, s.qpos.dtype
    print(KEYS)
    # KeyboardController serves as the cbreak-mode context manager only: its
    # own keymap (q quits, x is a joint key) would shadow these bindings
    with KeyboardController():
        t_end = time.time() + seconds
        running = True
        while time.time() < t_end and running:
            dp = np.zeros(3)
            dyaw = 0.0
            grip = None
            keys = ""
            while select.select([sys.stdin], [], [], 0)[0]:
                ch = sys.stdin.read(1)
                if not ch:              # end of input
                    break
                keys += ch
            for ch in keys:
                if ch in "wsadrf":
                    axis, sign = {"w": (1, 1), "s": (1, -1), "a": (0, -1), "d": (0, 1),
                                  "r": (2, 1), "f": (2, -1)}[ch]
                    dp[axis] += sign * STEP
                elif ch in "qe":
                    dyaw += ROT if ch == "q" else -ROT
                elif ch in "op":
                    grip = grip_open if ch == "o" else grip_close
                elif ch == "x":
                    running = False
            mp = s.mocap_pos + torch.as_tensor(dp, dtype=dt, device=dev)[None]
            mq = s.mocap_quat
            if dyaw:
                rot = torch.tensor([math.cos(dyaw / 2), 0, 0, math.sin(dyaw / 2)],
                                   dtype=dt, device=dev)
                mq = quat_ops.mul(rot[None], mq)
            ctrl = s.ctrl
            if grip is not None:
                ctrl = ctrl.clone()
                ctrl[grip_index] = grip
            s = fwd.n_steps(m, s.replace(mocap_pos=mp, mocap_quat=mq, ctrl=ctrl), 10)
            print(f"\ree {kin(s).cpu().numpy().round(3)} target "
                  f"{mp[0].cpu().numpy().round(3)}  ", end="", flush=True)
            if renderer is not None:
                frames.append(renderer.render(s, 240, 320, "top").cpu().numpy())
            time.sleep(0.02)
    if video and frames:
        import imageio

        imageio.mimsave(video, np.stack(frames), fps=50)
        print(f"\nwrote {video}")
    return s
