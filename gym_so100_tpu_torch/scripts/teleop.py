"""Joint-space keyboard teleop on the port's single-env engine.

The counterpart of the JAX package's `scripts/teleop.py`: keys nudge a
normalized [-1, 1] pose per joint (a/z s/x d/c f/v g/b h/n), which is
unnormalized to radians and applied as the position servos' ctrl each
0.02 s control step; the state prints to the terminal, and --video writes
the rasterizer's frames (needs imageio).

  python -m gym_so100_tpu_torch.scripts.teleop --seconds 60 --video teleop.mp4
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..device import resolve_device
from ..envs import constants as C
from ..envs.gym_env import _cached_model
from ..models.builder import ASSETS_XML
from ..ops import forward as fwd
from ..teleop.input import KeyboardController


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video", default=None)
    p.add_argument("--seconds", type=float, default=60.0)
    p.add_argument("--step", type=float, default=0.05,
                   help="normalized pose delta per key press")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch paths")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    m, aux = _cached_model(ASSETS_XML, torch.float32, device)
    pose = C.normalize_so100(C.SO100_START_ARM_POSE).astype(np.float32)
    s = fwd.make_state(m, ctrl=C.SO100_START_ARM_POSE)
    renderer = None
    frames = []
    if args.video:
        from ..render.rasterizer import Renderer

        renderer = Renderer(m, aux)

    print("keys: a/z s/x d/c f/v g/b h/n nudge joints 1-6, q quits")
    with KeyboardController(step=args.step) as ctl:
        t_end = time.time() + args.seconds
        while time.time() < t_end and ctl.running:
            ctl.update()
            if any(ctl.joint_deltas):
                pose = np.clip(pose + np.asarray(ctl.joint_deltas), -1, 1).astype(np.float32)
            ctrl = C.unnormalize_so100(pose)
            s = fwd.n_steps(m, s.replace(ctrl=torch.as_tensor(ctrl, device=device)),
                            C.N_SUBSTEPS)
            q = s.qpos[:6].cpu().numpy()
            print(f"\rqpos {np.round(q, 3)}  ctrl {np.round(ctrl, 3)}   ", end="", flush=True)
            if renderer is not None:
                frames.append(renderer.render(s, 240, 320, "top").cpu().numpy())
            time.sleep(0.02)
    if args.video and frames:
        import imageio

        imageio.mimsave(args.video, np.stack(frames), fps=50)
        print(f"\nwrote {args.video}")


if __name__ == "__main__":
    main()
