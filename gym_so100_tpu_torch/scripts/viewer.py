"""Interactive browser viewer for headless hosts.

The counterpart of the JAX package's `scripts/viewer.py` on the port's
single-env engine: a small stdlib HTTP server streams the rasterizer's
frames as MJPEG to a browser, and key presses in the page drive the same
normalized joint targets as `scripts/teleop.py` (or, with --ee, the weld
target of the EE scene).

    python -m gym_so100_tpu_torch.scripts.viewer --port 8000   # joint space
    python -m gym_so100_tpu_torch.scripts.viewer --ee          # EE mocap scene
    open http://localhost:8000

Keys (joint mode): a/z s/x d/c f/v g/b h/n nudge joints 1-6; 0 re-centers.
EE mode: arrows and +/- move the weld target, o/p the gripper.
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

KEYMAP = {  # key -> (joint, sign), as scripts/teleop.py
    "a": (0, +1), "z": (0, -1), "s": (1, +1), "x": (1, -1),
    "d": (2, +1), "c": (2, -1), "f": (3, +1), "v": (3, -1),
    "g": (4, +1), "b": (4, -1), "h": (5, +1), "n": (5, -1),
}
EE_KEYS = {  # key -> (axis, mocap delta in m)
    "ArrowUp": (2, +0.01), "ArrowDown": (2, -0.01),
    "ArrowRight": (0, +0.01), "ArrowLeft": (0, -0.01),
    "+": (1, +0.01), "-": (1, -0.01), "=": (1, +0.01),
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--ee", action="store_true", help="EE mocap-weld scene")
    p.add_argument("--camera", default="top")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--fps", type=float, default=15.0)
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch paths")
    args = p.parse_args(argv)

    from ..device import resolve_device
    from ..envs import constants as C
    from ..envs.ee_env import EE_XML
    from ..envs.gym_env import _cached_model
    from ..models.builder import ASSETS_XML
    from ..ops import forward as fwd
    from ..ops import smooth
    from ..render.mjpeg import MjpegServer
    from ..render.rasterizer import Renderer

    device = resolve_device(args.device)
    m, aux = _cached_model(EE_XML if args.ee else ASSETS_XML, torch.float32, device)
    renderer = Renderer(m, aux)
    lock = threading.Lock()
    start = C.normalize_so100(C.SO100_START_ARM_POSE).astype(np.float32)
    state = {"pose": start.copy()}          # normalized joint targets
    s = fwd.make_state(m)
    if args.ee:
        ee = m.site_id("ee_site")
        s = s.replace(mocap_pos=smooth.kinematics(m, s).site_xpos[ee][None].clone())
    state["s"] = s

    def on_key(key):
        with lock:
            s = state["s"]
            if args.ee:
                if key in EE_KEYS:
                    ax, dlt = EE_KEYS[key]
                    mp = s.mocap_pos.clone()
                    mp[0, ax] += dlt
                    state["s"] = s.replace(mocap_pos=mp)
                elif key in ("o", "p"):
                    ctrl = s.ctrl.clone()
                    ctrl[5] += 0.05 if key == "o" else -0.05
                    state["s"] = s.replace(ctrl=ctrl)
            elif key in KEYMAP:
                j, sg = KEYMAP[key]
                state["pose"][j] = float(np.clip(state["pose"][j] + sg * 0.05, -1, 1))
            elif key == "0":
                state["pose"][:] = start

    server = MjpegServer(
        port=args.port, fps=args.fps,
        title=(f"gym_so100_tpu_torch — {'EE mocap' if args.ee else 'joint-space'} "
               f"viewer (camera: {args.camera})"),
        help_text=("arrows/+-: move target, o/p: gripper" if args.ee
                   else "a/z s/x d/c f/v g/b h/n: joints, 0: home"),
        key_handler=on_key)

    def sim_loop():
        dt = 1.0 / args.fps
        while True:
            t0 = time.time()
            with lock:
                s = state["s"]
                if not args.ee:
                    ctrl = C.unnormalize_so100(state["pose"])
                    s = s.replace(ctrl=torch.as_tensor(ctrl, device=device))
            s2 = fwd.n_steps(m, s, C.N_SUBSTEPS)
            frame = renderer.render(s2, args.height, args.width, args.camera).cpu().numpy()
            with lock:
                state["s"] = s2
            server.publish(frame)
            time.sleep(max(0.0, dt - (time.time() - t0)))

    threading.Thread(target=sim_loop, daemon=True).start()
    print(f"viewer: http://localhost:{args.port}  (ctrl-c to quit)", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
