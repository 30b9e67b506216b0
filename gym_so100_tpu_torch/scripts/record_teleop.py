"""Record teleoperation demonstrations in the demo pickle format.

The counterpart of the JAX package's `scripts/record_teleop.py` on the
port's single env: joint-space teleop with the keyboard (or a gamepad
where HID hardware exists); episodes are saved as a pickle list of
{observations, actions, rewards, infos, success} dicts, the format
`agents/bc.py` and `interop/lerobot.py` read.  --watch streams the camera
view to a browser (MJPEG; browser keydowns drive the same keys as the
terminal); --video also writes an mp4 per episode (needs imageio).

  python -m gym_so100_tpu_torch.scripts.record_teleop --episodes 10 --watch
"""

from __future__ import annotations

import argparse
import pickle
import signal
import sys
import time

import numpy as np

from ..envs.constants import SO100_START_ARM_POSE, normalize_so100
from ..envs.registration import make
from ..teleop.input import GamepadControllerHID, KeyboardController


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="SO100CubeToBin-v0")
    p.add_argument("--out", default="demos.pkl")
    p.add_argument("--episodes", type=int, default=10)
    p.add_argument("--video", action="store_true")
    p.add_argument("--gamepad", action="store_true")
    p.add_argument("--watch", type=int, nargs="?", const=8000, default=None,
                   metavar="PORT",
                   help="stream the camera view to a browser while recording")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch paths")
    args = p.parse_args(argv)

    env = make(f"gym_so100_tpu/{args.task}", obs_type="so100_state", device=args.device)
    demos = []

    def flush(*_):
        if demos:
            with open(args.out, "wb") as f:
                pickle.dump(demos, f)
            print(f"\nsaved {len(demos)} episodes to {args.out}")
        sys.exit(0)

    signal.signal(signal.SIGINT, flush)

    ctrl_cls = GamepadControllerHID if args.gamepad else KeyboardController
    with ctrl_cls() as ctl:
        server = None
        if args.watch is not None:
            from ..render.mjpeg import MjpegServer

            server = MjpegServer(
                port=args.watch, fps=15.0, title="gym_so100_tpu_torch — recording",
                help_text="a/z s/x d/c f/v g/b h/n: joints; 1=success 2=failure "
                "3=rerecord q=quit",
                key_handler=getattr(ctl, "inject", None)).start()
            print(f"watch: http://localhost:{server.port}")
        print("keys: a/z s/x d/c f/v g/b h/n joints; 1=success 2=failure 3=rerecord q=quit")
        for ep in range(args.episodes):
            obs, info = env.reset(seed=ep)
            state = normalize_so100(SO100_START_ARM_POSE).astype(np.float32)
            episode = dict(observations=[obs], actions=[], rewards=[], infos=[])
            frames = []
            ctl.episode_end_status = None
            while ctl.episode_end_status is None and ctl.running:
                ctl.update()
                if hasattr(ctl, "joint_deltas"):
                    state = np.clip(state + np.asarray(ctl.joint_deltas), -1, 1).astype(
                        np.float32)
                obs, reward, term, trunc, info = env.step(state)
                episode["observations"].append(obs)
                episode["actions"].append(state.copy())
                episode["rewards"].append(reward)
                episode["infos"].append(info)
                if args.video or server is not None:
                    frame = np.asarray(env.render())
                    if args.video:
                        frames.append(frame)
                    if server is not None:
                        server.publish(frame)
                print(f"\rep {ep} t={len(episode['actions'])} r={reward:+.3f} ",
                      end="", flush=True)
                time.sleep(0.02)
                if term or trunc:
                    break
            if not ctl.running:
                break
            if ctl.episode_end_status == "rerecord_episode":
                print(f"\nrerecording episode {ep}")
                continue
            episode["success"] = ctl.episode_end_status == "success"
            demos.append(episode)
            if args.video and frames:
                import imageio

                imageio.mimsave(f"teleop_ep{ep}.mp4", np.stack(frames), fps=50)
    flush()


if __name__ == "__main__":
    main()
