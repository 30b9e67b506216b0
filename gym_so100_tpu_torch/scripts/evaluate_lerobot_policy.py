"""Evaluate a pretrained LeRobot policy (ACT / Diffusion / PI0FAST /
SmolVLA) on the port's single env.

The counterpart of the JAX package's `scripts/evaluate_lerobot_policy.py`
over the port's `interop/lerobot.py` (needs the `lerobot` package).

  python -m gym_so100_tpu_torch.scripts.evaluate_lerobot_policy act \
      lerobot/act_so100 --episodes 5 --video eval.mp4
"""

from __future__ import annotations

import argparse

import numpy as np

from ..envs.registration import make
from ..interop import lerobot as interop


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("kind", choices=["act", "diffusion", "pi0fast", "smolvla"])
    p.add_argument("path_or_repo")
    p.add_argument("--task", default="SO100CubeToBin-v0")
    p.add_argument("--episodes", type=int, default=5)
    p.add_argument("--video", default=None)
    p.add_argument("--no-unit-conversion", action="store_true",
                   help="skip the gym <-> LeRobot +-100 unit conversion")
    p.add_argument("--task-text", default="Put the red cube into the bin")
    p.add_argument("--obs-width", type=int, default=640)
    p.add_argument("--obs-height", type=int, default=480)
    p.add_argument("--device", default="cuda",
                   help="torch device of the env; cpu runs the plain PyTorch paths")
    args = p.parse_args(argv)

    policy = interop.load_pretrained_policy(args.kind, args.path_or_repo)
    env = make(f"gym_so100_tpu/{args.task}", obs_type="so100_pixels_agent_pos",
               observation_width=args.obs_width, observation_height=args.obs_height,
               device=args.device)
    stats = interop.rollout_policy(
        policy, env, episodes=args.episodes,
        lerobot_units=not args.no_unit_conversion,
        task_text=args.task_text if args.kind in ("pi0fast", "smolvla") else None,
        video_path=args.video)
    print(f"mean return {np.mean(stats['returns']):.2f}  "
          f"success rate {np.mean(stats['successes']):.2f}")


if __name__ == "__main__":
    main()
