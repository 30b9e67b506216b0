"""Random-rollout example with a video of the pixel observations.

The counterpart of the JAX package's `scripts/example.py` on the port:
the registered SO100TouchCube-v0 at 64x48 pixels, random actions, an mp4
of the observations (needs imageio).

  python -m gym_so100_tpu_torch.scripts.example --steps 300 --out rollout.mp4
"""

from __future__ import annotations

import argparse

import numpy as np

from ..envs.registration import make


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--out", default="example_rollout.mp4")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch paths")
    args = p.parse_args(argv)

    env = make("gym_so100_tpu/SO100TouchCube-v0", obs_type="so100_pixels_agent_pos",
               observation_width=64, observation_height=48, device=args.device)
    obs, info = env.reset(seed=42)
    frames = [obs["pixels"]]
    for _ in range(args.steps):
        obs, reward, terminated, truncated, info = env.step(env.action_space.sample())
        frames.append(obs["pixels"])
        if terminated or truncated:
            obs, info = env.reset()
    import imageio

    imageio.mimsave(args.out, np.stack(frames), fps=50)
    print(f"wrote {args.out} ({len(frames)} frames)")


if __name__ == "__main__":
    main()
