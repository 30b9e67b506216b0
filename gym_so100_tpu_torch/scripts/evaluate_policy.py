"""Evaluate a trained SAC checkpoint on the port's single env: rollouts,
reward stats, video.

The counterpart of the JAX package's `scripts/evaluate_policy.py`: the
checkpoint's SACConfig comes from its sidecar, and the policy acts
deterministically on the state obs (float32).

  python -m gym_so100_tpu_torch.scripts.evaluate_policy runs/sac/ckpt_1000.pt \
      --episodes 5 --video eval.mp4
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..agents.sac import SAC, SACConfig
from ..envs.registration import make


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("checkpoint")
    p.add_argument("--task", default="SO100CubeToBin-v0")
    p.add_argument("--episodes", type=int, default=5)
    p.add_argument("--video", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch paths")
    args = p.parse_args(argv)

    from ..agents.train import Trainer

    # the SACConfig the checkpoint was trained with (the sidecar Trainer.save
    # writes), so the restored shapes match
    sac = SAC(Trainer.load_config(args.checkpoint) or SACConfig(), device=args.device)
    ckpt = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    st = sac.load_state_dict(ckpt["sac"])

    env = make(f"gym_so100_tpu/{args.task}", obs_type="so100_state",
               dtype=torch.float32, device=args.device)
    rets, succ, frames = [], 0, []
    for ep in range(args.episodes):
        obs, info = env.reset(seed=ep)
        total = 0.0
        while True:
            o = torch.as_tensor(obs, device=sac.device)[None]
            a = sac.act(st, o, deterministic=True)[0].cpu().numpy()
            obs, r, term, trunc, info = env.step(a)
            total += r
            if args.video and ep == 0:
                frames.append(np.asarray(env.render()))
            if term or trunc:
                succ += int(info.get("is_success", False))
                break
        rets.append(total)
        print(f"episode {ep}: return {total:.2f} success {info['is_success']}")
    print(f"mean return {np.mean(rets):.2f}  success rate {succ / args.episodes:.2f}")
    if args.video and frames:
        import imageio

        imageio.mimsave(args.video, np.stack(frames), fps=50)
        print(f"wrote {args.video}")


if __name__ == "__main__":
    main()
