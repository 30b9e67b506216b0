"""Behavior cloning: demos -> BC policy -> evaluation and video -> SAC
fine-tuning.

The counterpart of the JAX package's `scripts/train_bc.py` on the port:
`agents/bc.py` trains the SAC actor's architecture on the demos (flat
state obs, or the pixel dict through the NatureCNN encoder with
--pixels), deterministic rollouts on the single env evaluate it, and the
weights seed a SAC fine-tune on the batched env.

  python -m gym_so100_tpu_torch.scripts.train_bc demos/*.pkl --epochs 50 \
      --eval-episodes 5 --video bc_eval.mp4 --finetune-steps 50000 \
      --checkpoint-dir runs/bc
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..agents import bc
from ..agents.sac import SACConfig, det_action, unit_pixels
from ..agents.train import TrainConfig, Trainer
from ..device import resolve_device
from ..envs.registration import make

TASK_KEYS = {
    "SO100TouchCube-v0": "so100_touch_cube",
    "SO100TouchCubeSparse-v0": "so100_touch_cube_sparse",
    "SO100CubeToBin-v0": "so100_cube_to_bin",
}


def evaluate(actor, episodes, task, video=None, pixels=None, device="cuda"):
    """Deterministic rollouts of the BC policy on the single env; `pixels`
    (H, W) evaluates the pixel-dict policy on the pixel obs type.  Returns
    the mean return."""
    device = resolve_device(device)
    if pixels:
        env = make(f"gym_so100_tpu/{task}", obs_type="so100_pixels_agent_pos",
                   observation_height=pixels[0], observation_width=pixels[1],
                   dtype=torch.float32, device=device)

        def prep(o):
            return {"pixels": unit_pixels(torch.as_tensor(o["pixels"], device=device)[None],
                                          torch.float32),
                    "agent_pos": torch.as_tensor(o["agent_pos"], device=device)[None]}
    else:
        env = make(f"gym_so100_tpu/{task}", obs_type="so100_state", dtype=torch.float32,
                   device=device)
        prep = lambda o: torch.as_tensor(o, device=device)[None]
    rets, succ, frames = [], 0, []
    for ep in range(episodes):
        obs, info = env.reset(seed=ep)
        total = 0.0
        while True:
            with torch.no_grad():
                a = det_action(actor, prep(obs))[0].cpu().numpy()
            obs, r, term, trunc, info = env.step(a)
            total += float(r)
            if video and ep == 0:
                frames.append(np.asarray(env.render()))
            if term or trunc:
                succ += int(info.get("is_success", False))
                break
        rets.append(total)
        print(f"eval episode {ep}: return {total:.2f} "
              f"success {info.get('is_success', False)}")
    print(f"eval: mean return {np.mean(rets):.2f} success rate {succ / episodes:.2f}")
    if video and frames:
        import imageio

        imageio.mimsave(video, np.stack(frames), fps=50)
        print(f"wrote {video}")
    return float(np.mean(rets))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("demos", nargs="+", help="demo pickle files")
    p.add_argument("--task", default="SO100CubeToBin-v0")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--eval-episodes", type=int, default=5)
    p.add_argument("--video", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--finetune-steps", type=int, default=0,
                   help="continue with SAC fine-tuning from the BC weights")
    p.add_argument("--num-envs", type=int, default=64)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--pixels", action="store_true",
                   help="train on the pixel dict obs through the NatureCNN encoder")
    p.add_argument("--obs-height", type=int, default=48)
    p.add_argument("--obs-width", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch paths")
    args = p.parse_args(argv)

    obs, act = bc.load_demo_transitions(args.demos, pixels=args.pixels)
    print(f"loaded {act.shape[0]} transitions from {len(args.demos)} file(s)")
    actor = bc.train_bc(obs, act, epochs=args.epochs, batch_size=args.batch_size,
                        lr=args.lr, seed=args.seed, device=args.device,
                        progress=lambda line: print(json.dumps(line), flush=True))
    hw = tuple(obs["pixels"].shape[1:3]) if args.pixels else None
    if args.eval_episodes:
        evaluate(actor, args.eval_episodes, args.task, video=args.video, pixels=hw,
                 device=args.device)

    if args.finetune_steps or args.checkpoint_dir:
        task_key = TASK_KEYS.get(args.task, "so100_cube_to_bin")
        if args.pixels:
            tcfg = TrainConfig(task=task_key, num_envs=args.num_envs,
                               total_steps=args.finetune_steps,
                               checkpoint_dir=args.checkpoint_dir,
                               obs="pixels_agent_pos", obs_height=hw[0], obs_width=hw[1])
            scfg = SACConfig(obs_dim=obs["agent_pos"].shape[-1], pixels=hw)
        else:
            tcfg = TrainConfig(task=task_key, num_envs=args.num_envs,
                               total_steps=args.finetune_steps,
                               checkpoint_dir=args.checkpoint_dir)
            scfg = SACConfig(obs_dim=obs.shape[-1])
        trainer = Trainer(None, tcfg, scfg, device=args.device)
        st = bc.transfer_to_sac(trainer.sac, trainer.sac.init(args.seed), actor)
        if args.finetune_steps:
            print(f"SAC fine-tune for {args.finetune_steps} env steps")
            st = trainer.train(seed=args.seed, init_state=st,
                               progress=lambda line: print(json.dumps(line), flush=True))
        if args.checkpoint_dir:
            print(f"saved {trainer.save(st, args.checkpoint_dir, args.finetune_steps)}")


if __name__ == "__main__":
    main()
