"""Train SAC on the port's batched env.

The counterpart of the JAX package's `scripts/train_sac.py`, with the same
flags plus --max-contacts and --device.

  python -m gym_so100_tpu_torch.scripts.train_sac --task so100_touch_cube \
      --num-envs 128 --utd 8 --total-steps 1500000 --checkpoint-dir runs/sac

Pixel observations (48x64 top-camera frames and the arm qpos):

  python -m gym_so100_tpu_torch.scripts.train_sac --task so100_touch_cube \
      --obs pixels_agent_pos --obs-height 48 --obs-width 64 --num-envs 128 \
      --utd 8 --total-steps 1500000 --checkpoint-dir runs/sac_pixels
"""

from __future__ import annotations

import argparse

from ..agents.metrics import MetricLogger
from ..agents.sac import SACConfig
from ..agents.train import REFERENCE_STAGES, TrainConfig, Trainer


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="so100_cube_to_bin")
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--total-steps", type=int, default=1_000_000)
    p.add_argument("--learning-starts", type=int, default=1_000)
    p.add_argument("--utd", type=int, default=1,
                   help="gradient updates per env-batch step")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--buffer-size", type=int, default=50_000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=50_000)
    p.add_argument("--resume", default=None, help="checkpoint path to restore")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--hull-contacts", action=argparse.BooleanOptionalAction, default=True,
        help="full contact set (default; --no-hull-contacts drops the arm-mesh "
        "pairs)",
    )
    p.add_argument("--max-contacts", type=int, default=32,
                   help="contact slots per env (K) of the scene")
    p.add_argument("--obs", default="state", choices=["state", "pixels_agent_pos"])
    p.add_argument("--obs-height", type=int, default=48, help="pixel obs height")
    p.add_argument("--obs-width", type=int, default=64, help="pixel obs width")
    p.add_argument("--eval-every", type=int, default=0,
                   help="env steps between deterministic evals (0 = off)")
    p.add_argument("--eval-episodes", type=int, default=8)
    p.add_argument("--video-dir", default=None,
                   help="write an mp4 of each eval's first episode here (needs imageio)")
    p.add_argument("--stages", action="store_true",
                   help="use the reference's 3-stage entropy/LR curriculum")
    p.add_argument("--tensorboard-dir", default=None,
                   help="write TensorBoard scalars here in addition to stdout JSON")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch paths")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    pixels = args.obs == "pixels_agent_pos"
    sac_cfg = SACConfig(
        obs_dim=6 if pixels else 15,
        pixels=(args.obs_height, args.obs_width) if pixels else (),
        lr=args.lr, buffer_size=args.buffer_size, batch_size=args.batch_size)
    if args.resume:
        # rebuild from the saved sidecar so the restored shapes match
        sac_cfg = Trainer.load_config(args.resume) or sac_cfg
    trainer = Trainer(
        None,
        TrainConfig(
            task=args.task,
            num_envs=args.num_envs,
            total_steps=args.total_steps,
            learning_starts=args.learning_starts,
            utd=args.utd,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            hull_contacts=args.hull_contacts,
            max_contacts=args.max_contacts,
            stages=REFERENCE_STAGES if args.stages else (),
            obs=args.obs,
            obs_height=args.obs_height,
            obs_width=args.obs_width,
            eval_every=args.eval_every,
            eval_episodes=args.eval_episodes,
            video_dir=args.video_dir,
        ),
        sac_cfg,
        device=args.device,
    )
    init_state = None
    if args.resume:
        init_state = trainer.restore(args.resume)
        print(f"resumed from {args.resume} at env step "
              f"{init_state.batch_steps * args.num_envs}")
    logger = MetricLogger(args.tensorboard_dir)
    try:
        return trainer.train(seed=args.seed, progress=logger, init_state=init_state)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
