"""Train SAC+HER on the port's batched goal-conditioned envs.

The counterpart of the JAX package's `scripts/train_sac_her.py`, with the
same flags plus --max-contacts and --device.  The goal curriculum
(near-cube goals for the first --curriculum-steps total env steps, then the
bin interior) runs on the device with the env batch.

  python -m gym_so100_tpu_torch.scripts.train_sac_her --num-envs 256 --utd 16 \
      --near-cube-only --goal-min-dist 0.02 --total-steps 1000000 \
      --checkpoint-dir runs/her
"""

from __future__ import annotations

import argparse

from ..agents.metrics import MetricLogger
from ..agents.sac import SACConfig
from ..agents.train_her import GOAL_DIM, HERConfig, HERTrainer


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=32)
    p.add_argument("--total-steps", type=int, default=200_000)
    p.add_argument("--learning-starts", type=int, default=1_000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--her-episodes", type=int, default=256)
    p.add_argument("--her-ratio", type=float, default=0.8)    # n_sampled_goal=4
    p.add_argument("--utd", type=int, default=1,
                   help="gradient updates per env-batch step")
    p.add_argument("--curriculum-steps", type=int, default=5_000)
    p.add_argument(
        "--near-cube-only", action="store_true",
        help="keep the near-cube goal curriculum for the whole run (default: "
        "bin goals after --curriculum-steps, as the reference)",
    )
    p.add_argument("--distance-threshold", type=float, default=0.01,
                   help="success radius in meters")
    p.add_argument(
        "--goal-min-dist", type=float, default=0.0,
        help="push sampled goals at least this far from the cube's rest site, "
        "so that no episode succeeds without moving the cube (0 = the "
        "reference behavior)",
    )
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=20_000)
    p.add_argument("--resume", default=None, help="checkpoint path to restore")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--hull-contacts", action=argparse.BooleanOptionalAction, default=True,
        help="full contact set (default; --no-hull-contacts drops the arm-mesh "
        "pairs)",
    )
    p.add_argument("--max-contacts", type=int, default=32,
                   help="contact slots per env (K) of the scene")
    p.add_argument("--tensorboard-dir", default=None,
                   help="write TensorBoard scalars here in addition to stdout JSON")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch paths")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    trainer = HERTrainer(
        None,
        HERConfig(
            num_envs=args.num_envs,
            total_steps=args.total_steps,
            learning_starts=args.learning_starts,
            her_episodes=args.her_episodes,
            her_ratio=args.her_ratio,
            utd=args.utd,
            curriculum_steps=(1 << 30) if args.near_cube_only else args.curriculum_steps,
            distance_threshold=args.distance_threshold,
            goal_min_dist=args.goal_min_dist,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            hull_contacts=args.hull_contacts,
            max_contacts=args.max_contacts,
        ),
        SACConfig(obs_dim=15 + GOAL_DIM, act_dim=6, lr=args.lr, buffer_size=1,
                  batch_size=args.batch_size),
        device=args.device,
    )
    init_state = None
    if args.resume:
        init_state = trainer.restore(args.resume)
        print(f"resumed from {args.resume} at env step {init_state.genv.total}")
    logger = MetricLogger(args.tensorboard_dir)
    try:
        return trainer.train(seed=args.seed, progress=logger, init_state=init_state)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
