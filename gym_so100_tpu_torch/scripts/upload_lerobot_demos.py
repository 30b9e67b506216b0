"""Convert recorded demo pickles to a LeRobotDataset (optionally push).

The counterpart of the JAX package's `scripts/upload_lerobot_demos.py`
over the port's `interop/lerobot.py` (needs the `lerobot` package).

  python -m gym_so100_tpu_torch.scripts.upload_lerobot_demos demos/*.pkl \
      --repo-id user/so100 --push
"""

from __future__ import annotations

import argparse

from ..interop import lerobot as interop


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("demos", nargs="+", help="demo pickle files")
    p.add_argument("--repo-id", required=True)
    p.add_argument("--fps", type=int, default=50)
    p.add_argument("--push", action="store_true", help="push_to_hub after conversion")
    p.add_argument("--task-text", default="Put the red cube into the bin")
    args = p.parse_args(argv)

    ds = interop.demos_to_lerobot_dataset(
        args.demos, args.repo_id, fps=args.fps, push=args.push,
        task_text=args.task_text)
    print(f"dataset {args.repo_id}: {ds.num_episodes} episodes, "
          f"{ds.num_frames} frames" + ("  (pushed)" if args.push else ""))


if __name__ == "__main__":
    main()
