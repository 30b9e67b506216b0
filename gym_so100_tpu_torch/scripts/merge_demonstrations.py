"""Concatenate demo pickle files (the JAX package's
`scripts/merge_demonstrations.py`; host Python).

  python -m gym_so100_tpu_torch.scripts.merge_demonstrations a.pkl b.pkl --out all.pkl
"""

from __future__ import annotations

import argparse
import pickle


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("inputs", nargs="+")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    merged = []
    for path in args.inputs:
        with open(path, "rb") as f:
            eps = pickle.load(f)
        merged.extend(eps)
        print(f"{path}: {len(eps)} episodes")
    with open(args.out, "wb") as f:
        pickle.dump(merged, f)
    print(f"wrote {len(merged)} episodes to {args.out}")


if __name__ == "__main__":
    main()
