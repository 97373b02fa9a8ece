"""Blends or randomly splices two checkpoints of one net, the port's
counterpart of ``scripts/net_splice.py``: ``-i alpha`` interpolates every
leaf (as ``net_interp``); ``-s prob`` takes each whole leaf from model B
with probability ``prob``, drawn from ``random.Random(seed)`` leaf after
leaf in the tree's sorted order, so a seed picks what the JAX tool
picks.

Usage: python -m trainner_tpu_torch.scripts.net_splice a.ckpt b.ckpt
       out.ckpt (-i 0.5 | -s 0.3 [--seed 0])
"""

from __future__ import annotations

import argparse
import random
from typing import Optional

from ..utils.checkpoint import load_tree, save_params, tree_map
from .net_interp import interpolate


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("model_a")
    p.add_argument("model_b")
    p.add_argument("out")
    p.add_argument("-i", "--interpolate", type=float, default=None,
                   help="linear interpolation alpha toward model B")
    p.add_argument("-s", "--splice", type=float, default=None,
                   help="probability of taking each tensor from model B")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if (args.interpolate is None) == (args.splice is None):
        raise SystemExit("pass exactly one of -i/--interpolate or "
                         "-s/--splice")
    a, b = load_tree(args.model_a), load_tree(args.model_b)
    if args.interpolate is not None:
        out = interpolate(a, b, args.interpolate)
        print(f"interpolated alpha={args.interpolate}")
    else:
        rng = random.Random(args.seed)
        taken = [0, 0]

        def pick(x, y):
            use_b = rng.random() < args.splice
            taken[use_b] += 1
            return y if use_b else x

        out = tree_map(pick, a, b)
        print(f"spliced: {taken[0]} tensors from A, {taken[1]} from B")
    save_params(out, args.out, backup=False)
    print(f"-> {args.out}")


if __name__ == "__main__":
    main()
