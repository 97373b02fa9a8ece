"""DNI network interpolation: blends two checkpoints of one net, the
port's counterpart of ``scripts/net_interp.py``:
theta = alpha * theta_b + (1 - alpha) * theta_a, leaf by leaf, in each
leaf's own type, on the host.

Usage: python -m trainner_tpu_torch.scripts.net_interp psnr.ckpt gan.ckpt
       out.ckpt [--alpha 0.8]
"""

from __future__ import annotations

import argparse
from typing import Optional

from ..utils.checkpoint import load_tree, save_params, tree_map


def interpolate(a, b, alpha: float):
    """The blend of two param trees of one structure."""
    return tree_map(lambda x, y: (1.0 - alpha) * x + alpha * y, a, b)


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("model_a", help="base model (alpha=0 end, e.g. PSNR)")
    p.add_argument("model_b", help="target model (alpha=1 end, e.g. GAN)")
    p.add_argument("out")
    p.add_argument("--alpha", type=float, default=0.8)
    args = p.parse_args(argv)
    out = interpolate(load_tree(args.model_a), load_tree(args.model_b),
                      args.alpha)
    save_params(out, args.out, backup=False)
    print(f"interpolated (alpha={args.alpha}) -> {args.out}")


if __name__ == "__main__":
    main()
