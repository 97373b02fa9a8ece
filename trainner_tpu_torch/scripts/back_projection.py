"""Iterative back-projection of SR outputs against their LR inputs, the
port's counterpart of ``scripts/back_projection.py`` (the reference's
MATLAB ``backprojection.m`` and ``main_reverse_filter.m``) over the
port's MATLAB-parity resize (``ops/imresize.py::imresize``, bicubic,
antialiased), on the card unless ``--device cpu``:

* ``bp``: sr += conv(up(lr - down(sr)), p), p the normalised square of a
  5 x 5 sigma-1 gaussian, ``--iters`` times;
* ``if``: sr += up(lr) - up(down(sr)) (reverse filtering).

Pairs PNGs by name; reads and writes 8-bit images.

Usage: python -m trainner_tpu_torch.scripts.back_projection --lr LR_DIR
       --sr SR_DIR --out OUT [--mode bp|if] [--iters 20] [--scale 4]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.common import decode_image, save_img
from ..ops.imresize import imresize
from ..utils.device import resolve_device


def gauss_p() -> np.ndarray:
    """fspecial('gaussian', 5, 1) squared and renormalised."""
    g = np.arange(5.0) - 2.0
    k1 = np.exp(-0.5 * g * g)
    k = np.outer(k1, k1)
    k /= k.sum()
    k = k * k
    return (k / k.sum()).astype(np.float32)


def _conv_p(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The 5 x 5 kernel over each channel of an NHWC batch, zero-padded
    to the same size."""
    c = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), p.expand(c, 1, 5, 5), padding=2,
                 groups=c)
    return y.permute(0, 2, 3, 1)


@torch.no_grad()
def back_project(sr: torch.Tensor, lr: torch.Tensor, mode: str = "bp",
                 iters: int = 20, scale: int = 4) -> torch.Tensor:
    """``iters`` refinements of an NHWC f32 SR batch in [0, 1] against its
    LR batch, on their device."""
    if mode == "bp":
        p = torch.from_numpy(gauss_p()).to(sr.device)[None, None]
        lh, lw = lr.shape[1:3]
        hh, hw = sr.shape[1:3]
        for _ in range(iters):
            down = imresize(sr, out_shape=(lh, lw), kernel="cubic")
            diff = imresize(lr - down, out_shape=(hh, hw), kernel="cubic")
            sr = sr + _conv_p(diff, p)
        return sr
    j = imresize(lr, float(scale), kernel="cubic")
    for _ in range(iters):
        up = imresize(imresize(sr, 1.0 / scale, kernel="cubic"),
                      float(scale), kernel="cubic")
        sr = sr + (j - up)
    return sr


def _read(path: str) -> np.ndarray:
    img = decode_image(path)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    return img[:, :, :3].astype(np.float32)[None] / 255.0


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", required=True)
    ap.add_argument("--sr", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mode", choices=("bp", "if"), default="bp")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    names = sorted(os.path.basename(f)
                   for f in glob.glob(os.path.join(args.sr, "*.png")))
    for name in names:
        lr_path = os.path.join(args.lr, name)
        if not os.path.exists(lr_path):
            print(f"skip {name}: no LR pair", file=sys.stderr)
            continue
        lr = torch.from_numpy(_read(lr_path)).to(dev)
        sr = torch.from_numpy(_read(os.path.join(args.sr, name))).to(dev)
        out = back_project(sr, lr, args.mode, args.iters,
                           args.scale)[0].cpu().numpy()
        save_img(np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8),
                 os.path.join(args.out, name))
        print(name)


if __name__ == "__main__":
    main()
