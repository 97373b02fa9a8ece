"""Cuts large training images into overlapping patches, the port's
counterpart of ``scripts/extract_subimgs.py``: ``crop_size`` squares at a
stride of ``step``, only whole ones, skipping near-flat patches when
``--threshold`` is given (std below threshold / 255), as
``{name}_s{idx:03d}.png``, on the host.

Usage: python -m trainner_tpu_torch.scripts.extract_subimgs SRC_DIR
       OUT_DIR [--crop_size 480] [--step 240] [--threshold T]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

from ..data.common import read_img, save_img, scan_images, tensor2img


def main(argv: Optional[list] = None) -> int:
    """Returns how many patches were written."""
    p = argparse.ArgumentParser()
    p.add_argument("src_dir")
    p.add_argument("out_dir")
    p.add_argument("--crop_size", type=int, default=480)
    p.add_argument("--step", type=int, default=240)
    p.add_argument("--threshold", type=float, default=None,
                   help="skip near-flat patches (std below threshold/255)")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    cs, st = args.crop_size, args.step
    total = 0
    for path in scan_images(args.src_dir):
        img = read_img(path)
        h, w = img.shape[:2]
        base = os.path.splitext(os.path.basename(path))[0]
        idx = 0
        ys = list(range(0, max(h - cs, 0) + 1, st)) or [0]
        xs = list(range(0, max(w - cs, 0) + 1, st)) or [0]
        for y in ys:
            for x in xs:
                patch = img[y:y + cs, x:x + cs]
                if patch.shape[0] < cs or patch.shape[1] < cs:
                    continue
                if args.threshold and patch.std() < args.threshold / 255:
                    continue
                idx += 1
                save_img(tensor2img(patch), os.path.join(
                    args.out_dir, f"{base}_s{idx:03d}.png"))
        total += idx
    print(f"extracted {total} patches -> {args.out_dir}")
    return total


if __name__ == "__main__":
    main()
