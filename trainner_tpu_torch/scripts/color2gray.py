"""Converts a folder of colour images to grey PNGs of their luma, the
port's counterpart of ``scripts/color2gray.py``: each image read as
three channels (a grey one repeated, alpha dropped), its BT.601 Y
(``data/common.py::rgb2ycbcr``) written as an 8-bit PNG of the same
name, on the host, in ``--workers`` processes.

Usage: python -m trainner_tpu_torch.scripts.color2gray INPUT SAVE
       [--workers 8]
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
from typing import Optional, Tuple

import numpy as np

from ..data.common import decode_image, rgb2ycbcr, save_img

EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tif", ".tiff")


def _rgb8(path: str) -> Optional[np.ndarray]:
    """The image as 8-bit RGB, as OpenCV's colour read gives it (its
    order reversed): None where it cannot be read."""
    try:
        img = decode_image(path)
    except (IOError, ValueError, ImportError):
        return None
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return img[:, :, :3]


def convert(job: Tuple[str, str]) -> str:
    src, dst = job
    img = _rgb8(src)
    if img is None:
        return f"skip (unreadable): {src}"
    y = rgb2ycbcr(img.astype(np.float32) / 255.0, only_y=True)
    save_img(np.clip(y * 255.0 + 0.5, 0, 255).astype(np.uint8), dst)
    return os.path.basename(dst)


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("input")
    p.add_argument("save")
    p.add_argument("--workers", type=int, default=8)
    args = p.parse_args(argv)
    os.makedirs(args.save, exist_ok=True)
    jobs = [(os.path.join(args.input, f),
             os.path.join(args.save, os.path.splitext(f)[0] + ".png"))
            for f in sorted(os.listdir(args.input))
            if f.lower().endswith(EXTS)]
    if not jobs:
        raise SystemExit(f"no images in {args.input}")
    if args.workers <= 1:
        for job in jobs:
            print(convert(job))
    else:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.workers) as pool:
            for msg in pool.imap_unordered(convert, jobs):
                print(msg)
    print(f"done: {len(jobs)} images -> {args.save}")


if __name__ == "__main__":
    main()
