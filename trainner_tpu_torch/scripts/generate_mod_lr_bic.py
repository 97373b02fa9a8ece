"""Makes the classic SR evaluation triplets from a folder of HR images,
the port's counterpart of ``scripts/generate_mod_lr_bic.py``: each image
cropped to a multiple of the scale (``HR_mod``), its MATLAB-bicubic
downscale (``LR_bicx{s}``) and that upscaled back (``Bic_x{s}``), with
``ops/imresize.py::imresize_np`` on the host.

Usage: python -m trainner_tpu_torch.scripts.generate_mod_lr_bic SRC_DIR
       OUT_DIR [--scale 4]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

from ..data.common import modcrop, read_img, save_img, scan_images, \
    tensor2img
from ..ops.imresize import imresize_np


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("src_dir")
    p.add_argument("out_dir")
    p.add_argument("--scale", type=int, default=4)
    args = p.parse_args(argv)
    s = args.scale
    hr_dir = os.path.join(args.out_dir, "HR_mod")
    lr_dir = os.path.join(args.out_dir, f"LR_bicx{s}")
    bic_dir = os.path.join(args.out_dir, f"Bic_x{s}")
    for d in (hr_dir, lr_dir, bic_dir):
        os.makedirs(d, exist_ok=True)
    paths = scan_images(args.src_dir)
    for i, path in enumerate(paths):
        name = os.path.basename(path)
        hr = modcrop(read_img(path), s)
        lr = imresize_np(hr, 1.0 / s)
        bic = imresize_np(lr, float(s))
        save_img(tensor2img(hr), os.path.join(hr_dir, name))
        save_img(tensor2img(lr), os.path.join(lr_dir, name))
        save_img(tensor2img(bic), os.path.join(bic_dir, name))
        if (i + 1) % 50 == 0:
            print(f"{i + 1}/{len(paths)}")
    print(f"done: {len(paths)} images -> {args.out_dir}")


if __name__ == "__main__":
    main()
