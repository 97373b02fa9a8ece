"""PSNR and SSIM of a folder of SR images against a folder of ground
truths, paired by name (``name`` or ``name_rlt``), on RGB and on Y, the
port's counterpart of ``scripts/calculate_psnr_ssim.py``
(``utils/metrics.py::MetricsDict``), on the host.

Usage: python -m trainner_tpu_torch.scripts.calculate_psnr_ssim GT_DIR
       SR_DIR [--scale 4]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

from ..data.common import read_img, scan_images
from ..utils.metrics import MetricsDict


def main(argv: Optional[list] = None) -> Dict[str, Dict[str, float]]:
    """Prints each pair's scores and the averages; returns the averages
    by ``RGB`` and ``Y``."""
    p = argparse.ArgumentParser()
    p.add_argument("gt_dir")
    p.add_argument("sr_dir")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--y_only", action="store_true")
    args = p.parse_args(argv)
    sr_by_name = {os.path.splitext(os.path.basename(q))[0]: q
                  for q in scan_images(args.sr_dir)}
    rgb, ych = MetricsDict("psnr,ssim"), MetricsDict("psnr,ssim")
    n = 0
    for gp in scan_images(args.gt_dir):
        name = os.path.splitext(os.path.basename(gp))[0]
        sp = sr_by_name.get(name) or sr_by_name.get(name + "_rlt")
        if sp is None:
            continue
        gt, sr = read_img(gp), read_img(sp)
        h = min(gt.shape[0], sr.shape[0])
        w = min(gt.shape[1], sr.shape[1])
        gt, sr = gt[:h, :w], sr[:h, :w]
        r = rgb.calculate_metrics(sr, gt, crop_size=args.scale)
        y = ych.calculate_metrics(sr, gt, crop_size=args.scale, only_y=True)
        n += 1
        print(f"{n:4d} {name:30s} PSNR: {r['psnr']:.4f} dB  "
              f"SSIM: {r['ssim']:.6f}  PSNR_Y: {y['psnr']:.4f} dB  "
              f"SSIM_Y: {y['ssim']:.6f}")
    out = {}
    for tag, m in (("RGB", rgb), ("Y", ych)):
        avg = {a["name"]: a["average"] for a in m.get_averages()}
        if avg:
            out[tag] = avg
            print(f"Average {tag}: PSNR: {avg['psnr']:.4f} dB, "
                  f"SSIM: {avg['ssim']:.6f}")
    return out


if __name__ == "__main__":
    main()
