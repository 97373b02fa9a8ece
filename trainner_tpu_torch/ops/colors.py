"""Colour conversions: the part of ``trainner_tpu/ops/colors.py`` that the
test CLI's CEM post-processing runs (``rgb_to_ycbcr:62``,
``ycbcr_to_rgb:74``), MATLAB's rgb2ycbcr on [0, 1] NHWC tensors."""

from __future__ import annotations

import torch


def rgb_to_ycbcr(x: torch.Tensor, only_y: bool = False) -> torch.Tensor:
    r, g, b = x[..., 0:1], x[..., 1:2], x[..., 2:3]
    y = (65.481 * r + 128.553 * g + 24.966 * b + 16.0) / 255.0
    if only_y:
        return y
    cb = (-37.797 * r - 74.203 * g + 112.0 * b + 128.0) / 255.0
    cr = (112.0 * r - 93.786 * g - 18.214 * b + 128.0) / 255.0
    return torch.cat([y, cb, cr], dim=-1)


def ycbcr_to_rgb(x: torch.Tensor) -> torch.Tensor:
    y, cb, cr = x[..., 0:1] * 255.0, x[..., 1:2] * 255.0, x[..., 2:3] * 255.0
    r = (298.082 * y / 256.0 + 408.583 * cr / 256.0 - 222.921) / 255.0
    g = (298.082 * y / 256.0 - 100.291 * cb / 256.0 - 208.120 * cr / 256.0
         + 135.576) / 255.0
    b = (298.082 * y / 256.0 + 516.412 * cb / 256.0 - 276.836) / 255.0
    return torch.cat([r, g, b], dim=-1)
