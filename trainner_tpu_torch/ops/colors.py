"""Colour conversions on [0, 1] NHWC tensors.

Counterpart of ``trainner_tpu/ops/colors.py``: ``rgb_to_grayscale:19``,
``rgb_to_yuv:24`` and ``yuv_to_rgb:49`` (BT.601), ``rgb_to_ycbcr:62`` and
``ycbcr_to_rgb:74`` (MATLAB's rgb2ycbcr), ``srgb_to_linear:84``,
``linear_to_srgb:89`` and ``color_shift:94``, whose random weights are
drawn by ``draw_color_shift``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

# BT.601 luma coefficients
_KR, _KG, _KB = 0.299, 0.587, 0.114


def rgb_to_grayscale(x: torch.Tensor) -> torch.Tensor:
    r, g, b = x[..., 0:1], x[..., 1:2], x[..., 2:3]
    return _KR * r + _KG * g + _KB * b


def rgb_to_yuv(x: torch.Tensor, consts: str = "yuv") -> torch.Tensor:
    """RGB -> YUV: 'yuv' (the default) BT.601's analog form with chroma
    offset 0.5; 'yuvK' the offset-free matrix; 'ycbcr' the JPEG variant;
    'uv' only the chroma; 'y' only the luma."""
    r, g, b = x[..., 0:1], x[..., 1:2], x[..., 2:3]
    y = _KR * r + _KG * g + _KB * b
    if consts == "y":
        return y
    if consts == "yuvK":
        u = -0.147 * r - 0.289 * g + 0.436 * b
        v = 0.615 * r - 0.515 * g - 0.100 * b
        return torch.cat([y, u, v], dim=-1)
    uc, vc = (0.564, 0.713) if consts == "ycbcr" else (0.493, 0.877)
    u = (b - y) * uc + 0.5
    v = (r - y) * vc + 0.5
    if consts == "uv":
        return torch.cat([u, v], dim=-1)
    return torch.cat([y, u, v], dim=-1)


def yuv_to_rgb(x: torch.Tensor, consts: str = "yuv") -> torch.Tensor:
    y, u, v = x[..., 0:1], x[..., 1:2], x[..., 2:3]
    if consts == "yuvK":
        r = y + 1.14 * v
        g = y - 0.396 * u - 0.581 * v
        b = y + 2.029 * u
        return torch.cat([r, g, b], dim=-1)
    uc, vc = (0.564, 0.713) if consts == "ycbcr" else (0.493, 0.877)
    r = y + (v - 0.5) / vc
    b = y + (u - 0.5) / uc
    g = (y - _KR * r - _KB * b) / _KG
    return torch.cat([r, g, b], dim=-1)


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


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.04045, x / 12.92,
                       torch.pow(((x + 0.055) / 1.055).clamp_min(1e-8), 2.4))


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.0031308, x * 12.92,
                       1.055 * torch.pow(x.clamp_min(1e-8), 1 / 2.4) - 0.055)


def draw_color_shift(gen: torch.Generator, mode: str = "uniform"
                     ) -> Dict[str, torch.Tensor]:
    """The three random channel weights of one batch, 0-d tensors."""
    if mode == "normal":
        means = (0.299, 0.587, 0.114)
        return {k: torch.randn((), generator=gen, device=gen.device) * 0.1
                + m for k, m in zip(("r", "g", "b"), means)}
    lows = (0.199, 0.487, 0.014)
    return {k: torch.rand((), generator=gen, device=gen.device) * 0.2 + lo
            for k, lo in zip(("r", "g", "b"), lows)}


def color_shift(weights: Dict[str, torch.Tensor], img1: torch.Tensor,
                img2: torch.Tensor = None) -> Tuple:
    """The WBC random-weighted grayscale projection of one or two images
    with the weights of ``draw_color_shift``."""
    br, bg, bb = weights["r"], weights["g"], weights["b"]
    den = br + bg + bb

    def proj(img):
        return (img[..., 0:1] * br + img[..., 1:2] * bg
                + img[..., 2:3] * bb) / den

    if img2 is None:
        return (proj(img1),)
    return proj(img1), proj(img2)
