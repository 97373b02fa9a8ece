"""Pixel criteria: counterpart of ``trainner_tpu/losses/basic.py`` (the
``PIXEL_CRITERIA`` table ``:95-108``, ``masked_l1:62``,
``multiscale_pixel:80``, ``get_pixel_criterion:111``). NHWC tensors; every
criterion reduces to a scalar mean."""

from __future__ import annotations

from functools import partial
from typing import Callable, Sequence

import torch
import torch.nn.functional as F


def l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().mean()


def mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((x - y) ** 2).mean()


def charbonnier(x: torch.Tensor, y: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """sqrt(diff^2 + eps), a robust L1."""
    return torch.sqrt((x - y) ** 2 + eps).mean()


def elastic(x: torch.Tensor, y: torch.Tensor, a: float = 0.2
            ) -> torch.Tensor:
    """a * L2 + (1 - a) * L1."""
    return a * mse(x, y) + (1 - a) * l1(x, y)


def relative_l1(x: torch.Tensor, y: torch.Tensor, eps: float = 0.01
                ) -> torch.Tensor:
    """L1 divided by the target's magnitude."""
    return ((x - y).abs() / (y.abs() + eps)).mean()


def l1_cosine_sim(x: torch.Tensor, y: torch.Tensor,
                  loss_lambda: float = 5.0) -> torch.Tensor:
    """L1 plus the colour angle: 1 - cosine over the channel axis."""
    xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)
    yn = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + 1e-8)
    cos = (xn * yn).sum(-1)
    return l1(x, y) + loss_lambda * (1.0 - cos).mean()


def clip_l1(x: torch.Tensor, y: torch.Tensor, clip_min: float = 0.0,
            clip_max: float = 10.0) -> torch.Tensor:
    """L1 with each difference clipped to [clip_min, clip_max]."""
    return (x - y).abs().clamp(clip_min, clip_max).mean()


def masked_l1(x: torch.Tensor, y: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    return ((x - y).abs() * mask).sum() / mask.sum().clamp_min(1.0)


def frobenius(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The L2 norm of the whole difference over the channel count."""
    return torch.linalg.vector_norm((x - y).reshape(-1)) / x.shape[-1]


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling of NHWC, VALID (an odd last row or column is
    dropped)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def multiscale_pixel(x: torch.Tensor, y: torch.Tensor, base: Callable = l1,
                     weights: Sequence[float] = (1, 0.5, 0.25, 0.125, 0.125),
                     scales: int = 5) -> torch.Tensor:
    """``base`` at ``scales`` successive 2x downscales, weighted."""
    total = 0.0
    for i in range(scales):
        total = total + weights[i] * base(x, y)
        if i != scales - 1:
            x, y = _avg_pool2(x), _avg_pool2(y)
    return total


PIXEL_CRITERIA = {
    "l1": l1,
    "l2": mse,
    "mse": mse,
    "cb": charbonnier,
    "charbonnier": charbonnier,
    "elastic": elastic,
    "relativel1": relative_l1,
    "relative": relative_l1,
    "l1cosinesim": l1_cosine_sim,
    "clipl1": clip_l1,
    "fro": frobenius,
    "frobenius": frobenius,
}


def get_pixel_criterion(name: str) -> Callable:
    """A criterion by name, case, '-' and '_' ignored; 'multiscale<name>'
    is ``multiscale_pixel`` over it (l1 when the name is bare)."""
    key = (name or "l1").lower().replace("-", "").replace("_", "")
    if key.startswith("multiscale"):
        inner = key.replace("multiscale", "") or "l1"
        return partial(multiscale_pixel, base=PIXEL_CRITERIA[inner])
    if key not in PIXEL_CRITERIA:
        raise NotImplementedError(f"pixel criterion [{name}] not found")
    return PIXEL_CRITERIA[key]
