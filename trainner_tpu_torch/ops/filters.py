"""Image filters: the part of ``trainner_tpu/ops/filters.py`` that the test
CLI's CEM post-processing runs (``separable_filter2d:159``,
``_box_filter:210``, ``guided_filter:218``), on NHWC tensors."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def separable_filter2d(x: torch.Tensor, k1d,
                       pad_mode: str = "reflect") -> torch.Tensor:
    """A 1-D kernel along H, then along W, per channel, each after a
    ``pad_mode`` padding of (n-1)//2 before and the rest after."""
    k = torch.as_tensor(k1d, dtype=x.dtype, device=x.device)
    n, c = k.shape[0], x.shape[-1]
    pad = (n - 1) // 2
    y = x.permute(0, 3, 1, 2)
    y = F.pad(y, (0, 0, pad, n - 1 - pad), mode=pad_mode)
    y = F.conv2d(y, k.reshape(1, 1, n, 1).expand(c, 1, n, 1), groups=c)
    y = F.pad(y, (pad, n - 1 - pad, 0, 0), mode=pad_mode)
    y = F.conv2d(y, k.reshape(1, 1, 1, n).expand(c, 1, 1, n), groups=c)
    return y.permute(0, 2, 3, 1)


def _box_filter(x: torch.Tensor, r: int) -> torch.Tensor:
    """The mean over a (2r+1)^2 window, reflect-padded."""
    size = 2 * r + 1
    return separable_filter2d(x, [1.0 / size] * size, pad_mode="reflect")


def guided_filter(guide: torch.Tensor, src: torch.Tensor, radius: int = 1,
                  eps: float = 1e-2) -> torch.Tensor:
    """He et al.'s edge-preserving guided filter, each channel guided by
    its own."""
    mean_i = _box_filter(guide, radius)
    mean_p = _box_filter(src, radius)
    cov_ip = _box_filter(guide * src, radius) - mean_i * mean_p
    var_i = _box_filter(guide * guide, radius) - mean_i * mean_i
    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i
    return _box_filter(a, radius) * guide + _box_filter(b, radius)
