"""Partial convolution (a mask-normalised conv, Liu et al. 2018).

Counterpart of ``trainner_tpu/ops/partial_conv.py`` (``PartialConv:28``):
the masked input is convolved with no bias, each output is renormalised by
k*k over the count of valid taps under its window, and the bias is added
where the window saw a valid pixel (elsewhere the output is 0). With no
mask the input is all valid, so the zero padding is the only invalid region
and the layer is a border-renormalised conv. ``ConvBlock(convtype=
"PartialConv2D")`` runs it with its own weight and bias; the padding is the
partial conv's own.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def partial_conv(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], stride: int = 1,
                 pad: int = 0, mask: Optional[torch.Tensor] = None,
                 return_mask: bool = False):
    """NCHW partial convolution of ``x`` with the OIHW ``weight``, run in
    x's type; ``mask`` (N or 1, 1, H, W), all ones when None. Returns the
    output, and with ``return_mask`` the updated mask (f32)."""
    k = weight.shape[-1]
    h, w = x.shape[-2:]
    if mask is None:
        mask = torch.ones((1, 1, h, w), dtype=torch.float32, device=x.device)
    else:
        mask = mask.float()
    x = x * mask.to(x.dtype)
    if pad:
        x = F.pad(x, (pad,) * 4)
        mask = F.pad(mask, (pad,) * 4)
    raw = F.conv2d(x, weight.to(x.dtype), None, stride=stride)
    with torch.no_grad():
        ones = torch.ones((1, 1, k, k), dtype=torch.float32,
                          device=x.device)
        mask_sum = F.conv2d(mask, ones, stride=stride)
        update = mask_sum.clamp(0.0, 1.0)
        ratio = (float(k * k) / mask_sum.clamp_min(1e-8)) * update
    out = raw * ratio.to(raw.dtype)
    if bias is not None:
        out = (out + bias.to(out.dtype)[None, :, None, None]) \
            * update.to(out.dtype)
    if return_mask:
        return out, update
    return out
