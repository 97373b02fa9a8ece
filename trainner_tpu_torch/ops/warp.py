"""Bilinear sampling: counterpart of ``trainner_tpu/ops/warp.py::
grid_sample:15``, which AdaTarget samples its target patches with.

The JAX package gathers the four taps itself; here
``torch.nn.functional.grid_sample`` computes the same function (bilinear,
``border`` or ``zeros`` padding, ``align_corners`` either way: with border
padding a tap off the image reads the edge, with zeros it adds nothing),
on NHWC tensors. The warps of the video models (``flow_warp_vsr``,
``flow_warp_pix``) wait for those models (ROADMAP Queue A 10.5).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(image: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = True,
                padding_mode: str = "border") -> torch.Tensor:
    """Samples the NHWC ``image`` at ``grid`` (b, h_out, w_out, 2), whose
    (x, y) are normalised to [-1, 1]; returns (b, h_out, w_out, c) in the
    image's type."""
    if padding_mode not in ("border", "zeros"):
        raise NotImplementedError(f"padding_mode [{padding_mode}]")
    out = F.grid_sample(image.permute(0, 3, 1, 2),
                        grid.to(image.dtype), mode="bilinear",
                        padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.permute(0, 2, 3, 1)
