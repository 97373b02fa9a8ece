"""Bilinear sampling and the video models' warps: counterpart of
``trainner_tpu/ops/warp.py`` (``grid_sample:15``, ``flow_warp_vsr:77``,
``flow_warp_pix:94``).

``grid_sample`` is ``torch.nn.functional.grid_sample`` on NHWC tensors
(bilinear, ``border`` or ``zeros`` padding, ``align_corners`` either way),
which AdaTarget samples its target patches with.

The warps of the video models gather the four taps themselves, as the JAX
package does (``sample_bilinear``): floor of the source position, the taps'
indices clipped to the image, ``zeros`` padding masking each tap outside
it. So a gradient reaches the flow through the interpolation weights
alone, each output element writing its own: when the image needs no
gradient (SOF-VSR warps its input frames and HR targets) the backward
adds nothing with atomics, and a graphed step equals its eager run bit
for bit. A gradient to the image goes through ``torch.gather``'s backward
(a scatter-add, which adds with atomics on the card: EDVR's and RIFE's
feature warps, ROADMAP C 25).
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


def sample_bilinear(image: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                    padding_mode: str = "border") -> torch.Tensor:
    """The NHWC ``image`` (b, h, w, c) at pixel positions ``fx``, ``fy``
    (b, h_out, w_out): the JAX ``grid_sample``'s four gathered taps, their
    indices clipped to the image; with ``zeros`` each tap outside the
    image adds nothing. The weights are in the image's type."""
    if padding_mode not in ("border", "zeros"):
        raise NotImplementedError(f"padding_mode [{padding_mode}]")
    b, h, w, c = image.shape
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx = (fx - x0).to(image.dtype)[..., None]
    wy = (fy - y0).to(image.dtype)[..., None]
    flat = image.reshape(b, h * w, c)
    out_hw = fx.shape[1:]

    def tap(yy, xx):
        # the indices clipped in the positions' type, as the JAX package
        # clips them: in bf16 past 256 px w - 1 may round up to w, which
        # reads the next row; the flat index is then clipped to the image,
        # as JAX's gather clips it (``torch.gather`` would fail), and a NaN
        # position reads 0 (its weights are NaN, and so is the output)
        yi = yy.nan_to_num(0.0).clamp(0, h - 1).long()
        xi = xx.nan_to_num(0.0).clamp(0, w - 1).long()
        idx = (yi * w + xi).clamp(0, h * w - 1)
        idx = idx.reshape(b, -1, 1).expand(-1, -1, c)
        v = torch.gather(flat, 1, idx).reshape(b, *out_hw, c)
        if padding_mode == "zeros":
            inside = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
            v = v * inside[..., None].to(v.dtype)
        return v

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def flow_warp_vsr(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """SOF-VSR's warp: the normalised grid (``linspace(-1, 1)``) plus the
    flow times 31 / (dim - 1), border padding, corners aligned.

    image: (b, h, w, c); flow: (b, h, w, 2), (x, y) components."""
    b, h, w, _ = image.shape
    dev = image.device
    xs = torch.linspace(-1.0, 1.0, w, device=dev)
    ys = torch.linspace(-1.0, 1.0, h, device=dev)
    gx = xs[None, None, :] + flow[..., 0] * (31.0 / (w - 1))
    gy = ys[None, :, None] + flow[..., 1] * (31.0 / (h - 1))
    return sample_bilinear(image, (gx + 1.0) * 0.5 * (w - 1),
                           (gy + 1.0) * 0.5 * (h - 1), "border")


def flow_warp_pix(image: torch.Tensor, flow: torch.Tensor,
                  padding_mode: str = "zeros") -> torch.Tensor:
    """EDVR's and RIFE's warp: the flow in pixels added to the pixel grid,
    normalised to [-1, 1] and sampled with corners aligned, ``zeros`` or
    ``border`` padding.

    image: (b, h, w, c); flow: (b, h, w, 2), (x, y) offsets in pixels."""
    b, h, w, _ = image.shape
    dev = image.device
    xs = torch.arange(w, dtype=flow.dtype, device=dev)
    ys = torch.arange(h, dtype=flow.dtype, device=dev)
    px = xs[None, None, :] + flow[..., 0]
    py = ys[None, :, None] + flow[..., 1]
    gx = 2.0 * px / max(w - 1, 1) - 1.0
    gy = 2.0 * py / max(h - 1, 1) - 1.0
    return sample_bilinear(image, (gx + 1.0) * 0.5 * (w - 1),
                           (gy + 1.0) * 0.5 * (h - 1), padding_mode)
