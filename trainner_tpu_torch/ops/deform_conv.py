"""Modulated deformable convolution (DCNv2) of EDVR's PCD alignment.

Counterpart of ``trainner_tpu/ops/deform_conv.py``
(``_bilinear_group_sample:28``, ``modulated_deform_conv2d:62``,
``DCNv2Pack:108``), built as the JAX package builds it, in plain PyTorch:
for each of the k x k taps, one bilinear gather per deformable group at
the offset positions (``ops/warp.py::sample_bilinear`` with zeros
padding: taps outside the image add nothing), times the tap's modulation; the taps stacked and contracted against the kernel in
one matmul. Stride 1, SAME padding. No CUDA kernel of the repo runs here;
a hand-written one is later kernel work (ROADMAP). The gathers' backward
to the features is ``torch.gather``'s scatter-add, which adds with atomics
on the card (ROADMAP C 25).

Offsets: channel ((g k² + tap) 2 + {dy, dx}), the layout torchvision's op
reads and DCNv2Pack's concatenation of its two offset halves gives.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .blocks import Conv, conv_nhwc
from .warp import sample_bilinear


def modulated_deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                            mask: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            kernel_size: Tuple[int, int] = (3, 3),
                            deformable_groups: int = 1) -> torch.Tensor:
    """DCNv2, stride 1, SAME padding, NHWC.

    x: (b, h, w, c_in); offset: (b, h, w, G kh kw 2), (dy, dx) per (group,
    tap); mask: (b, h, w, G kh kw); weight: (c_out, c_in, kh, kw), torch's
    layout. The contraction accumulates in f32 and is cast to x's type."""
    b, h, w, c = x.shape
    kh, kw = kernel_size
    G = deformable_groups
    taps = kh * kw
    cg = c // G
    # each deformable group as an image of its own: (b G, h, w, c / G),
    # its positions (b G, h, w)
    off = offset.reshape(b, h, w, G, taps, 2).permute(0, 3, 1, 2, 4, 5
                                                       ).reshape(
        b * G, h, w, taps, 2)
    msk = mask.reshape(b, h, w, G, taps).permute(0, 3, 1, 2, 4)
    x_g = x.reshape(b, h, w, G, cg).permute(0, 3, 1, 2, 4).reshape(
        b * G, h, w, cg)
    dev = x.device
    base_y = torch.arange(h, dtype=off.dtype, device=dev)[None, :, None]
    base_x = torch.arange(w, dtype=off.dtype, device=dev)[None, None, :]
    cols = []
    for k in range(taps):
        ky, kx = divmod(k, kw)
        py = base_y + (ky - (kh - 1) // 2) + off[..., k, 0]
        px = base_x + (kx - (kw - 1) // 2) + off[..., k, 1]
        v = sample_bilinear(x_g, px, py, "zeros").reshape(b, G, h, w, cg)
        v = v * msk[..., k, None].to(v.dtype)
        cols.append(v.permute(0, 2, 3, 1, 4).reshape(b, h, w, c))
    col = torch.stack(cols, 3).reshape(b * h * w, taps * c)
    # (c_out, c_in, kh, kw) -> (taps c_in, c_out), the stacked taps' order
    w_mat = weight.permute(2, 3, 1, 0).reshape(taps * c, -1)
    out = (col.float() @ w_mat.float()).reshape(b, h, w, -1).to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


class DCNv2Pack(nn.Module):
    """Deformable alignment: offsets and modulation predicted from
    ``feat`` by ``conv_offset`` (zero at init, so training starts as a
    plain conv at modulation 0.5), then DCNv2 of ``x`` with ``weight``
    (flax's ``kernel``) and ``bias``. NHWC in and out, in x's type; the
    offsets in f32."""

    def __init__(self, in_nc: int, features: int, feat_nc: int,
                 kernel_size: int = 3, deformable_groups: int = 8):
        super().__init__()
        k = kernel_size
        n = deformable_groups * k * k
        self.k, self.G = k, deformable_groups
        self.conv_offset = Conv(feat_nc, 3 * n, k)
        self.weight = nn.Parameter(torch.zeros(features, in_nc, k, k))
        self.bias = nn.Parameter(torch.zeros(features))

    def flax_leaves(self) -> dict:
        return {"weight": ("kernel", "conv"), "bias": ("bias", "vec")}

    def forward(self, x, feat):
        n = self.G * self.k * self.k
        # f32 whatever x's type: the JAX module builds DCNv2Pack at its
        # default dtype
        om = conv_nhwc(self.conv_offset, feat, torch.float32)
        offset, m = om[..., :2 * n], om[..., 2 * n:]
        return modulated_deform_conv2d(
            x, offset, torch.sigmoid(m), self.weight.to(x.dtype), self.bias,
            kernel_size=(self.k, self.k), deformable_groups=self.G)
