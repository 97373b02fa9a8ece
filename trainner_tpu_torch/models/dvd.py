"""DVDNet, the deinterlacer: counterpart of ``trainner_tpu/models/dvd.py``
(``vertical_upscale:22``, ``replace_field:31``, ``DVDNet:44``).

A shared trunk (``fea1``, ``fea2``: 3x3 convs with ReLU; ``fea3``: a 1x1
conv to nf / 2) feeds two branches, each a 3x3 conv and a stride-(2, 1)
3x3 conv (``final_top``, ``final_bottom``) that predicts the missing field
at half height. ``replace_field`` interleaves a predicted field with the
field the input keeps: the top frame takes the input's even rows and the
prediction on its odd rows, the bottom frame the prediction on its even
rows and the input's odd rows. The interleaves are stacks and reshapes,
exact copies of rows in any type.

Takes and returns NHWC like the JAX module: the convs run on cuDNN in
``dtype`` (parameters f32); each frame is the sum of the two interleaves,
in the wider of ``dtype`` and the input's type, as jnp promotes it (the
kept field exact). Module names are the flax ones (``named_flax_paths``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tensor
from ..ops.blocks import _Conv, lecun_init, named_flax_paths


def vertical_upscale(x: torch.Tensor, upfield: bool = True
                     ) -> torch.Tensor:
    """(b, h, w, c) -> (b, 2h, w, c) with zero rows between: the data on
    the even rows if ``upfield``, else on the odd rows."""
    z = torch.zeros_like(x)
    pair = (x, z) if upfield else (z, x)
    b, h, w, c = x.shape
    return torch.stack(pair, dim=2).reshape(b, 2 * h, w, c)


def replace_field(x: torch.Tensor, input_image: torch.Tensor,
                  upfield: bool = True) -> torch.Tensor:
    """A predicted half-height field ``x`` interleaved with the field of
    ``input_image`` that is kept: its even rows with ``upfield``, else its
    odd rows."""
    if upfield:
        return vertical_upscale(x, upfield=False) + \
            vertical_upscale(input_image[:, 0::2], upfield=True)
    return vertical_upscale(x, upfield=True) + \
        vertical_upscale(input_image[:, 1::2], upfield=False)


class _FieldConv(_Conv):
    """flax's ``nn.Conv`` with a bias, symmetric zero padding of (k - 1) //
    2 and ``stride`` (a pair: the branches' last convs step 2 down the
    rows and 1 across)."""

    def __init__(self, in_nc: int, out_nc: int, k: int,
                 stride: Tuple[int, int] = (1, 1)):
        super().__init__(in_nc, out_nc, k, True)
        self.stride = stride

    def forward(self, x):
        return tensor.apply(self, x, lambda x, w, b: F.conv2d(
            x, w, b, stride=self.stride, padding=(w.shape[-1] - 1) // 2))


class DVDNet(nn.Module):
    """x (b, h, w, in_nc), h even -> (top frame, bottom frame), each (b,
    h, w, out_nc)."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        half = nf // 2
        self.fea1 = _FieldConv(in_nc, nf, 3)
        self.fea2 = _FieldConv(nf, nf, 3)
        self.fea3 = _FieldConv(nf, half, 1)
        self.branch_top = _FieldConv(half, half, 3)
        self.final_top = _FieldConv(half, out_nc, 3, (2, 1))
        self.branch_bottom = _FieldConv(half, half, 3)
        self.final_bottom = _FieldConv(half, out_nc, 3, (2, 1))

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_init(self, generator)

    def flax_paths(self) -> Dict[str, tuple]:
        return named_flax_paths(self)

    def forward(self, x):
        v = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        h = F.relu(self.fea1(v))
        h = F.relu(self.fea2(h))
        h = self.fea3(h)
        y = self.final_top(self.branch_top(h)).permute(0, 2, 3, 1)
        z = self.final_bottom(self.branch_bottom(h)).permute(0, 2, 3, 1)
        return replace_field(y, x, upfield=True), \
            replace_field(z, x, upfield=False)
