"""The white-box cartoonization U-Net: counterpart of
``trainner_tpu/models/wbcunet.py`` (``tf_same_padding:31``,
``tf_2x_bilinear:38``, ``WBCResBlock:54``, ``UnetGeneratorWBC:71``).

A 7x7 stem (``conv``), two stride-2 3x3 downs each followed by a 3x3 conv
(``conv_1`` .. ``conv_4``, the channels doubling), four residual blocks
(``block_{i}``: conv1, LeakyReLU, conv2, plus the input), ``conv_5``, then
two 2x bilinear ups, each added to the skip of its scale and followed by
two convs (``conv_6``, ``conv_7``; ``conv_8``), and a 7x7 head
(``conv_9``); LeakyReLU 0.2 after every conv but the blocks' second and
the head. ``mode: pt`` pads the downs' convs by 1 on each side and
upsamples with torch's half-pixel bilinear (``ops/blocks.py::
resize_torch``'s contractions, whose backward adds in a fixed order);
``mode: tf`` pads them TF's SAME way (0 before, 1 after) and upsamples as
TF did: even positions copy the input, odd ones are the mean of the pixel
and its next neighbour down, right, or diagonally (a two-tap mean, as the
JAX module has it), the last row and column repeated.

Takes and returns NHWC like the JAX module: the convs run on cuDNN in
``dtype`` (parameters f32), the output comes back in ``dtype``. Module
names are the flax ones (``named_flax_paths``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tensor
from ..ops.blocks import _Conv, lecun_init, named_flax_paths, resize_torch


def tf_same_padding(x: torch.Tensor, k_size: int = 3) -> torch.Tensor:
    """TF's SAME padding before a stride-2 conv of an NCHW map: k // 2 - 1
    zeros before, k // 2 after, on h and w."""
    j = k_size // 2
    return F.pad(x, (j - 1, j, j - 1, j))


def _edge_next(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Each element's next neighbour along ``dim`` (the last repeated), as
    a slice and a concatenation: its backward adds in a fixed order."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)],
                     dim)


def tf_2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """The JAX module's TF-parity 2x upsample of an NHWC tensor:
    out[2i, 2j] = x[i, j]; out[2i, 2j+1] the mean with the right
    neighbour, out[2i+1, 2j] with the one below, out[2i+1, 2j+1] with the
    diagonal one; edges repeated."""
    b, h, w, c = x.shape
    down = _edge_next(x, 1)
    right = _edge_next(x, 2)
    diag = _edge_next(down, 2)
    tr = (x + right) / 2
    bl = (x + down) / 2
    br = (x + diag) / 2
    top = torch.stack([x, tr], dim=3).reshape(b, h, 2 * w, c)
    bot = torch.stack([bl, br], dim=3).reshape(b, h, 2 * w, c)
    return torch.stack([top, bot], dim=2).reshape(b, 2 * h, 2 * w, c)


class _WConv(_Conv):
    """flax's ``nn.Conv`` with a bias: k x k, ``stride``, symmetric zero
    padding ``pad``."""

    def __init__(self, in_nc: int, out_nc: int, k: int = 3, stride: int = 1,
                 pad: int = None):
        super().__init__(in_nc, out_nc, k, True, stride)
        self.pad = (k - 1) // 2 if pad is None else pad

    def forward(self, x):
        return tensor.apply(self, x, lambda x, w, b: F.conv2d(
            x, w, b, stride=self.stride, padding=self.pad))


class WBCResBlock(nn.Module):
    """conv1, LeakyReLU, conv2, plus the input."""

    def __init__(self, nf: int, slope: float = 0.2):
        super().__init__()
        self.slope = slope
        self.conv1 = _WConv(nf, nf)
        self.conv2 = _WConv(nf, nf)

    def forward(self, x):
        return self.conv2(F.leaky_relu(self.conv1(x), self.slope)) + x


class UnetGeneratorWBC(nn.Module):
    """x (b, h, w, 3), h and w multiples of 4 -> (b, h, w, 3) in
    ``dtype``."""

    def __init__(self, nf: int = 32, mode: str = "pt", slope: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.mode, self.slope = dtype, mode, slope
        tf = mode == "tf"
        down_pad = 0 if tf else 1
        self.conv = _WConv(3, nf, 7)
        self.conv_1 = _WConv(nf, nf, 3, 2, down_pad)
        self.conv_2 = _WConv(nf, nf * 2)
        self.conv_3 = _WConv(nf * 2, nf * 2, 3, 2, down_pad)
        self.conv_4 = _WConv(nf * 2, nf * 4)
        for i in range(4):
            setattr(self, f"block_{i}", WBCResBlock(nf * 4, slope))
        self.conv_5 = _WConv(nf * 4, nf * 2)
        self.conv_6 = _WConv(nf * 2, nf * 2)
        self.conv_7 = _WConv(nf * 2, nf)
        self.conv_8 = _WConv(nf, nf)
        self.conv_9 = _WConv(nf, 3, 7)

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_init(self, generator)

    def flax_paths(self) -> Dict[str, tuple]:
        return named_flax_paths(self)

    def _up(self, x: torch.Tensor) -> torch.Tensor:
        """The 2x upsample of an NCHW (channels_last) map."""
        v = x.permute(0, 2, 3, 1)
        v = tf_2x_bilinear(v) if self.mode == "tf" else \
            resize_torch(v, scale=2, mode="bilinear")
        return v.permute(0, 3, 1, 2)

    def forward(self, x):
        act = lambda v: F.leaky_relu(v, self.slope)  # noqa: E731
        tf = self.mode == "tf"
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x0 = act(self.conv(x))
        x1 = act(self.conv_1(tf_same_padding(x0) if tf else x0))
        x1 = act(self.conv_2(x1))
        x2 = act(self.conv_3(tf_same_padding(x1) if tf else x1))
        x2 = act(self.conv_4(x2))
        for i in range(4):
            x2 = getattr(self, f"block_{i}")(x2)
        x2 = act(self.conv_5(x2))
        x3 = act(self.conv_6(self._up(x2) + x1))
        x3 = act(self.conv_7(x3))
        x4 = act(self.conv_8(self._up(x3) + x0))
        return self.conv_9(x4).permute(0, 2, 3, 1)
