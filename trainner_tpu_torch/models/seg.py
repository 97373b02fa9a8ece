"""The outdoor-scene segmentation net (SFTGAN's segmentation prior):
counterpart of ``trainner_tpu/models/seg.py`` (``Res131:23``,
``OutdoorSceneSeg:62``).

A dilated ResNet-101-like stack of 1-3-1 bottlenecks with batch norm
(stride 8 overall), a 512-channel 3x3 head with dropout 0.1 in train
mode, an ``n_classes`` 1x1 conv, the 8x grouped transposed conv (k16, s8,
p4, one group per class; its ``deconv_kernel`` is torch's (n_classes, 1,
16, 16) weight, flax's (16, 16, 1, n_classes) kernel transposed) and a
softmax over the classes. The batch norms' running statistics are
flax's (momentum 0.99, the biased variance) and are written once per
step by ``commit_stats`` (ROADMAP C 9's rule for a G's statistics).
Modules are NCHW in ``channels_last`` memory under the flax names
(``flax_paths``); ``forward`` takes and returns NHWC, f32 out.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import (BatchNorm, Conv, Dropout, lecun_init,
                          named_flax_paths)


class Res131(nn.Module):
    """1x1, 3x3 (stride, dilation), 1x1 convs without bias, each with a
    batch norm, ReLUs, and a projected skip where the shape changes."""

    def __init__(self, in_nc: int, mid_nc: int, out_nc: int,
                 dilation: int = 1, stride: int = 1):
        super().__init__()
        self.conv0 = Conv(in_nc, mid_nc, 1, use_bias=False)
        self.BatchNorm_0 = BatchNorm(mid_nc)
        self.conv1 = Conv(mid_nc, mid_nc, 3, use_bias=False,
                          dilation=dilation, stride=stride)
        self.BatchNorm_1 = BatchNorm(mid_nc)
        self.conv2 = Conv(mid_nc, out_nc, 1, use_bias=False)
        self.BatchNorm_2 = BatchNorm(out_nc)
        self.proj = None
        if in_nc != out_nc or stride != 1:
            self.proj = Conv(in_nc, out_nc, 1, use_bias=False, stride=stride)
            self.BatchNorm_3 = BatchNorm(out_nc)

    def forward(self, x):
        h = F.relu(self.BatchNorm_0(self.conv0(x)))
        h = F.relu(self.BatchNorm_1(self.conv1(h)))
        h = self.BatchNorm_2(self.conv2(h))
        if self.proj is not None:
            x = self.BatchNorm_3(self.proj(x))
        return F.relu(x + h)


class OutdoorSceneSeg(nn.Module):
    """The 8-class outdoor scene segmenter: NHWC image -> NHWC class
    probabilities at the image's size."""

    def __init__(self, n_classes: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1_1 = Conv(3, 64, 3, use_bias=False, stride=2)
        self.BatchNorm_0 = BatchNorm(64)
        self.conv1_2 = Conv(64, 64, 3, use_bias=False)
        self.BatchNorm_1 = BatchNorm(64)
        self.conv1_3 = Conv(64, 128, 3, use_bias=False)
        self.BatchNorm_2 = BatchNorm(128)
        blocks = [("res2a", 128, 64, 256, 1, 1)]
        blocks += [(f"res2b{i}", 256, 64, 256, 1, 1) for i in range(2)]
        blocks += [("res3a", 256, 128, 512, 1, 2)]
        blocks += [(f"res3b{i}", 512, 128, 512, 1, 1) for i in range(3)]
        blocks += [("res4a", 512, 256, 1024, 2, 1)]
        blocks += [(f"res4b{i}", 1024, 256, 1024, 2, 1) for i in range(22)]
        blocks += [(f"res5{i}", 1024 if i == 0 else 2048, 512, 2048, 4, 1)
                   for i in range(3)]
        self.blocks = [name for name, *_ in blocks]
        for name, i, m, o, d, s in blocks:
            setattr(self, name, Res131(i, m, o, d, s))
        self.conv5_4 = Conv(2048, 512, 3, use_bias=False)
        self.BatchNorm_3 = BatchNorm(512)
        self.dropout = Dropout(0.1)
        self.conv6 = Conv(512, n_classes, 1)
        self.deconv_kernel = nn.Parameter(torch.zeros(n_classes, 1, 16, 16))

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's default init: LeCun normal convs and deconv kernel (fan-in
        16 x 16), zero biases, batch norms at 1 and 0."""
        lecun_init(self, generator)
        with torch.no_grad():
            self.deconv_kernel.normal_(0.0, 1.0 / 16.0, generator=generator)

    def flax_leaves(self):
        return {"deconv_kernel": ("deconv_kernel", "conv")}

    def flax_paths(self) -> Dict[str, tuple]:
        return named_flax_paths(self)

    def forward(self, x):
        h = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        h = F.relu(self.BatchNorm_0(self.conv1_1(h)))
        h = F.relu(self.BatchNorm_1(self.conv1_2(h)))
        h = F.relu(self.BatchNorm_2(self.conv1_3(h)))
        h = F.max_pool2d(F.pad(h, (0, 1, 0, 1), value=float("-inf")), 3, 2)
        for name in self.blocks:
            h = getattr(self, name)(h)
        h = F.relu(self.BatchNorm_3(self.conv5_4(h)))
        h = self.conv6(self.dropout(h))
        h = F.conv_transpose2d(h, self.deconv_kernel.to(h.dtype), stride=8,
                               padding=4, groups=self.deconv_kernel.shape[0])
        return torch.softmax(h.float(), dim=1).permute(0, 2, 3, 1)
