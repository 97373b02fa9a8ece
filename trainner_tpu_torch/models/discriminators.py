"""Discriminators: counterpart of ``trainner_tpu/models/discriminators.py``
for ``DiscriminatorVGG:28``. The other discriminators raise in
``models/networks.py::define_D`` and name their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import BatchNorm, ConvBlock


class DiscriminatorVGG(nn.Module):
    """Size-adaptive VGG-style discriminator: a 3x3 conv, then 4x4 stride-2
    convs (each after a 3x3 conv past the first pair) that halve the map
    down to 4x4 while the channels double up to 512, then a two-layer head.

    Takes NHWC like the JAX module; the body runs in ``dtype`` (parameters
    and batch-norm statistics stay f32) and the logits come out f32.
    ``return_feats`` also returns the feature map after each stride-2 conv
    (NHWC). Module names follow the JAX module (``conv{i}_{0|1}``,
    ``linear0``, ``linear1``); ``linear0`` takes torch's (C, H, W)
    flattening, as the reference ``.pth`` classifier does.

    ``train`` selects batch statistics. A train-mode pass never writes the
    running statistics: ``commit_stats`` writes those of the last pass,
    so the caller decides which pass of a step counts (``BatchNorm``)."""

    def __init__(self, size: int = 128, in_nc: int = 3, base_nf: int = 64,
                 norm_type: Optional[str] = "batch",
                 act_type: str = "leakyrelu", arch: str = "ESRGAN",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        cb = dict(norm_type=norm_type, act_type=act_type)
        self.conv0_0 = ConvBlock(in_nc, base_nf, 3, act_type=act_type)
        self.conv0_1 = ConvBlock(base_nf, base_nf, 4, stride=2, **cb)
        cur_size, cur_nc, i = size // 2, base_nf, 1
        while cur_size > 4:
            out_nc = cur_nc * 2 if cur_nc < 512 else cur_nc
            setattr(self, f"conv{i}_0", ConvBlock(cur_nc, out_nc, 3, **cb))
            setattr(self, f"conv{i}_1",
                    ConvBlock(out_nc, out_nc, 4, stride=2, **cb))
            cur_nc, cur_size, i = out_nc, cur_size // 2, i + 1
        self.n_blocks = i
        self.linear0 = nn.Linear(cur_nc * cur_size * cur_size,
                                 128 if arch == "PPON" else 100)
        self.linear1 = nn.Linear(self.linear0.out_features, 1)

    def init_weights(self, generator: torch.Generator) -> None:
        """LeCun-normal weights (std 1/sqrt(fan_in)) and zero biases, the
        default init of the JAX module's convs and dense layers."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (ConvBlock, nn.Linear)):
                    fan_in = m.weight[0].numel()
                    m.weight.normal_(0.0, fan_in ** -0.5,
                                     generator=generator)
                    m.bias.zero_()

    def norms(self):
        return [m for m in self.modules() if isinstance(m, BatchNorm)]

    def commit_stats(self) -> None:
        for m in self.norms():
            m.commit()

    def forward(self, x, train: bool = True, return_feats: bool = False):
        self.train(train)
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        feats = []
        x = self.conv0_1(self.conv0_0(x))
        feats.append(x)
        for i in range(1, self.n_blocks):
            x = getattr(self, f"conv{i}_1")(getattr(self, f"conv{i}_0")(x))
            feats.append(x)
        x = x.reshape(x.shape[0], -1)
        x = F.leaky_relu(_linear(self.linear0, x), 0.2)
        out = _linear(self.linear1, x).float()
        if return_feats:
            return out, [f.permute(0, 2, 3, 1) for f in feats]
        return out


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """f32 parameters, product in the input's type."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))
