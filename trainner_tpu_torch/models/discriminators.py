"""Discriminators: counterpart of ``trainner_tpu/models/discriminators.py``
for ``DiscriminatorVGG:28`` (with or without spectral norm) and
``UNetDiscriminator:185``. The other discriminators raise in
``models/networks.py::define_D`` and name their ROADMAP item.

A train-mode pass writes no state: ``commit_stats`` writes the batch-norm
statistics and the spectral norms' ``u`` and ``sigma`` of the last pass,
so the caller decides which pass of a step counts.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import (BatchNorm, ConvBlock, SpectralNorm, _Conv,
                          bilinear_torch, commit_stats)


class _Discriminator(nn.Module):
    """What both discriminators share: their init and their pending state."""

    def init_weights(self, generator: torch.Generator) -> None:
        """LeCun-normal weights (std 1/sqrt(fan_in)) and zero biases, the
        default init of the JAX modules' convs and dense layers; each
        spectral norm's ``u`` from a standard normal and ``sigma`` 1."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (_Conv, nn.Linear)):
                    fan_in = m.weight[0].numel()
                    m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, SpectralNorm):
                    m.init_state(generator)

    def norms(self):
        """The modules whose state a pass leaves pending: batch norms and
        spectral norms."""
        return [m for m in self.modules()
                if isinstance(m, (BatchNorm, SpectralNorm))]

    def commit_stats(self) -> None:
        """Writes the state of the last train-mode pass."""
        commit_stats(self)


class DiscriminatorVGG(_Discriminator):
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
                 spectral_norm: bool = False, mode: str = "CNA",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        cb = dict(norm_type=norm_type, act_type=act_type, mode=mode,
                  spectral_norm=spectral_norm)
        self.conv0_0 = ConvBlock(in_nc, base_nf, 3, act_type=act_type,
                                 mode=mode, spectral_norm=spectral_norm)
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


class UNetDiscriminator(_Discriminator):
    """Real-ESRGAN's U-Net discriminator: a 3x3 conv, three 4x4 stride-2
    convs without bias that halve the map as the channels double, three
    x2 bilinear upsamples each followed by a 3x3 conv without bias (its
    output plus the encoder map of its size with ``skip_connection``), two
    more 3x3 convs and a 3x3 conv to one channel; lrelu 0.2 after every
    conv but the last; every conv but the last spectrally normalised
    (``spectral_norm``). Takes NHWC like the JAX module and gives an f32
    (b, h, w, 1) map; the body runs in ``dtype``. Module names follow the
    JAX module (``conv0`` .. ``conv9``)."""

    def __init__(self, nf: int = 64, in_nc: int = 3,
                 skip_connection: bool = True, spectral_norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.skip_connection = skip_connection
        chans = [(in_nc, nf, 3, 1, True), (nf, 2 * nf, 4, 2, False),
                 (2 * nf, 4 * nf, 4, 2, False), (4 * nf, 8 * nf, 4, 2, False),
                 (8 * nf, 4 * nf, 3, 1, False), (4 * nf, 2 * nf, 3, 1, False),
                 (2 * nf, nf, 3, 1, False), (nf, nf, 3, 1, False),
                 (nf, nf, 3, 1, False)]
        for i, (cin, cout, k, s, bias) in enumerate(chans):
            setattr(self, f"conv{i}", _Conv(cin, cout, k, bias, s,
                                            spectral_norm=spectral_norm))
        self.conv9 = _Conv(nf, 1, 3)

    def forward(self, x, train: bool = True, return_feats: bool = False):
        if return_feats:
            raise TypeError("the U-Net discriminator gives no feature maps")
        self.train(train)

        def lrelu_conv(i, y):
            return F.leaky_relu(getattr(self, f"conv{i}")._conv(y), 0.2)

        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x0 = lrelu_conv(0, x)
        x1 = lrelu_conv(1, x0)
        x2 = lrelu_conv(2, x1)
        x3 = lrelu_conv(3, x2)
        x4 = lrelu_conv(4, bilinear_torch(x3))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = lrelu_conv(5, bilinear_torch(x4))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = lrelu_conv(6, bilinear_torch(x5))
        if self.skip_connection:
            x6 = x6 + x0
        out = lrelu_conv(8, lrelu_conv(7, x6))
        return self.conv9._conv(out).float().permute(0, 2, 3, 1)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """f32 parameters, product in the input's type."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))
