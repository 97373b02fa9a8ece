"""The spectral-norm, self-attention SRGAN family: counterpart of
``trainner_tpu/models/asrresnet.py`` (``PReLU:28``, ``_SNConv:35``,
``_ResBlock:53``, ``ASRResNet:77``, ``ASRCNN:118``,
``ADiscriminator:160``).

``ASRResNet``: a 9x9 stem, five residual blocks of spectrally normalised
convs with batch norm and scalar PReLUs, an SN conv and batch norm on the
global skip, ``SelfAttentionBlock`` with spectral norm (a ``poolsize`` max
pool first with ``max_pool``), nearest 2x upsamples with plain convs,
a 9x9 output conv. ``ASRCNN``: 5x5 and 3x3 SN convs, the attention, a
pixel shuffle of r^2 output channels, ``finalact`` (tanh or sigmoid).
``ADiscriminator``: SN VGG-like convs (batch norm in their place without
spectral norm), the attention after the 256-channel stage, 1x1 convs to
one logit per position, and with ``return_maps`` the feature maps; no
``define_D`` builds it, in either package (ROADMAP C 26).

The spectral norms' state (``u``, ``sigma``) and the batch norms'
statistics sit in ``batch_stats`` under flax's names (``flax_paths``) and
are written once per step (``ops/blocks.py::commit_stats``). Modules are
NCHW in ``channels_last`` memory under the flax names; ``forward`` takes
and returns NHWC (f32 out), the convs in ``dtype`` with f32 parameters.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import (BatchNorm, SelfAttentionBlock, _Conv,
                          depth_to_space, lecun_init, named_flax_paths,
                          nearest_up)
from .abpn import PReLU


class _SNConv(nn.Module):
    """A conv named ``conv`` (stride ``stride``, zero padding (k - 1) /
    2), spectrally normalised with ``spectral_norm``."""

    def __init__(self, in_nc: int, out_nc: int, k: int = 3,
                 stride: int = 1, spectral_norm: bool = True):
        super().__init__()
        self.conv = _Conv(in_nc, out_nc, k, stride=stride,
                          spectral_norm=spectral_norm)

    def forward(self, x):
        return self.conv._conv(x)


class _ResBlock(nn.Module):
    """SN conv, batch norm, PReLU, twice, plus the input."""

    def __init__(self, nf: int, spectral_norm: bool = True):
        super().__init__()
        self.conv1 = _SNConv(nf, nf, spectral_norm=spectral_norm)
        self.BatchNorm_0 = BatchNorm(nf)
        self.act1 = PReLU()
        self.conv2 = _SNConv(nf, nf, spectral_norm=spectral_norm)
        self.BatchNorm_1 = BatchNorm(nf)
        self.act2 = PReLU()

    def forward(self, x):
        h = self.act1(self.BatchNorm_0(self.conv1(x)))
        h = self.act2(self.BatchNorm_1(self.conv2(h)))
        return x + h


class _Net(nn.Module):
    """flax's default init, flax names, NHWC in and out."""

    dtype = torch.float32

    def init_weights(self, generator: torch.Generator) -> None:
        """LeCun normal convs, zero biases, a spectral norm's ``u`` from a
        standard normal; slopes 0.25, batch norms at 1 and 0."""
        lecun_init(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, PReLU):
                    m.alpha.fill_(0.25)

    def flax_paths(self) -> Dict[str, tuple]:
        return named_flax_paths(self)

    def _nchw(self, x):
        return x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)


class ASRResNet(_Net):
    """The attentional SRResNet generator."""

    def __init__(self, scale_factor: int = 4, in_nc: int = 3, nf: int = 64,
                 spectral_norm: bool = True, self_attention: bool = True,
                 max_pool: bool = False, poolsize: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.block1 = _SNConv(in_nc, nf, 9, spectral_norm=spectral_norm)
        self.act1 = PReLU()
        for i in range(5):
            setattr(self, f"block{i + 2}", _ResBlock(nf, spectral_norm))
        self.block7 = _SNConv(nf, nf, spectral_norm=spectral_norm)
        self.bn7 = BatchNorm(nf)
        self.FSA = SelfAttentionBlock(nf, max_pool, poolsize,
                                      spectral_norm) \
            if self_attention else None
        self.n_up = int(math.log2(scale_factor))
        for i in range(self.n_up):
            setattr(self, f"up{i}", _SNConv(nf, nf, spectral_norm=False))
        self.out = _SNConv(nf, in_nc, 9, spectral_norm=False)

    def forward(self, x):
        b1 = self.act1(self.block1(self._nchw(x)))
        h = b1
        for i in range(5):
            h = getattr(self, f"block{i + 2}")(h)
        h = b1 + self.bn7(self.block7(h))
        if self.FSA is not None:
            h = self.FSA(h)
        for i in range(self.n_up):
            h = nearest_up(h.permute(0, 2, 3, 1), 2).permute(0, 3, 1, 2)
            h = F.leaky_relu(getattr(self, f"up{i}")(h), 0.2)
        return self.out(h).permute(0, 2, 3, 1).float()


class ASRCNN(_Net):
    """The lightweight attentional SRCNN."""

    def __init__(self, upscale_factor: int = 4, in_nc: int = 3, nf: int = 64,
                 spectral_norm: bool = True, self_attention: bool = True,
                 max_pool: bool = True, poolsize: int = 4,
                 finalact: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.r, self.finalact = dtype, upscale_factor, finalact
        self.feat = _SNConv(in_nc, nf, 5, spectral_norm=spectral_norm)
        self.act0 = PReLU()
        self.map = _SNConv(nf, nf // 2, 3, spectral_norm=spectral_norm)
        self.act1 = PReLU()
        self.FSA = SelfAttentionBlock(nf // 2, max_pool, poolsize,
                                      spectral_norm) \
            if self_attention else None
        self.up = _SNConv(nf // 2, in_nc * upscale_factor ** 2, 3,
                          spectral_norm=False)

    def forward(self, x):
        h = self.act1(self.map(self.act0(self.feat(self._nchw(x)))))
        if self.FSA is not None:
            h = self.FSA(h)
        out = depth_to_space(self.up(h).permute(0, 2, 3, 1), self.r)
        if self.finalact == "tanh":
            out = torch.tanh(out)
        elif self.finalact == "sigmoid":
            out = torch.sigmoid(out)
        return out.float()


class ADiscriminator(_Net):
    """The self-attention SN discriminator: logits (b, h/16, w/16, 1), and
    with ``return_maps`` the eight feature maps too."""

    PLAN = ((64, 1), (64, 2), (128, 1), (128, 2), (256, 1), (256, 2))

    def __init__(self, in_nc: int = 3, spectral_norm: bool = True,
                 self_attention: bool = True, max_pool: bool = False,
                 poolsize: int = 4, return_maps: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.sn, self.return_maps = dtype, spectral_norm, \
            return_maps
        c, bn = in_nc, 0
        for i, (f, s) in enumerate(self.PLAN + ((512, 1), (512, 2))):
            setattr(self, f"conv{i + 1}", _SNConv(c, f, 3, s, spectral_norm))
            if i > 0 and not spectral_norm:
                setattr(self, f"BatchNorm_{bn}", BatchNorm(f))
                bn += 1
            c = f
            if i == 5:
                self.FSA = SelfAttentionBlock(c, max_pool, poolsize,
                                              spectral_norm) \
                    if self_attention else None
        self.conv9 = _SNConv(c, 1024, 1, 1, spectral_norm)
        self.conv10 = _SNConv(1024, 1, 1, 1, spectral_norm)

    def forward(self, x):
        h = self._nchw(x)
        maps, bn = [], 0
        for i in range(8):
            h = getattr(self, f"conv{i + 1}")(h)
            if i > 0 and not self.sn:
                h = getattr(self, f"BatchNorm_{bn}")(h)
                bn += 1
            h = F.leaky_relu(h, 0.2)
            maps.append(h.permute(0, 2, 3, 1).float())
            if i == 5 and self.FSA is not None:
                h = self.FSA(h)
        h = F.leaky_relu(self.conv9(h), 0.2)
        logits = self.conv10(h).permute(0, 2, 3, 1).float()
        if self.return_maps:
            return logits, maps
        return logits
