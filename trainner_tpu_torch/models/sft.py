"""SFTGAN's networks: counterpart of ``trainner_tpu/models/sft.py``
(``SFTLayer:31``, ``ResBlockSFT:50``, ``SFTNet:65``, ``ACDVGGBN96:106``).

``SFTNet`` takes an LR image and the segmentation probabilities of its HR
size (8 classes): its condition net is a 4x4 stride-4 VALID conv (to 128
channels, at LR size), three 1x1 convs and a 1x1 to ``cond_nf``, each but
the last followed by LeakyReLU(0.1). The body is a 3x3 conv to ``nf``,
``n_blocks`` SFT residual blocks (SFT layer, 3x3 conv, relu, SFT layer,
3x3 conv, plus the input), a last SFT layer and 3x3 conv added to the
body's input; then two 2x pixel shuffles (3x3 conv to 4 nf, shuffle,
relu) and a 3x3 conv with relu and one to ``out_nc``. An SFT layer
modulates its features as ``fea * (scale + 1) + shift``, scale and shift
each from two 1x1 convs (32 channels whatever ``cond_nf`` is,
LeakyReLU(0.1), ``nf``) on the condition. ``ACDVGGBN96`` is the
auxiliary-classifier discriminator of 96 px inputs: eight convs (3x3 stride 1 and 4x4 stride 2 alternately, 64 to
512 channels, a batch norm after each but the first, LeakyReLU(0.1)),
then two heads of two dense layers each (100 hidden) on the (H, W, C)
flattening of the 6 x 6 x 512 map: the GAN logit and 8 class logits.

Both take NHWC; the bodies run in ``dtype``; ``SFTNet`` returns NHWC in
``dtype``, ``ACDVGGBN96`` (gan, cls) in f32. Module names are the flax
tree's (``flax_paths``): ``cond{i}``, ``conv0``, ``sft_block{i}`` with
``sft0``/``conv0``/``sft1``/``conv1``, ``sft_final``, ``conv_body``,
``up0``, ``up1``, ``hr0``, ``hr1``; an SFT layer's ``scale0``, ``scale1``,
``shift0``, ``shift1``; D's ``conv{i}``, ``BatchNorm_{k}`` (in call
order), ``gan_fc0/1``, ``cls_fc0/1``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import BatchNorm, _Conv, conv_paths, norm_paths
from .discriminators import _Discriminator, _linear
from .resnet_g import _Net, conv


def _same(m: _Conv, x: torch.Tensor) -> torch.Tensor:
    """A stride-1 conv with (k - 1) // 2 zero padding."""
    return conv(m, x, (m.weight.shape[-1] - 1) // 2)


class SFTLayer(nn.Module):
    """The modulation of ``nf`` features by a condition of ``cond_in``
    channels through a hidden width of 32: the JAX ``SFTNet`` builds its
    layers without its ``cond_nf``, so their hidden width stays at
    ``SFTLayer``'s default whatever ``cond_nf`` is (ROADMAP C 22)."""

    def __init__(self, nf: int = 64, cond_in: int = 32, hidden: int = 32):
        super().__init__()
        self.scale0 = _Conv(cond_in, hidden, 1)
        self.scale1 = _Conv(hidden, nf, 1)
        self.shift0 = _Conv(cond_in, hidden, 1)
        self.shift1 = _Conv(hidden, nf, 1)

    def forward(self, fea, cond):
        scale = _same(self.scale1, F.leaky_relu(_same(self.scale0, cond),
                                                0.1))
        shift = _same(self.shift1, F.leaky_relu(_same(self.shift0, cond),
                                                0.1))
        return fea * (scale + 1.0) + shift


class ResBlockSFT(nn.Module):
    def __init__(self, nf: int = 64, cond_nf: int = 32):
        super().__init__()
        self.sft0 = SFTLayer(nf, cond_nf)
        self.conv0 = _Conv(nf, nf, 3)
        self.sft1 = SFTLayer(nf, cond_nf)
        self.conv1 = _Conv(nf, nf, 3)

    def forward(self, fea, cond):
        h = F.relu(_same(self.conv0, self.sft0(fea, cond)))
        h = _same(self.conv1, self.sft1(h, cond))
        return fea + h


def _named_conv_paths(net: nn.Module) -> Dict[str, tuple]:
    """Every ``_Conv`` of ``net`` at its own dotted name as the flax
    path (kernel, bias)."""
    out = {}
    for name, m in net.named_modules():
        if type(m) is _Conv:
            out.update(conv_paths(name, m, tuple(name.split("."))))
    return out


class SFTNet(_Net):
    """SFTGAN's generator (nf 64, cond_nf 32, 16 blocks by default).
    Call with (LR image (b, h, w, 3), seg (b, 4h, 4w, 8))."""

    def __init__(self, nf: int = 64, cond_nf: int = 32, n_blocks: int = 16,
                 out_nc: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n_blocks = n_blocks
        self.cond0 = _Conv(8, 128, 4, stride=4)
        for i in range(1, 4):
            setattr(self, f"cond{i}", _Conv(128, 128, 1))
        self.cond4 = _Conv(128, cond_nf, 1)
        self.conv0 = _Conv(3, nf, 3)
        for i in range(n_blocks):
            setattr(self, f"sft_block{i}", ResBlockSFT(nf, cond_nf))
        self.sft_final = SFTLayer(nf, cond_nf)
        self.conv_body = _Conv(nf, nf, 3)
        self.up0 = _Conv(nf, nf * 4, 3)
        self.up1 = _Conv(nf, nf * 4, 3)
        self.hr0 = _Conv(nf, nf, 3)
        self.hr1 = _Conv(nf, out_nc, 3)

    def forward(self, x, seg):
        c = F.leaky_relu(conv(self.cond0, self._nchw(seg)), 0.1)
        for i in range(1, 4):
            c = F.leaky_relu(_same(getattr(self, f"cond{i}"), c), 0.1)
        cond = _same(self.cond4, c)
        fea = _same(self.conv0, self._nchw(x))
        res = fea
        for i in range(self.n_blocks):
            res = getattr(self, f"sft_block{i}")(res, cond)
        res = _same(self.conv_body, self.sft_final(res, cond))
        fea = fea + res
        h = F.relu(F.pixel_shuffle(_same(self.up0, fea), 2))
        h = F.relu(F.pixel_shuffle(_same(self.up1, h), 2))
        h = F.relu(_same(self.hr0, h))
        return _same(self.hr1, h).permute(0, 2, 3, 1)

    def flax_paths(self) -> Dict[str, tuple]:
        return _named_conv_paths(self)


class ACDVGGBN96(_Discriminator):
    """The auxiliary-classifier VGG-BN discriminator of 96 px inputs;
    returns (gan logits (b, 1), class logits (b, ``n_classes``))."""

    PLAN = ((64, 3, 1, False), (64, 4, 2, True), (128, 3, 1, True),
            (128, 4, 2, True), (256, 3, 1, True), (256, 4, 2, True),
            (512, 3, 1, True), (512, 4, 2, True))

    def __init__(self, n_classes: int = 8, in_nc: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        cin, k = in_nc, 0
        for i, (f, ks, s, use_bn) in enumerate(self.PLAN):
            setattr(self, f"conv{i}", _Conv(cin, f, ks, stride=s))
            if use_bn:
                setattr(self, f"BatchNorm_{k}", BatchNorm(f))
                k += 1
            cin = f
        self.gan_fc0 = nn.Linear(512 * 6 * 6, 100)
        self.gan_fc1 = nn.Linear(100, 1)
        self.cls_fc0 = nn.Linear(512 * 6 * 6, 100)
        self.cls_fc1 = nn.Linear(100, n_classes)

    def forward(self, x, train: bool = True):
        self.train(train)
        h = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        k = 0
        for i, (_, ks, _, use_bn) in enumerate(self.PLAN):
            h = conv(getattr(self, f"conv{i}"), h, (ks - 1) // 2)
            if use_bn:
                h = getattr(self, f"BatchNorm_{k}")(h)
                k += 1
            h = F.leaky_relu(h, 0.1)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        gan = _linear(self.gan_fc1, F.leaky_relu(_linear(self.gan_fc0, h),
                                                 0.1))
        cls = _linear(self.cls_fc1, F.leaky_relu(_linear(self.cls_fc0, h),
                                                 0.1))
        return gan.float(), cls.float()

    def flax_paths(self) -> Dict[str, tuple]:
        out = {}
        for name, m in self.named_children():
            if isinstance(m, BatchNorm):
                out.update(norm_paths(name, m, (name,)))
            else:
                out.update(conv_paths(name, m, (name,)))
        return out
