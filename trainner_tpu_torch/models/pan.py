"""PAN (pixel attention network) and A2N (attention in attention) SR
generators: counterpart of ``trainner_tpu/models/pan.py`` (``PA:33``,
``PACnv:45``, ``SCPA:62``, ``PAUpconvBlock:82``, ``PAN:107``,
``AttentionBranch:165``, ``AAB:185``, ``AAN:216``).

Module names are the flax module's, so ``utils/torch_interop.py`` moves
weights both ways. PAN's input skip is bilinear with ``align_corners``
(``bilinear_align_corners``), A2N's the half-pixel bilinear of
``interpolate``. ``PAUpconvBlock`` ends at ``hrconv``, with no activation
after it, as the JAX block does. The convs run on PyTorch's convolutions:
the JAX package has no Pallas kernel on this path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import (Conv, Dense, SelfAttentionBlock,
                          bilinear_align_corners, interpolate, kaiming_init_,
                          nearest_up)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _init_lecun(net: nn.Module, generator: torch.Generator) -> None:
    """flax's default init: LeCun-normal kernels (std sqrt(1 / fan_in),
    drawn here from a plain normal), zero biases."""
    for m in net.modules():
        if isinstance(m, (Conv, Dense)):
            kaiming_init_(m.weight, math.sqrt(0.5), generator)
            if getattr(m, "bias", None) is not None:
                with torch.no_grad():
                    m.bias.zero_()
        elif isinstance(m, SelfAttentionBlock):
            for conv in (m.f, m.g, m.h):
                kaiming_init_(conv.weight, math.sqrt(0.5), generator)
                with torch.no_grad():
                    conv.bias.zero_()


class PA(nn.Module):
    """Pixel attention: x * sigmoid(conv1x1(x))."""

    def __init__(self, nf: int):
        super().__init__()
        self.conv = Conv(nf, nf, 1)

    def forward(self, x):
        return x * torch.sigmoid(self.conv(x))


class PACnv(nn.Module):
    """k4(k3(x) * sigmoid(k2(x)))."""

    def __init__(self, nf: int, k_size: int = 3):
        super().__init__()
        self.k2 = Conv(nf, nf, 1)
        self.k3 = Conv(nf, nf, k_size, use_bias=False)
        self.k4 = Conv(nf, nf, k_size, use_bias=False)

    def forward(self, x):
        return self.k4(self.k3(x) * torch.sigmoid(self.k2(x)))


class SCPA(nn.Module):
    """Self-calibrated pixel-attention block: two 1x1 halves, a 3x3 conv on
    one and a ``PACnv`` on the other, joined by a 1x1 conv, plus x."""

    def __init__(self, nf: int, reduction: int = 2):
        super().__init__()
        gw = nf // reduction
        self.conv1_a = Conv(nf, gw, 1, use_bias=False)
        self.conv1_b = Conv(nf, gw, 1, use_bias=False)
        self.k1 = Conv(gw, gw, 3, use_bias=False)
        self.pacnv = PACnv(gw)
        self.conv3 = Conv(2 * gw, nf, 1, use_bias=False)

    def forward(self, x):
        a = _lrelu(self.k1(_lrelu(self.conv1_a(x))))
        b = _lrelu(self.pacnv(_lrelu(self.conv1_b(x))))
        return x + self.conv3(torch.cat([a, b], dim=1))


class PAUpconvBlock(nn.Module):
    """Upsample (nearest, or ``interpolate``'s ``mode``), 3x3 conv, PA,
    lrelu, 3x3 conv."""

    def __init__(self, in_nc: int, unf: int, upscale_factor: int = 2,
                 mode: str = "nearest"):
        super().__init__()
        self.r, self.mode = upscale_factor, mode
        self.upconv = Conv(in_nc, unf)
        self.att = PA(unf)
        self.hrconv = Conv(unf, unf)

    def forward(self, x):
        x = _nhwc(x)
        x = nearest_up(x, self.r) if self.mode == "nearest" else \
            interpolate(x, scale=self.r, mode=self.mode)
        x = self.upconv(_nchw(x))
        return self.hrconv(_lrelu(self.att(x)))


class PAN(nn.Module):
    """NHWC in and out (f32 out); the body in ``dtype``, the input skip
    from the f32 input, added in ``dtype``."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 40,
                 unf: int = 24, nb: int = 16, scale: int = 4,
                 self_attention: bool = False, double_scpa: bool = False,
                 ups_inter_mode: str = "nearest",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.nb, self.scale = dtype, nb, scale
        self.double_scpa, self.self_attention = double_scpa, self_attention
        unf = nf if scale == 1 else unf
        self.n_up = 1 if scale == 3 else \
            (int(math.log2(scale)) if scale > 1 else 0)
        self.conv_first = Conv(in_nc, nf)
        for i in range(nb):
            setattr(self, f"scpa{i}", SCPA(nf))
        self.trunk_conv = Conv(nf, nf)
        if double_scpa:
            for i in range(nb):
                setattr(self, f"scpa2_{i}", SCPA(nf))
            self.trunk_conv2 = Conv(nf, nf)
        if self_attention:
            self.fsa = SelfAttentionBlock(nf, max_pool=True, poolsize=4)
        r = 3 if scale == 3 else 2
        for i in range(self.n_up):
            setattr(self, f"up{i}", PAUpconvBlock(nf if i == 0 else unf, unf,
                                                  r, ups_inter_mode))
        self.conv_last = Conv(unf if self.n_up else nf, out_nc)

    def init_weights(self, generator: torch.Generator) -> None:
        _init_lecun(self, generator)

    def forward(self, x):
        x32 = x.float()
        fea = self.conv_first(_nchw(x.to(self.dtype)))
        t = fea
        for i in range(self.nb):
            t = getattr(self, f"scpa{i}")(t)
        t = self.trunk_conv(t)
        if self.double_scpa:
            for i in range(self.nb):
                t = getattr(self, f"scpa2_{i}")(t)
            t = self.trunk_conv2(t)
        fea = fea + t
        if self.self_attention:
            fea = self.fsa(fea)
        for i in range(self.n_up):
            fea = getattr(self, f"up{i}")(fea)
        out = _nhwc(self.conv_last(fea))
        ilr = bilinear_align_corners(x32, scale=self.scale) \
            if self.scale > 1 else x32
        return (out + ilr.to(out.dtype)).float().contiguous()


class AttentionBranch(nn.Module):
    """k4(k3(x) * sigmoid(k2(lrelu(k1(x)))))."""

    def __init__(self, nf: int, k_size: int = 3):
        super().__init__()
        self.k1 = Conv(nf, nf, k_size, use_bias=False)
        self.k2 = Conv(nf, nf, 1)
        self.k3 = Conv(nf, nf, k_size, use_bias=False)
        self.k4 = Conv(nf, nf, k_size, use_bias=False)

    def forward(self, x):
        y = torch.sigmoid(self.k2(_lrelu(self.k1(x))))
        return self.k4(self.k3(x) * y)


class AAB(nn.Module):
    """Attention-in-attention block: a 1x1 conv and lrelu, then the
    attention branch and a plain conv mixed by softmax(MLP(mean) / t)
    weights over K = 2, lrelu, a 1x1 conv, plus x."""

    def __init__(self, nf: int, reduction: int = 4, K: int = 2,
                 t: float = 30.0, mode: str = "n"):
        super().__init__()
        self.t = t
        self.conv_first = Conv(nf, nf, 1, use_bias=False)
        self.adm1 = Dense(nf, nf // reduction)
        self.adm2 = Dense(nf // reduction, K)
        self.attention = AttentionBranch(nf)
        self.non_attention = Conv(nf, nf, 1 if mode == "m" else 3,
                                  use_bias=False)
        self.conv_last = Conv(nf, nf, 1, use_bias=False)

    def forward(self, x):
        h = _lrelu(self.conv_first(x))
        y = h.float().mean((2, 3)).to(h.dtype)
        y = self.adm2(F.relu(self.adm1(y)))
        ax = torch.softmax(y.float() / self.t, dim=1).to(h.dtype)
        h = self.attention(h) * ax[:, 0, None, None, None] + \
            self.non_attention(h) * ax[:, 1, None, None, None]
        return self.conv_last(_lrelu(h)) + x


class AAN(nn.Module):
    """A2N: NHWC in and out (f32 out); the body in ``dtype``, the input
    skip (half-pixel bilinear) from the f32 input, added in ``dtype``."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 40,
                 unf: int = 24, nb: int = 16, scale: int = 4,
                 mode: str = "n", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.nb, self.scale = dtype, nb, scale
        self.conv_first = Conv(in_nc, nf)
        for i in range(nb):
            setattr(self, f"aab{i}", AAB(nf, mode=mode))
        self.trunk_conv = Conv(nf, nf)
        self.ups = [scale] if scale in (2, 3) else \
            ([2, 2] if scale == 4 else [])
        for i in range(len(self.ups)):
            setattr(self, f"upconv{i + 1}", Conv(nf if i == 0 else unf, unf))
            setattr(self, f"att{i + 1}", PA(unf))
            setattr(self, f"hrconv{i + 1}", Conv(unf, unf))
        self.conv_last = Conv(unf if self.ups else nf, out_nc)

    def init_weights(self, generator: torch.Generator) -> None:
        _init_lecun(self, generator)

    def forward(self, x):
        x32 = x.float()
        fea = self.conv_first(_nchw(x.to(self.dtype)))
        t = fea
        for i in range(self.nb):
            t = getattr(self, f"aab{i}")(t)
        fea = fea + self.trunk_conv(t)
        for i, r in enumerate(self.ups):
            fea = _nchw(nearest_up(_nhwc(fea), r))
            fea = getattr(self, f"upconv{i + 1}")(fea)
            fea = _lrelu(getattr(self, f"att{i + 1}")(fea))
            fea = _lrelu(getattr(self, f"hrconv{i + 1}")(fea))
        out = _nhwc(self.conv_last(fea))
        ilr = interpolate(x32, scale=self.scale, mode="bilinear") \
            if self.scale > 1 else x32
        return (out + ilr.to(out.dtype)).float().contiguous()
