"""The ResNet image-to-image generator (CycleGAN's): counterpart of
``trainner_tpu/models/resnet_g.py`` (``_pad:23``, ``_Norm:31``,
``ResnetBlock:49``, ``ResnetGenerator:80``).

A 7x7 conv after a reflect pad of 3, two stride-2 3x3 convs down (the
channels doubling), ``n_blocks`` residual blocks (pad, 3x3 conv, norm,
relu, dropout 0.5 with ``use_dropout``, pad, 3x3 conv, norm, plus the
input; the pads reflect, replicate or zero by ``padding_type``), two ups
(``deconv``: torch's ``ConvTranspose2d(k 3, s 2, p 1, op 1)``; else a
nearest 2x upsample and a 3x3 conv), each with its norm and relu, and a
7x7 conv to ``output_nc`` after a reflect pad of 3, then tanh. The norm is
flax's ``BatchNorm`` (``batch``) or flax's ``GroupNorm`` over each channel
with eps 1e-5 and no scale or bias (``instance``); the convs before a norm
have a bias only with the instance norm, as in the JAX module.

Takes and returns NHWC like the JAX module: the body runs in ``dtype``
(parameters and batch-norm statistics f32), the output comes back in
``dtype``. Module names follow the flax tree (``flax_paths``): the convs
``Conv_k`` in call order, the norms ``_Norm_k`` (a batch norm at
``_Norm_k/BatchNorm_0``), the ups ``ConvTranspose_i``, the blocks
``block{i}`` with their own ``Conv_0``, ``_Norm_0``, ``Conv_1``,
``_Norm_1``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tensor
from ..ops.blocks import (BatchNorm, Dropout, InstanceNorm, TorchDeconv,
                          _Conv, conv_paths, explicit_pad, lecun_init,
                          norm_paths)


def make_norm(norm_type: Optional[str], nc: int) -> nn.Module:
    """``batch``/``BN`` -> flax's BatchNorm, ``instance``/``IN`` -> its
    GroupNorm(C) with eps 1e-5 and neither scale nor bias."""
    if norm_type in ("BN", "batch"):
        return BatchNorm(nc)
    if norm_type in ("IN", "instance"):
        return InstanceNorm(1e-5)
    raise NameError(f"Unknown norm layer {norm_type}")


def conv(m: _Conv, x: torch.Tensor, padding: int = 0) -> torch.Tensor:
    """The conv of ``m`` on ``x`` with zero padding ``padding`` on each
    side, in x's type."""
    return tensor.apply(m, x, lambda x, w, b: F.conv2d(
        x, w, b, stride=m.stride, padding=padding))


def _fold(g: torch.Tensor, p: int, dim: int, reflect: bool):
    """The gradient of one axis's edge pad by ``p``: the middle, plus each
    padded band added back onto the rows it copied (reflected, or all onto
    the edge row), in a fixed order."""
    n = g.shape[dim] - 2 * p
    out = g.narrow(dim, p, n).clone()
    lo, hi = g.narrow(dim, 0, p), g.narrow(dim, n + p, p)
    if reflect:
        out.narrow(dim, 1, p).add_(lo.flip(dim))
        out.narrow(dim, n - p - 1, p).add_(hi.flip(dim))
    else:
        out.narrow(dim, 0, 1).add_(lo.sum(dim, keepdim=True))
        out.narrow(dim, n - 1, 1).add_(hi.sum(dim, keepdim=True))
    return out


class _EdgePad(torch.autograd.Function):
    """``F.pad`` in ``reflect`` or ``replicate`` mode whose backward adds in
    a fixed order: ``F.pad``'s own backward of those modes adds with
    atomics on the card, so two runs of a step would differ in the last
    bits (a graphed step against its eager program)."""

    @staticmethod
    def forward(ctx, x, p: int, mode: str):
        ctx.p, ctx.reflect = p, mode == "reflect"
        return F.pad(x, (p,) * 4, mode=mode)

    @staticmethod
    def backward(ctx, g):
        g = _fold(g, ctx.p, 2, ctx.reflect)
        return _fold(g, ctx.p, 3, ctx.reflect), None, None


def pad(x: torch.Tensor, p: int, padding_type: str) -> torch.Tensor:
    """The JAX ``_pad`` of an NCHW map: ``reflect``, ``replicate`` (edge)
    or ``zero``; the first two with a backward in a fixed order
    (``_EdgePad``)."""
    if padding_type not in ("reflect", "replicate", "zero"):
        raise KeyError(padding_type)
    if p == 0 or padding_type == "zero":
        return explicit_pad(x, p, padding_type)
    return _EdgePad.apply(x, p, padding_type)


class _Net(nn.Module):
    """What the image-to-image nets share: flax's default init, the
    state-dict keys' flax names, the NHWC boundary."""

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_init(self, generator)

    def flax_paths(self) -> Dict[str, tuple]:
        raise NotImplementedError

    def _nchw(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)


class ResnetBlock(nn.Module):
    """conv-norm-relu(-dropout)-conv-norm with the identity added."""

    def __init__(self, dim: int, padding_type: str = "reflect",
                 norm_type: str = "instance", use_dropout: bool = False,
                 use_bias: bool = True):
        super().__init__()
        self.padding_type = padding_type
        self.conv0 = _Conv(dim, dim, 3, use_bias)
        self.norm0 = make_norm(norm_type, dim)
        self.dropout = Dropout(0.5) if use_dropout else None
        self.conv1 = _Conv(dim, dim, 3, use_bias)
        self.norm1 = make_norm(norm_type, dim)

    def forward(self, x):
        h = self.norm0(conv(self.conv0, pad(x, 1, self.padding_type)))
        h = F.relu(h)
        if self.dropout is not None:
            h = self.dropout(h)
        h = self.norm1(conv(self.conv1, pad(h, 1, self.padding_type)))
        return x + h

    def flax_paths(self, key: str, path: tuple) -> Dict[str, tuple]:
        out = {}
        for i in (0, 1):
            out.update(conv_paths(f"{key}.conv{i}", getattr(self, f"conv{i}"),
                                  path + (f"Conv_{i}",)))
            out.update(norm_paths(f"{key}.norm{i}", getattr(self, f"norm{i}"),
                                  path + (f"_Norm_{i}", "BatchNorm_0")))
        return out


class ResnetGenerator(_Net):
    """The ResNet i2i generator at the JAX module's defaults (ngf 64, 9
    blocks, instance norm, reflect padding, deconv ups)."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 norm_type: str = "instance", use_dropout: bool = False,
                 n_blocks: int = 9, padding_type: str = "reflect",
                 upsample_mode: str = "deconv",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.upsample_mode = upsample_mode
        use_bias = norm_type in ("IN", "instance")
        self.stem = _Conv(input_nc, ngf, 7, use_bias)
        self.downs = nn.ModuleList(
            _Conv(ngf * 2 ** i, ngf * 2 ** (i + 1), 3, use_bias, stride=2)
            for i in range(2))
        self.norms = nn.ModuleList(
            make_norm(norm_type, ngf * 2 ** i) for i in (0, 1, 2))
        self.blocks = nn.ModuleList(
            ResnetBlock(ngf * 4, padding_type, norm_type, use_dropout,
                        use_bias) for _ in range(n_blocks))
        ups: List[nn.Module] = []
        for i in range(2):
            cin, cout = ngf * 2 ** (2 - i), ngf * 2 ** (2 - i) // 2
            ups.append(TorchDeconv(cin, cout, 3, 2, 1, 1, use_bias)
                       if upsample_mode == "deconv"
                       else _Conv(cin, cout, 3, use_bias))
        self.ups = nn.ModuleList(ups)
        self.up_norms = nn.ModuleList(
            make_norm(norm_type, ngf * 2 ** (1 - i)) for i in range(2))
        self.head = _Conv(ngf, output_nc, 7)

    def forward(self, x):
        x = self._nchw(x)
        x = F.relu(self.norms[0](conv(self.stem, pad(x, 3, "reflect"))))
        for i, down in enumerate(self.downs):
            x = F.relu(self.norms[i + 1](conv(down, x, 1)))
        for block in self.blocks:
            x = block(x)
        for up, norm in zip(self.ups, self.up_norms):
            if isinstance(up, TorchDeconv):
                x = up(x)
            else:
                x = conv(up, F.interpolate(x, scale_factor=2,
                                           mode="nearest"), 1)
            x = F.relu(norm(x))
        x = conv(self.head, pad(x, 3, "reflect"))
        return torch.tanh(x).permute(0, 2, 3, 1)

    def flax_paths(self) -> Dict[str, tuple]:
        deconv = self.upsample_mode == "deconv"
        out = conv_paths("stem", self.stem, ("Conv_0",))
        for i, down in enumerate(self.downs):
            out.update(conv_paths(f"downs.{i}", down, (f"Conv_{i + 1}",)))
        for i, norm in enumerate(self.norms):
            out.update(norm_paths(f"norms.{i}", norm,
                                  (f"_Norm_{i}", "BatchNorm_0")))
        for i, block in enumerate(self.blocks):
            out.update(block.flax_paths(f"blocks.{i}", (f"block{i}",)))
        for i, up in enumerate(self.ups):
            name = f"ConvTranspose_{i}" if deconv else f"Conv_{i + 3}"
            out.update(conv_paths(f"ups.{i}", up, (name,)))
            out.update(norm_paths(f"up_norms.{i}", self.up_norms[i],
                                  (f"_Norm_{i + 3}", "BatchNorm_0")))
        out.update(conv_paths("head", self.head,
                              ("Conv_3" if deconv else "Conv_5",)))
        return out
