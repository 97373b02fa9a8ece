"""Discriminators: counterpart of ``trainner_tpu/models/discriminators.py``
for ``DiscriminatorVGG:28`` (with or without spectral norm),
``NLayerDiscriminator:81`` (PatchGAN: ``patch``, spectral norm,
``use_sigmoid``), ``MultiscaleDiscriminator:131``,
``PixelDiscriminator:165`` and ``UNetDiscriminator:185``. SFTGAN's
auxiliary-classifier D is in ``models/sft.py``.

A train-mode pass writes no state: ``commit_stats`` writes the batch-norm
statistics and the spectral norms' ``u`` and ``sigma`` of the last pass,
so the caller decides which pass of a step counts.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tensor
from ..ops.blocks import (BatchNorm, ConvBlock, SpectralNorm, _Conv,
                          bilinear_torch, commit_stats, conv_paths)


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

    def route_linears(self) -> None:
        """Its linear layers run through ``_linear``, by output column on
        a tensor axis (``parallel/tensor.py``)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.tensor_routed = True

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


class NLayerDiscriminator(_Discriminator):
    """PatchGAN: a 4x4 stride-2 conv (LeakyReLU 0.2, no norm), then
    ``n_layers - 1`` more 4x4 stride-2 convs without bias with their norm
    (channels ndf times min(2^n, 8)), a 4x4 stride-1 one, and either a 4x4
    stride-1 conv to one channel (``patch``) or a dense layer on the
    spatial mean; ``use_sigmoid`` squashes the output. Spectral norm on
    every conv replaces the norms. Each conv zero-pads by 1 (the JAX
    ``ConvBlock``'s (k - 1) // 2). Takes NHWC (``in_nc`` channels: torch
    needs them up front, where flax infers them) and gives the f32 map
    (b, h', w', 1) or logits (b, 1); ``return_feats`` also gives each
    conv's NHWC output. Names follow the flax tree: ``conv{n}``,
    ``conv_out`` or ``linear_out``."""

    def __init__(self, in_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 norm_type: Optional[str] = "batch",
                 use_sigmoid: bool = False, patch: bool = True,
                 use_spectral_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.n_layers = dtype, n_layers
        self.use_sigmoid, self.patch = use_sigmoid, patch
        sn = use_spectral_norm
        norm = None if sn else norm_type
        self.conv0 = ConvBlock(in_nc, ndf, 4, stride=2, norm_type=None,
                               act_type="leakyrelu", spectral_norm=sn)
        cin = ndf
        for n in range(1, n_layers + 1):
            cout = ndf * min(2 ** n, 8)
            setattr(self, f"conv{n}", ConvBlock(
                cin, cout, 4, stride=2 if n < n_layers else 1,
                use_bias=False, norm_type=norm, act_type="leakyrelu",
                spectral_norm=sn))
            cin = cout
        if patch:
            self.conv_out = ConvBlock(cin, 1, 4, norm_type=None,
                                      act_type=None, spectral_norm=sn)
        else:
            self.linear_out = nn.Linear(cin, 1)

    def forward(self, x, train: bool = True, return_feats: bool = False):
        self.train(train)
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        feats = []
        for n in range(self.n_layers + 1):
            x = getattr(self, f"conv{n}")(x)
            feats.append(x)
        if self.patch:
            out = self.conv_out(x).permute(0, 2, 3, 1)
        else:
            out = _linear(self.linear_out, x.mean((2, 3)))
        if self.use_sigmoid:
            out = torch.sigmoid(out)
        out = out.float()
        if return_feats:
            return out, [f.permute(0, 2, 3, 1) for f in feats]
        return out

    def flax_paths(self, key: str = "", path: tuple = ()) -> dict:
        pre = f"{key}." if key else ""
        out = {}
        for name, m in self.named_children():
            out.update(conv_paths(pre + name, m, path + (name,)))
        return out


class MultiscaleDiscriminator(_Discriminator):
    """``num_D`` PatchGANs (batch-norm ones by default) on the input and
    on its successive 3x3 stride-2 average pools (padding 1, counting only
    the pixels inside); returns their outputs finest first. The sub-nets
    are named ``scale{num_D - 1 - i}`` as in the flax tree."""

    def __init__(self, in_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 norm_type: Optional[str] = "batch", num_D: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_D = num_D
        for i in range(num_D):
            setattr(self, f"scale{num_D - 1 - i}", NLayerDiscriminator(
                in_nc, ndf, n_layers, norm_type, dtype=dtype))

    def forward(self, x, train: bool = True, return_feats: bool = False):
        self.train(train)
        outs, feats = [], []
        cur = x
        for i in range(self.num_D):
            d = getattr(self, f"scale{self.num_D - 1 - i}")
            if return_feats:
                o, f = d(cur, train, return_feats=True)
                feats.extend(f)
            else:
                o = d(cur, train)
            outs.append(o)
            if i != self.num_D - 1:
                cur = _avg_pool_valid(cur)
        return (outs, feats) if return_feats else outs

    def flax_paths(self) -> dict:
        out = {}
        for name, m in self.named_children():
            out.update(m.flax_paths(name, (name,)))
        return out


class PixelDiscriminator(_Discriminator):
    """PixelGAN: 1x1 convs ``conv0`` (bias, LeakyReLU 0.2), ``conv1`` (no
    bias, its norm, LeakyReLU 0.2) and ``conv2`` (no bias) to one channel;
    NHWC in, the f32 (b, h, w, 1) map out."""

    def __init__(self, in_nc: int = 3, ndf: int = 64,
                 norm_type: Optional[str] = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = _Conv(in_nc, ndf, 1)
        self.conv1 = ConvBlock(ndf, 2 * ndf, 1, use_bias=False,
                               norm_type=norm_type, act_type="leakyrelu")
        self.conv2 = _Conv(2 * ndf, 1, 1, use_bias=False)

    def forward(self, x, train: bool = True, return_feats: bool = False):
        if return_feats:
            raise TypeError("the pixel discriminator gives no feature maps")
        self.train(train)
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = self.conv1(F.leaky_relu(self.conv0._conv(x), 0.2))
        return self.conv2._conv(x).float().permute(0, 2, 3, 1)

    def flax_paths(self) -> dict:
        out = {}
        for name, m in self.named_children():
            out.update(conv_paths(name, m, (name,)))
        return out


def _avg_pool_valid(x: torch.Tensor) -> torch.Tensor:
    """flax's ``avg_pool(x, (3, 3), (2, 2), padding 1,
    count_include_pad=False)`` of an NHWC map: each window's sum over the
    pixels inside the map, divided by their count, on a contiguous NCHW
    copy."""
    nchw = x.permute(0, 3, 1, 2).contiguous()
    sums = F.avg_pool2d(nchw, 3, 2, 1, divisor_override=1)
    ones = torch.ones((1, 1) + tuple(nchw.shape[2:]), dtype=x.dtype,
                      device=x.device)
    counts = F.avg_pool2d(ones, 3, 2, 1, divisor_override=1)
    return (sums / counts).permute(0, 2, 3, 1)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """f32 parameters, product in the input's type."""
    return tensor.apply(layer, x, F.linear, out_dim=-1)
