"""SRFlow with the reference's exact architecture: counterpart of
``trainner_tpu/models/srflow_interop.py`` (``squeeze2d:39``,
``_split_cross:54``, ``gaussian_logp:59``, ``ActNormI:68``,
``InvConvI:92``, ``GlowConv:118``, ``GlowConvZeros:135``, ``FNet:157``,
``CondAffineI:173``, ``FlowStepI:226``, ``Split2dI:257``,
``SRFlowEncoderI:294``, ``SRFlowNetI:366``).

Module names follow the reference ``.pth`` layout (``RRDB.conv_first``,
``RRDB.RRDB_trunk.{i}.RDB{j}.conv{k}``, ``RRDB.upconv1``,
``flowUpsamplerNet.layers.{i}.actnorm`` / ``.invconv`` /
``.affine.fAffine.{0,2,4}`` / ``.conv``), so the JAX package's
``utils/torch_interop.py::srflow_to_params`` takes this net's
``state_dict()`` as it stands; ``flax_paths`` names the flax
``SRFlowNetI`` tree (``encoder``, ``RRDB{i}``, ``layers_{i}``, ``f0`` /
``f2`` / ``f4``). NHWC throughout, the flow in f32.

Per level: squeeze in torch's pixel-unshuffle order ``(c, by, bx)``,
``n_noaffine`` steps without coupling, ``K`` conditional steps, and a
split where the level is below ``L - 1``; the couplings and the split
read their scale and shift, mean and logs from even and odd channels
(``_split_cross``). The encoder's 23 ``RRDB``s (69 residual dense blocks,
on the block kernels) keep the reference's quirks: the residual skip adds
the last block's output, ``fea_up2`` / ``fea_up4`` are the tensors after
the LeakyReLU, ``fea_up0`` is ``fea_up1`` bilinearly at half size, and the
four tapped blocks, resized by nearest neighbours (a repeat or a strided
slice: no atomics in their backward), join every conditional (320
channels). What no level reads (``fea_up4`` and the image head ``out`` at
L = 3) is not computed: its weights get zero gradients, as in the JAX
package. ROADMAP C 26 lists the traps.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import (Conv, _Conv, conv_paths, interpolate,
                          kaiming_init_, nearest_up, resize_torch)
from .rrdb import RRDB, ResidualDenseBlock5C
from .srflow import orthogonal_

LOG2PI = math.log(2 * math.pi)


def squeeze2d(x: torch.Tensor) -> torch.Tensor:
    """(b, h, w, c) -> (b, h/2, w/2, 4c), torch's pixel-unshuffle order
    (c, by, bx)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // 2, w // 2, c * 4)


def unsqueeze2d(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, c // 4, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * 2, w * 2, c // 4)


def _split_cross(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Even and odd channels."""
    return t[..., 0::2], t[..., 1::2]


def gaussian_logp(x, mean=None, logs=None):
    if mean is None:
        ll = -0.5 * (x ** 2 + LOG2PI)
    else:
        ll = -0.5 * (logs * 2.0 + (x - mean) ** 2 / torch.exp(logs * 2.0)
                     + LOG2PI)
    return ll.sum((1, 2, 3))


class ActNormI(nn.Module):
    """ActNorm2d: (x + bias) * exp(logs) over the channels of an NHWC
    tensor (dim -1) or an NCHW one (``nchw``)."""

    def __init__(self, features: int, nchw: bool = False):
        super().__init__()
        self.nchw = nchw
        self.bias = nn.Parameter(torch.zeros(features))
        self.logs = nn.Parameter(torch.zeros(features))

    def forward(self, x, logdet=None, reverse: bool = False):
        """(y, logdet moved by the log-determinant; None stays None)."""
        bias, logs = self.bias, self.logs
        if self.nchw:
            bias, logs = bias[:, None, None], logs[:, None, None]
        if logdet is not None:
            dld = self.logs.sum() * (x.shape[1] * x.shape[2])
            logdet = logdet - dld if reverse else logdet + dld
        if not reverse:
            return (x + bias) * torch.exp(logs), logdet
        return x * torch.exp(-logs) - bias, logdet


class InvConvI(nn.Module):
    """InvertibleConv1x1: y = x w^T, with ``weight`` as the torch conv's
    (O, I) matrix."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.eye(features))

    def forward(self, x, logdet, reverse: bool = False):
        if logdet is not None:
            dld = torch.linalg.slogdet(self.weight)[1] * (x.shape[1]
                                                          * x.shape[2])
            logdet = logdet - dld if reverse else logdet + dld
        if not reverse:
            return x @ self.weight.T.to(x.dtype), logdet
        w_inv = torch.linalg.inv_ex(self.weight)[0]
        return x @ w_inv.T.to(x.dtype), logdet


class GlowConv(_Conv):
    """Conv2d (no bias, zero padding (k - 1) / 2) with an ActNorm after it;
    NCHW."""

    def __init__(self, in_nc: int, out_nc: int, kernel_size: int = 3):
        super().__init__(in_nc, out_nc, kernel_size, use_bias=False)
        self.actnorm = ActNormI(out_nc, nchw=True)

    def forward(self, x):
        return self.actnorm(self._conv(x))[0]


class GlowConvZeros(_Conv):
    """Zero-initialised Conv2d times exp(3 logs); NCHW."""

    def __init__(self, in_nc: int, out_nc: int, kernel_size: int = 3):
        super().__init__(in_nc, out_nc, kernel_size)
        self.logs = nn.Parameter(torch.zeros(out_nc))

    def forward(self, x):
        return self._conv(x) * torch.exp(self.logs * 3.0)[:, None, None]


class FNetI(nn.Sequential):
    """GlowConv 3x3, ReLU, GlowConv 1x1, ReLU, GlowConvZeros 3x3 (the
    reference Sequential's indices 0-4) on an NHWC tensor."""

    def __init__(self, in_nc: int, out_nc: int, hidden: int = 64):
        super().__init__(GlowConv(in_nc, hidden, 3), nn.ReLU(),
                         GlowConv(hidden, hidden, 1), nn.ReLU(),
                         GlowConvZeros(hidden, out_nc, 3))

    def forward(self, x):
        y = super().forward(x.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1)


class CondAffineI(nn.Module):
    """CondAffineSeparatedAndCond: the features' affine of all of z, then
    the first half's and the features' affine of the second half."""

    def __init__(self, in_channels: int, rrdb_channels: int = 320,
                 hidden: int = 64, eps: float = 1e-4):
        super().__init__()
        self.cnn = in_channels // 2
        self.eps = eps
        self.fAffine = FNetI(self.cnn + rrdb_channels,
                             (in_channels - self.cnn) * 2, hidden)
        self.fFeatures = FNetI(rrdb_channels, in_channels * 2, hidden)

    def _scale_shift(self, h):
        shift, scale = _split_cross(h)
        return torch.sigmoid(scale + 2.0) + self.eps, shift

    def forward(self, x, ft, logdet, reverse: bool = False):
        def ld(scale):
            return torch.log(scale).sum((1, 2, 3))

        cnn = self.cnn
        if not reverse:
            scale_ft, shift_ft = self._scale_shift(self.fFeatures(ft))
            x = (x + shift_ft) * scale_ft
            logdet = logdet + ld(scale_ft)
            z1, z2 = x[..., :cnn], x[..., cnn:]
            scale, shift = self._scale_shift(
                self.fAffine(torch.cat([z1, ft], -1)))
            z2 = (z2 + shift) * scale
            return torch.cat([z1, z2], -1), logdet + ld(scale)
        z1, z2 = x[..., :cnn], x[..., cnn:]
        scale, shift = self._scale_shift(self.fAffine(torch.cat([z1, ft],
                                                                -1)))
        z2 = z2 / scale - shift
        x = torch.cat([z1, z2], -1)
        scale_ft, shift_ft = self._scale_shift(self.fFeatures(ft))
        if logdet is not None:
            logdet = logdet - ld(scale) - ld(scale_ft)
        return x / scale_ft - shift_ft, logdet


class FlowStepI(nn.Module):
    """actnorm -> invconv -> (conditional affine)."""

    def __init__(self, features: int, coupling: bool = True,
                 rrdb_channels: int = 320, hidden: int = 64):
        super().__init__()
        self.actnorm = ActNormI(features)
        self.invconv = InvConvI(features)
        self.affine = CondAffineI(features, rrdb_channels, hidden) \
            if coupling else None

    def forward(self, x, ft, logdet, reverse: bool = False):
        if not reverse:
            x, logdet = self.actnorm(x, logdet)
            x, logdet = self.invconv(x, logdet)
            if self.affine is not None:
                x, logdet = self.affine(x, ft, logdet)
            return x, logdet
        if self.affine is not None:
            x, logdet = self.affine(x, ft, logdet, True)
        x, logdet = self.invconv(x, logdet, True)
        return self.actnorm(x, logdet, True)


class Split2dI(nn.Module):
    """Split2d: half of the channels consumed under the prior that the
    other half gives (mean and logs from even and odd channels)."""

    def __init__(self, num_channels: int, consume_ratio: float = 0.5,
                 logs_eps: float = 0.0):
        super().__init__()
        self.n_consume = int(round(num_channels * consume_ratio))
        self.n_pass = num_channels - self.n_consume
        self.logs_eps = logs_eps
        self.conv = GlowConvZeros(self.n_pass, self.n_consume * 2, 3)

    def _prior(self, z1):
        return _split_cross(self.conv(z1.permute(0, 3, 1, 2))
                            .permute(0, 2, 3, 1))

    def forward(self, x, logdet, reverse: bool = False, eps=None):
        if not reverse:
            z1, z2 = x[..., :self.n_pass], x[..., self.n_pass:]
            mean, logs = self._prior(z1)
            out_eps = (z2 - mean) / (torch.exp(logs) + self.logs_eps)
            return z1, logdet + gaussian_logp(z2, mean, logs), out_eps
        mean, logs = self._prior(x)
        z2 = mean + (torch.exp(logs) + self.logs_eps) * eps
        if logdet is not None:
            logdet = logdet - gaussian_logp(z2, mean, logs)
        return torch.cat([x, z2], -1), logdet, None


class _Squeeze(nn.Module):
    """A level's squeeze: a layer of the reference's list with no
    parameters."""

    def forward(self, x):
        return squeeze2d(x)


class SRFlowEncoderI(nn.Module):
    """The SRFlow variant of the RRDB encoder. ``forward(x)`` (NHWC) -> the
    conditionals that ``keys`` names (of ``fea_up0``, ``fea_up1``,
    ``fea_up2``, ``fea_up4``, ``last_lr_fea`` and ``out``), each but
    ``out`` with the tapped blocks' features joined (f32 not forced: the
    encoder's dtype)."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64,
                 nb: int = 23, gc: int = 32, scale: int = 4,
                 blocks: Sequence[int] = (1, 8, 15, 22),
                 fea_up0: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks, self.fea_up0, self.dtype = tuple(blocks), fea_up0, dtype
        self.conv_first = Conv(in_nc, nf, 3)
        self.RRDB_trunk = nn.ModuleList([RRDB(nf, gc, 3) for _ in range(nb)])
        self.trunk_conv = Conv(nf, nf, 3)
        self.upconv1 = Conv(nf, nf, 3)
        self.upconv2 = Conv(nf, nf, 3)
        self.HRconv = Conv(nf, nf, 3)
        self.conv_last = Conv(nf, out_nc, 3)

    def _c(self, conv, x):
        """A conv of the NHWC ``x``."""
        return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward(self, x, keys=("fea_up0", "fea_up1", "fea_up2", "fea_up4",
                               "last_lr_fea", "out")) -> Dict[str,
                                                              torch.Tensor]:
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        h = self.conv_first(x)
        taps = {}
        for i, block in enumerate(self.RRDB_trunk):
            h = block(h)
            if i in self.blocks:
                taps[i] = h
        last = (h + self.trunk_conv(h)).permute(0, 2, 3, 1)
        results = {"last_lr_fea": last, "fea_up1": last}
        if {"fea_up2", "fea_up4", "out"} & set(keys):
            results["fea_up2"] = F.leaky_relu(
                self._c(self.upconv1, nearest_up(last, 2)), 0.2)
        if {"fea_up4", "out"} & set(keys):
            results["fea_up4"] = F.leaky_relu(
                self._c(self.upconv2, nearest_up(results["fea_up2"], 2)), 0.2)
        if "out" in keys:
            hr = F.leaky_relu(self._c(self.HRconv, results["fea_up4"]), 0.2)
            results["out"] = self._c(self.conv_last, hr)
        if self.fea_up0:
            b, lh, lw, _ = last.shape
            results["fea_up0"] = resize_torch(
                last, size=(int(round(lh * 0.5)), int(round(lw * 0.5))),
                mode="bilinear")
        results = {k: v for k, v in results.items() if k in keys}
        if self.blocks:
            concat = torch.cat([taps[i] for i in self.blocks],
                               1).permute(0, 2, 3, 1)
            for k, v in results.items():
                if k != "out":
                    results[k] = torch.cat([v, interpolate(
                        concat, size=(v.shape[1], v.shape[2]),
                        mode="nearest")], -1)
        return results


class _FlowUpsampler(nn.Module):
    """Holds the flow's ``layers`` under the reference's module name."""

    def __init__(self, layers: List[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class SRFlowNetI(nn.Module):
    """Reference-exact SRFlowNet (the scale-4 layout). ``forward(gt=hr,
    lr=lr, noise=u)`` -> ``(z, nll, logdet)`` (with ``train`` the
    quantisation: ``noise``, uniform [0, 1) draws of gt's shape, when
    given, and its log-determinant offset); ``forward(lr=lr, reverse=True,
    z=..., eps_list=...)`` and ``sample`` -> ``(sr, logdet)``;
    ``encode_eps`` -> ``(z, logdet, eps_list)`` with no noise."""

    LEVEL_NAMES = {0: "fea_up4", 1: "fea_up2", 2: "fea_up1", 3: "fea_up0",
                   4: "fea_up-1"}

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64,
                 nb: int = 23, gc: int = 32, scale: int = 4, K: int = 16,
                 L: int = 3, n_noaffine: int = 2, hidden: int = 64,
                 quant: float = 255.0,
                 blocks: Sequence[int] = (1, 8, 15, 22),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale, self.L, self.quant = scale, L, quant
        self.dtype = dtype
        self.train_encoder = True
        self.RRDB = SRFlowEncoderI(in_nc, out_nc, nf, nb, gc, scale, blocks,
                                   fea_up0=True, dtype=dtype)
        n_rrdb = (len(blocks) + 1) * nf
        layers: List[nn.Module] = []
        c = out_nc
        for level in range(1, L + 1):
            layers.append(_Squeeze())
            c *= 4
            layers += [FlowStepI(c, coupling=False)
                       for _ in range(n_noaffine)]
            layers += [FlowStepI(c, True, n_rrdb, hidden) for _ in range(K)]
            if level < L - 1:
                layers.append(Split2dI(c))
                c -= int(round(c * 0.5))
        self.flowUpsamplerNet = _FlowUpsampler(layers)
        self.final_c = c

    def _keys(self) -> tuple:
        return tuple({self.LEVEL_NAMES.get(lv, "fea_up1")
                      for lv in range(1, self.L + 1)})

    def _conditionals(self, lr):
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and self.train_encoder):
            return self.RRDB(lr, keys=self._keys())

    def _run(self, z, rrdb_results, logdet, reverse: bool,
             eps_list: Optional[List[torch.Tensor]] = None):
        out_eps: List[torch.Tensor] = []
        in_eps = list(eps_list) if eps_list else []
        layers = list(self.flowUpsamplerNet.layers)
        level = 0
        if reverse:
            layers.reverse()
            level = self.L
        for layer in layers:
            if isinstance(layer, _Squeeze):
                if not reverse:
                    z, level = squeeze2d(z), level + 1
                else:
                    z, level = unsqueeze2d(z), level - 1
                continue
            if isinstance(layer, FlowStepI):
                ft = rrdb_results.get(self.LEVEL_NAMES.get(level, "fea_up1"))
                z, logdet = layer(z, None if ft is None else ft.to(z.dtype),
                                  logdet, reverse)
            elif not reverse:
                z, logdet, eps = layer(z, logdet)
                out_eps.append(eps)
            else:
                z, logdet, _ = layer(z, logdet, True, eps=in_eps.pop())
        return z, logdet, out_eps

    def forward(self, gt=None, lr=None, z=None, eps_std: float = 1.0,
                reverse: bool = False, noise: Optional[torch.Tensor] = None,
                train: bool = True, eps_list=None):
        if reverse:
            return self.sample(lr, z, eps_std, eps_list)
        rrdb_results = self._conditionals(lr)
        pixels = gt.shape[1] * gt.shape[2]
        x = gt.float()
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        if train:
            if noise is not None:
                x = x + (noise - 0.5) / self.quant
            logdet = logdet + float(-math.log(self.quant) * pixels)
        z, logdet, _ = self._run(x, rrdb_results, logdet, reverse=False)
        nll = -(logdet + gaussian_logp(z)) / float(math.log(2.0) * pixels)
        return z, nll, logdet

    def encode_eps(self, gt, lr):
        rrdb_results = self._conditionals(lr)
        x = gt.float()
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        return self._run(x, rrdb_results, logdet, reverse=False)

    def top_shape(self, lr_shape) -> tuple:
        b, h, w = lr_shape[:3]
        f = 2 ** self.L
        return (b, h * self.scale // f, w * self.scale // f, self.final_c)

    def eps_shapes(self, lr_shape) -> List[tuple]:
        """The split latents' shapes, in the order of ``encode_eps``'s
        list."""
        b, h, w = lr_shape[:3]
        out, level = [], 0
        for layer in self.flowUpsamplerNet.layers:
            if isinstance(layer, _Squeeze):
                level += 1
            elif isinstance(layer, Split2dI):
                f = 2 ** level
                out.append((b, h * self.scale // f, w * self.scale // f,
                            layer.n_consume))
        return out

    def sample(self, lr, z=None, eps_std: float = 1.0, eps_list=None,
               draws=None, with_logdet: bool = True):
        """SR from the top latent ``z`` (else ``draws(shape) * eps_std``)
        and the split latents ``eps_list`` (else drawn, the last level's
        first, times ``eps_std``); without ``with_logdet`` the
        log-determinant is None and not computed."""
        rrdb_results = self._conditionals(lr)
        if z is None:
            z = draws(self.top_shape(lr.shape)) * eps_std
        if eps_list is None:
            eps_list = [None] * len(self.eps_shapes(lr.shape))
            for i, shape in reversed(list(enumerate(
                    self.eps_shapes(lr.shape)))):
                eps_list[i] = draws(shape) * eps_std
        z = z.float()
        logdet = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device) \
            if with_logdet else None
        sr, logdet, _ = self._run(z, rrdb_results, logdet, reverse=True,
                                  eps_list=eps_list)
        return sr, logdet

    def sample_shapes(self, lr_shape) -> List[tuple]:
        """The draws of a sample in the order they are made: the top
        latent, then each split's from the last level down."""
        return [self.top_shape(lr_shape)] + self.eps_shapes(lr_shape)[::-1]

    def sample_from(self, lr, draws: List[torch.Tensor]) -> torch.Tensor:
        """The SR image of ``sample`` from draws made in the order of
        ``sample_shapes`` (already times the temperature)."""
        return self.sample(lr, z=draws[0], eps_list=list(draws[1:])[::-1],
                           with_logdet=False)[0]

    def blocks(self) -> List[ResidualDenseBlock5C]:
        return [m for m in self.RRDB.modules()
                if isinstance(m, ResidualDenseBlock5C)]

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's default init (LeCun normal, zero biases) of every conv but
        the blocks' (Kaiming x 0.1) and the zero convs (zeros); orthogonal
        invertible convs; zero ActNorms and logs."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, ResidualDenseBlock5C):
                    for c in m.convs():
                        kaiming_init_(c.weight, 0.1, generator)
                        c.bias.zero_()
                elif isinstance(m, GlowConvZeros):
                    m.weight.zero_()
                    m.bias.zero_()
                    m.logs.zero_()
                elif isinstance(m, (Conv, GlowConv)):
                    m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                                     generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, InvConvI):
                    orthogonal_(m.weight, generator)
                elif isinstance(m, ActNormI):
                    m.bias.zero_()
                    m.logs.zero_()

    def flax_paths(self) -> Dict[str, tuple]:
        """Each state_dict key -> (collection, path in the flax
        ``SRFlowNetI`` tree, kind)."""
        out: Dict[str, tuple] = {}
        enc = self.RRDB
        for name in ("conv_first", "trunk_conv", "upconv1", "upconv2",
                     "HRconv", "conv_last"):
            out.update(conv_paths(f"RRDB.{name}", getattr(enc, name),
                                  ("encoder", name)))
        for i, rrdb in enumerate(enc.RRDB_trunk):
            for j in range(1, rrdb.nr + 1):
                for k, conv in enumerate(getattr(rrdb, f"RDB{j}").convs()):
                    out.update(conv_paths(
                        f"RRDB.RRDB_trunk.{i}.RDB{j}.conv{k + 1}", conv,
                        ("encoder", f"RRDB{i}", f"RDB{j}", f"conv{k + 1}")))

        def glow(key, m, path):
            if isinstance(m, GlowConvZeros):
                out.update(conv_paths(key, m, path + ("conv",)))
                out[f"{key}.logs"] = ("params", path + ("logs",), "vec")
            else:
                out[f"{key}.weight"] = ("params", path + ("conv", "kernel"),
                                        "conv")
                for leaf in ("bias", "logs"):
                    out[f"{key}.actnorm.{leaf}"] = (
                        "params", path + ("actnorm", leaf), "vec")

        for i, layer in enumerate(self.flowUpsamplerNet.layers):
            pre, path = f"flowUpsamplerNet.layers.{i}", (f"layers_{i}",)
            if isinstance(layer, FlowStepI):
                for leaf in ("bias", "logs"):
                    out[f"{pre}.actnorm.{leaf}"] = (
                        "params", path + ("actnorm", leaf), "vec")
                out[f"{pre}.invconv.weight"] = (
                    "params", path + ("invconv", "weight"), "vec")
                if layer.affine is not None:
                    for fn in ("fAffine", "fFeatures"):
                        for j in (0, 2, 4):
                            glow(f"{pre}.affine.{fn}.{j}",
                                 getattr(layer.affine, fn)[j],
                                 path + ("affine", fn, f"f{j}"))
            elif isinstance(layer, Split2dI):
                glow(f"{pre}.conv", layer.conv, path + ("conv",))
        return out
