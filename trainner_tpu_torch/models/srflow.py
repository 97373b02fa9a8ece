"""SRFlow, the normalizing-flow SR net: counterpart of
``trainner_tpu/models/srflow.py`` (``squeeze2:43``, ``unsqueeze2:50``,
``gaussian_logp:56``, ``ActNorm:68``, ``InvConv1x1:94``, ``_FNet:116``,
``CondAffine:140``, ``FlowStep:187``, ``Split2d:211``, ``RRDBEncoder:242``,
``SRFlowNet:276``).

Tensors are NHWC, as in the JAX module; the flow runs in f32 (its
parameters, the latents and the log-determinants), the encoder in the
net's dtype. The encoder's ``nb`` residual dense blocks are the port's
``ResidualDenseBlock5C`` of the flagship form, so they run the block
kernels (``ops/rdb5c.py``: the forward alone under ``no_grad``, the
forward with residuals and the kernel backward under autograd). The
squeeze is glow's ``(by, bx, c)`` order; the conditioning features are
resized to each level by ``ops/blocks.py::resize_torch`` (bilinear, no
antialias: what the JAX ``interpolate`` computes at these ratios, and a
backward of contractions, which adds in a fixed order on the card). The
invertible 1x1 conv takes its log-determinant from ``torch.linalg.slogdet``
and its inverse from ``torch.linalg.inv_ex``: neither reads the device,
so both stay inside a CUDA graph.

Random draws (the quantisation noise, the sampled latents) are never made
here: the caller passes them (``noise``, ``z``, ``epses``). Without
``noise`` the NLL call adds none, as the JAX module does with no ``rng``,
and the quantisation's log-determinant offset still applies under
``add_gt_noise``. Module names are the flax ones (``RRDB``, ``rdb{i}``,
``cond_proj{lv}``, ``step{lv}_{k}``, ``split{lv}``), which ``flax_paths``
maps. The JAX module's traps are ROADMAP C 26.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import Conv, conv_nhwc, kaiming_init_, named_flax_paths, \
    resize_torch
from .rrdb import ResidualDenseBlock5C

LOG2 = math.log(2.0)
LOG2PI = math.log(2 * math.pi)


def squeeze2(x: torch.Tensor) -> torch.Tensor:
    """(b, h, w, c) -> (b, h/2, w/2, 4c), glow's (by, bx, c) order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def unsqueeze2(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, 2, 2, c // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * 2, w * 2, c // 4)


def gaussian_logp(x: torch.Tensor, mean=None, logs=None) -> torch.Tensor:
    """log N(x; mean, exp(logs)^2) summed over every axis but the batch."""
    if mean is None:
        ll = -0.5 * (x ** 2 + LOG2PI)
    else:
        ll = -0.5 * ((x - mean) ** 2 / torch.exp(2.0 * logs) + LOG2PI) \
            - logs
    return ll.sum((1, 2, 3))


def orthogonal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """The Q of the QR of a standard normal draw (the invertible conv's
    init)."""
    with torch.no_grad():
        q = torch.linalg.qr(torch.randn(w.shape, generator=generator))[0]
        w.copy_(q)


class ActNorm(nn.Module):
    """Per-channel affine (x + bias) * exp(logs), with its log-determinant."""

    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))
        self.logs = nn.Parameter(torch.zeros(channels))

    def flax_leaves(self):
        return {"bias": ("bias", "vec"), "logs": ("logs", "vec")}

    def forward(self, x, logdet, reverse: bool = False):
        if logdet is not None:
            dlogdet = self.logs.sum() * (x.shape[1] * x.shape[2])
            logdet = logdet - dlogdet if reverse else logdet + dlogdet
        if not reverse:
            return (x + self.bias) * torch.exp(self.logs), logdet
        return x * torch.exp(-self.logs) - self.bias, logdet


class InvConv1x1(nn.Module):
    """y = x w over the channels, log|det w| per pixel."""

    def __init__(self, channels: int):
        super().__init__()
        self.w = nn.Parameter(torch.eye(channels))

    def flax_leaves(self):
        return {"w": ("w", "vec")}

    def forward(self, x, logdet, reverse: bool = False):
        if logdet is not None:
            dlogdet = torch.linalg.slogdet(self.w)[1] * (x.shape[1]
                                                         * x.shape[2])
            logdet = logdet - dlogdet if reverse else logdet + dlogdet
        if not reverse:
            return x @ self.w.to(x.dtype), logdet
        return x @ torch.linalg.inv_ex(self.w)[0].to(x.dtype), logdet


class _FNet(nn.Module):
    """Coupling net: 3x3 conv, ReLU, 1x1 conv, ReLU, zero-initialised 3x3
    conv, times exp(3 logs)."""

    def __init__(self, in_nc: int, out_nc: int, hidden: int = 64):
        super().__init__()
        self.conv0 = Conv(in_nc, hidden, 3)
        self.conv1 = Conv(hidden, hidden, 1)
        self.conv_zero = Conv(hidden, out_nc, 3)
        self.logs = nn.Parameter(torch.zeros(out_nc))

    def flax_leaves(self):
        return {"logs": ("logs", "vec")}

    def forward(self, x):
        h = F.relu(conv_nhwc(self.conv0, x))
        h = F.relu(conv_nhwc(self.conv1, h))
        return conv_nhwc(self.conv_zero, h) * torch.exp(self.logs * 3.0)


class CondAffine(nn.Module):
    """A feature-conditional affine of all of z, then a self-conditional
    affine of its second half given (first half, features)."""

    def __init__(self, channels: int, cond_nc: int, hidden: int = 64,
                 eps: float = 1e-4):
        super().__init__()
        self.c1 = channels // 2
        self.eps = eps
        self.fFeatures = _FNet(cond_nc, 2 * channels, hidden)
        self.fAffine = _FNet(self.c1 + cond_nc, 2 * (channels - self.c1),
                             hidden)

    def _scale_shift(self, h):
        shift, scale = h.chunk(2, dim=-1)
        return torch.sigmoid(scale + 2.0) + self.eps, shift

    def forward(self, x, ft, logdet, reverse: bool = False):
        def ld(scale):
            return torch.log(scale).sum((1, 2, 3))

        c1 = self.c1
        if not reverse:
            scale_ft, shift_ft = self._scale_shift(self.fFeatures(ft))
            x = (x + shift_ft) * scale_ft
            logdet = logdet + ld(scale_ft)
            z1, z2 = x[..., :c1], x[..., c1:]
            scale, shift = self._scale_shift(
                self.fAffine(torch.cat([z1, ft], -1)))
            z2 = (z2 + shift) * scale
            return torch.cat([z1, z2], -1), logdet + ld(scale)
        z1, z2 = x[..., :c1], x[..., c1:]
        scale, shift = self._scale_shift(self.fAffine(torch.cat([z1, ft],
                                                                -1)))
        z2 = z2 / scale - shift
        x = torch.cat([z1, z2], -1)
        scale_ft, shift_ft = self._scale_shift(self.fFeatures(ft))
        if logdet is not None:
            logdet = logdet - ld(scale) - ld(scale_ft)
        return x / scale_ft - shift_ft, logdet


class FlowStep(nn.Module):
    """ActNorm -> InvConv1x1 -> CondAffine (and back in reverse)."""

    def __init__(self, channels: int, cond_nc: int, hidden: int = 64):
        super().__init__()
        self.actnorm = ActNorm(channels)
        self.invconv = InvConv1x1(channels)
        self.affine = CondAffine(channels, cond_nc, hidden)

    def forward(self, x, ft, logdet, reverse: bool = False):
        if not reverse:
            x, logdet = self.actnorm(x, logdet)
            x, logdet = self.invconv(x, logdet)
            return self.affine(x, ft, logdet)
        x, logdet = self.affine(x, ft, logdet, True)
        x, logdet = self.invconv(x, logdet, True)
        return self.actnorm(x, logdet, True)


class Split2d(nn.Module):
    """Factors out the last half of the channels under a prior that the
    first half conditions (its hidden width is 64 whatever the flow's)."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        self.c2 = channels // 2
        self.prior = _FNet(channels - self.c2, 2 * self.c2, 64)

    def forward(self, x, logdet, reverse: bool = False, eps=None):
        """Forward: (z1, logdet + log p(z2), the normalised z2). Reverse:
        (z1 joined with mean + exp(logs) eps, logdet, None)."""
        if not reverse:
            n = self.channels - self.c2
            z1, z2 = x[..., :n], x[..., n:]
            mean, logs = self.prior(z1).chunk(2, dim=-1)
            logdet = logdet + gaussian_logp(z2, mean, logs)
            return z1, logdet, (z2 - mean) * torch.exp(-logs)
        mean, logs = self.prior(x).chunk(2, dim=-1)
        return torch.cat([x, mean + torch.exp(logs) * eps], -1), logdet, None


class RRDBEncoder(nn.Module):
    """conv_first, ``nb`` residual dense blocks (the kernels' form), taps
    after the blocks of ``block_idxs``, trunk_conv; returns [conv_first +
    trunk, taps...] concatenated on the channels, NHWC, in ``dtype``."""

    def __init__(self, in_nc: int = 3, nf: int = 64, nb: int = 23,
                 gc: int = 32, block_idxs: Sequence[int] = (1, 8, 15, 22),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nb, self.dtype = nb, dtype
        self.block_idxs = tuple(i for i in block_idxs if i < nb)
        self.conv_first = Conv(in_nc, nf, 3)
        for i in range(nb):
            setattr(self, f"rdb{i}", ResidualDenseBlock5C(nf, gc))
        self.trunk_conv = Conv(nf, nf, 3)
        self.out_nc = nf * (1 + len(self.block_idxs))

    def blocks(self) -> List[ResidualDenseBlock5C]:
        return [getattr(self, f"rdb{i}") for i in range(self.nb)]

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        fea = self.conv_first(x)
        taps = []
        t = fea
        for i, block in enumerate(self.blocks()):
            t = block(t)
            if i in self.block_idxs:
                taps.append(t)
        out = torch.cat([fea + self.trunk_conv(t)] + taps, 1)
        return out.permute(0, 2, 3, 1)


class SRFlowNet(nn.Module):
    """Flow-based SR net. ``forward(gt=hr, lr=lr)`` -> ``(z, nll,
    logdet)`` (``return_epses``: the list of each split's normalised
    latent and the top z in place of z); ``forward(lr=lr, reverse=True,
    z=..., epses=...)`` -> ``(sr, logdet)``: the top latent from
    ``epses[-1]`` or ``z``, each split's from ``epses`` (its last level's
    first), else from ``draws`` (callables of a shape), times ``eps_std``;
    without ``with_logdet`` the log-determinant (which sampling does not
    read, and XLA drops from the JAX sampler) is None, and its terms
    (each invertible conv's slogdet among them) are not computed.
    """

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64,
                 nb: int = 23, gc: int = 32, scale: int = 4, K: int = 16,
                 L: int = 3, hidden_channels: int = 64, quant: int = 255,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_nc, self.scale, self.K, self.L = out_nc, scale, K, L
        self.quant = quant
        self.dtype = dtype
        self.train_encoder = True
        self.RRDB = RRDBEncoder(in_nc, nf, nb, gc, dtype=dtype)
        self.chans = self._levels()
        for lv in range(1, L + 1):
            setattr(self, f"cond_proj{lv}", Conv(self.RRDB.out_nc, nf, 1))
        for lv in range(1, L + 1):
            for k in range(K):
                setattr(self, f"step{lv}_{k}",
                        FlowStep(self.chans[lv - 1], nf, hidden_channels))
            if lv < L:
                setattr(self, f"split{lv}", Split2d(self.chans[lv - 1]))

    def _levels(self) -> List[int]:
        chans, c = [], self.out_nc
        for lv in range(1, self.L + 1):
            c *= 4
            chans.append(c)
            if lv < self.L:
                c -= c // 2
        return chans

    def top_shape(self, lr_shape) -> tuple:
        """The top latent's shape for an LR batch of ``lr_shape``."""
        b, h, w = lr_shape[:3]
        f = 2 ** self.L
        return (b, h * self.scale // f, w * self.scale // f, self.chans[-1])

    def eps_shapes(self, lr_shape) -> List[tuple]:
        """The shapes of the split latents, level 1 first."""
        b, h, w = lr_shape[:3]
        out = []
        for lv in range(1, self.L):
            f = 2 ** lv
            out.append((b, h * self.scale // f, w * self.scale // f,
                        self.chans[lv - 1] // 2))
        return out

    def sample_shapes(self, lr_shape) -> List[tuple]:
        """The draws of a sample in the order the JAX module makes them:
        the top latent, then each split's from the last level down."""
        return [self.top_shape(lr_shape)] + self.eps_shapes(lr_shape)[::-1]

    def sample_from(self, lr, draws: List[torch.Tensor]) -> torch.Tensor:
        """The SR image from draws made in the order of ``sample_shapes``
        (already times the temperature)."""
        epses = list(draws[1:])[::-1] + [draws[0]]
        return self(lr=lr, reverse=True, epses=epses, with_logdet=False)[0]

    def blocks(self) -> List[ResidualDenseBlock5C]:
        return self.RRDB.blocks()

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's default init (LeCun normal, zero biases) of the plain
        convs, Kaiming x 0.1 of the blocks' convs, an orthogonal draw for
        each invertible conv, zeros for the couplings' last convs, the
        logs and the ActNorms."""
        with torch.no_grad():
            for name, m in self.named_modules():
                if isinstance(m, Conv):
                    if name.endswith("conv_zero"):
                        m.weight.zero_()
                    else:
                        m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                                         generator=generator)
                    m.bias.zero_()
                elif isinstance(m, ResidualDenseBlock5C):
                    for c in m.convs():
                        kaiming_init_(c.weight, 0.1, generator)
                        c.bias.zero_()
                elif isinstance(m, InvConv1x1):
                    orthogonal_(m.w, generator)
                elif isinstance(m, (ActNorm, _FNet)):
                    m.logs.zero_()
                    if isinstance(m, ActNorm):
                        m.bias.zero_()

    def flax_paths(self) -> Dict[str, tuple]:
        return named_flax_paths(self)

    def conditions(self, lr: torch.Tensor) -> List[torch.Tensor]:
        """Each level's conditioning features (f32, NHWC): the encoder's
        output resized to the level and projected to nf, LeakyReLU 0.2.
        With ``train_encoder`` off the encoder runs without autograd."""
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and self.train_encoder):
            cond = self.RRDB(lr).float()
        lr_h, lr_w = lr.shape[1], lr.shape[2]
        hr_h, hr_w = lr_h * self.scale, lr_w * self.scale
        conds = []
        for lv in range(1, self.L + 1):
            size = (hr_h // 2 ** lv, hr_w // 2 ** lv)
            ft = cond if size == (lr_h, lr_w) else resize_torch(
                cond, size=size, mode="bilinear")
            ft = conv_nhwc(getattr(self, f"cond_proj{lv}"), ft)
            conds.append(F.leaky_relu(ft, 0.2))
        return conds

    def forward(self, gt=None, lr=None, z=None, eps_std: float = 1.0,
                reverse: bool = False, add_gt_noise: bool = True,
                noise: Optional[torch.Tensor] = None,
                return_epses: bool = False, epses=None, draws=None,
                with_logdet: bool = True):
        conds = self.conditions(lr)
        hr_h, hr_w = lr.shape[1] * self.scale, lr.shape[2] * self.scale
        pixels = float(hr_h * hr_w * self.out_nc)
        if not reverse:
            x = gt.float()
            logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
            if add_gt_noise:
                if noise is not None:
                    x = x + (noise - 0.5) / self.quant
                logdet = logdet + float(-math.log(self.quant) * pixels)
            out_eps = []
            for lv in range(1, self.L + 1):
                x = squeeze2(x)
                for k in range(self.K):
                    x, logdet = getattr(self, f"step{lv}_{k}")(
                        x, conds[lv - 1], logdet)
                if lv < self.L:
                    x, logdet, eps = getattr(self, f"split{lv}")(x, logdet)
                    out_eps.append(eps)
            out_eps.append(x)
            nll = -(logdet + gaussian_logp(x)) / (LOG2 * pixels)
            return (out_eps if return_epses else x), nll, logdet

        dev = conds[0].device
        if epses is not None:
            x = epses[-1]
        elif z is not None:
            x = z
        else:
            x = draws(self.top_shape(lr.shape)) * eps_std
        x = x.float()
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=dev) \
            if with_logdet else None
        shapes = self.eps_shapes(lr.shape)
        for lv in range(self.L, 0, -1):
            if lv < self.L:
                eps = epses[lv - 1] if epses is not None else \
                    draws(shapes[lv - 1]) * eps_std
                x, logdet, _ = getattr(self, f"split{lv}")(x, logdet, True,
                                                           eps=eps)
            for k in reversed(range(self.K)):
                x, logdet = getattr(self, f"step{lv}_{k}")(
                    x, conds[lv - 1], logdet, True)
            x = unsqueeze2(x)
        return x, logdet
