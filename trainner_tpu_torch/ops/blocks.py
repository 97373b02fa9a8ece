"""Building blocks of the generator and the discriminator.

Counterpart of ``trainner_tpu/ops/blocks.py``: ``kaiming_init:27``,
``act:44``, ``finalact:73``, ``depth_to_space:112``, ``wire_to_f01:169``,
``nearest_up:180``, ``ConvBlock:192`` (CNA, zero padding, no norm or a
batch norm that reproduces flax's), ``GaussianNoise:282`` (relative noise
in train mode, the identity at eval), ``PixelShuffleBlock:315`` and
``UpconvBlock:369``.

Modules take and return NCHW tensors (the network keeps them in
``channels_last`` memory, so NHWC views of them are contiguous); the free
functions ``depth_to_space`` and ``nearest_up`` take NHWC, as in the JAX
package. Parameters stay f32; a conv runs in the dtype of its input, as the
JAX modules' ``dtype`` policy does. Each block holds its conv's ``weight``
and ``bias`` itself, so that state-dict keys follow the reference ``.pth``
layout (``upconv1.weight``, ``HRconv.bias``, ...).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.graphs import device_constant


def kaiming_init_(weight: torch.Tensor, scale: float = 1.0,
                  generator: Optional[torch.Generator] = None,
                  negative_slope: float = 0.0) -> torch.Tensor:
    """Kaiming-normal fan-in init times ``scale``: std = scale *
    sqrt(2 / ((1 + a^2) * fan_in)) (``blocks.kaiming_init``)."""
    fan_in = weight[0].numel()
    std = scale * math.sqrt(2.0 / ((1.0 + negative_slope ** 2) * fan_in))
    with torch.no_grad():
        return weight.normal_(0.0, std, generator=generator)


def act(act_type: Optional[str], neg_slope: float = 0.2) -> Callable:
    """String -> activation function."""
    if not act_type:
        return lambda x: x
    act_type = act_type.lower()
    table = {
        "relu": F.relu,
        "leakyrelu": lambda x: F.leaky_relu(x, neg_slope),
        "lrelu": lambda x: F.leaky_relu(x, neg_slope),
        "tanh": torch.tanh,
        "sigmoid": torch.sigmoid,
        "swish": F.silu,
        "silu": F.silu,
        "selu": F.selu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "elu": F.elu,
    }
    if act_type not in table:
        raise NotImplementedError(
            f"activation [{act_type}] is not ported yet (ROADMAP Queue A, "
            "norms and other block options)")
    return table[act_type]


def finalact(mode: Optional[str]) -> Callable:
    """Output cap: tanh / sigmoid / clamp / scaltanh."""
    if not mode:
        return lambda x: x
    mode = mode.lower()
    if mode == "tanh":
        return torch.tanh
    if mode == "sigmoid":
        return torch.sigmoid
    if mode in ("clamp", "clip"):
        return lambda x: torch.clamp(x, 0.0, 1.0)
    if mode == "scaltanh":
        return lambda x: 0.5 * torch.tanh(x) + 0.5
    raise NotImplementedError(f"final activation [{mode}] not found")


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC depth_to_space with torch.pixel_shuffle's (c_out, r, r)
    channel order."""
    b, h, w, c = x.shape
    c_out = c // (r * r)
    x = x.reshape(b, h, w, c_out, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c_out)


def wire_to_f01(x: torch.Tensor, znorm: bool = False) -> torch.Tensor:
    """Normalises a wire batch on the device: uint8 -> [0, 1] f32 (/255,
    and to [-1, 1] with ``znorm``); float batches pass through as f32."""
    if x.dtype == torch.uint8:
        y = x.float() * (1.0 / 255.0)
        return y * 2.0 - 1.0 if znorm else y
    return x.float()


def nearest_up(x: torch.Tensor, r: int) -> torch.Tensor:
    """Exact nearest upsample of an NHWC tensor by an integer factor."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, r, w, r, c)
    return x.reshape(b, h * r, w * r, c)


class _Conv(nn.Module):
    """Holds one conv's f32 ``weight`` (OIHW) and ``bias``."""

    def __init__(self, in_nc: int, out_nc: int, kernel_size: int,
                 use_bias: bool = True, stride: int = 1):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(out_nc, in_nc, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_nc)) if use_bias else None
        self.stride = stride

    def init_weights(self, scale: float, generator: torch.Generator):
        kaiming_init_(self.weight, scale, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def _conv(self, x, weight=None, bias=None):
        """Zero padding of (k - 1) // 2 on each side, as ``explicit_pad``
        before a VALID conv gives (1 for the 4x4 stride-2 kernel)."""
        weight = self.weight if weight is None else weight
        bias = self.bias if bias is None else bias
        return F.conv2d(x, weight.to(x.dtype),
                        None if bias is None else bias.to(x.dtype),
                        stride=self.stride,
                        padding=(weight.shape[-1] - 1) // 2)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over NCHW: momentum 0.99, eps 1e-5,
    statistics in f32 whatever the input's type, variance as E[x^2] -
    E[x]^2 clipped at 0, and a running variance that is the *biased* batch
    variance (torch stores the unbiased one).

    In train mode it normalises with the batch statistics and leaves the
    new running statistics in ``pending`` instead of writing them:
    ``commit`` writes the last pass's. So a caller can run the module
    several times per step and keep one update, or none, as the JAX
    trainer does with the ``batch_stats`` collection."""

    def __init__(self, num_features: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.pending = None

    def forward(self, x):
        x32 = x.float()
        if self.training:
            mean = x32.mean((0, 2, 3))
            var = ((x32 * x32).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.pending = (m * self.running_mean + (1 - m) * mean,
                                m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[None, :, None, None]) * mul[None, :, None, None] \
            + self.bias[None, :, None, None]
        return y.to(x.dtype)

    def commit(self) -> None:
        """Writes the running statistics of the last train-mode pass."""
        if self.pending is not None:
            self.running_mean.copy_(self.pending[0])
            self.running_var.copy_(self.pending[1])
            self.pending = None


class ConvBlock(_Conv):
    """conv (+ batch norm) + act in the CNA order, zero padding."""

    def __init__(self, in_nc: int, out_nc: int, kernel_size: int = 3,
                 act_type: Optional[str] = "relu", norm_type=None,
                 mode: str = "CNA", pad_type: str = "zero",
                 use_bias: bool = True, stride: int = 1):
        norm_type = (norm_type or "").lower() or None
        if norm_type not in (None, "batch") or mode != "CNA" \
                or pad_type != "zero":
            raise NotImplementedError(
                "ConvBlock supports CNA, zero padding and no norm or batch "
                "norm; the rest is not ported yet (ROADMAP Queue A 2.5, "
                "norms and other block options)")
        super().__init__(in_nc, out_nc, kernel_size, use_bias, stride)
        self.norm = BatchNorm(out_nc) if norm_type == "batch" else None
        self.act = act(act_type)

    def forward(self, x):
        x = self._conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return self.act(x)


class GaussianNoise(nn.Module):
    """Train-time latent noise, relative to the input and with no gradient
    through the scale: ``x + sigma * x.detach() * randn``. The identity in
    eval mode. The draw comes from ``generator`` (one on x's device, which
    the trainer owns and sets), or from torch's default generator when
    none is set. The trainer registers its generator with every graph that
    captures the step, so each replay draws fresh noise."""

    def __init__(self, sigma: float = 0.1):
        super().__init__()
        self.sigma = sigma
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or not self.sigma:
            return x
        noise = torch.randn(x.shape, dtype=x.dtype, device=x.device,
                            generator=self.generator)
        return x + self.sigma * x.detach() * noise


class PixelShuffleBlock(_Conv):
    """conv(C -> C*r^2) + pixel shuffle + act."""

    def __init__(self, in_nc: int, out_nc: int, upscale: int = 2,
                 kernel_size: int = 3, act_type: Optional[str] = "relu",
                 norm_type=None):
        if norm_type:
            raise NotImplementedError(
                "PixelShuffleBlock norms are not ported yet (ROADMAP "
                "Queue A, norms and other block options)")
        super().__init__(in_nc, out_nc * upscale * upscale, kernel_size)
        self.upscale = upscale
        self.act = act(act_type)

    def forward(self, x):
        return self.act(F.pixel_shuffle(self._conv(x), self.upscale))


# Row maps of the LR-space form: HR row 2i+a of the nearest-upsampled map
# reads LR rows floor((a+u)/2), u in {-1, 0, 1}.
_PHASE_MAPS = ([[1., 0., 0.], [0., 1., 1.], [0., 0., 0.]],
               [[0., 0., 0.], [1., 1., 0.], [0., 0., 1.]])


def upconv_lr_weights(weight: torch.Tensor, bias: torch.Tensor):
    """3x3 conv after a 2x nearest upsample -> one 3x3 conv in LR space
    with 4x the output channels (channel o*4 + a*2 + b, the order that
    pixel_shuffle reads), and its repeated bias."""
    m = device_constant(_PHASE_MAPS, weight.dtype, weight.device)
    wp = torch.stack([torch.einsum("ru,sv,oiuv->oirs", m[a], m[b], weight)
                      for a in (0, 1) for b in (0, 1)], dim=1)
    wp = wp.reshape(4 * weight.shape[0], weight.shape[1], 3, 3)
    return wp, bias.repeat_interleave(4)


class UpconvBlock(_Conv):
    """Nearest upsample + conv + act.

    At 2x with a 3x3 kernel it runs the exact LR-space form that the JAX
    package runs at eval: one LR conv with 4x the output channels, then a
    pixel shuffle, with no HR-size intermediate before the conv. Other
    factors upsample first."""

    def __init__(self, in_nc: int, out_nc: int, upscale: int = 2,
                 kernel_size: int = 3, act_type: Optional[str] = "relu",
                 mode: str = "nearest"):
        if mode != "nearest" or not float(upscale).is_integer():
            raise NotImplementedError(
                f"upconv mode [{mode}] x{upscale} is not ported yet "
                "(ROADMAP Queue A, norms and other block options)")
        super().__init__(in_nc, out_nc, kernel_size)
        self.upscale = int(upscale)
        self.act = act(act_type)

    def forward(self, x):
        if self.upscale == 2 and self.weight.shape[-1] == 3:
            wp, bp = upconv_lr_weights(self.weight, self.bias)
            return self.act(F.pixel_shuffle(self._conv(x, wp, bp), 2))
        x = x.repeat_interleave(self.upscale, dim=2) \
             .repeat_interleave(self.upscale, dim=3)
        return self.act(self._conv(x))
