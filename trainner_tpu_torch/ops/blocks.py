"""Building blocks of the generators and the discriminators.

Counterpart of ``trainner_tpu/ops/blocks.py``: ``kaiming_init:27``,
``act:44`` (``prelu`` as flax's ``nn.PReLU``), ``finalact:73``,
``explicit_pad:93``, ``depth_to_space:112``, ``space_to_depth:123``,
``interpolate:137``, ``wire_to_f01:169``, ``nearest_up:180``,
``ConvBlock:192`` (CNA, NAC and CNAC; zero, reflect and replicate padding;
no norm, flax's ``BatchNorm``, ``GroupNorm`` as an instance norm or
``LayerNorm`` over the channels; a ``PartialConv2D`` conv; flax's
``nn.SpectralNorm`` of its conv), ``bilinear_align_corners:571``,
``bilinear_torch:589``, ``GaussianNoise:282`` (relative noise in train
mode, the identity at eval), ``PixelShuffleBlock:315``,
``UpconvBlock:369`` (nearest, or bilinear / bicubic through
``interpolate``) and ``SelfAttentionBlock:441`` (with flax's spectral
norm of its convs or without); ``bicubic_torch:621`` (``resize_torch``);
``Conv`` (a bare conv, dilated or not) and ``Dense`` are flax's ``nn.Conv``
and ``nn.Dense`` as the PPON, PAN and A2N generators use them;
``TorchDeconv:500`` (torch's ``ConvTranspose2d``) and flax's ``nn.Dropout``
(``Dropout``) for the image-to-image generators. ``conv_paths`` and
``norm_paths`` give the flax names of a net's tensors (``named_flax_paths``
of a whole net whose module names are flax's), ``conv_nhwc`` runs an NCHW
conv on an NHWC tensor, ``resize_torch`` is torch's bilinear or bicubic
resize as weight matrices, ``lecun_init`` flax's default init.

Modules take and return NCHW tensors (the network keeps them in
``channels_last`` memory, so NHWC views of them are contiguous); the free
functions ``depth_to_space``, ``space_to_depth``, ``interpolate`` and
``nearest_up`` take NHWC, as in the JAX package, and ``explicit_pad``
takes the modules' NCHW. Parameters stay f32; a conv runs in the dtype of
its input, as the JAX modules' ``dtype`` policy does, and a norm takes its
statistics in f32 whatever its input's type, as flax's do. Each block
holds its conv's ``weight`` and ``bias`` itself, so that state-dict keys
follow the reference ``.pth`` layout (``upconv1.weight``, ``HRconv.bias``,
...).

A train-mode pass of a norm with state (``BatchNorm``, ``SpectralNorm``)
writes none: it leaves the new state pending, and ``commit_stats`` writes
the last pass's, so the caller decides which pass of a step counts.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tensor
from ..parallel.collectives import batch_mean, sample_draw
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


class PReLU(nn.Module):
    """flax's ``nn.PReLU``: one learned slope for every channel,
    ``negative_slope`` (a 0-d f32 parameter, 0.25 at init)."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(float(init)))

    def forward(self, x):
        return torch.where(x >= 0, x, self.negative_slope.to(x.dtype) * x)


def act(act_type: Optional[str], neg_slope: float = 0.2) -> Callable:
    """String -> activation function; ``prelu`` -> a ``PReLU`` module
    (whose slope is a parameter of the block that holds it)."""
    if not act_type:
        return lambda x: x
    act_type = act_type.lower()
    if act_type == "prelu":
        return PReLU(0.25)
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
        raise NotImplementedError(f"activation [{act_type}] not found")
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


_PAD_MODES = {"reflect": "reflect", "replicate": "replicate",
              "edge": "replicate"}


def explicit_pad(x: torch.Tensor, pad: int,
                 pad_type: str = "zero") -> torch.Tensor:
    """Spatial padding of an NCHW tensor by ``pad`` on each side: reflect,
    replicate (``edge``) or, for any other type, zeros."""
    if pad == 0:
        return x
    mode = _PAD_MODES.get(pad_type)
    if mode is None:
        return F.pad(x, (pad,) * 4)
    return F.pad(x, (pad,) * 4, mode=mode)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC depth_to_space with torch.pixel_shuffle's (c_out, r, r)
    channel order."""
    b, h, w, c = x.shape
    c_out = c // (r * r)
    x = x.reshape(b, h, w, c_out, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c_out)


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """The inverse of ``depth_to_space``: NHWC, torch.pixel_unshuffle's
    (c, r, r) channel order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // r, w // r, c * r * r)


def interpolate(x: torch.Tensor, scale=None, size=None,
                mode: str = "nearest") -> torch.Tensor:
    """``torch.nn.functional.interpolate``'s semantics on NHWC, as the JAX
    package's ``interpolate`` computes them: nearest reads source
    floor(i * in / out); bilinear and bicubic are ``jax.image.resize``'s
    (half-pixel centres, Keys' cubic, no antialiasing), in f32 and cast
    back to x's type."""
    from .imresize import jax_resize

    b, h, w, c = x.shape
    if size is None:
        size = (int(round(h * scale)), int(round(w * scale)))
    if mode == "nearest":
        if size[0] % h == 0 and size[1] % w == 0 and \
                size[0] // h == size[1] // w and size[0] > h:
            return nearest_up(x, size[0] // h)
        if h % size[0] == 0 and w % size[1] == 0 and size[0] <= h:
            return x[:, :: h // size[0], :: w // size[1]]
        iy = (torch.arange(size[0], device=x.device) * (h / size[0])).floor()
        ix = (torch.arange(size[1], device=x.device) * (w / size[1])).floor()
        return x[:, iy.long()][:, :, ix.long()]
    method = {"bilinear": "linear", "linear": "linear", "bicubic": "cubic",
              "cubic": "cubic"}.get(mode)
    if method is None:
        raise NotImplementedError(f"interpolate mode {mode}")
    return jax_resize(x, tuple(size), method, antialias=False).to(x.dtype)


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


def bilinear_torch(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Bilinear upsample of an NCHW tensor by ``scale`` with half-pixel
    centres, edge clamping and no antialiasing: what the JAX package's
    ``bilinear_torch`` computes with its weight matrices."""
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=False)


def bilinear_align_corners(x: torch.Tensor, scale: float = None,
                           size=None) -> torch.Tensor:
    """Bilinear resize of an NHWC tensor with torch's ``align_corners=True``
    convention (corner pixels map to corner pixels), as the JAX package
    computes it: a 2-tap weight matrix per axis, built on the device in
    f32 and contracted in x's type, H first."""
    b, h, w, c = x.shape
    if size is None:
        size = (int(round(h * scale)), int(round(w * scale)))

    def weights(n_out: int, n_in: int) -> torch.Tensor:
        dev = x.device
        if n_out == 1 or n_in == 1:
            return torch.full((n_out, n_in), 1.0 / n_in, device=dev)
        pos = torch.arange(n_out, dtype=torch.float32, device=dev) \
            * (n_in - 1) / (n_out - 1)
        pos = pos.clamp(0.0, n_in - 1.0)
        lo = pos.floor().long().clamp(0, n_in - 1)
        hi = (lo + 1).clamp(0, n_in - 1)
        frac = pos - lo.float()
        rows = torch.arange(n_out, device=dev)
        wm = torch.zeros((n_out, n_in), dtype=torch.float32, device=dev)
        wm.index_put_((rows, lo), 1.0 - frac, accumulate=True)
        wm.index_put_((rows, hi), frac, accumulate=True)
        return wm

    y = torch.einsum("oh,bhwc->bowc", weights(size[0], h).to(x.dtype), x)
    return torch.einsum("pw,bhwc->bhpc", weights(size[1], w).to(x.dtype), y)


def _torch_resize_weights(n_out: int, n_in: int, mode: str, device,
                          dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """The JAX package's (n_out, n_in) weight matrix of torch's
    half-pixel ``bilinear`` (2 taps) or ``bicubic`` (4 taps, a = -0.75)
    resize, source indices clamped to the edge, built in f32 (in f64 for
    an f64 witness)."""
    pos = (torch.arange(n_out, dtype=dtype, device=device) + 0.5) \
        * (n_in / n_out) - 0.5
    rows = torch.arange(n_out, device=device)
    wm = torch.zeros((n_out, n_in), dtype=dtype, device=device)
    if mode == "bilinear":
        pos = pos.clamp(0.0, n_in - 1.0)
        lo = pos.floor().long().clamp(0, n_in - 1)
        hi = (lo + 1).clamp(0, n_in - 1)
        frac = pos - lo.to(dtype)
        wm.index_put_((rows, lo), 1.0 - frac, accumulate=True)
        wm.index_put_((rows, hi), frac, accumulate=True)
        return wm
    a = -0.75
    base = pos.floor()
    for k in range(-1, 3):
        t = (pos - (base + k)).abs()
        w1 = ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0
        w2 = (((t - 5.0) * t + 8.0) * t - 4.0) * a
        wk = torch.where(t <= 1.0, w1, torch.where(t < 2.0, w2,
                                                   torch.zeros_like(t)))
        idx = (base.long() + k).clamp(0, n_in - 1)
        wm.index_put_((rows, idx), wk, accumulate=True)
    return wm


def resize_torch(x: torch.Tensor, scale: float = None, size=None,
                 mode: str = "bilinear") -> torch.Tensor:
    """torch's ``F.interpolate`` (``bilinear`` or ``bicubic``,
    ``align_corners=False``) of an NHWC tensor as the JAX package's
    ``bilinear_torch`` / ``bicubic_torch`` compute it: one weight matrix
    per axis, contracted in x's type, H first. Its backward is two more
    contractions, so it adds in a fixed order on the card, where
    ``F.interpolate``'s backward adds with atomics."""
    b, h, w, c = x.shape
    if size is None:
        size = (int(round(h * scale)), int(round(w * scale)))
    wdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    wh = _torch_resize_weights(size[0], h, mode, x.device, wdt).to(x.dtype)
    ww = _torch_resize_weights(size[1], w, mode, x.device, wdt).to(x.dtype)
    y = torch.einsum("oh,bhwc->bowc", wh, x)
    return torch.einsum("pw,bhwc->bhpc", ww, y)


def bicubic_torch(x: torch.Tensor, scale: float = None,
                  size=None) -> torch.Tensor:
    """The JAX package's ``bicubic_torch``: torch's ``bicubic``
    (``align_corners=False``, a = -0.75, edges clamped) of an NHWC tensor,
    by ``resize_torch``'s contractions."""
    return resize_torch(x, scale, size, mode="bicubic")


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralNorm(nn.Module):
    """flax's ``nn.SpectralNorm`` of one conv kernel, with one power step.

    The OIHW weight is read in flax's (kh, kw, in, out) order as a matrix
    W of shape (kh kw in, out); from the stored ``u`` (1, out) one power
    step gives v = l2n(u W^T) and u' = l2n(v W), with no gradient through
    either, and sigma = v W u'^T, which the gradient does flow through; the
    conv runs with W / sigma (unless sigma is 0). Every pass runs the power
    step from the stored ``u``, as flax's does with ``update_stats`` off;
    a train-mode pass leaves (u', sigma) in ``pending`` instead of writing
    them, and ``commit`` writes the last pass's, as ``BatchNorm`` does.
    ``u`` and ``sigma`` are buffers: D's state, not its parameters."""

    def __init__(self, out_nc: int, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.register_buffer("u", torch.zeros(1, out_nc))
        self.register_buffer("sigma", torch.ones(()))
        self.pending = None

    def init_state(self, generator: torch.Generator) -> None:
        """u from a standard normal, sigma 1 (flax's initialisers)."""
        with torch.no_grad():
            self.u.normal_(0.0, 1.0, generator=generator)
            self.sigma.fill_(1.0)

    def forward(self, weight: torch.Tensor) -> torch.Tensor:
        value = weight.permute(2, 3, 1, 0).reshape(-1, weight.shape[0])
        with torch.no_grad():
            w = value.detach()
            v0 = _l2_normalize(self.u @ w.T, self.eps)
            u0 = _l2_normalize(v0 @ w, self.eps)
        sigma = (v0 @ value @ u0.T)[0, 0]
        if self.training:
            self.pending = (u0, sigma.detach())
        return weight / torch.where(sigma != 0, sigma,
                                    torch.ones_like(sigma))

    def commit(self) -> None:
        """Writes ``u`` and ``sigma`` of the last train-mode pass."""
        if self.pending is not None:
            self.u.copy_(self.pending[0])
            self.sigma.copy_(self.pending[1])
            self.pending = None


class _Conv(nn.Module):
    """Holds one conv's f32 ``weight`` (OIHW) and ``bias``, and with
    ``spectral_norm`` the ``SpectralNorm`` of its weight (``sn``). Its
    conv runs through ``parallel/tensor.py::apply`` (by output column on
    a tensor axis); a subclass that convolves at a site of its own routes
    it there too, or sets ``tensor_routed`` False."""

    tensor_routed = True

    def __init__(self, in_nc: int, out_nc: int, kernel_size: int,
                 use_bias: bool = True, stride: int = 1,
                 spectral_norm: bool = False, dims: int = 2,
                 groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(out_nc, in_nc // groups, *(kernel_size,) * dims))
        self.bias = nn.Parameter(torch.zeros(out_nc)) if use_bias else None
        self.stride = stride
        self.groups = groups
        self.sn = SpectralNorm(out_nc) if spectral_norm else None
        # flax numbers a scope's SpectralNorm wrappers in creation order
        self.sn_index = 0

    def init_weights(self, scale: float, generator: torch.Generator):
        kaiming_init_(self.weight, scale, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def _conv(self, x, weight=None, bias=None):
        """Zero padding of (k - 1) // 2 on each side, as ``explicit_pad``
        before a VALID conv gives (1 for the 4x4 stride-2 kernel)."""
        weight = self.weight if weight is None else weight
        if self.sn is not None:
            weight = self.sn(weight)
        bias = self.bias if bias is None else bias
        conv = F.conv3d if weight.dim() == 5 else F.conv2d
        return tensor.apply(self, x, lambda x, w, b: conv(
            x, w, b, stride=self.stride, padding=(w.shape[-1] - 1) // 2,
            groups=self.groups), weight, bias)


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
            mean2 = (x32 * x32).mean((0, 2, 3))
            # the global batch's statistics under a data axis
            mean, mean2 = batch_mean(torch.stack([mean, mean2])).unbind(0)
            var = (mean2 - mean * mean).clamp_min(0.0)
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


class InstanceNorm(nn.Module):
    """flax's ``GroupNorm(num_groups=C, epsilon=1e-5)`` with no scale and
    no bias, as the JAX ``ConvBlock`` builds its instance norm: each
    sample's channel normalised over H and W, statistics in f32, variance
    as E[x^2] - E[x]^2 clipped at 0."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean((2, 3), keepdim=True)
        var = ((x32 * x32).mean((2, 3), keepdim=True)
               - mean * mean).clamp_min(0.0)
        return ((x32 - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` as the JAX ``ConvBlock`` runs it on NHWC:
    over the channel axis alone, eps 1e-6, with a scale and a bias per
    channel, statistics in f32."""

    def __init__(self, num_features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(1, keepdim=True)
        var = ((x32 * x32).mean(1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight[None, :, None, None]
        y = (x32 - mean) * mul + self.bias[None, :, None, None]
        return y.to(x.dtype)


def norm_layer(norm_type: Optional[str], num_features: int):
    """``batch`` | ``instance`` | ``layer`` | None -> the norm module."""
    if not norm_type:
        return None
    nt = norm_type.lower()
    if nt == "batch":
        return BatchNorm(num_features)
    if nt == "instance":
        return InstanceNorm()
    if nt == "layer":
        return LayerNorm(num_features)
    raise NotImplementedError(f"norm [{norm_type}] not found")


def commit_stats(net: nn.Module) -> None:
    """Writes the pending state of every batch norm and spectral norm of
    ``net`` (that of its last train-mode pass)."""
    for m in net.modules():
        if isinstance(m, (BatchNorm, SpectralNorm)):
            m.commit()


class ConvBlock(_Conv):
    """conv (+ norm) + act in the CNA or CNAC order (pad, conv, norm, act)
    or the NAC order (norm, act, pad, conv; the norm then over the input's
    channels). ``pad_type`` zero, reflect or replicate; ``convtype``
    ``PartialConv2D`` runs the conv as a partial convolution
    (``ops/partial_conv.py``), which owns its zero padding; with
    ``spectral_norm`` the conv's weight is spectrally normalised. ``dims``
    3 makes it a Conv3D block over NCDHW (EVSRGAN's trunk: zero padding,
    no norm)."""

    def __init__(self, in_nc: int, out_nc: int, kernel_size: int = 3,
                 act_type: Optional[str] = "relu", norm_type=None,
                 mode: str = "CNA", pad_type: str = "zero",
                 use_bias: bool = True, stride: int = 1,
                 spectral_norm: bool = False, convtype: str = "Conv2D",
                 dims: int = 2):
        if mode not in ("CNA", "NAC", "CNAC"):
            raise ValueError(f"ConvBlock mode [{mode}]: CNA, NAC or CNAC")
        if convtype.lower() not in ("conv2d", "partialconv2d"):
            raise NotImplementedError(f"convtype [{convtype}] not found")
        if dims == 3 and (norm_type or pad_type in _PAD_MODES
                          or convtype.lower() != "conv2d" or spectral_norm):
            raise NotImplementedError(
                "a Conv3D block with a norm, a padding other than zeros, a "
                "partial conv or spectral norm is not ported (EVSRGAN at "
                "its defaults builds none; ROADMAP C 25)")
        super().__init__(in_nc, out_nc, kernel_size, use_bias, stride,
                         spectral_norm, dims)
        self.mode, self.pad_type = mode, pad_type
        self.partial = convtype.lower() == "partialconv2d"
        self.norm = norm_layer(norm_type, in_nc if mode == "NAC" else out_nc)
        self.act = act(act_type)

    def _block_conv(self, x):
        pad = (self.weight.shape[-1] - 1) // 2
        if self.partial:
            from .partial_conv import partial_conv

            return partial_conv(x, self.weight, self.bias, self.stride, pad)
        if self.pad_type in _PAD_MODES:
            weight = self.weight if self.sn is None else self.sn(self.weight)
            return tensor.apply(self, explicit_pad(x, pad, self.pad_type),
                                lambda x, w, b: F.conv2d(
                                    x, w, b, stride=self.stride), weight)
        return self._conv(x)

    def forward(self, x):
        if self.mode == "NAC":
            if self.norm is not None:
                x = self.norm(x)
            return self._block_conv(self.act(x))
        x = self._block_conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return self.act(x)


class GaussianNoise(nn.Module):
    """Train-time latent noise, relative to the input and with no gradient
    through the scale: ``x + sigma * x.detach() * randn``. The identity in
    eval mode. The draw comes from ``generator`` (one on x's device, which
    the trainer owns and sets), or from torch's default generator when
    none is set. The trainer registers its generator with every graph that
    captures the step, so each replay draws fresh noise. With ``hold`` set
    the first draw is kept (``held``) and every later pass reuses it (a
    pass of another shape or type raises): the PBR trainer's passes over a
    step's maps share one draw, as the JAX ones share one key."""

    def __init__(self, sigma: float = 0.1):
        super().__init__()
        self.sigma = sigma
        self.generator: Optional[torch.Generator] = None
        self.hold = False
        self.held: Optional[torch.Tensor] = None

    def forward(self, x):
        if not self.training or not self.sigma:
            return x
        noise = self.held if self.hold else None
        if noise is not None and (noise.shape != x.shape
                                  or noise.dtype != x.dtype):
            raise ValueError(
                f"a held latent-noise draw of {tuple(noise.shape)} "
                f"{noise.dtype} cannot serve a pass of {tuple(x.shape)} "
                f"{x.dtype}")
        if noise is None:
            noise = sample_draw(lambda n: torch.randn(
                (n, *x.shape[1:]), dtype=x.dtype, device=x.device,
                generator=self.generator), x.shape[0])
            if self.hold:
                self.held = noise
        return x + self.sigma * x.detach() * noise


class PixelShuffleBlock(_Conv):
    """conv(C -> C*r^2) + pixel shuffle + act."""

    def __init__(self, in_nc: int, out_nc: int, upscale: int = 2,
                 kernel_size: int = 3, act_type: Optional[str] = "relu",
                 norm_type=None):
        if norm_type:
            raise NotImplementedError(
                "PixelShuffleBlock with a norm (the JAX block's 1x1 "
                "ConvBlock after the shuffle) serves no ported generator "
                "yet (ROADMAP Queue A 10, the rest of the zoo)")
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
    """Upsample (nearest, or bilinear / bicubic through ``interpolate``) +
    conv + act.

    Nearest at 2x with a 3x3 kernel runs the exact LR-space form that the
    JAX package runs at eval: one LR conv with 4x the output channels,
    then a pixel shuffle, with no HR-size intermediate before the conv.
    Other nearest factors upsample first."""

    def __init__(self, in_nc: int, out_nc: int, upscale=2,
                 kernel_size: int = 3, act_type: Optional[str] = "relu",
                 mode: str = "nearest"):
        super().__init__(in_nc, out_nc, kernel_size)
        self.upscale, self.mode = upscale, mode
        self.act = act(act_type)

    def forward(self, x):
        if self.mode == "nearest" and float(self.upscale).is_integer():
            r = int(self.upscale)
            if r == 2 and self.weight.shape[-1] == 3:
                wp, bp = upconv_lr_weights(self.weight, self.bias)
                return self.act(F.pixel_shuffle(self._conv(x, wp, bp), 2))
            x = x.repeat_interleave(r, dim=2).repeat_interleave(r, dim=3)
        else:
            x = interpolate(x.permute(0, 2, 3, 1), scale=self.upscale,
                            mode=self.mode).permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
        return self.act(self._conv(x))


class Conv(_Conv):
    """flax's ``nn.Conv`` with a k x k kernel, stride 1, zero padding of
    ``dilation * (k - 1) // 2`` and kernel dilation ``dilation``; its
    parameters sit at ``kernel`` and ``bias`` of its own flax module."""

    def __init__(self, in_nc: int, out_nc: int, kernel_size: int = 3,
                 use_bias: bool = True, dilation: int = 1, stride: int = 1,
                 groups: int = 1):
        super().__init__(in_nc, out_nc, kernel_size, use_bias, stride,
                         groups=groups)
        self.dilation = dilation

    def forward(self, x):
        return tensor.apply(self, x, lambda x, w, b: F.conv2d(
            x, w, b, stride=self.stride,
            padding=self.dilation * (w.shape[-1] - 1) // 2,
            dilation=self.dilation, groups=self.groups))


class Dense(nn.Module):
    """flax's ``nn.Dense`` without a bias: ``weight`` (out, in), torch's
    layout (flax's ``kernel`` is its transpose); runs in x's type."""

    tensor_routed = True

    def __init__(self, in_f: int, out_f: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_f, in_f))

    def forward(self, x):
        return tensor.apply(self, x, F.linear, out_dim=-1)


class TorchDeconv(nn.Module):
    """The JAX package's ``TorchDeconv``: torch's ``ConvTranspose2d`` with
    stride ``stride``, padding ``padding`` and output padding
    ``output_padding``. ``weight`` is held in torch's (in, out, kh, kw)
    layout; the flax ``kernel`` (kh, kw, in, out) is the same array
    permuted, with no spatial flip: the JAX module correlates the dilated
    input with the flipped kernel, which is what ``conv_transpose2d``
    computes from the unflipped one (``utils/torch_interop.py`` maps it,
    kind ``deconv``)."""

    def __init__(self, in_nc: int, out_nc: int, kernel_size: int = 3,
                 stride: int = 2, padding: int = 1, output_padding: int = 1,
                 use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(in_nc, out_nc, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_nc)) if use_bias else None
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding

    def init_weights(self, generator: torch.Generator) -> None:
        """LeCun normal over flax's fan-in (kh kw in), a zero bias."""
        fan_in = self.weight.shape[0] * self.weight[0, 0].numel()
        with torch.no_grad():
            self.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    tensor_routed = True

    def forward(self, x):
        return tensor.apply(self, x, lambda x, w, b: F.conv_transpose2d(
            x, w, b, stride=self.stride, padding=self.padding,
            output_padding=self.output_padding))


class Dropout(nn.Module):
    """flax's ``nn.Dropout(rate)``: in train mode each element is kept
    with probability 1 - rate (a uniform draw below it) and scaled by
    1 / (1 - rate), else zeroed; the identity in eval mode. The draw comes
    from ``generator`` (the trainer's, which it registers with the step's
    graph, so each replay draws a new mask) or from torch's default one."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or not self.rate:
            return x
        keep = sample_draw(lambda n: torch.rand(
            (n, *x.shape[1:]), dtype=torch.float32, device=x.device,
            generator=self.generator), x.shape[0]) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def discard_stats(net: nn.Module) -> None:
    """Drops the pending state of every batch norm and spectral norm of
    ``net``: the passes since the last commit leave nothing."""
    for m in net.modules():
        if isinstance(m, (BatchNorm, SpectralNorm)):
            m.pending = None


def conv_paths(key: str, m: nn.Module, path: tuple) -> dict:
    """The flax names of one conv-like module's tensors, for a net's
    ``flax_paths``: state-dict key -> (collection, flax path, kind), where
    kind says how the tensor maps (``conv`` OIHW <-> HWIO, ``conv3d``
    OIDHW <-> DHWIO, ``deconv``
    (in, out, kh, kw) <-> (kh, kw, in, out), ``dense`` (out, in) <-> (in,
    out), ``vec`` as it is). ``m`` is a ``_Conv`` or ``Conv`` (``kernel``,
    ``bias`` at ``path``), a ``TorchDeconv``, an ``nn.Linear`` or a
    ``ConvBlock`` (``Conv_0`` with ``BatchNorm_0`` or ``LayerNorm_0``
    beside it, or with ``SpectralNorm_0``'s ``u`` and ``sigma`` in
    ``batch_stats``; a bare conv's spectral norm, ``SpectralNorm_{k}``
    beside the conv at ``path``, k its ``sn_index``)."""
    pre = f"{key}." if key else ""
    out = {}
    if isinstance(m, ConvBlock):
        out[pre + "weight"] = ("params", path + ("Conv_0", "kernel"), "conv")
        if m.bias is not None:
            out[pre + "bias"] = ("params", path + ("Conv_0", "bias"), "vec")
        if m.sn is not None:
            for leaf in ("u", "sigma"):
                out[f"{pre}sn.{leaf}"] = (
                    "batch_stats", path + ("SpectralNorm_0",
                                           f"Conv_0/kernel/{leaf}"), "vec")
        if isinstance(m.norm, (BatchNorm, LayerNorm)):
            out.update(norm_paths(f"{pre}norm", m.norm, path + (
                "BatchNorm_0" if isinstance(m.norm, BatchNorm)
                else "LayerNorm_0",)))
        return out
    kind = {TorchDeconv: "deconv", nn.Linear: "dense"}.get(
        type(m), "conv3d" if m.weight.dim() == 5 else "conv")
    out[pre + "weight"] = ("params", path + ("kernel",), kind)
    if m.bias is not None:
        out[pre + "bias"] = ("params", path + ("bias",), "vec")
    if getattr(m, "sn", None) is not None:
        # flax's nn.SpectralNorm(conv) beside the conv, in batch_stats
        for leaf in ("u", "sigma"):
            out[f"{pre}sn.{leaf}"] = (
                "batch_stats", path[:-1] + (f"SpectralNorm_{m.sn_index}",
                                            f"{path[-1]}/kernel/{leaf}"),
                "vec")
    return out


def norm_paths(key: str, m: nn.Module, path: tuple) -> dict:
    """The flax names of a norm's tensors (``conv_paths``' form): a
    ``BatchNorm``'s scale and bias, and its running statistics in
    ``batch_stats``; a ``LayerNorm``'s scale and bias; an instance norm
    (flax's ``GroupNorm`` with neither) holds none."""
    if not isinstance(m, (BatchNorm, LayerNorm)):
        return {}
    out = {f"{key}.weight": ("params", path + ("scale",), "vec"),
           f"{key}.bias": ("params", path + ("bias",), "vec")}
    if isinstance(m, BatchNorm):
        out[f"{key}.running_mean"] = ("batch_stats", path + ("mean",), "vec")
        out[f"{key}.running_var"] = ("batch_stats", path + ("var",), "vec")
    return out


def named_flax_paths(net: nn.Module, prefix: str = "",
                     path: tuple = ()) -> dict:
    """``flax_paths`` of a net whose module names are the flax ones (the
    video nets): every conv and deconv (``conv_paths``) and norm
    (``norm_paths``)
    under its dotted name, and the tensors a module names itself
    (``flax_leaves()``: attribute -> (flax leaf, kind))."""
    out = {}
    for name, m in net.named_modules():
        key = f"{prefix}{name}"
        where = path + tuple(name.split(".")) if name else path
        if isinstance(m, (_Conv, TorchDeconv)):
            out.update(conv_paths(key, m, where))
        elif isinstance(m, (BatchNorm, LayerNorm)):
            out.update(norm_paths(key, m, where))
        elif hasattr(m, "flax_leaves"):
            for attr, (leaf, kind) in m.flax_leaves().items():
                out[f"{key}.{attr}" if key else attr] = (
                    "params", where + (leaf,), kind)
    return out


def conv_nhwc(conv: nn.Module, x: torch.Tensor,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """An NCHW conv module on an NHWC tensor (cast to ``dtype`` first):
    the NCHW view of a contiguous NHWC tensor is ``channels_last``, so
    neither way copies."""
    if dtype is not None:
        x = x.to(dtype)
    return conv(x.contiguous().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def lecun_init(net: nn.Module, generator: torch.Generator) -> None:
    """flax's default init of every conv, deconv and dense layer of
    ``net``: LeCun normal (std 1/sqrt(fan_in)), zero biases; norms keep a
    scale of 1 and a bias of 0, a spectral norm's ``u`` is drawn from a
    standard normal."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, TorchDeconv):
                m.init_weights(generator)
            elif isinstance(m, (_Conv, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, SpectralNorm):
                m.init_state(generator)


class SelfAttentionBlock(nn.Module):
    """SAGAN-style self-attention over the positions of an NCHW map,
    optionally after a ``poolsize`` max pool: query and key by 1x1 convs
    to C/8, value by a 1x1 conv to C (``f``, ``g``, ``h``, with biases),
    softmax of the query-key products in f32, the attended values resized
    back bilinearly (``interpolate``), added times the learned 0-d
    ``gamma`` (0 at init). With ``spectral_norm`` (ASRResNet, ASRCNN and
    ADiscriminator) each of the three convs is spectrally normalised, its
    state under flax's names (``SpectralNorm_0`` to ``_2`` beside ``f``,
    ``g``, ``h``), written once per step by ``commit_stats``."""

    def __init__(self, nc: int, max_pool: bool = False, poolsize: int = 4,
                 spectral_norm: bool = False):
        super().__init__()
        self.max_pool, self.poolsize = max_pool, poolsize
        self.f = _Conv(nc, nc // 8, 1, spectral_norm=spectral_norm)
        self.g = _Conv(nc, nc // 8, 1, spectral_norm=spectral_norm)
        self.h = _Conv(nc, nc, 1, spectral_norm=spectral_norm)
        self.g.sn_index, self.h.sn_index = 1, 2
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        inp = x
        if self.max_pool:
            x = F.max_pool2d(x, self.poolsize, self.poolsize)
        b, c, h, w = x.shape

        def flat(t):
            return t.permute(0, 2, 3, 1).reshape(b, h * w, -1)

        f, g, v = flat(self.f._conv(x)), flat(self.g._conv(x)), \
            flat(self.h._conv(x))
        attn = torch.softmax(torch.bmm(f.float(), g.float().transpose(1, 2)),
                             dim=-1)
        o = torch.bmm(attn.to(x.dtype), v).reshape(b, h, w, c)
        if self.max_pool:
            o = interpolate(o, size=(inp.shape[2], inp.shape[3]),
                            mode="bilinear")
        o = o.permute(0, 3, 1, 2)
        return inp + self.gamma.to(x.dtype) * o

    def flax_leaves(self):
        return {"gamma": ("gamma", "vec")}
