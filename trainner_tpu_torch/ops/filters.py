"""Image filters on NHWC tensors.

Counterpart of ``trainner_tpu/ops/filters.py``: the kernel builders
(``box_kernel:28`` to ``motion_kernel:122``, numpy constants built on the
host), ``filter2d:140``, ``filter2d_per_sample:159``,
``separable_filter2d:170``, ``filter_low:190``, ``filter_high:206``,
``_box_filter:218`` and ``guided_filter:226``. Filtering is a depthwise
``F.conv2d`` (cross-correlation, as ``lax.conv_general_dilated``) after
an explicit padding.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.graphs import device_constant

# the padding modes of ``jnp.pad`` -> those of ``F.pad``
_PAD_MODES = {"reflect": "reflect", "constant": "constant",
              "edge": "replicate", "wrap": "circular",
              "symmetric": "symmetric"}

# ---------------------------------------------------------------------------
# kernel builders (numpy, on the host)
# ---------------------------------------------------------------------------


def box_kernel(size: int) -> np.ndarray:
    k = np.ones((size, size), np.float32)
    return k / k.sum()


def gaussian_kernel_1d(size: int, sigma: float) -> np.ndarray:
    ax = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    k = np.exp(-0.5 * (ax / sigma) ** 2)
    return k / k.sum()


def gaussian_kernel_2d(size: int, sigma: float,
                       sigma_y: Optional[float] = None,
                       angle: float = 0.0) -> np.ndarray:
    """An isotropic or anisotropic gaussian kernel, rotated by ``angle``
    degrees, summing to 1."""
    sigma_y = sigma if sigma_y is None else sigma_y
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    xx, yy = np.meshgrid(ax, ax)
    if angle:
        t = math.radians(angle)
        xr = xx * math.cos(t) + yy * math.sin(t)
        yr = -xx * math.sin(t) + yy * math.cos(t)
        xx, yy = xr, yr
    k = np.exp(-0.5 * ((xx / max(sigma, 1e-8)) ** 2 +
                       (yy / max(sigma_y, 1e-8)) ** 2))
    k /= k.sum()
    return k.astype(np.float32)


def sinc_kernel(size: int, cutoff: float) -> np.ndarray:
    """A 2-D circular low-pass (sinc) kernel, cutoff J1(cutoff r) / (2 pi
    r), cutoff^2 / 4 pi at the centre, summing to 1."""
    from scipy.special import j1

    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    xx, yy = np.meshgrid(ax, ax)
    r = np.sqrt(xx ** 2 + yy ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        k = cutoff * j1(cutoff * r) / (2 * math.pi * r)
    k[(size - 1) // 2, (size - 1) // 2] = cutoff ** 2 / (4 * math.pi)
    k /= k.sum()
    return k.astype(np.float32)


def log_kernel(size: int, sigma: float = 0.5) -> np.ndarray:
    """A Laplacian-of-Gaussian kernel: gaussian x (r^2 - 2 sigma^2) / (2 pi
    sigma^4), sign-flipped and divided by its own sum."""
    half = (size - 1) // 2
    ax = np.arange(-half, half + 1, dtype=np.float64)
    yy, xx = np.meshgrid(ax, ax, indexing="ij")
    s2 = sigma * sigma
    g = np.exp(-(xx ** 2) / (2 * s2)) * np.exp(-(yy ** 2) / (2 * s2))
    lg = g * ((xx ** 2 + yy ** 2) - 2 * s2) / (2 * math.pi * s2 * s2)
    lg = -lg / lg.sum()
    return lg.astype(np.float32)


def laplacian_kernel(size: int = 3) -> np.ndarray:
    if size == 3:
        return np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)
    if size == 5:
        k = np.ones((5, 5), np.float32)
        k[2, 2] = -24.0
        return k
    raise ValueError("laplacian size must be 3 or 5")


def sobel_kernels() -> Tuple[np.ndarray, np.ndarray]:
    gx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
    return gx, gx.T.copy()


def scharr_kernels() -> Tuple[np.ndarray, np.ndarray]:
    gx = np.array([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]], np.float32) / 16.0
    return gx, gx.T.copy()


def prewitt_kernels() -> Tuple[np.ndarray, np.ndarray]:
    gx = np.array([[-1, 0, 1], [-1, 0, 1], [-1, 0, 1]], np.float32)
    return gx, gx.T.copy()


def motion_kernel(size: int, angle: float = 0.0) -> np.ndarray:
    """A linear motion-blur kernel: the middle row, rotated by ``angle``
    degrees (linear interpolation), summing to 1."""
    k = np.zeros((size, size), np.float32)
    k[(size - 1) // 2, :] = 1.0
    if angle:
        from scipy.ndimage import rotate

        k = rotate(k, angle, reshape=False, order=1)
        k = np.clip(k, 0, None)
    k /= max(k.sum(), 1e-8)
    return k.astype(np.float32)


# ---------------------------------------------------------------------------
# application (NHWC)
# ---------------------------------------------------------------------------


def _nchw_padded(x: torch.Tensor, kh: int, kw: int, pad_mode: str
                 ) -> torch.Tensor:
    """x (b, h, w, c) -> (b, c, h', w'), padded by (k-1)//2 before and the
    rest after, in each direction."""
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    return F.pad(x.permute(0, 3, 1, 2), (pw, kw - 1 - pw, ph, kh - 1 - ph),
                 mode=_PAD_MODES[pad_mode])


def filter2d(x: torch.Tensor, kernel, pad_mode: str = "reflect",
             stride: int = 1) -> torch.Tensor:
    """Depthwise filtering of an NHWC tensor by one 2-D kernel (kh, kw)."""
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    kh, kw = k.shape[-2], k.shape[-1]
    c = x.shape[-1]
    y = F.conv2d(_nchw_padded(x, kh, kw, pad_mode),
                 k.reshape(1, 1, kh, kw).expand(c, 1, kh, kw),
                 stride=stride, groups=c)
    return y.permute(0, 2, 3, 1)


def filter2d_per_sample(x: torch.Tensor, kernels: torch.Tensor,
                        pad_mode: str = "reflect") -> torch.Tensor:
    """Each sample filtered by its own 2-D kernel, ``kernels`` (b, kh, kw):
    the batch folded into the channels, one grouped convolution."""
    b, h, w, c = x.shape
    kh, kw = kernels.shape[-2], kernels.shape[-1]
    xp = _nchw_padded(x, kh, kw, pad_mode)
    weight = kernels.to(x.dtype).repeat_interleave(c, dim=0)[:, None]
    y = F.conv2d(xp.reshape(1, b * c, *xp.shape[2:]), weight, groups=b * c)
    return y.reshape(b, c, h, w).permute(0, 2, 3, 1)


def reflect_pad(x: torch.Tensor, dim: int, before: int,
                after: int) -> torch.Tensor:
    """``F.pad``'s reflect padding of one axis written as slices, flips
    and a concatenation: the same values bit for bit, and a backward that
    adds in a fixed order (``F.pad``'s reflect backward adds with atomics
    on the card, so two runs of a step would differ in the last bits)."""
    n = x.shape[dim]
    parts = [x]
    if before:
        parts.insert(0, x.narrow(dim, 1, before).flip(dim))
    if after:
        parts.append(x.narrow(dim, n - 1 - after, after).flip(dim))
    return torch.cat(parts, dim) if len(parts) > 1 else x


def _pad_axis(y: torch.Tensor, dim: int, before: int, after: int,
              mode: str) -> torch.Tensor:
    if mode == "reflect":
        return reflect_pad(y, dim, before, after)
    pads = (0, 0, before, after) if dim == 2 else (before, after, 0, 0)
    return F.pad(y, pads, mode=mode)


def separable_filter2d(x: torch.Tensor, k1d,
                       pad_mode: str = "reflect") -> torch.Tensor:
    """A 1-D kernel along H, then along W, per channel, each after a
    ``pad_mode`` padding of (n-1)//2 before and the rest after (reflect by
    ``reflect_pad``)."""
    k = torch.as_tensor(k1d, dtype=x.dtype, device=x.device)
    n, c = k.shape[0], x.shape[-1]
    pad = (n - 1) // 2
    mode = _PAD_MODES[pad_mode]
    y = x.permute(0, 3, 1, 2)
    y = _pad_axis(y, 2, pad, n - 1 - pad, mode)
    y = F.conv2d(y, k.reshape(1, 1, n, 1).expand(c, 1, n, 1), groups=c)
    y = _pad_axis(y, 3, pad, n - 1 - pad, mode)
    y = F.conv2d(y, k.reshape(1, 1, 1, n).expand(c, 1, 1, n), groups=c)
    return y.permute(0, 2, 3, 1)


def _on(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """A fixed kernel as a constant on x's device, made once (a copy from
    the host inside a CUDA graph's capture would wait for the card)."""
    return device_constant(kernel.astype(np.float32).tolist(),
                           torch.float32, x.device)


def filter_low(x: torch.Tensor, kernel_size: int = 9,
               sigma: Optional[float] = None,
               filter_type: str = "gaussian") -> torch.Tensor:
    """Low-pass: 'average' (or 'box') is a box mean with the zero padding
    counted in; 'gaussian' a zero-padded separable gaussian of sigma
    kernel_size / 6 unless given."""
    if filter_type in ("average", "box"):
        return filter2d(x, _on(x, box_kernel(kernel_size)),
                        pad_mode="constant")
    sigma = sigma or kernel_size / 6.0
    return separable_filter2d(x, _on(x, gaussian_kernel_1d(kernel_size,
                                                           sigma)),
                              pad_mode="constant")


def filter_high(x: torch.Tensor, kernel_size: int = 9,
                sigma: Optional[float] = None,
                filter_type: str = "gaussian",
                normalize: bool = True) -> torch.Tensor:
    """High-pass x - low-pass(x); ``normalize`` maps it to (hf + 1) / 2."""
    hf = x - filter_low(x, kernel_size, sigma, filter_type)
    if normalize:
        hf = (hf + 1.0) / 2.0
    return hf


def _box_filter(x: torch.Tensor, r: int) -> torch.Tensor:
    """The mean over a (2r+1)^2 window, reflect-padded."""
    size = 2 * r + 1
    return separable_filter2d(
        x, device_constant([1.0 / size] * size, x.dtype, x.device),
        pad_mode="reflect")


def guided_filter(guide: torch.Tensor, src: torch.Tensor, radius: int = 1,
                  eps: float = 1e-2) -> torch.Tensor:
    """He et al.'s edge-preserving guided filter, each channel guided by
    its own."""
    mean_i = _box_filter(guide, radius)
    mean_p = _box_filter(src, radius)
    cov_ip = _box_filter(guide * src, radius) - mean_i * mean_p
    var_i = _box_filter(guide * guide, radius) - mean_i * mean_i
    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i
    return _box_filter(a, radius) * guide + _box_filter(b, radius)
