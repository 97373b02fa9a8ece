"""MATLAB-style antialiased resize as two dense contractions.

Counterpart of ``trainner_tpu/ops/imresize.py`` (kernels ``:30-152``,
``resize_matrix:155``, ``_out_len:208``, ``imresize:223``,
``imresize_np:269``) on the reference's live "resizeright" grid: each
spatial axis is resized by one dense ``(out_len, in_len)`` weight matrix
with the mirrored boundary folded in. The matrices are built on the host in
numpy, once per (sizes, kernel); ``imresize`` keeps a copy of each on the
tensor's device and contracts in f32 with ``torch.matmul`` (which runs in
full f32 on the card while ``torch.backends.cuda.matmul.allow_tf32`` is
off, its default). ``imresize_np`` is the numpy path the datasets use.

``jax_resize`` is the same machinery with the weights of ``jax.image.resize``
(``jax/_src/image/scale.py``: ``compute_weight_mat``, ``_resize_nearest``),
which the cv2-style resize codes of the degradations use: half-pixel
centres, the kernel widened by 1 / scale where it antialiases a downscale,
each output's taps renormalised to sum 1, an axis of unchanged size left
as it is, and no clipping.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch


def cubic(x, a: float = -0.5):
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return (((a + 2) * ax3 - (a + 3) * ax2 + 1) * (ax <= 1) +
            (a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a) *
            ((ax > 1) & (ax <= 2)))


def box(x):
    # support (-1, 1]: the reference's width-2 'box'
    return (((-1 <= x) & (x < 0)) * 1.0 + ((0 <= x) & (x <= 1)) * 1.0)


def linear(x):
    ax = np.abs(x)
    return (1 - ax) * (ax <= 1)


def lanczos(x, a: int = 3):
    eps = np.finfo(np.float32).eps
    xp = np.pi * x
    return ((np.sin(xp) * np.sin(xp / a) + eps) /
            (xp ** 2 / a + eps)) * (np.abs(x) <= a)


def sinc_k(x, a: int = 2):
    # unwindowed: the tap window alone truncates it
    eps = np.finfo(np.float32).eps
    xp = np.pi * x
    out = (np.sin(xp) + eps) / (xp + eps) * (np.abs(x) != 0)
    return out + 1.0 * (np.abs(x) == 0)


def blackman(x, a: int = 2):
    # the window alone (no sinc), with a spike of 1 at x == 0
    xp = np.pi * x
    win = 0.42 - 0.5 * np.cos(xp / a) + 0.08 * np.cos(2 * xp / a)
    return win * (np.abs(x) <= a) + 1.0 * (np.abs(x) == 0)


def hermite(x):
    ax = np.abs(x)
    return (2 * ax ** 3 - 3 * ax ** 2 + 1) * (ax <= 1)


def bell(x):
    ax = np.abs(x)
    return np.where(ax <= 0.5, 0.75 - ax ** 2,
                    np.where(ax <= 1.5, 0.5 * (ax - 1.5) ** 2, 0.0))


def mitchell(x, b: float = 1 / 3, c: float = 1 / 3):
    ax = np.abs(x)
    p1 = ((12 - 9 * b - 6 * c) * ax ** 3 + (-18 + 12 * b + 6 * c) * ax ** 2 +
          (6 - 2 * b)) / 6
    p2 = ((-b - 6 * c) * ax ** 3 + (6 * b + 30 * c) * ax ** 2 +
          (-12 * b - 48 * c) * ax + (8 * b + 24 * c)) / 6
    return np.where(ax < 1, p1, np.where(ax < 2, p2, 0.0))


def catrom(x):
    return mitchell(x, b=0.0, c=0.5)


def hanning(x):
    return (0.5 + 0.5 * np.cos(np.pi * x)) * (np.abs(x) < 5)


def hamming(x):
    return (0.54 + 0.46 * np.cos(np.pi * x)) * (np.abs(x) < 5)


def gaussian(x, sigma: float = 0.5):
    return np.exp(-x ** 2 / (2 * sigma ** 2)) / (sigma * np.sqrt(2 * np.pi))


# name -> (kernel function, width of its support in taps)
_KERNELS: dict = {
    "cubic": (cubic, 4.0),
    "box": (box, 1.0),
    "linear": (linear, 2.0),
    "lanczos2": (functools.partial(lanczos, a=2), 4.0),
    "lanczos3": (functools.partial(lanczos, a=3), 6.0),
    "lanczos4": (functools.partial(lanczos, a=4), 8.0),
    "lanczos5": (functools.partial(lanczos, a=5), 10.0),
    "sinc2": (functools.partial(sinc_k, a=2), 4.0),
    "sinc3": (functools.partial(sinc_k, a=3), 6.0),
    "sinc4": (functools.partial(sinc_k, a=4), 8.0),
    "sinc5": (functools.partial(sinc_k, a=5), 10.0),
    "blackman2": (functools.partial(blackman, a=2), 4.0),
    "blackman3": (functools.partial(blackman, a=3), 6.0),
    "blackman4": (functools.partial(blackman, a=4), 8.0),
    "blackman5": (functools.partial(blackman, a=5), 10.0),
    "hermite": (hermite, 2.0),
    "bell": (bell, 2.0),
    "mitchell": (mitchell, 4.0),
    "catrom": (catrom, 4.0),
    "hanning": (hanning, 2.0),
    "hamming": (hamming, 2.0),
    "gaussian": (gaussian, 4.0),
}

_ALIASES = {
    "bicubic": "cubic", "matlab_bicubic": "cubic", "nearest": "box",
    "bilinear": "linear", "lanczos": "lanczos3", "blackman": "blackman2",
    "sinc": "sinc2",
}


def get_kernel(name: str) -> Tuple[Callable, float]:
    name = (name or "cubic").lower()
    name = _ALIASES.get(name, name)
    if name not in _KERNELS:
        raise ValueError(f"unknown resize kernel [{name}]")
    return _KERNELS[name]


@functools.lru_cache(maxsize=256)
def resize_matrix(in_length: int, out_length: int, kernel: str = "cubic",
                  antialiasing: bool = True,
                  scale: Optional[float] = None) -> np.ndarray:
    """Dense (out_length, in_length) f32 weights of one axis: the kernel
    evaluated at the mirrored source positions, rows normalised (the JAX
    package's grid='resizeright'). The cached array is shared: callers do
    not write to it."""
    kfunc, kwidth = get_kernel(kernel)
    s = scale if scale else out_length / in_length
    if s < 1 and antialiasing:
        kw = kwidth / s
        kf = lambda d: s * kfunc(s * d)  # noqa: E731
    else:
        kw = kwidth
        kf = kfunc
    eps = np.finfo(np.float32).eps
    u = (np.arange(out_length, dtype=np.float64) / s +
         (in_length - 1) / 2 - (out_length - 1) / (2 * s))
    left = np.ceil(u - kw / 2 - eps)
    p = int(np.ceil(kw - eps))
    indices = left[:, None] + np.arange(p)[None, :]
    aux = np.concatenate([np.arange(in_length),
                          np.arange(in_length - 1, -1, -1)])
    idx = aux[np.mod(indices.astype(np.int64), aux.size)]
    weights = kf(u[:, None] - idx)
    norm = np.sum(weights, axis=1, keepdims=True)
    norm[norm == 0] = 1.0
    weights = weights / norm
    mat = np.zeros((out_length, in_length), np.float64)
    for j in range(p):
        np.add.at(mat, (np.arange(out_length), idx[:, j]), weights[:, j])
    return mat.astype(np.float32)


def _out_len(in_len: int, scale: float) -> int:
    return int(np.ceil(in_len * scale))


def _sizes(shape, scale, out_shape):
    nd = len(shape)
    h_ax, w_ax = (0, 1) if nd == 2 else (nd - 3, nd - 2)
    in_h, in_w = shape[h_ax], shape[w_ax]
    if out_shape is not None:
        out_h, out_w = int(out_shape[0]), int(out_shape[1])
        sc_h, sc_w = out_h / in_h, out_w / in_w
    else:
        if scale is None:
            raise ValueError("imresize needs a scale or an out_shape")
        sc_h = sc_w = float(scale)
        out_h, out_w = _out_len(in_h, sc_h), _out_len(in_w, sc_w)
    return h_ax, w_ax, (in_h, out_h, sc_h), (in_w, out_w, sc_w)


# (in, out, kernel, antialiasing, scale, device) -> the matrix on that device
_device_matrices: Dict[tuple, torch.Tensor] = {}


def _device_matrix(in_len: int, out_len: int, kernel: str, antialiasing: bool,
                   scale: float, device: torch.device) -> torch.Tensor:
    key = (in_len, out_len, kernel, antialiasing, scale, str(device))
    mat = _device_matrices.get(key)
    if mat is None:
        # made outside inference mode, so that autograd may use it later
        with torch.inference_mode(False):
            mat = torch.from_numpy(resize_matrix(
                in_len, out_len, kernel, antialiasing, scale)).to(device)
        _device_matrices[key] = mat
    return mat


def imresize(img: torch.Tensor, scale: Optional[float] = None,
             out_shape: Optional[Tuple[int, int]] = None,
             kernel: str = "cubic", antialiasing: bool = True,
             clip: bool = True) -> torch.Tensor:
    """Resize of an HW / HWC / NHWC tensor on its device: H then W are
    contracted with their weight matrices in f32. Float results are clipped
    to [0, 1] (unless ``clip`` is off), uint8 ones rounded and clipped to
    [0, 255]."""
    h_ax, w_ax, (in_h, out_h, sc_h), (in_w, out_w, sc_w) = _sizes(
        img.shape, scale, out_shape)
    wh = _device_matrix(in_h, out_h, kernel, antialiasing, sc_h, img.device)
    ww = _device_matrix(in_w, out_w, kernel, antialiasing, sc_w, img.device)
    x = img.float()
    if img.dim() == 2:
        x = wh @ x @ ww.T
    else:
        # (..., H, W, C): H is contracted against (H, W*C) rows, then W
        # against each row's (W, C) matrix
        x = torch.matmul(wh, x.flatten(-2)).unflatten(-1, x.shape[-2:])
        x = torch.matmul(ww, x)
    if img.dtype == torch.uint8:
        return x.round().clamp_(0, 255).to(torch.uint8)
    return x.clamp_(0.0, 1.0) if clip else x


def imresize_np(img: np.ndarray, scale: float = None,
                out_shape: Optional[Tuple[int, int]] = None,
                kernel: str = "cubic", antialiasing: bool = True
                ) -> np.ndarray:
    """Resize of an HWC / HW / NHWC numpy array on the host; float results
    are clipped to [0, 1], integer ones rounded and clipped to [0, 255]."""
    img = np.asarray(img)
    h_ax, w_ax, (in_h, out_h, sc_h), (in_w, out_w, sc_w) = _sizes(
        img.shape, scale, out_shape)
    wh = resize_matrix(in_h, out_h, kernel, antialiasing, sc_h)
    ww = resize_matrix(in_w, out_w, kernel, antialiasing, sc_w)
    x = img.astype(np.float32)
    x = np.moveaxis(np.tensordot(wh, x, axes=(1, h_ax)), 0, h_ax)
    x = np.moveaxis(np.tensordot(ww, x, axes=(1, w_ax)), 0, w_ax)
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(np.round(x), 0, 255).astype(img.dtype)
    return np.clip(x, 0.0, 1.0)


# ---------------------------------------------------------------------------
# the weights of jax.image.resize
# ---------------------------------------------------------------------------


def _triangle(x):
    return np.maximum(np.float32(0), 1 - np.abs(x))


def _keys_cubic(x):
    """Keys' cubic convolution kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = np.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return np.where(x >= 2., 0., out)


def _lanczos3(x):
    y = 3. * np.sin(np.pi * x) * np.sin(np.pi * x / 3.)
    out = np.where(x > 1e-3, y / np.where(x != 0, np.pi ** 2 * x ** 2, 1), 1)
    return np.where(x > 3., 0., out)


_JAX_KERNELS = {"linear": _triangle, "cubic": _keys_cubic,
                "lanczos3": _lanczos3}


@functools.lru_cache(maxsize=256)
def jax_resize_matrix(in_len: int, out_len: int, method: str,
                      antialias: bool) -> np.ndarray:
    """The (out_len, in_len) f32 weights of ``jax.image.resize`` along one
    axis (``compute_weight_mat`` with no translation), computed in f32 as
    there."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_len / in_len))
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample_f = (np.arange(out_len, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_len, dtype=f32)[:, None]) \
        / kernel_scale
    with np.errstate(divide="ignore", invalid="ignore"):
        w = _JAX_KERNELS[method](x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000. * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_len - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, 0).T
                                .astype(f32))


def _nearest_index(in_len: int, out_len: int) -> np.ndarray:
    """``_resize_nearest``'s source row of each output row."""
    pos = (np.arange(out_len, dtype=np.float32) + 0.5) * np.float32(
        in_len / out_len)
    return np.floor(pos.astype(np.float32)).astype(np.int64)


# (in, out, method, antialias, device) -> its matrix or index on the device
_jax_tables: Dict[tuple, torch.Tensor] = {}


def _jax_table(in_len: int, out_len: int, method: str, antialias: bool,
               device: torch.device) -> torch.Tensor:
    key = (in_len, out_len, method, antialias, str(device))
    t = _jax_tables.get(key)
    if t is None:
        with torch.inference_mode(False):  # as in _device_matrix
            t = torch.from_numpy(
                _nearest_index(in_len, out_len) if method == "nearest" else
                jax_resize_matrix(in_len, out_len, method, antialias)
            ).to(device)
        _jax_tables[key] = t
    return t


def jax_resize(x: torch.Tensor, out_hw: Tuple[int, int], method: str,
               antialias: bool) -> torch.Tensor:
    """``jax.image.resize(x, (b, oh, ow, c), method, antialias)`` of an
    NHWC tensor, in f32: each axis whose size changes is contracted with
    its weight matrix (or, for ``nearest``, gathered), H first."""
    (h, w), (oh, ow) = x.shape[1:3], out_hw
    y = x.float()
    if oh != h:
        t = _jax_table(h, oh, method, antialias, x.device)
        y = y.index_select(1, t) if method == "nearest" else \
            torch.matmul(t.to(y.dtype), y.flatten(2)).unflatten(
                2, y.shape[2:])
    if ow != w:
        t = _jax_table(w, ow, method, antialias, x.device)
        y = y.index_select(2, t) if method == "nearest" else \
            torch.matmul(t.to(y.dtype), y)
    return y
