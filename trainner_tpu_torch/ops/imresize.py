"""MATLAB-style antialiased bicubic resize on the host (numpy).

The numpy path of ``trainner_tpu/ops/imresize.py`` (``cubic:30``,
``resize_matrix:155``, ``_out_len:208``, ``imresize_np:269``) for the cubic
kernel and the reference's live "resizeright" grid: each spatial axis is
resized by one dense ``(out_len, in_len)`` weight matrix. The synthetic and
aligned datasets make their LR images with it.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np


def cubic(x, a: float = -0.5):
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return (((a + 2) * ax3 - (a + 3) * ax2 + 1) * (ax <= 1) +
            (a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a) *
            ((ax > 1) & (ax <= 2)))


@functools.lru_cache(maxsize=64)
def resize_matrix(in_length: int, out_length: int,
                  antialiasing: bool = True,
                  scale: Optional[float] = None) -> np.ndarray:
    """Dense (out_length, in_length) bicubic weights with a mirrored
    boundary and normalized rows (the JAX package's grid='resizeright')."""
    kwidth = 4.0
    s = scale if scale else out_length / in_length
    if s < 1 and antialiasing:
        kw = kwidth / s
        kf = lambda d: s * cubic(s * d)  # noqa: E731
    else:
        kw = kwidth
        kf = cubic
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


def imresize_np(img: np.ndarray, scale: float = None,
                out_shape: Optional[Tuple[int, int]] = None,
                kernel: str = "cubic", antialiasing: bool = True
                ) -> np.ndarray:
    """Bicubic resize of an HWC / HW / NHWC numpy array; float results
    are clipped to [0, 1], integer ones rounded and clipped to [0, 255]."""
    if kernel not in ("cubic", "bicubic", "matlab_bicubic"):
        raise NotImplementedError(
            f"resize kernel [{kernel}] is not ported yet (ROADMAP Queue A, "
            "end-to-end producer)")
    img = np.asarray(img)
    nd = img.ndim
    h_ax, w_ax = (0, 1) if nd == 2 else (nd - 3, nd - 2)
    in_h, in_w = img.shape[h_ax], img.shape[w_ax]
    if out_shape is not None:
        out_h, out_w = int(out_shape[0]), int(out_shape[1])
        sc_h, sc_w = out_h / in_h, out_w / in_w
    else:
        sc_h = sc_w = float(scale)
        out_h, out_w = _out_len(in_h, sc_h), _out_len(in_w, sc_w)
    wh = resize_matrix(in_h, out_h, antialiasing, sc_h)
    ww = resize_matrix(in_w, out_w, antialiasing, sc_w)
    x = img.astype(np.float32)
    x = np.moveaxis(np.tensordot(wh, x, axes=(1, h_ax)), 0, h_ax)
    x = np.moveaxis(np.tensordot(ww, x, axes=(1, w_ax)), 0, w_ax)
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(np.round(x), 0, 255).astype(img.dtype)
    return np.clip(x, 0.0, 1.0)
