"""Optical-flow visualisation and Middlebury ``.flo`` files: the port's
copy of ``trainner_tpu/utils/flow_utils.py`` (``make_color_wheel:14``,
``flow2rgb:39``, ``read_flo:66``, ``write_flo:79``), numpy on the host.
"""

from __future__ import annotations

import numpy as np

_TAG = 202021.25  # the .flo sanity tag


def make_color_wheel() -> np.ndarray:
    """The Middlebury 55-colour wheel, (55, 3) in [0, 255]."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    wheel[col:col + RY, 0] = 255
    wheel[col:col + RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow2rgb(flow: np.ndarray, max_flow: float = None) -> np.ndarray:
    """(h, w, 2) flow -> (h, w, 3) f32 colours in [0, 1]: hue by direction,
    saturation by magnitude over ``max_flow`` (the largest by default),
    darkened past it."""
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max_flow if max_flow else max(rad.max(), 1e-6)
    u, v = u / maxrad, v / maxrad
    wheel = make_color_wheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros((*u.shape, 3))
    for c in range(3):
        col = (1 - f) * wheel[k0, c] / 255.0 + f * wheel[k1, c] / 255.0
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., c] = col
    return img.astype(np.float32)


def read_flo(path: str) -> np.ndarray:
    """A Middlebury ``.flo`` file -> (h, w, 2) f32."""
    with open(path, "rb") as f:
        tag = np.frombuffer(f.read(4), np.float32)[0]
        if abs(tag - _TAG) > 1e-3:
            raise ValueError(f"bad .flo tag in {path}")
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(h * w * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()


def write_flo(path: str, flow: np.ndarray) -> None:
    """(h, w, 2) flow -> a ``.flo`` file."""
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(np.float32(_TAG).tobytes())
        f.write(np.int32(w).tobytes())
        f.write(np.int32(h).tobytes())
        f.write(flow.astype(np.float32).tobytes())
