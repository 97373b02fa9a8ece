"""Host-side image IO and tensor conversion.

Counterpart of ``trainner_tpu/data/common.py`` (``scan_images:44``,
``read_img:60``, ``img2tensor:202``, ``tensor2img:218``, ``save_img:232``).
Host images are numpy HWC float32 RGB in [0, 1]. ``save_img`` writes 8-bit
PNG with the standard library (``zlib``, ``struct``); ``read_img`` imports
``cv2`` only when it is called.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tif", ".tiff",
                  ".webp")


def is_image_file(path: str) -> bool:
    return path.lower().endswith(IMG_EXTENSIONS)


def scan_images(root: str) -> List[str]:
    """Sorted recursive image listing."""
    if str(root).endswith(".lmdb"):
        raise NotImplementedError(
            "LMDB datasets are not ported yet (ROADMAP Queue A, end-to-end "
            "producer)")
    out = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if is_image_file(f):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def read_img(path: str, out_nc: int = 3) -> np.ndarray:
    """Image file -> float32 RGB HWC in [0, 1]."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"cannot read image [{path}]")
    if img.dtype == np.uint16:
        img = (img / 65535.0).astype(np.float32)
    else:
        img = (img / 255.0).astype(np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 4:
        img = cv2.cvtColor(img, cv2.COLOR_BGRA2BGR)
    if img.shape[2] == 3:
        img = img[:, :, ::-1]  # BGR -> RGB
    return fix_img_channels(np.ascontiguousarray(img), out_nc)


def fix_img_channels(img: np.ndarray, out_nc: int = 3) -> np.ndarray:
    if img.ndim == 2:
        img = img[:, :, None]
    c = img.shape[2]
    if out_nc == 3 and c == 1:
        img = np.repeat(img, 3, axis=2)
    elif out_nc == 1 and c == 3:
        img = rgb2ycbcr(img, only_y=True)[:, :, None]
    elif c > out_nc:
        img = img[:, :, :out_nc]
    return img


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """ITU-R BT.601 studio swing, RGB input in [0, 1]."""
    w = np.array([[65.481, -37.797, 112.0],
                  [128.553, -74.203, -93.786],
                  [24.966, 112.0, -18.214]], np.float32) / 255.0
    if only_y:
        return img @ w[:, 0] + 16.0 / 255.0
    return img @ w + np.array([16, 128, 128], np.float32) / 255.0


def channel_convert(img: np.ndarray, color: Optional[str]) -> np.ndarray:
    """'gray' | 'y' | 'RGB' conversions."""
    if not color or color in ("RGB", "rgb"):
        return img
    if color in ("gray", "grey"):
        return img.mean(axis=2, keepdims=True) if img.shape[2] == 3 else img
    if color.lower() == "y":
        return rgb2ycbcr(img, only_y=True)[:, :, None]
    return img


def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop H, W to multiples of scale."""
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale]


def img2tensor(img: np.ndarray, znorm: bool = False) -> np.ndarray:
    """HWC float32 [0, 1] -> network input array (HWC); znorm maps to
    [-1, 1]."""
    img = img.astype(np.float32)
    if znorm:
        img = img * 2.0 - 1.0
    return img


def tensor2img(t, znorm: bool = False, out_type=np.uint8) -> np.ndarray:
    """Model output (HWC or NHWC numpy array or tensor, [0, 1] or [-1, 1])
    -> uint8 HWC RGB."""
    if hasattr(t, "detach"):
        t = t.detach().float().cpu().numpy()
    arr = np.asarray(t, np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    if znorm:
        arr = (arr + 1.0) / 2.0
    arr = np.clip(arr, 0.0, 1.0)
    if out_type == np.uint8:
        return (arr * 255.0).round().astype(np.uint8)
    return arr


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_img(img: np.ndarray, path: str) -> None:
    """uint8 HWC (RGB, RGBA or gray) or HW image -> 8-bit PNG file."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"save_img writes uint8 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        color = 0
    elif img.shape[2] == 3:
        color = 2
    elif img.shape[2] == 4:
        color = 6
    else:
        raise ValueError(f"cannot write an image of shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
           + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
           + _png_chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)
