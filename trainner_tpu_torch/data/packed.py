"""The packed single-file image format ``.tpak``: counterpart of
``trainner_tpu/data/packed.py`` (``PackedWriter:24``, ``PackedReader:57``,
``pack_folder:87``), the same bytes both ways.

Layout: ``[8-byte little-endian index length][index JSON][payloads]``;
the index maps each key to ``[offset, length, h, w, c]`` of its payload,
an encoded PNG. One open file, random access by offset.

With OpenCV installed the writer's PNGs are OpenCV's (``cv2.imencode``),
byte for byte the JAX writer's file; without it the port's encoder
(``data/common.py::encode_png``) writes them, which decode to the same
pixels. The reader decodes with OpenCV, or without it with the port's
PNG decoder, and gives what the JAX reader gives: float32 HWC in [0, 1],
three channels in RGB order (the writer stores them reversed, as
``cv2.imencode`` takes BGR; other channel counts as stored, ROADMAP C 28).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List

import numpy as np

from .common import decode_png, encode_png, read_img, scan_images


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _swap_bgr(img: np.ndarray) -> np.ndarray:
    """BGR(A) <-> RGB(A), as OpenCV converts between its arrays and a
    PNG's pixels; gray as it is."""
    if img.ndim == 3 and img.shape[2] == 3:
        return img[..., ::-1]
    if img.ndim == 3 and img.shape[2] == 4:
        return img[..., [2, 1, 0, 3]]
    return img


class PackedWriter:
    def __init__(self, path: str):
        self.path = path
        self.entries: Dict[str, List[int]] = {}
        self.payloads: List[bytes] = []
        self.offset = 0

    def add_image(self, key: str, img: np.ndarray) -> None:
        """``img``: HWC uint8, or float in [0, 1] (scaled by 255, clipped
        and cut to uint8, as the JAX writer does), stored as a PNG with its
        last axis reversed (RGB -> BGR)."""
        if img.dtype != np.uint8:
            img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        stored = np.ascontiguousarray(img[..., ::-1])
        cv2 = _cv2()
        if cv2 is not None:
            ok, enc = cv2.imencode(".png", stored)
            if not ok:
                raise IOError(f"PNG encode failed for {key}")
            data = enc.tobytes()
        else:
            data = encode_png(np.ascontiguousarray(_swap_bgr(stored)))
        h, w = img.shape[:2]
        c = img.shape[2] if img.ndim == 3 else 1
        self.entries[key] = [self.offset, len(data), h, w, c]
        self.payloads.append(data)
        self.offset += len(data)

    def close(self) -> None:
        index = json.dumps(self.entries).encode()
        with open(self.path, "wb") as f:
            f.write(struct.pack("<Q", len(index)))
            f.write(index)
            for p in self.payloads:
                f.write(p)


class PackedReader:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (index_len,) = struct.unpack("<Q", f.read(8))
            self.index: Dict[str, List[int]] = json.loads(
                f.read(index_len).decode())
        self.base = 8 + index_len
        self._f = open(path, "rb")
        self.keys = sorted(self.index)

    def __len__(self) -> int:
        return len(self.keys)

    def read(self, key: str) -> np.ndarray:
        """The image under ``key``: float32 HWC in [0, 1], RGB."""
        off, length, h, w, c = self.index[key]
        self._f.seek(self.base + off)
        data = self._f.read(length)
        cv2 = _cv2()
        if cv2 is not None:
            img = cv2.imdecode(np.frombuffer(data, np.uint8),
                               cv2.IMREAD_UNCHANGED)
        else:
            # the PNG's order, made OpenCV's
            img = _swap_bgr(decode_png(data, f"{self.path}::{key}"))
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[2] == 3:
            img = img[..., ::-1]  # BGR -> RGB
        return np.ascontiguousarray(img).astype(np.float32) / 255.0

    def close(self) -> None:
        self._f.close()


def pack_folder(src_dir: str, out_path: str) -> int:
    """Every image under ``src_dir`` (``scan_images``' order) into
    ``out_path``, keyed by its path relative to ``src_dir`` without the
    extension; returns how many."""
    w = PackedWriter(out_path)
    paths = scan_images(src_dir)
    for p in paths:
        key = os.path.splitext(os.path.relpath(p, src_dir))[0]
        w.add_image(key, read_img(p))
    w.close()
    return len(paths)
