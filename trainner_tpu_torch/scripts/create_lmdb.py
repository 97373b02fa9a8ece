"""Makes an LMDB dataset from an image folder: the port's counterpart of
``scripts/create_lmdb.py``, with the standard-library writer of
``data/lmdb_io.py`` (no ``lmdb`` package needed).

Each image is stored under its file stem as a 3-channel 8-bit PNG, beside
a ``meta_info.txt`` line ``{key}.png ({h},{w},{c}) {level}``. With OpenCV
installed the PNG is OpenCV's, byte for byte what the JAX script writes;
without it the port's encoder writes it (``data/common.py::encode_png``,
rows unfiltered), which decodes to the same pixels.

Usage: python -m trainner_tpu_torch.scripts.create_lmdb SRC DST [--level 1]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from ..data.common import decode_image, encode_png, scan_images
from ..data.lmdb_io import write_lmdb


def _encode(path: str, level: int):
    """(PNG bytes, (h, w, c)) of an image read as three 8-bit channels, or
    None when it cannot be read."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            return None
        ok, enc = cv2.imencode(".png", img,
                               [cv2.IMWRITE_PNG_COMPRESSION, level])
        return (enc.tobytes(), img.shape) if ok else None
    img = decode_image(path)
    if img.dtype != np.uint8:
        return None
    if img.ndim == 2:
        img = img[:, :, None]
    img = np.ascontiguousarray(np.repeat(img, 3, axis=2)
                               if img.shape[2] == 1 else img[:, :, :3])
    return encode_png(img, level), img.shape


def create_lmdb(src: str, dst: str, level: int = 1) -> str:
    """Writes every image under ``src`` into the LMDB ``dst`` (``.lmdb``
    appended when missing) with its ``meta_info.txt``; returns the path."""
    if not dst.endswith(".lmdb"):
        dst += ".lmdb"
    paths = scan_images(src)
    if not paths:
        raise SystemExit(f"no images under {src}")
    items, meta_lines = {}, []
    for path in paths:
        enc = _encode(path, level)
        if enc is None:
            print(f"skip unreadable {path}")
            continue
        data, (h, w, c) = enc
        key = os.path.splitext(os.path.basename(path))[0]
        items[key.encode("ascii")] = data
        meta_lines.append(f"{key}.png ({h},{w},{c}) {level}")
    write_lmdb(dst, items)
    with open(os.path.join(dst, "meta_info.txt"), "w") as f:
        f.write("\n".join(meta_lines) + "\n")
    print(f"wrote {len(items)} images -> {dst}")
    return dst


def main(argv: Optional[list] = None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--level", type=int, default=1,
                   help="PNG compression level")
    args = p.parse_args(argv)
    return create_lmdb(args.src, args.dst, args.level)


if __name__ == "__main__":
    main()
