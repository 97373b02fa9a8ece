"""Migrates an LMDB image dataset (the reference's, or one that
``create_lmdb`` wrote) into the packed ``.tpak`` format without loss,
the port's counterpart of ``scripts/lmdb2tpak.py``: each value decoded
as an 8-bit three-channel image (grey repeated, alpha dropped, as
OpenCV's colour decode gives it) and added under its key
(``data/lmdb_io.py::LmdbReader``, ``data/packed.py::PackedWriter``);
neither needs the ``lmdb`` library. On the host.

Usage: python -m trainner_tpu_torch.scripts.lmdb2tpak DATASET.lmdb
       OUT.tpak
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from ..data.common import decode_image_bytes
from ..data.lmdb_io import LmdbReader
from ..data.packed import PackedWriter


def _rgb8(buf: bytes, key: bytes) -> Optional[np.ndarray]:
    try:
        img = decode_image_bytes(bytes(buf), key.decode("ascii", "replace"))
    except (IOError, ValueError):
        return None
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def main(argv: Optional[list] = None) -> int:
    """Returns how many images were migrated."""
    p = argparse.ArgumentParser()
    p.add_argument("src")
    p.add_argument("dst")
    args = p.parse_args(argv)
    reader = LmdbReader(args.src)
    writer = PackedWriter(args.dst)
    n = 0
    try:
        for key, buf in reader.items():
            img = _rgb8(buf, key)
            if img is None:
                print(f"skip undecodable key {key!r}")
                continue
            writer.add_image(key.decode("ascii"), img)
            n += 1
        writer.close()
    finally:
        reader.close()
    print(f"migrated {n} images {args.src} -> {args.dst}")
    return n


if __name__ == "__main__":
    main()
