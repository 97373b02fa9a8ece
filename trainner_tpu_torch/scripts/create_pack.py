"""Makes a ``.tpak`` packed dataset from an image folder: the port's
counterpart of ``create_lmdb.py`` for the packed format
(``data/packed.py::pack_folder``, the JAX ``data/packed.py:87``).

Usage: python -m trainner_tpu_torch.scripts.create_pack SRC DST.tpak
"""

from __future__ import annotations

import argparse
from typing import Optional

from ..data.packed import pack_folder


def create_pack(src: str, dst: str) -> str:
    """Every image under ``src`` into ``dst`` (``.tpak`` appended when
    missing); returns the path."""
    if not dst.endswith(".tpak"):
        dst += ".tpak"
    n = pack_folder(src, dst)
    if not n:
        raise SystemExit(f"no images under {src}")
    print(f"wrote {n} images -> {dst}")
    return dst


def main(argv: Optional[list] = None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("src")
    p.add_argument("dst")
    args = p.parse_args(argv)
    return create_pack(args.src, args.dst)


if __name__ == "__main__":
    main()
