"""Averages every checkpoint under a directory into one model (a uniform
model soup), the port's counterpart of ``scripts/dir_interp.py``: the
``.ckpt`` / ``.msgpack`` files in walk order, summed leaf by leaf, then
divided by their count, on the host.

Usage: python -m trainner_tpu_torch.scripts.dir_interp --intdir
       experiments/run/models [--savepath soup.ckpt]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from ..utils.checkpoint import load_tree, save_params, tree_map

EXTS = (".ckpt", ".msgpack")


def model_files(root: str) -> List[str]:
    """The checkpoint files under ``root``, directories and names in
    sorted order."""
    paths = []
    for dirpath, _, fnames in sorted(os.walk(root)):
        for fname in sorted(fnames):
            if fname.endswith(EXTS):
                paths.append(os.path.join(dirpath, fname))
    return paths


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--intdir", required=True)
    p.add_argument("--savepath", default="dirinterp.ckpt")
    args = p.parse_args(argv)
    paths = model_files(args.intdir)
    if not paths:
        raise SystemExit(f"no {EXTS} files under {args.intdir}")
    acc = load_tree(paths[0])
    print(f"{paths[0]} added.")
    for path in paths[1:]:
        acc = tree_map(lambda x, y: x + y, acc, load_tree(path))
        print(f"{path} added.")
    n = float(len(paths))
    acc = tree_map(lambda x: x / n, acc)
    save_params(acc, args.savepath, backup=False)
    print(f"averaged {len(paths)} models -> {args.savepath}")


if __name__ == "__main__":
    main()
