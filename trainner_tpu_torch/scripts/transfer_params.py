"""Initialises one net's params from another's (a warm start), the
port's counterpart of ``scripts/transfer_params.py``: every leaf of the
destination tree whose dotted path (after ``--map SRC=DST`` prefix
renames) exists in the source with the same shape is copied; the others
keep the destination's values. On the host.

Usage: python -m trainner_tpu_torch.scripts.transfer_params
       pretrained.ckpt fresh_init.ckpt out.ckpt [--map SRC=DST ...]
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

from ..utils.checkpoint import load_tree, save_params


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """The leaves of a tree of dicts by dotted path."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(flatten(v, f"{prefix}{k}."))
    return out


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("source", help="pretrained params .ckpt")
    p.add_argument("dest", help="freshly-initialized params .ckpt of "
                   "the target net")
    p.add_argument("out")
    p.add_argument("--map", action="append", default=[],
                   metavar="SRC_PREFIX=DST_PREFIX")
    args = p.parse_args(argv)
    src = flatten(load_tree(args.source))
    renames = [m.split("=", 1) for m in args.map]
    copied, kept = 0, 0

    def visit(node, path=""):
        nonlocal copied, kept
        if isinstance(node, dict):
            return {k: visit(v, f"{path}{k}.") for k, v in node.items()}
        key = lookup = path[:-1]
        for sp, dp in renames:
            if key.startswith(dp):
                lookup = sp + key[len(dp):]
                break
        cand = src.get(lookup)
        if cand is not None and tuple(cand.shape) == tuple(node.shape):
            copied += 1
            print(f"copy {lookup} -> {key} {tuple(node.shape)}")
            return cand
        kept += 1
        return node

    out = visit(load_tree(args.dest))
    save_params(out, args.out, backup=False)
    print(f"copied {copied} tensors, kept {kept} fresh -> {args.out}")


if __name__ == "__main__":
    main()
