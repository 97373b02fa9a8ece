"""Extracts a plain generator checkpoint from an SWA training state, the
port's counterpart of ``scripts/swa2normal.py``: the ``swa_params``
subtree of a ``.state`` file (either package's) into a params ``.ckpt``;
or, from a reference ``.pth`` with an ``n_averaged`` key (torch's
``AveragedModel``), the wrapper stripped and the ESRGAN weights
converted (``utils/pth_convert.py``). On the host.

Usage: python -m trainner_tpu_torch.scripts.swa2normal latest.state
       swa_G.ckpt
       python -m trainner_tpu_torch.scripts.swa2normal swa_model.pth
       swa_G.ckpt
"""

from __future__ import annotations

import argparse
from typing import Any, Optional

import torch

from ..utils.checkpoint import load_tree, save_params
from ..utils.pth_convert import esrgan_to_params


def from_torch(path: str) -> Any:
    """An ESRGAN ``.pth``, SWA-wrapped or not -> its flax param tree."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if "n_averaged" in sd:
        print(f"stripping SWA wrapper (n_averaged="
              f"{int(sd['n_averaged'])})")
        sd = {k[len("module."):] if k.startswith("module.") else k: v
              for k, v in sd.items() if k != "n_averaged"}
    return esrgan_to_params({k: v.detach().numpy() for k, v in sd.items()})


def from_state(path: str) -> Any:
    """The ``swa_params`` subtree of a training state file."""
    raw = load_tree(path)
    tree = raw.get("state", raw)
    swa = tree.get("swa_params")
    if swa is None:
        raise SystemExit(f"{path} has no swa_params subtree — was SWA "
                         "enabled (train.swa)?")
    n = tree.get("swa_n")
    if n is not None:
        print(f"swa_n = {n}")
    return swa


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("state", help=".state/.ckpt training state or torch "
                   ".pth with n_averaged")
    p.add_argument("out")
    args = p.parse_args(argv)
    params = from_torch(args.state) if args.state.endswith(".pth") \
        else from_state(args.state)
    save_params(params, args.out, backup=False)
    print(f"SWA params -> {args.out}")


if __name__ == "__main__":
    main()
