"""Visual check of a dataset and its on-device degradations, the port's
counterpart of ``scripts/test_dataloader.py``: the train dataset and
loader of an options file and ``train/producer.py::make_otf_degradation``
(on the card unless ``--device cpu``, so the blur kernel carries the
degradations; its draws from a generator seeded 0, as the JAX tool's
from ``PRNGKey(0)``), for ``-n``
batches: each array of each batch described in the JAX package's format
(``utils/debug.py::describe_array``) and dumped as PNGs under
``{out}/batch{i}/{key}_{j}.png`` (``tmp_vis``).

Usage: python -m trainner_tpu_torch.scripts.test_dataloader -opt
       options/sr/train_sr.yml [-n 2] [-out DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import torch

from ..data import create_dataloader, create_dataset
from ..options import parse
from ..train.producer import make_otf_degradation
from ..utils.debug import describe_array, tmp_vis
from ..utils.device import resolve_device


def run(opt: dict, n: int, out: str, device=None
        ) -> List[Dict[str, torch.Tensor]]:
    """The first ``n`` batches of the train loader through the degrader,
    described, dumped and returned (each tensor on the host)."""
    dev = resolve_device(device)
    train_ds = None
    for key, ds in (opt.get("datasets") or {}).items():
        if key.split("_")[0] == "train":
            train_ds = ds
    loader = create_dataloader(create_dataset(train_ds), train_ds)
    degrade = make_otf_degradation(opt, device=dev)
    got = []
    for i, batch in enumerate(loader):
        if i >= n:
            break
        arrays = {k: v.to(dev) for k, v in batch.items()
                  if isinstance(v, torch.Tensor)}
        if degrade is not None:
            arrays = degrade(arrays)
        arrays = {k: v.cpu() for k, v in arrays.items()}
        for k, v in arrays.items():
            print(describe_array(v, f"batch{i}.{k}"))
            tmp_vis(v, os.path.join(out, f"batch{i}"), k)
        got.append(arrays)
    print(f"dumped {n} batches -> {out}")
    return got


def main(argv: Optional[list] = None):
    p = argparse.ArgumentParser()
    p.add_argument("-opt", required=True)
    p.add_argument("-n", type=int, default=2, help="batches to dump")
    p.add_argument("-out", default="dl_vis")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    return run(parse(args.opt, is_train=True), args.n, args.out,
               args.device)


if __name__ == "__main__":
    main()
