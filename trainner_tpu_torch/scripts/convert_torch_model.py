"""Converts reference PyTorch checkpoints into the port's files, the
port's counterpart of ``scripts/convert_torch_model.py``, on the host:

* ``esrgan`` (both key layouts), ``srresnet``, ``discriminator``
  (D-VGG: params and batch_stats), ``ppon``, ``sofvsr``: a ``.pth``
  state dict -> the flax param ``.ckpt`` of the JAX layout, which both
  packages load;
* ``vgg``: torchvision VGG features -> ``conv{b}_{c}/kernel|bias`` npz;
* ``lpips``: the reference LPIPS lin weights -> ``lin{i}`` npz;
* ``lpips-full``: a torchvision squeeze / alex / vgg16 backbone (and
  ``--lin`` weights) -> ``net/<layer>/kernel|bias`` npz;
* ``export``: an RRDBNet ``.ckpt`` -> a reference-layout ``.pth``.

The other layouts of the JAX tool (pan, resnet_g, sftnet, unet, aan, dvd,
wbcunet, abpn, seg, srflow, edvr) are not ported yet (ROADMAP Queue
A 12).

Usage: python -m trainner_tpu_torch.scripts.convert_torch_model KIND SRC
       DST [--nb 23] [--net squeeze|alex|vgg] [--lin LIN.pth]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ..models.perceptual import VGG_CFGS
from ..utils import pth_convert as pc
from ..utils.checkpoint import load_tree, save_params
from ..utils.torch_interop import srresnet_to_params

CONVERTERS = {"esrgan": pc.esrgan_to_params,
              "srresnet": srresnet_to_params,
              "discriminator": pc.discriminator_vgg_to_params,
              "ppon": pc.ppon_to_params, "sofvsr": pc.sofvsr_to_params}

# torchvision state-dict conv prefixes -> the flax layer names, per backbone
_LPIPS_BACKBONE_MAPS = {
    "squeeze": [("features.0", "conv1")] + [
        (f"features.{idx}.{part}", f"fire{n}_{tag}")
        for n, idx in enumerate((3, 4, 6, 7, 9, 10, 11, 12), start=1)
        for part, tag in (("squeeze", "s"), ("expand1x1", "e1"),
                          ("expand3x3", "e3"))],
    "alex": [(f"features.{idx}", f"conv{n}")
             for n, idx in enumerate((0, 3, 6, 8, 10), start=1)],
    "vgg": [(f"features.{idx}", f"conv{b}_{c}")
            for (b, c), idx in zip(
                [(b, c) for b, reps in enumerate((2, 2, 3, 3, 3), start=1)
                 for c in range(1, reps + 1)],
                (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28))],
}


def convert_vgg(src: str, dst: str) -> None:
    """torchvision vgg .pth ('features.N.weight') -> conv{b}_{c} npz."""
    sd = pc.load_state_dict(src)
    n_convs = sorted(int(k.split(".")[1]) for k in sd
                     if k.startswith("features.") and k.endswith(".weight")
                     and sd[k].ndim == 4)
    arch = {8: "vgg11", 10: "vgg13", 13: "vgg16", 16: "vgg19"}[
        len(n_convs)]
    out = {}
    it = iter(n_convs)
    for b, reps in enumerate(VGG_CFGS[arch], start=1):
        for c in range(1, reps + 1):
            idx = next(it)
            out[f"conv{b}_{c}/kernel"] = pc.conv_to_hwio(
                sd[f"features.{idx}.weight"])
            out[f"conv{b}_{c}/bias"] = sd[f"features.{idx}.bias"]
    np.savez(dst, **out)
    print(f"{arch} features -> {dst}")


def _lin_vectors(sd: dict) -> dict:
    out = {}
    for k, v in sd.items():
        if ".model.1.weight" in k or (k.startswith("lin")
                                      and k.endswith("weight")):
            out[f"lin{k.split('.')[0].replace('lin', '')}"] = \
                np.asarray(v).reshape(-1)
    return out


def convert_lpips(src: str, dst: str) -> None:
    out = _lin_vectors(pc.load_state_dict(src))
    np.savez(dst, **out)
    print(f"LPIPS lin weights ({len(out)} layers) -> {dst}")


def convert_lpips_full(src: str, dst: str, net: str,
                       lin_src: Optional[str] = None) -> None:
    """A torchvision backbone .pth (squeezenet1_1 | alexnet | vgg16 state
    dict) -> the full LPIPS npz ('net/<layer>/kernel|bias', HWIO), with
    the lin vectors of ``lin_src`` when given."""
    sd = pc.load_state_dict(src)
    out = {}
    for prefix, name in _LPIPS_BACKBONE_MAPS[net]:
        out[f"net/{name}/kernel"] = pc.conv_to_hwio(sd[f"{prefix}.weight"])
        out[f"net/{name}/bias"] = np.asarray(sd[f"{prefix}.bias"])
    if lin_src:
        out.update(_lin_vectors(pc.load_state_dict(lin_src)))
    np.savez(dst, **out)
    print(f"LPIPS {net} backbone ({len(out)} arrays) -> {dst}")


def export_esrgan(src: str, dst: str, nb: int) -> None:
    """An RRDBNet ``.ckpt`` -> the reference's named-layout ``.pth``."""
    sd = pc.params_to_esrgan(load_tree(src), nb=nb)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               dst)
    print(f"exported reference-layout state_dict -> {dst}")


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("kind", choices=sorted(CONVERTERS) + [
        "vgg", "lpips", "lpips-full", "export"])
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--nb", type=int, default=23)
    p.add_argument("--net", choices=["squeeze", "alex", "vgg"],
                   default="squeeze", help="lpips-full backbone kind")
    p.add_argument("--lin", default=None,
                   help="lpips-full: reference lin-weights .pth to embed")
    args = p.parse_args(argv)
    if args.kind in CONVERTERS:
        save_params(CONVERTERS[args.kind](pc.load_state_dict(args.src)),
                    args.dst, backup=False)
        print(f"{args.kind} params -> {args.dst}")
    elif args.kind == "vgg":
        convert_vgg(args.src, args.dst)
    elif args.kind == "lpips":
        convert_lpips(args.src, args.dst)
    elif args.kind == "lpips-full":
        convert_lpips_full(args.src, args.dst, args.net, lin_src=args.lin)
    else:
        export_esrgan(args.src, args.dst, args.nb)


if __name__ == "__main__":
    main()
