"""Network factory: counterpart of ``trainner_tpu/models/networks.py``
(``define_G:277``, ``_build_rrdb:29``, ``define_D:291``) for the generator
and the discriminators that the port runs. Other types raise and name
their ROADMAP item."""

from __future__ import annotations

import torch

from .discriminators import DiscriminatorVGG, UNetDiscriminator
from .rrdb import RRDBNet


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue A, other generator "
        "types and block options)")


def _build_rrdb(cfg: dict, dtype: torch.dtype) -> RRDBNet:
    if cfg.get("norm_type"):
        raise _not_ported(f"rrdb_net norm [{cfg['norm_type']}]")
    if (cfg.get("mode") or "CNA") != "CNA":
        raise _not_ported(f"rrdb_net mode [{cfg['mode']}]")
    if str(cfg.get("act_type") or "leakyrelu").lower() not in ("leakyrelu",
                                                                "lrelu"):
        raise _not_ported(f"rrdb_net act_type [{cfg['act_type']}]")
    if cfg.get("plus"):
        raise _not_ported("rrdb_net plus (ESRGAN+)")
    convtype = str(cfg.get("convtype") or "Conv2D")
    if convtype.lower() != "conv2d":
        raise _not_ported(f"rrdb_net convtype [{convtype}]")
    if cfg.get("scan_blocks"):
        raise _not_ported("scan_blocks (an XLA compile-time device)")
    return RRDBNet(
        in_nc=cfg.get("in_nc", 3), out_nc=cfg.get("out_nc", 3),
        nf=cfg.get("nf", 64), nb=cfg.get("nb", 23), nr=cfg.get("nr", 3),
        gc=cfg.get("gc", 32), upscale=cfg.get("upscale", 4),
        act_type=cfg.get("act_type", "leakyrelu"),
        upsample_mode=cfg.get("upsample_mode", "upconv"),
        final_act=cfg.get("finalact"),
        gaussian_noise=bool(cfg.get("gaussian_noise", True)),
        dtype=dtype)


_G_REGISTRY = {"rrdb_net": _build_rrdb}


def define_G(opt: dict, dtype: torch.dtype = torch.float32) -> RRDBNet:
    """Build the generator module from parsed options."""
    cfg = dict(opt["network_G"])
    kind = cfg.get("type")
    if kind not in _G_REGISTRY:
        raise _not_ported(f"Generator model [{kind}]")
    return _G_REGISTRY[kind](cfg, dtype)


def define_D(opt: dict, dtype: torch.dtype = torch.bfloat16):
    """Build the discriminator module from parsed options: D-VGG (with
    spectral norm and no batch norm for a ``*_sn`` type or
    ``spectral_norm``) or the U-Net."""
    cfg = dict(opt["network_D"])
    kind = (cfg.get("type") or "").lower()
    if kind == "unet":
        return UNetDiscriminator(
            nf=cfg.get("nf", 64),
            skip_connection=bool(cfg.get("skip_connection", True)),
            spectral_norm=bool(cfg.get("spectral_norm", True)), dtype=dtype)
    if not kind.startswith("discriminator_vgg"):
        raise NotImplementedError(
            f"Discriminator model [{kind}] is not ported yet (ROADMAP Queue "
            "A 10.4, the other discriminators)")
    size = cfg.get("size")
    for tok in ("96", "128", "192", "256"):  # fixed-size variants
        if tok in kind:
            size = int(tok)
    if (cfg.get("mode") or "CNA") != "CNA":
        raise NotImplementedError(
            f"discriminator mode [{cfg['mode']}] is not ported yet (ROADMAP "
            "Queue A 2.5, norms and other block options)")
    sn = kind.endswith("_sn") or bool(cfg.get("spectral_norm"))
    return DiscriminatorVGG(
        size=int(size), in_nc=cfg.get("in_nc", 3),
        base_nf=cfg.get("base_nf", 64),
        norm_type=None if sn else cfg.get("norm_type", "batch"),
        act_type=cfg.get("act_type", "leakyrelu"),
        arch=cfg.get("arch", "ESRGAN"), spectral_norm=sn, dtype=dtype)
