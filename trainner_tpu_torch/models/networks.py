"""Network factory: counterpart of ``trainner_tpu/models/networks.py``
(``define_G:277``, ``_build_rrdb:29``, ``_build_mrrdb:48``,
``_build_srresnet:56``, ``_build_ppon:67``, ``_build_pan:75``,
``_build_a2n:244``, ``define_D:291``) for the generators and the
discriminators that the port runs. Other types raise and name their
ROADMAP item."""

from __future__ import annotations

import torch

from .discriminators import DiscriminatorVGG, UNetDiscriminator
from .rrdb import MRRDBNet, RRDBNet
from .srresnet import SRResNet


def _build_rrdb(cfg: dict, dtype: torch.dtype) -> RRDBNet:
    convtype = str(cfg.get("convtype") or "Conv2D").lower()
    if convtype == "conv3d":
        raise NotImplementedError(
            "rrdb_net convtype [Conv3D] (EVSRGAN, video input) is not ported "
            "yet (ROADMAP Queue A 10.5, the video models)")
    if cfg.get("scan_blocks"):
        raise NotImplementedError(
            "scan_blocks (an XLA compile-time device) is not ported")
    return RRDBNet(
        in_nc=cfg.get("in_nc", 3), out_nc=cfg.get("out_nc", 3),
        nf=cfg.get("nf", 64), nb=cfg.get("nb", 23), nr=cfg.get("nr", 3),
        gc=cfg.get("gc", 32), upscale=cfg.get("upscale", 4),
        norm_type=cfg.get("norm_type"),
        act_type=cfg.get("act_type", "leakyrelu"),
        mode=cfg.get("mode", "CNA"),
        upsample_mode=cfg.get("upsample_mode", "upconv"),
        final_act=cfg.get("finalact"),
        gaussian_noise=bool(cfg.get("gaussian_noise", True)),
        plus=bool(cfg.get("plus", False)),
        convtype="PartialConv2D" if convtype == "partialconv2d"
        else "Conv2D",
        dtype=dtype)


def _build_mrrdb(cfg: dict, dtype: torch.dtype) -> MRRDBNet:
    if cfg.get("scan_blocks"):
        raise NotImplementedError(
            "scan_blocks (an XLA compile-time device) is not ported")
    return MRRDBNet(in_nc=cfg.get("in_nc", 3), out_nc=cfg.get("out_nc", 3),
                    nf=cfg.get("nf", 64), nb=cfg.get("nb", 23),
                    gc=cfg.get("gc", 32), upscale=cfg.get("upscale", 4),
                    dtype=dtype)


def _build_srresnet(cfg: dict, dtype: torch.dtype) -> SRResNet:
    return SRResNet(
        in_nc=cfg.get("in_nc", 3), out_nc=cfg.get("out_nc", 3),
        nf=cfg.get("nf", 64), nb=cfg.get("nb", 16),
        upscale=cfg.get("upscale", 4), norm_type=cfg.get("norm_type"),
        act_type=cfg.get("act_type", "relu"), mode=cfg.get("mode", "CNA"),
        res_scale=cfg.get("res_scale", 1),
        upsample_mode=cfg.get("upsample_mode", "pixelshuffle"),
        final_act=cfg.get("finalact"), dtype=dtype)


def _build_ppon(cfg: dict, dtype: torch.dtype):
    from .ppon import PPON

    return PPON(in_nc=cfg.get("in_nc", 3), out_nc=cfg.get("out_nc", 3),
                nf=cfg.get("nf", 64), nb=cfg.get("nb", 24),
                upscale=cfg.get("upscale", 4), dtype=dtype)


def _build_pan(cfg: dict, dtype: torch.dtype):
    from .pan import PAN

    return PAN(in_nc=cfg.get("in_nc", 3), out_nc=cfg.get("out_nc", 3),
               nf=cfg.get("nf", 40), unf=cfg.get("unf", 24),
               nb=cfg.get("nb", 16), scale=cfg.get("scale", 4),
               self_attention=bool(cfg.get("self_attention", False)),
               double_scpa=bool(cfg.get("double_scpa", False)),
               ups_inter_mode=cfg.get("ups_inter_mode", "nearest"),
               dtype=dtype)


def _build_a2n(cfg: dict, dtype: torch.dtype):
    from .pan import AAN

    return AAN(in_nc=cfg.get("in_nc", 3), out_nc=cfg.get("out_nc", 3),
               nf=cfg.get("nf", 40), unf=cfg.get("unf", 24),
               nb=cfg.get("nb", 16), scale=cfg.get("scale", 4), dtype=dtype)


_G_REGISTRY = {"rrdb_net": _build_rrdb, "mrrdb_net": _build_mrrdb,
               "sr_resnet": _build_srresnet, "ppon": _build_ppon,
               "pan_net": _build_pan, "a2n_net": _build_a2n}


def define_G(opt: dict, dtype: torch.dtype = torch.float32):
    """Build the generator module from parsed options; the keys a builder
    does not read (``group``, ``strict``) are ignored, as in the JAX
    package."""
    cfg = dict(opt["network_G"])
    kind = cfg.get("type")
    if kind not in _G_REGISTRY:
        raise NotImplementedError(
            f"Generator model [{kind}] is not ported yet (ROADMAP Queue A "
            "10, the rest of the zoo)")
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
    sn = kind.endswith("_sn") or bool(cfg.get("spectral_norm"))
    return DiscriminatorVGG(
        size=int(size), in_nc=cfg.get("in_nc", 3),
        base_nf=cfg.get("base_nf", 64),
        norm_type=None if sn else cfg.get("norm_type", "batch"),
        act_type=cfg.get("act_type", "leakyrelu"),
        mode=cfg.get("mode") or "CNA", arch=cfg.get("arch", "ESRGAN"),
        spectral_norm=sn, dtype=dtype)
