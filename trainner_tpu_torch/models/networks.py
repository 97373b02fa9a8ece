"""Network factory: counterpart of ``trainner_tpu/models/networks.py``
(``define_G:277``, ``_build_rrdb:29``, ``_build_mrrdb:48``,
``_build_srresnet:56``, ``_build_ppon:67``, ``_build_pan:75``,
``_build_a2n:244``, ``_build_unet:87``, ``_build_resnet_g:98``,
``_build_sft:195``, ``_build_sofvsr:117``, ``_build_sr3d:128``,
``_build_edvr:179``, ``_build_rife:231``, ``_build_srflow:144``,
``_build_srflow_interop:158``, ``_build_abpn:200``,
``_build_asr_resnet:207``, ``_build_asr_cnn:218``, ``_build_seg:237``,
``_build_wbcunet:110``, ``_build_dvd:137``, ``define_D:291``): every
generator type of the JAX package, and the discriminators it builds."""

from __future__ import annotations

import torch

from typing import Optional

from .discriminators import (DiscriminatorVGG, MultiscaleDiscriminator,
                             NLayerDiscriminator, PixelDiscriminator,
                             UNetDiscriminator)
from .rrdb import MRRDBNet, RRDBNet
from .srresnet import SRResNet


def _build_rrdb(cfg: dict, dtype: torch.dtype) -> RRDBNet:
    convtype = str(cfg.get("convtype") or "Conv2D").lower()
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
        else "Conv2D", conv3d=convtype == "conv3d",
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


def _build_unet(cfg: dict, dtype: torch.dtype):
    from .unet import UnetGenerator

    return UnetGenerator(
        input_nc=cfg.get("input_nc", 3), output_nc=cfg.get("output_nc", 3),
        num_downs=cfg.get("num_downs", 8), ngf=cfg.get("ngf", 64),
        norm_type=cfg.get("norm_type", "batch"),
        use_dropout=bool(cfg.get("use_dropout", False)),
        upsample_mode=cfg.get("upsample_mode", "deconv"), dtype=dtype)


def _build_resnet_g(cfg: dict, dtype: torch.dtype):
    from .resnet_g import ResnetGenerator

    return ResnetGenerator(
        input_nc=cfg.get("input_nc", 3), output_nc=cfg.get("output_nc", 3),
        n_blocks=cfg.get("n_blocks", 9), ngf=cfg.get("ngf", 64),
        norm_type=cfg.get("norm_type", "instance"),
        use_dropout=bool(cfg.get("use_dropout", False)),
        upsample_mode=cfg.get("upsample_mode", "deconv"),
        padding_type=cfg.get("padding_type", "reflect"), dtype=dtype)


def _build_sft(cfg: dict, dtype: torch.dtype):
    """SFTNet at its defaults: the JAX ``_build_sft`` reads none of ``cfg``
    (the SFTGAN trainer builds its own from ``nf``, ``cond_nf`` and
    ``n_blocks``; ROADMAP C 22)."""
    from .sft import SFTNet

    return SFTNet(dtype=dtype)


def _build_sofvsr(cfg: dict, dtype: torch.dtype):
    """SOF-VSR as the JAX ``_build_sofvsr`` makes it: the RRDB tail's gc, latent
    noise and ``plus`` at their defaults (32, on, off), whatever
    ``sr_gc``, ``sr_gaussian_noise`` and ``sr_plus`` say."""
    from .sofvsr import SOFVSR

    return SOFVSR(n_frames=cfg.get("n_frames", 3),
                  channels=cfg.get("channels", 320),
                  scale=cfg.get("scale", 4), img_ch=cfg.get("img_ch", 3),
                  sr_net=cfg.get("SR_net", "rrdb"),
                  sr_nf=cfg.get("sr_nf", 64), sr_nb=cfg.get("sr_nb", 23),
                  dtype=dtype)


def _build_sr3d(cfg: dict, dtype: torch.dtype):
    from .sr3d import SR3DNet

    return SR3DNet(in_nc=cfg.get("in_nc", 3), out_nc=cfg.get("out_nc", 3),
                   nf=cfg.get("nf", 64), nb=cfg.get("nb", 23),
                   scale=cfg.get("scale", 4),
                   n_frames=cfg.get("n_frames", 5), dtype=dtype)


def _build_edvr(cfg: dict, dtype: torch.dtype):
    """EDVR as the JAX ``_build_edvr`` makes it: ``upsample_mode`` at its default
    (pixelshuffle) whatever the options say."""
    from .edvr import EDVR

    return EDVR(num_in_ch=cfg.get("num_in_ch", 3),
                num_out_ch=cfg.get("num_out_ch", 3),
                num_feat=cfg.get("num_feat", 64),
                num_frame=cfg.get("num_frame", 5),
                upscale=cfg.get("upscale", 4),
                deformable_groups=cfg.get("deformable_groups", 8),
                num_extract_block=cfg.get("num_extract_block", 5),
                num_reconstruct_block=cfg.get("num_reconstruct_block", 10),
                center_frame_idx=cfg.get("center_frame_idx"),
                with_predeblur=bool(cfg.get("with_predeblur", False)),
                with_tsa=bool(cfg.get("with_tsa", True)), dtype=dtype)


def _build_rife(cfg: dict, dtype: torch.dtype):
    from .rife import RIFE

    return RIFE(c=cfg.get("c", 16), dtype=dtype)


def _build_srflow(cfg: dict, dtype: torch.dtype):
    """SRFlowNet, or the reference-exact net with ``flow.interop`` or
    ``type: srflow_interop``; ``flow.L`` and ``flow.hidden_channels`` (and
    ``K`` beside the type) as the JAX ``_build_srflow`` reads them."""
    flow = cfg.get("flow") or {}
    if flow.get("interop") or cfg.get("type") == "srflow_interop":
        return _build_srflow_interop(cfg, dtype)
    from .srflow import SRFlowNet

    return SRFlowNet(in_nc=cfg.get("in_nc", 3), out_nc=cfg.get("out_nc", 3),
                     nf=cfg.get("nf", 64), nb=cfg.get("nb", 23),
                     gc=cfg.get("gc", 32), scale=cfg.get("scale", 4),
                     K=cfg.get("K", 16), L=flow.get("L", 3),
                     hidden_channels=flow.get("hidden_channels", 64),
                     dtype=dtype)


def _build_srflow_interop(cfg: dict, dtype: torch.dtype):
    """The reference-exact SRFlowNet: ``additionalFlowNoAffine``,
    ``CondAffineSeparatedAndCond.hidden_channels`` (else
    ``hidden_channels``), ``stackRRDB.blocks`` of ``flow``, ``quant``."""
    from .srflow_interop import SRFlowNetI

    flow = cfg.get("flow") or {}
    stack = flow.get("stackRRDB") or {}
    coupling = flow.get("CondAffineSeparatedAndCond") or {}
    return SRFlowNetI(
        in_nc=cfg.get("in_nc", 3), out_nc=cfg.get("out_nc", 3),
        nf=cfg.get("nf", 64), nb=cfg.get("nb", 23), gc=cfg.get("gc", 32),
        scale=cfg.get("scale", 4), K=cfg.get("K", 16), L=flow.get("L", 3),
        n_noaffine=int(flow.get("additionalFlowNoAffine", 2)),
        hidden=int(coupling.get("hidden_channels",
                                flow.get("hidden_channels", 64)) or 64),
        quant=float(cfg.get("quant", 255.0) or 255.0),
        blocks=tuple(stack.get("blocks", (1, 8, 15, 22))), dtype=dtype)


def _build_abpn(cfg: dict, dtype: torch.dtype):
    from .abpn import ABPN

    return ABPN(input_dim=cfg.get("input_dim", cfg.get("in_nc", 3)),
                dim=cfg.get("dim", cfg.get("nf", 32)), dtype=dtype)


def _build_asr_resnet(cfg: dict, dtype: torch.dtype):
    from .asrresnet import ASRResNet

    return ASRResNet(
        scale_factor=cfg.get("scale_factor", cfg.get("scale", 4)),
        spectral_norm=bool(cfg.get("spectral_norm", True)),
        self_attention=bool(cfg.get("self_attention", True)),
        max_pool=bool(cfg.get("max_pool", False)),
        poolsize=cfg.get("poolsize", 4), dtype=dtype)


def _build_asr_cnn(cfg: dict, dtype: torch.dtype):
    from .asrresnet import ASRCNN

    return ASRCNN(
        upscale_factor=cfg.get("upscale_factor", cfg.get("scale", 4)),
        spectral_norm=bool(cfg.get("spectral_norm", True)),
        self_attention=bool(cfg.get("self_attention", True)),
        max_pool=bool(cfg.get("max_pool", True)),
        poolsize=cfg.get("poolsize", 4), finalact=cfg.get("finalact"),
        dtype=dtype)


def _build_wbcunet(cfg: dict, dtype: torch.dtype):
    from .wbcunet import UnetGeneratorWBC

    return UnetGeneratorWBC(nf=cfg.get("nf", 32), mode=cfg.get("mode", "pt"),
                            dtype=dtype)


def _build_dvd(cfg: dict, dtype: torch.dtype):
    from .dvd import DVDNet

    return DVDNet(in_nc=cfg.get("in_nc", 3), out_nc=cfg.get("out_nc", 3),
                  nf=cfg.get("nf", 64), dtype=dtype)


def _build_seg(cfg: dict, dtype: torch.dtype):
    from .seg import OutdoorSceneSeg

    return OutdoorSceneSeg(n_classes=cfg.get("n_classes", 8), dtype=dtype)


_G_REGISTRY = {"rrdb_net": _build_rrdb, "mrrdb_net": _build_mrrdb,
               "sr_resnet": _build_srresnet, "ppon": _build_ppon,
               "pan_net": _build_pan, "a2n_net": _build_a2n,
               "unet_net": _build_unet, "resnet_net": _build_resnet_g,
               "sft_arch": _build_sft, "sofvsr_net": _build_sofvsr,
               "sr3d_net": _build_sr3d, "edvr_net": _build_edvr,
               "rife_net": _build_rife, "srflow_net": _build_srflow,
               "srflow_interop": _build_srflow_interop,
               "abpn_net": _build_abpn, "asr_resnet": _build_asr_resnet,
               "asr_cnn": _build_asr_cnn, "seg_arch": _build_seg,
               "wbcunet_net": _build_wbcunet, "dvd_net": _build_dvd}


def define_G(opt: dict, dtype: torch.dtype = torch.float32):
    """Build the generator module from parsed options; the keys a builder
    does not read (``group``, ``strict``) are ignored, as in the JAX
    package."""
    cfg = dict(opt["network_G"])
    kind = cfg.get("type")
    if kind not in _G_REGISTRY:
        raise NotImplementedError(f"Generator model [{kind}] not "
                                  "recognized")
    return _G_REGISTRY[kind](cfg, dtype)


def define_D(opt: dict, dtype: torch.dtype = torch.bfloat16,
             in_nc: Optional[int] = None):
    """Build the discriminator module from parsed options: D-VGG (with
    spectral norm and no batch norm for a ``*_sn`` type or
    ``spectral_norm``), PatchGAN, the multiscale PatchGAN, PixelGAN or the
    U-Net. ``in_nc`` gives the input's channels where the trainer knows
    them (pix2pix's conditional D sees A and B, 6; WBC's texture D one
    grey channel, 1), in place of the options' ``input_nc`` (``in_nc`` for
    D-VGG): flax infers them from the input, torch needs them up front."""
    cfg = dict(opt["network_D"])
    kind = (cfg.get("type") or "").lower()
    nc = in_nc or cfg.get("input_nc", 3)
    if kind in ("patchgan", "nlayerdiscriminator"):
        return NLayerDiscriminator(
            in_nc=nc, ndf=cfg.get("ndf", 64), n_layers=cfg.get("n_layers", 3),
            norm_type=cfg.get("norm_type", "batch"),
            patch=bool(cfg.get("patch", True)),
            use_spectral_norm=bool(cfg.get("use_spectral_norm", False)),
            dtype=dtype)
    if kind == "multiscale":
        return MultiscaleDiscriminator(
            in_nc=nc, ndf=cfg.get("ndf", 64), n_layers=cfg.get("n_layers", 3),
            norm_type=cfg.get("norm_type", "batch"),
            num_D=cfg.get("num_D", 3), dtype=dtype)
    if kind in ("pixelgan", "pixeldiscriminator"):
        return PixelDiscriminator(in_nc=nc, ndf=cfg.get("ndf", 64),
                                  norm_type=cfg.get("norm_type", "batch"),
                                  dtype=dtype)
    if kind == "unet":
        return UNetDiscriminator(
            nf=cfg.get("nf", 64), in_nc=in_nc or 3,
            skip_connection=bool(cfg.get("skip_connection", True)),
            spectral_norm=bool(cfg.get("spectral_norm", True)), dtype=dtype)
    if not kind.startswith("discriminator_vgg"):
        raise NotImplementedError(
            f"Discriminator model [{kind}] not recognized")
    size = cfg.get("size")
    for tok in ("96", "128", "192", "256"):  # fixed-size variants
        if tok in kind:
            size = int(tok)
    sn = kind.endswith("_sn") or bool(cfg.get("spectral_norm"))
    return DiscriminatorVGG(
        size=int(size), in_nc=in_nc or cfg.get("in_nc", 3),
        base_nf=cfg.get("base_nf", 64),
        norm_type=None if sn else cfg.get("norm_type", "batch"),
        act_type=cfg.get("act_type", "leakyrelu"),
        mode=cfg.get("mode") or "CNA", arch=cfg.get("arch", "ESRGAN"),
        spectral_norm=sn, dtype=dtype)
