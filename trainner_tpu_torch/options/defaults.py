"""Per-architecture network defaults ("pre-flight check").

Counterpart of ``trainner_tpu/options/defaults.py``: ``get_network_G_config``
(the aliases and defaults of ``:19-114``, the per-type key aliases, the
pixel-unshuffle wrapper's config of ``:169-180``), ``get_network_D_config``
(``:219-280``) and ``get_network_defaults`` (``:283-309``). The generator
types that the port builds are the SR generators ``rrdb_net``,
``mrrdb_net``, ``sr_resnet``, ``ppon``, ``pan_net``, ``a2n_net``,
``abpn_net``, ``asr_resnet``, ``asr_cnn`` and ``seg_arch``, SRFlow's
``srflow_net`` (with its nested ``flow`` config merged into the defaults
of ``:182-205``; ``flow.interop`` or the type ``srflow_interop`` selects
the reference-exact net, an alias the JAX table lacks, ROADMAP C 26), the
image-to-image and SFTGAN generators ``unet_net``, ``resnet_net`` and
``sft_arch``, white-box cartoonization's ``wbcunet_net`` (``wbcunet``;
``wbcunet_tf`` sets ``mode: tf``), the deinterlacer ``dvd_net``, and the
video generators ``sofvsr_net``, ``sr3d_net``, ``edvr_net``, ``rife_net``
and ``evsrgan`` (``rrdb_net`` with a Conv3D trunk): every type of the JAX
table. Every discriminator spec is parsed as the JAX
package parses it; ``models/networks.py::define_D`` refuses the types the
port does not build.
"""

from __future__ import annotations

import copy
from typing import Any

__all__ = ["get_network_G_config", "get_network_D_config",
           "get_network_defaults"]

_G_ALIASES = {
    "rrdb_net": "rrdb_net", "esrgan": "rrdb_net", "evsrgan": "rrdb_net",
    "esrgan-lite": "rrdb_net", "esrgan-anime-lite": "rrdb_net",
    "esrgan-mid": "rrdb_net",
    "mrrdb_net": "mrrdb_net", "mesrgan": "mrrdb_net",
    "sr_resnet": "sr_resnet", "srresnet": "sr_resnet", "srgan": "sr_resnet",
    "ppon": "ppon", "pan_net": "pan_net", "pan": "pan_net",
    "a2n_net": "a2n_net", "a2n": "a2n_net", "aan": "a2n_net",
    "sft_arch": "sft_arch", "sft_net": "sft_arch",
    "unet_net": "unet_net", "unet_128": "unet_net", "unet_256": "unet_net",
    "resnet_net": "resnet_net", "resnet_6blocks": "resnet_net",
    "resnet_9blocks": "resnet_net",
    "sofvsr_net": "sofvsr_net", "sofvsr": "sofvsr_net",
    "sr3d_net": "sr3d_net", "sr3d": "sr3d_net",
    "edvr_net": "edvr_net", "edvr": "edvr_net",
    "rife_net": "rife_net", "rife": "rife_net",
    "srflow_net": "srflow_net", "srflow": "srflow_net",
    "srflow_interop": "srflow_net",
    "abpn_net": "abpn_net", "abpn": "abpn_net",
    "asr_cnn": "asr_cnn", "asr_resnet": "asr_resnet",
    "seg_arch": "seg_arch", "seg": "seg_arch",
    "wbcunet": "wbcunet_net", "wbcunet_tf": "wbcunet_net",
    "wbcunet_net": "wbcunet_net",
    "dvd_net": "dvd_net",
}

_SCALE = "__scale__"

_G_DEFAULTS: dict[str, dict[str, Any]] = {
    "rrdb_net": dict(
        norm_type=None, mode="CNA", nf=64, nb=23, nr=3, in_nc=3, out_nc=3,
        gc=32, convtype="Conv2D", act_type="leakyrelu", gaussian_noise=True,
        plus=False, finalact=None, upscale=_SCALE, upsample_mode="upconv",
    ),
    "mrrdb_net": dict(in_nc=3, out_nc=3, nf=64, nb=23, gc=32, upscale=_SCALE),
    "sr_resnet": dict(in_nc=3, out_nc=3, nf=64, nb=16, upscale=_SCALE,
                      norm_type=None, act_type="relu", mode="CNA",
                      upsample_mode="pixelshuffle", convtype="Conv2D",
                      finalact=None, res_scale=1),
    "ppon": dict(in_nc=3, out_nc=3, nf=64, nb=24, upscale=_SCALE,
                 act_type="leakyrelu"),
    "pan_net": dict(in_nc=3, out_nc=3, nf=40, unf=24, nb=16, scale=_SCALE,
                    self_attention=False, double_scpa=False,
                    ups_inter_mode="nearest"),
    "a2n_net": dict(in_nc=3, out_nc=3, nf=40, unf=24, nb=16, scale=_SCALE,
                    mode="n"),
    "sft_arch": dict(),
    "unet_net": dict(input_nc=3, output_nc=3, num_downs=8, ngf=64,
                     norm_type="batch", use_dropout=False,
                     upsample_mode="deconv"),
    "resnet_net": dict(input_nc=3, output_nc=3, n_blocks=9, ngf=64,
                       norm_type="instance", use_dropout=False,
                       upsample_mode="deconv", padding_type="reflect"),
    "sofvsr_net": dict(n_frames=3, channels=320, scale=_SCALE, img_ch=3,
                       SR_net="rrdb", sr_nf=64, sr_nb=23, sr_gc=32, sr_unf=24,
                       sr_gaussian_noise=True, sr_plus=False, sr_sa=True,
                       sr_upinter_mode="nearest"),
    "sr3d_net": dict(in_nc=3, out_nc=3, nf=64, nb=23, scale=_SCALE, n_frames=5),
    "edvr_net": dict(num_in_ch=3, num_out_ch=3, num_feat=64, num_frame=5,
                     upscale=_SCALE, deformable_groups=8, num_extract_block=5,
                     num_reconstruct_block=10, center_frame_idx=None,
                     with_predeblur=False, with_tsa=True,
                     upsample_mode="pixelshuffle", add_rrdb=False, nb=23),
    "rife_net": dict(),
    "srflow_net": dict(in_nc=3, out_nc=3, nf=64, nb=23, gc=32, scale=_SCALE,
                       train_RRDB=False, train_RRDB_delay=0.5),
    "abpn_net": dict(input_dim=3, dim=32),
    "asr_cnn": dict(upscale_factor=_SCALE, spectral_norm=True,
                    self_attention=True, max_pool=True, poolsize=4,
                    finalact="tanh"),
    "asr_resnet": dict(scale_factor=_SCALE, spectral_norm=True,
                       self_attention=True, max_pool=True, poolsize=4),
    "seg_arch": dict(n_classes=8),
    "wbcunet_net": dict(nf=32, mode="pt"),
    "dvd_net": dict(in_nc=3, out_nc=3, nf=64),
}

_SRFLOW_FLOW_DEFAULTS = dict(
    K=16, L=3, noInitialInj=True, coupling="CondAffineSeparatedAndCond",
    additionalFlowNoAffine=2, fea_up0=True,
    split={"enable": True}, augmentation={"noiseQuant": True},
    stackRRDB={"blocks": [1, 8, 15, 22], "concat": True},
)

_G_ALIAS_OVERRIDES: dict[str, dict[str, Any]] = {
    "esrgan-lite": dict(nf=32, nb=12),
    "esrgan-anime-lite": dict(nf=64, nb=6),
    "esrgan-mid": dict(nf=64, nb=6),
    "evsrgan": dict(convtype="Conv3D"),
    # the JAX alias table lacks it (its parse refuses the type, C 26)
    "srflow_interop": dict(flow={"interop": True}),
    "unet_128": dict(num_downs=7),
    "unet_256": dict(num_downs=8),
    "resnet_6blocks": dict(n_blocks=6),
    "resnet_9blocks": dict(n_blocks=9),
    "wbcunet_tf": dict(mode="tf"),
}

# user key -> canonical key, or {canonical type: canonical key}
_G_KEY_ALIASES = {
    "net_act": "act_type",
    "gaussian": "gaussian_noise",
    "scale": {"rrdb_net": "upscale", "mrrdb_net": "upscale",
              "ppon": "upscale", "sr_resnet": "upscale",
              "asr_cnn": "upscale_factor", "asr_resnet": "scale_factor",
              "edvr_net": "upscale"},
    "in_nc": {"unet_net": "input_nc", "resnet_net": "input_nc",
              "abpn_net": "input_dim", "sofvsr_net": "img_ch",
              "edvr_net": "num_in_ch"},
    "out_nc": {"unet_net": "output_nc", "resnet_net": "output_nc",
               "edvr_net": "num_out_ch"},
    "nf": {"edvr_net": "num_feat"},
    "n_frames": {"edvr_net": "num_frame"},
    "predeblur": "with_predeblur",
    "tsa": "with_tsa",
}


def _extract_kind(network,
                  which_keys=("which_model_G", "which_model_D", "type")):
    if isinstance(network, str):
        return network.lower(), {}
    if isinstance(network, dict):
        user = dict(network)
        for k in which_keys:
            if k in user:
                return str(user.pop(k)).lower(), user
    raise ValueError(f"Cannot determine network type from: {network!r}")


def _canon_key(user_key: str, canon_type: str) -> str:
    alias = _G_KEY_ALIASES.get(user_key)
    if alias is None:
        return user_key
    if isinstance(alias, dict):
        return alias.get(canon_type, user_key)
    return alias


def get_network_G_config(network_G, scale: int, crop_size=None) -> dict:
    kind, user = _extract_kind(network_G)
    strict = user.pop("strict", False)
    canon = _G_ALIASES.get(kind)
    if canon is None:
        raise NotImplementedError(f"Generator model [{kind}] not "
                                  "recognized")
    cfg = copy.deepcopy(_G_DEFAULTS[canon])
    cfg.update(_G_ALIAS_OVERRIDES.get(kind, {}))
    cfg["type"] = canon
    cfg["strict"] = strict

    # the pixel-unshuffle wrapper: in_nc times unshuffle_scale^2
    unshuffle = user.pop("unshuffle", False)
    unshuffle_scale = user.pop("unshuffle_scale", None)
    if unshuffle:
        if unshuffle_scale is None:
            net_scale = user.get("scale")
            unshuffle_scale = (net_scale // scale) \
                if net_scale and net_scale != scale else None
        cfg["unshuffle_scale"] = unshuffle_scale
        in_nc = user.get("in_nc", 3)
        if unshuffle_scale and in_nc in (1, 3):
            user["in_nc"] = in_nc * unshuffle_scale ** 2

    # SRFlow's nested flow config: each dict merged into its default
    if canon == "srflow_net":
        flow = copy.deepcopy(_SRFLOW_FLOW_DEFAULTS)
        for k, v in list((cfg.pop("flow", None) or {}).items()) + list(
                (user.pop("flow", None) or {}).items()):
            if isinstance(v, dict) and isinstance(flow.get(k), dict):
                flow[k].update(v)
            else:
                flow[k] = v
        cfg["flow"] = flow
        cfg["K"] = flow["K"]
        cfg["upscale"] = None

    for k, v in user.items():
        cfg[_canon_key(k, canon)] = v
    for k, v in list(cfg.items()):
        if v == _SCALE:
            cfg[k] = scale
    if canon == "srflow_net":
        cfg["upscale"] = cfg["scale"]
    return cfg


def get_network_D_config(network_D, scale: int, crop_size,
                         model_G: str) -> dict:
    """A ``network_D`` spec -> its config: the key aliases (``nf`` /
    ``base_nf``, ``net_act``, ``G_arch``, ``in_nc`` / ``input_nc``,
    ``which_model_D``), ``size`` from the crop size, and the keys it does
    not name passed through."""
    arch = "PPON" if model_G == "ppon" else "ESRGAN"
    kind, user = _extract_kind(network_D)
    cfg: dict[str, Any] = {"strict": user.pop("strict", True)}

    def take(key, default, *user_keys):
        for uk in user_keys or (key,):
            if uk in user:
                return user.pop(uk)
        return default

    if kind == "dis_acd":
        cfg["type"] = "dis_acd"
    elif kind == "discriminator_vgg_128_sn":
        cfg["type"] = "discriminator_vgg_128_SN"
    elif kind in ("adiscriminator", "adiscriminator_s"):
        cfg.update(type="adiscriminator",
                   spectral_norm=take("spectral_norm", True),
                   self_attention=take("self_attention", True),
                   max_pool=take("max_pool", False),
                   poolsize=take("poolsize", 4))
    elif "discriminator_vgg" in kind or kind in ("discriminator_192",
                                                 "discriminator_256"):
        cfg["type"] = kind
        cfg["in_nc"] = take("in_nc", 3)
        cfg["base_nf"] = take("base_nf", 64, "nf", "base_nf")
        cfg["norm_type"] = take("norm_type", "batch")
        cfg["mode"] = take("mode", "CNA")
        cfg["act_type"] = take("act_type", "leakyrelu", "net_act",
                               "act_type")
        cfg["convtype"] = take("convtype", "Conv2D")
        cfg["arch"] = take("arch", arch, "G_arch")
        if "_fea" in kind:
            cfg.update(spectral_norm=take("spectral_norm", False),
                       self_attention=take("self_attention", False),
                       max_pool=take("max_pool", False),
                       poolsize=take("poolsize", 4))
        if kind in ("discriminator_vgg", "discriminator_vgg_fea"):
            cfg["size"] = take("size", crop_size, "D_size", "size")
    elif kind in ("patchgan", "nlayerdiscriminator", "multiscale",
                  "pixelgan", "pixeldiscriminator"):
        cfg["type"] = {"nlayerdiscriminator": "patchgan",
                       "pixeldiscriminator": "pixelgan"}.get(kind, kind)
        cfg["input_nc"] = take("input_nc", 3, "in_nc", "input_nc")
        cfg["ndf"] = take("ndf", 64, "nf", "ndf")
        if cfg["type"] in ("patchgan", "multiscale"):
            cfg["n_layers"] = take("n_layers", 3, "n_layers", "nlayer")
            cfg["get_feats"] = take("get_feats", False)
        if cfg["type"] == "patchgan":
            cfg["patch"] = take("patch", True, "patch_output", "patch")
            cfg["use_spectral_norm"] = take(
                "use_spectral_norm", False, "spectral_norm",
                "use_spectral_norm")
        if cfg["type"] == "multiscale":
            cfg["num_D"] = take("num_D", 3)
    elif "unet" in kind:
        cfg.update(type="unet",
                   input_nc=take("input_nc", 3, "in_nc", "input_nc"),
                   nf=take("nf", 64),
                   skip_connection=take("skip_connection", True))
    else:
        raise NotImplementedError(
            f"Discriminator model [{kind}] not recognized")
    cfg.update(user)  # the keys it does not name pass through
    return cfg


def get_network_defaults(opt: dict, is_train: bool = True) -> dict:
    """``network_G`` (with the unshuffle wrapper's keys) and ``network_D``
    -> their configs; ``unshuffle_scale`` lands at the top level."""
    scale = opt.get("scale", 1)
    if is_train:
        crop_size = ((opt.get("datasets") or {}).get("train")
                     or {}).get("crop_size")
        crop_size = int(crop_size) if crop_size else None
    else:
        crop_size = opt.get("img_size")

    network_G = opt.pop("network_G", None)
    if network_G is None:
        return opt
    if opt.get("use_unshuffle") and isinstance(network_G, dict):
        network_G.setdefault("unshuffle", True)
        if opt.get("unshuffle_scale"):
            network_G.setdefault("unshuffle_scale", opt["unshuffle_scale"])
    elif opt.get("use_unshuffle") and isinstance(network_G, str):
        network_G = {"type": network_G, "unshuffle": True,
                     "unshuffle_scale": opt.get("unshuffle_scale")}
    network_G = get_network_G_config(network_G, scale, crop_size)
    if "unshuffle_scale" in network_G:
        opt["unshuffle_scale"] = network_G.pop("unshuffle_scale")
    opt["network_G"] = network_G

    if opt.get("network_D"):
        opt["network_D"] = get_network_D_config(
            opt.pop("network_D"), scale, crop_size, network_G["type"])
    return opt
