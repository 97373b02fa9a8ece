"""Per-architecture network defaults ("pre-flight check").

Counterpart of ``trainner_tpu/options/defaults.py``: ``get_network_G_config``
(the aliases and defaults of ``:19-114``, the per-type key aliases, the
pixel-unshuffle wrapper's config of ``:169-180``), ``get_network_D_config``
(``:219-280``) and ``get_network_defaults`` (``:283-309``). The generator
types that the port builds are the SR generators ``rrdb_net``,
``mrrdb_net``, ``sr_resnet``, ``ppon``, ``pan_net`` and ``a2n_net``; the
JAX package's other types raise here and name their ROADMAP item. Every discriminator spec is parsed as the JAX
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
}

# the JAX package's other generator aliases -> the ROADMAP item that ports
# each (Queue A 10)
_G_NOT_PORTED = {
    "sft_arch": "10.3", "sft_net": "10.3",
    "unet_net": "10.4", "unet_128": "10.4", "unet_256": "10.4",
    "resnet_net": "10.4", "resnet_6blocks": "10.4", "resnet_9blocks": "10.4",
    "sofvsr_net": "10.5", "sofvsr": "10.5", "sr3d_net": "10.5",
    "sr3d": "10.5", "edvr_net": "10.5", "edvr": "10.5", "rife_net": "10.5",
    "rife": "10.5",
    "dvd_net": "10.6", "srflow_net": "10.6", "srflow": "10.6",
    "wbcunet": "10.6", "wbcunet_tf": "10.6", "wbcunet_net": "10.6",
    "seg_arch": "10.6", "seg": "10.6", "abpn_net": "10.6", "abpn": "10.6",
    "asr_resnet": "10.6", "asr_cnn": "10.6",
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
}

_G_ALIAS_OVERRIDES: dict[str, dict[str, Any]] = {
    "esrgan-lite": dict(nf=32, nb=12),
    "esrgan-anime-lite": dict(nf=64, nb=6),
    "esrgan-mid": dict(nf=64, nb=6),
    "evsrgan": dict(convtype="Conv3D"),
}

# user key -> canonical key, or {canonical type: canonical key}
_G_KEY_ALIASES = {
    "scale": {"rrdb_net": "upscale", "mrrdb_net": "upscale",
              "ppon": "upscale", "sr_resnet": "upscale"},
    "net_act": "act_type",
    "gaussian": "gaussian_noise",
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
        item = _G_NOT_PORTED.get(kind)
        if item is None:
            raise NotImplementedError(f"Generator model [{kind}] not "
                                      "recognized")
        raise NotImplementedError(
            f"Generator model [{kind}] is not ported yet (ROADMAP Queue A "
            f"{item}, the rest of the zoo)")
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

    for k, v in user.items():
        cfg[_canon_key(k, canon)] = v
    for k, v in list(cfg.items()):
        if v == _SCALE:
            cfg[k] = scale
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
