"""Per-architecture network defaults for the generator.

Counterpart of ``trainner_tpu/options/defaults.py`` (``get_network_G_config``
and ``get_network_defaults``), restricted to the ESRGAN family that the
port runs. Other generator types raise and name their ROADMAP item.
"""

from __future__ import annotations

import copy
from typing import Any

_G_ALIASES = {
    "rrdb_net": "rrdb_net", "esrgan": "rrdb_net", "evsrgan": "rrdb_net",
    "esrgan-lite": "rrdb_net", "esrgan-anime-lite": "rrdb_net",
    "esrgan-mid": "rrdb_net",
}

_SCALE = "__scale__"

_G_DEFAULTS: dict[str, dict[str, Any]] = {
    "rrdb_net": dict(
        norm_type=None, mode="CNA", nf=64, nb=23, nr=3, in_nc=3, out_nc=3,
        gc=32, convtype="Conv2D", act_type="leakyrelu", gaussian_noise=True,
        plus=False, finalact=None, upscale=_SCALE, upsample_mode="upconv",
    ),
}

_G_ALIAS_OVERRIDES: dict[str, dict[str, Any]] = {
    "esrgan-lite": dict(nf=32, nb=12),
    "esrgan-anime-lite": dict(nf=64, nb=6),
    "esrgan-mid": dict(nf=64, nb=6),
    "evsrgan": dict(convtype="Conv3D"),
}

# user key -> canonical key
_G_KEY_ALIASES = {"scale": "upscale", "net_act": "act_type",
                  "gaussian": "gaussian_noise"}


def _extract_kind(network):
    if isinstance(network, str):
        return network.lower(), {}
    if isinstance(network, dict):
        user = dict(network)
        for k in ("which_model_G", "type"):
            if k in user:
                return str(user.pop(k)).lower(), user
    raise ValueError(f"Cannot determine network type from: {network!r}")


def get_network_G_config(network_G, scale: int) -> dict:
    kind, user = _extract_kind(network_G)
    strict = user.pop("strict", False)
    canon = _G_ALIASES.get(kind)
    if canon is None:
        raise NotImplementedError(
            f"Generator model [{kind}] is not ported yet (ROADMAP Queue A, "
            "other generator types)")
    cfg = copy.deepcopy(_G_DEFAULTS[canon])
    cfg.update(_G_ALIAS_OVERRIDES.get(kind, {}))
    cfg["type"] = canon
    cfg["strict"] = strict
    for k, v in user.items():
        cfg[_G_KEY_ALIASES.get(k, k)] = v
    for k, v in list(cfg.items()):
        if v == _SCALE:
            cfg[k] = scale
    return cfg


def get_network_defaults(opt: dict) -> dict:
    network_G = opt.pop("network_G", None)
    if network_G is not None:
        opt["network_G"] = get_network_G_config(network_G,
                                                opt.get("scale", 1))
    return opt
