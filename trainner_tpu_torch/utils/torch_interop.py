"""Weights for the port's ``RRDBNet``: from the JAX package's flax param
tree, and from reference ESRGAN ``.pth`` state_dicts in either layout.

The port's own copy of what it needs from
``trainner_tpu/utils/torch_interop.py`` (``detect_esrgan_arch:40``,
``_esrgan_old_to_named:50``, ``load_state_dict:21``), plus
``params_from_jax``, the inverse of the flax-side naming of
``esrgan_to_params:82``. Flax kernels are HWIO, torch's OIHW.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def hwio_to_oihw(w: np.ndarray) -> np.ndarray:
    """flax HWIO -> torch OIHW (the inverse of ``conv_to_hwio``)."""
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def _unstack_trunk(params: Mapping[str, Any]) -> Dict[str, Any]:
    """A ``scan_blocks`` tree (``RRDBs/block`` leaves stacked on a leading
    nb axis) -> the unrolled ``RRDB{i}`` layout."""
    if "RRDBs" not in params:
        return dict(params)
    stacked = params["RRDBs"]["block"]

    def take(node, i):
        if isinstance(node, Mapping):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    first = stacked
    while isinstance(first, Mapping):
        first = next(iter(first.values()))
    out = {k: v for k, v in params.items() if k != "RRDBs"}
    for i in range(np.shape(first)[0]):
        out[f"RRDB{i}"] = take(stacked, i)
    return out


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax ``RRDBNet`` param tree (numpy leaves, unrolled or scan
    layout, with or without a top-level ``params`` key) -> the port's
    state_dict in the reference "new" ``.pth`` layout:

      fea_conv/Conv_0                     -> conv_first
      RRDB{i}/RDB{j}/conv{k}/Conv_0       -> RRDB_trunk.{i}.RDB{j}.conv{k}
      LR_conv/Conv_0                      -> trunk_conv
      up{n}/ConvBlock_0/Conv_0            -> upconv{n+1}
      HR_conv0/Conv_0, HR_conv1/Conv_0    -> HRconv, conv_last
    """
    if "params" in params and "fea_conv" not in params:
        params = params["params"]
    params = _unstack_trunk(params)
    sd: Dict[str, torch.Tensor] = {}

    def emit(name: str, node: Mapping[str, Any]) -> None:
        sd[f"{name}.weight"] = torch.from_numpy(
            hwio_to_oihw(np.asarray(node["kernel"], np.float32)))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.array(node["bias"], np.float32))

    for key, node in params.items():
        if key == "fea_conv":
            emit("conv_first", node["Conv_0"])
        elif key == "LR_conv":
            emit("trunk_conv", node["Conv_0"])
        elif key == "HR_conv0":
            emit("HRconv", node["Conv_0"])
        elif key == "HR_conv1":
            emit("conv_last", node["Conv_0"])
        elif (m := re.fullmatch(r"up(\d+)", key)):
            emit(f"upconv{int(m.group(1)) + 1}",
                 node["ConvBlock_0"]["Conv_0"])
        elif (m := re.fullmatch(r"RRDB(\d+)", key)):
            for rdb, convs in node.items():
                for conv, leaf in convs.items():
                    if not conv.startswith("conv") or conv == "conv1x1":
                        raise ValueError(
                            f"unexpected RRDBNet param {key}/{rdb}/{conv}")
                    emit(f"RRDB_trunk.{m.group(1)}.{rdb}.{conv}",
                         leaf["Conv_0"])
        else:
            raise ValueError(f"unexpected RRDBNet param subtree {key!r}")
    return sd


def detect_esrgan_arch(sd: Mapping[str, Any]) -> str:
    """'old' (``model.*`` Sequential layout) or 'new' (named layout)."""
    if any(k.startswith("model.") for k in sd):
        return "old"
    if any(k.startswith(("conv_first", "RRDB_trunk")) for k in sd):
        return "new"
    raise ValueError("unrecognized ESRGAN state_dict layout")


def _esrgan_old_to_named(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Old Sequential keys -> the "new" named layout. The post-trunk convs
    map by order: the last two are HRconv and conv_last, the ones between
    the trunk and those are upconv1..k."""
    out = {}
    for k, v in sd.items():
        if k.startswith("model.0."):
            out["conv_first." + k.split(".", 2)[2]] = v
        elif (m := re.match(r"model\.1\.sub\.(\d+)\.(RDB\d\.conv\d(?:x\d)?"
                            r"(?:\.0)?)\.(weight|bias)", k)):
            i, mid, leaf = m.group(1), m.group(2), m.group(3)
            mid = mid.replace(".0", "")
            out[f"RRDB_trunk.{i}.{mid}.{leaf}"] = v
        elif (m := re.match(r"model\.1\.sub\.(\d+)\.(weight|bias)", k)):
            out["trunk_conv." + m.group(2)] = v
    tail_idx = sorted({int(m.group(1)) for k in sd
                       if (m := re.match(r"model\.(\d+)\.", k))
                       and int(m.group(1)) >= 2})
    names = [f"upconv{i + 1}" for i in range(len(tail_idx) - 2)] \
        + ["HRconv", "conv_last"]
    for idx, name in zip(tail_idx, names):
        for k, v in sd.items():
            if k.startswith(f"model.{idx}."):
                out[f"{name}." + k.split(".", 2)[2]] = v
    return out


def load_esrgan_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference ESRGAN ``.pth`` (either layout, optionally wrapped in
    ``state_dict`` or ``params``) -> a "new"-layout f32 state_dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "params"):
        if isinstance(sd, dict) and isinstance(sd.get(wrapper), dict):
            sd = sd[wrapper]
    sd = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    if detect_esrgan_arch(sd) == "old":
        sd = _esrgan_old_to_named(sd)
    return {k: v.detach().float() for k, v in sd.items()}
