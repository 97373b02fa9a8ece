"""Reference PyTorch checkpoints (``.pth`` state dicts) to the flax
param trees of the JAX package's layouts, and back for ESRGAN, in numpy
on the host: the port's own copy of the converters of
``trainner_tpu/utils/torch_interop.py`` that
``scripts/convert_torch_model.py`` and ``scripts/swa2normal.py`` use
(``load_state_dict:21``, ``conv_to_hwio:35``, ``esrgan_to_params:82``,
``params_to_esrgan:152``, ``discriminator_vgg_to_params:243``,
``ppon_to_params:296``, ``sofvsr_to_params:513``; SRResNet's and the
ESRGAN layouts' detection are in ``torch_interop.py``). A ``.pth`` is
read with ``torch.load(..., weights_only=True)``.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from .torch_interop import _esrgan_old_to_named, detect_esrgan_arch


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch ``.pth`` state dict (optionally under ``state_dict`` or
    ``params``) -> its tensors as numpy arrays."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "params" in sd and all(
            hasattr(v, "numpy") for v in sd["params"].values()):
        sd = sd["params"]
    return {k: v.detach().numpy() for k, v in sd.items()
            if hasattr(v, "numpy")}


def conv_to_hwio(w: np.ndarray) -> np.ndarray:
    """torch OIHW -> flax HWIO."""
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def esrgan_to_params(sd: Dict[str, np.ndarray]) -> Dict:
    """Map an ESRGAN state_dict (either layout) onto the flax RRDBNet
    param tree (models/rrdb.py naming).

    Named-layout keys map as:
      conv_first      -> fea_conv/Conv_0
      RRDB_trunk.i.*  -> RRDB{i}/RDB{j}/conv{k}/Conv_0 (conv1x1 direct)
      trunk_conv      -> LR_conv/Conv_0
      upconv{k}       -> up{k-1}/ConvBlock_0/Conv_0
      HRconv          -> HR_conv0/Conv_0
      conv_last       -> HR_conv1/Conv_0
    """
    if detect_esrgan_arch(sd) == "old":
        sd = _esrgan_old_to_named(sd)

    tree: Dict[str, Any] = {}

    def put(path, leaf, value):
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        if leaf == "weight":
            if value.ndim == 4:
                node["kernel"] = conv_to_hwio(value)
            else:
                node["kernel"] = value.T
        else:
            node["bias"] = value

    for k, v in sd.items():
        parts = k.split(".")
        leaf = parts[-1]
        if parts[0] == "conv_first":
            put(("fea_conv", "Conv_0"), leaf, v)
        elif parts[0] == "RRDB_trunk":
            i, rdb, conv = parts[1], parts[2], parts[3]
            if conv == "conv1x1":
                put((f"RRDB{i}", rdb, "conv1x1"), leaf, v)
            else:
                put((f"RRDB{i}", rdb, conv, "Conv_0"), leaf, v)
        elif parts[0] == "trunk_conv":
            put(("LR_conv", "Conv_0"), leaf, v)
        elif (m := re.match(r"upconv(\d+)", parts[0])):
            put((f"up{int(m.group(1)) - 1}", "ConvBlock_0", "Conv_0"),
                leaf, v)
        elif parts[0] == "HRconv":
            put(("HR_conv0", "Conv_0"), leaf, v)
        elif parts[0] == "conv_last":
            put(("HR_conv1", "Conv_0"), leaf, v)

    return tree


def params_to_esrgan(params: Dict, nb: int) -> Dict[str, np.ndarray]:
    """Export our RRDBNet params to the reference 'new'-layout state_dict
    (for releasing models usable by the reference / chaiNNer etc.)."""
    sd: Dict[str, np.ndarray] = {}

    def conv_from(node):
        k = np.asarray(node["kernel"])
        out = {"weight": np.ascontiguousarray(k.transpose(3, 2, 0, 1))}
        if "bias" in node:
            out["bias"] = np.asarray(node["bias"])
        return out

    def emit(name, node):
        for leaf, v in conv_from(node).items():
            sd[f"{name}.{leaf}"] = v

    emit("conv_first", params["fea_conv"]["Conv_0"])
    for i in range(nb):
        blk = params[f"RRDB{i}"]
        for rdb_name, rdb in blk.items():
            for conv_name, conv in rdb.items():
                if conv_name == "conv1x1":
                    emit(f"RRDB_trunk.{i}.{rdb_name}.conv1x1", conv)
                elif conv_name.startswith("conv"):
                    emit(f"RRDB_trunk.{i}.{rdb_name}.{conv_name}",
                         conv["Conv_0"])
    emit("trunk_conv", params["LR_conv"]["Conv_0"])
    i = 0
    while f"up{i}" in params:
        emit(f"upconv{i + 1}", params[f"up{i}"]["ConvBlock_0"]["Conv_0"])
        i += 1
    emit("HRconv", params["HR_conv0"]["Conv_0"])
    emit("conv_last", params["HR_conv1"]["Conv_0"])
    return sd


def discriminator_vgg_to_params(sd: Dict[str, np.ndarray]) -> Dict:
    """Map a Discriminator_VGG_* .pth state_dict (ref
    architectures/discriminators.py:54-308: 'features.N' conv/BN
    Sequential + 'classifier.N' linears) onto the flax DiscriminatorVGG
    variables {params, batch_stats} (models/discriminators.py naming:
    conv{b}_{0|1} with BatchNorm on all but the first conv, then
    linear0/linear1).

    The first linear's kernel is re-permuted from torch's (C,H,W)
    flattening to NHWC (H,W,C) flattening.
    """
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    conv_idx = sorted(int(k.split(".")[1]) for k, v in sd.items()
                      if k.startswith("features.") and k.endswith(".weight")
                      and v.ndim == 4)
    bn_idx = sorted({int(k.split(".")[1]) for k in sd
                     if k.startswith("features.")
                     and k.endswith(".running_mean")})
    names = []
    for n in range(len(conv_idx)):
        names.append(f"conv{n // 2}_{n % 2}")
    for idx, name in zip(conv_idx, names):
        node = params.setdefault(name, {})
        node["Conv_0"] = {
            "kernel": conv_to_hwio(sd[f"features.{idx}.weight"]),
            "bias": sd[f"features.{idx}.bias"]}
        if idx + 1 in bn_idx:
            node["BatchNorm_0"] = {
                "scale": sd[f"features.{idx + 1}.weight"],
                "bias": sd[f"features.{idx + 1}.bias"]}
            stats[name] = {"BatchNorm_0": {
                "mean": sd[f"features.{idx + 1}.running_mean"],
                "var": sd[f"features.{idx + 1}.running_var"]}}

    lin_idx = sorted(int(k.split(".")[1]) for k in sd
                     if k.startswith("classifier.")
                     and k.endswith(".weight"))
    # the conv stack halves the map five times; final channels = last conv
    c_last = sd[f"features.{conv_idx[-1]}.weight"].shape[0]
    for n, idx in enumerate(lin_idx):
        w = sd[f"classifier.{idx}.weight"]
        if n == 0:
            out_f, in_f = w.shape
            hw = int(np.sqrt(in_f // c_last))
            w = w.reshape(out_f, c_last, hw, hw) \
                 .transpose(0, 2, 3, 1).reshape(out_f, in_f)
        params[f"linear{n}"] = {"kernel": w.T,
                                "bias": sd[f"classifier.{idx}.bias"]}
    return {"params": params, "batch_stats": stats}


def ppon_to_params(sd: Dict[str, np.ndarray]) -> Dict:
    """Map a PPON .pth state_dict (ref PPON_arch.py:18: CFEM/CRM/SFEM/
    SRM/PFEM/PRM Sequentials) onto the flax PPON param tree
    (models/ppon.py naming: fea_conv, rb{i}, lr_conv / ssim{i} /
    gan{i} branches + per-branch up/hr convs).

    Inner residual-block leaf names (RB{r}.c1/d1../c2) match 1:1; the
    reconstruction-module convs map by order: up_*0..k, hr0_*, hr1_*.
    """
    tree: Dict[str, Any] = {}

    def put(path, leaf, v):
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node["kernel" if leaf == "weight" else "bias"] = \
            conv_to_hwio(v) if leaf == "weight" and v.ndim == 4 else v

    fem_base = {"SFEM": "ssim", "PFEM": "gan"}
    rm_branch = {"CRM": "c", "SRM": "s", "PRM": "p"}

    for k, v in sd.items():
        if k.startswith("CFEM.0."):
            put(("fea_conv",), k.rsplit(".", 1)[-1], v)
        elif (m := re.match(r"CFEM\.1\.sub\.(\d+)\.(RB\d)\.(\w+)"
                            r"\.(weight|bias)", k)):
            put((f"rb{m.group(1)}", m.group(2), m.group(3)),
                m.group(4), v)
        elif (m := re.match(r"CFEM\.1\.sub\.(\d+)\.(weight|bias)", k)):
            put(("lr_conv",), m.group(2), v)
        elif (m := re.match(r"(SFEM|PFEM)\.(\d+)\.(RB\d)\.(\w+)"
                            r"\.(weight|bias)", k)):
            put((f"{fem_base[m.group(1)]}{m.group(2)}", m.group(3),
                 m.group(4)), m.group(5), v)

    for rm, suffix in rm_branch.items():
        idxs = sorted({int(m.group(1)) for k in sd
                       if (m := re.match(rf"{rm}\.(\d+)\.", k))})
        names = [f"up_{suffix}{i}" for i in range(len(idxs) - 2)] \
            + [f"hr0_{suffix}", f"hr1_{suffix}"]
        for idx, name in zip(idxs, names):
            path = (name, "ConvBlock_0", "Conv_0") \
                if name.startswith("up_") else (name,)
            for k, v in sd.items():
                if k.startswith(f"{rm}.{idx}."):
                    put(path, k.rsplit(".", 1)[-1], v)
    return tree


def sofvsr_to_params(sd: Dict[str, np.ndarray]) -> Dict:
    """Map a SOFVSR .pth state_dict (ref SOFVSR_arch.py:20: OFR RNN1/
    RNN2/SR + SR net, CasResB bodies of depthwise ResBs) onto the flax
    SOFVSR tree (models/sofvsr.py). Depthwise (C,1,k,k) kernels map to
    flax (k,k,1,C) like plain convs."""
    tree: Dict[str, Any] = {}

    def put(path, leaf, v):
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node["kernel" if leaf == "weight" else "bias"] = \
            conv_to_hwio(v) if leaf == "weight" and v.ndim == 4 else v

    _RESB = {"0": "c1", "2": "dw", "3": "c2"}
    # flat tails: Sequential index -> (module path)
    direct = {
        "OFR.RNN1.0": ("OFR", "rnn1_conv"),
        "OFR.RNN2.0": ("OFR", "rnn2"),
        "OFR.SR.1": ("OFR", "sr_head", "ps0"),
        "OFR.SR.4": ("OFR", "sr_head", "ps1"),
        "OFR.SR.7": ("OFR", "sr_head", "out"),
        "SR.body.0": ("SR", "head"),
        "SR.body.3": ("SR", "tail", "ps0"),
        "SR.body.6": ("SR", "tail", "ps1"),
        "SR.body.9": ("SR", "tail", "out"),
    }
    body_maps = [
        (re.compile(r"OFR\.RNN1\.2\.body\.(\d+)\.body\.(\d)"
                    r"\.(weight|bias)"), ("OFR", "rnn1_body")),
        (re.compile(r"OFR\.SR\.0\.body\.(\d+)\.body\.(\d)"
                    r"\.(weight|bias)"), ("OFR", "sr_body")),
        (re.compile(r"SR\.body\.2\.body\.(\d+)\.body\.(\d)"
                    r"\.(weight|bias)"), ("SR", "body")),
    ]
    for k, v in sd.items():
        prefix, leaf = k.rsplit(".", 1)
        if prefix in direct:
            put(direct[prefix], leaf, v)
            continue
        for rx, base in body_maps:
            if (m := rx.fullmatch(k)):
                put(base + (f"resb{m.group(1)}", _RESB[m.group(2)]),
                    m.group(3), v)
                break
    return tree
