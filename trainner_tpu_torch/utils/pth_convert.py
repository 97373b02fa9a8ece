"""Reference PyTorch checkpoints (``.pth`` state dicts) to the flax
param trees of the JAX package's layouts, and back for ESRGAN, in numpy
on the host: the port's own copy of the converters of
``trainner_tpu/utils/torch_interop.py`` that
``scripts/convert_torch_model.py`` and ``scripts/swa2normal.py`` use
(``load_state_dict:21``, ``conv_to_hwio:35``, ``esrgan_to_params:82``,
``params_to_esrgan:152``, ``discriminator_vgg_to_params:243``,
``ppon_to_params:296``, ``sofvsr_to_params:513``, ``pan_to_params:345``,
``sftnet_to_params:403``, ``resnet_g_to_params:459``,
``named_to_params:561`` (the WBC U-Net), ``dvdnet_to_params:579``,
``aan_to_params:601``, ``unet_to_params:636``, ``abpn_to_params:676``,
``seg_to_params:707``, ``edvr_to_params:838``, ``srflow_to_params:920``;
SRResNet's and the ESRGAN layouts' detection are in
``torch_interop.py``). A ``.pth`` is
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


def pan_to_params(sd: Dict[str, np.ndarray]) -> Dict:
    """Map a PAN .pth state_dict (ref PAN_arch.py:109: conv_first,
    SCPA_trunk.N, trunk_conv, 'upsample' Sequential of
    [upconv, PA(att.conv), hrconv] per level, conv_last) onto the flax
    PAN tree (models/pan.py: scpa{i}, up{k}/{upconv,att/conv,hrconv})."""
    tree: Dict[str, Any] = {}

    def put(path, leaf, v):
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node["kernel" if leaf == "weight" else "bias"] = \
            conv_to_hwio(v) if leaf == "weight" and v.ndim == 4 else v

    for k, v in sd.items():
        leaf = k.rsplit(".", 1)[-1]
        if k.startswith("conv_first."):
            put(("conv_first",), leaf, v)
        elif k.startswith("conv_last."):
            put(("conv_last",), leaf, v)
        elif k.startswith("trunk_conv."):
            put(("trunk_conv",), leaf, v)
        elif (m := re.match(r"SCPA_trunk\.(\d+)\.k1\.0\.(weight|bias)", k)):
            put((f"scpa{m.group(1)}", "k1"), m.group(2), v)
        elif (m := re.match(r"SCPA_trunk\.(\d+)\.PACnv\.(k\d)"
                            r"\.(weight|bias)", k)):
            put((f"scpa{m.group(1)}", "pacnv", m.group(2)), m.group(3), v)
        elif (m := re.match(r"SCPA_trunk\.(\d+)\.(conv1_a|conv1_b|conv3)"
                            r"\.(weight|bias)", k)):
            put((f"scpa{m.group(1)}", m.group(2)), m.group(3), v)

    # upsample Sequential: plain convs alternate upconv/hrconv per level;
    # '.conv.' entries are the pixel-attention 1x1
    ups = sorted({int(m.group(1)) for k in sd
                  if (m := re.match(r"upsample\.(\d+)\.", k))})
    level, expect_up = 0, True
    for idx in ups:
        is_att = any(k.startswith(f"upsample.{idx}.conv.") for k in sd)
        if is_att:
            name, sub = f"up{level}", ("att", "conv")
        elif expect_up:
            name, sub = f"up{level}", ("upconv",)
            expect_up = False
        else:
            name, sub = f"up{level}", ("hrconv",)
            expect_up = True
            level += 1
        prefix = f"upsample.{idx}.conv." if is_att else f"upsample.{idx}."
        for k, v in sd.items():
            if k.startswith(prefix):
                put((name,) + sub, k.rsplit(".", 1)[-1], v)
    return tree



_SFT_LEAF = {"SFT_scale_conv0": "scale0", "SFT_scale_conv1": "scale1",
             "SFT_shift_conv0": "shift0", "SFT_shift_conv1": "shift1"}



def sftnet_to_params(sd: Dict[str, np.ndarray]) -> Dict:
    """Map an SFT_Net .pth state_dict (ref sft_arch.py:40: conv0,
    sft_branch 0..N-1 ResBlock_SFT + final SFTLayer + conv, HR_branch
    Sequential, CondNet Sequential) onto the flax SFTNet tree
    (models/sft.py: sft_block{i}, sft_final, conv_body, up{k}/hr{k},
    cond{k})."""
    tree: Dict[str, Any] = {}

    def put(path, leaf, v):
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node["kernel" if leaf == "weight" else "bias"] = \
            conv_to_hwio(v) if leaf == "weight" and v.ndim == 4 else v

    branch_idx = sorted({int(m.group(1)) for k in sd
                         if (m := re.match(r"sft_branch\.(\d+)\.", k))})
    final_sft, final_conv = branch_idx[-2], branch_idx[-1]

    for k, v in sd.items():
        leaf = k.rsplit(".", 1)[-1]
        if k.startswith("conv0."):
            put(("conv0",), leaf, v)
        elif (m := re.match(r"sft_branch\.(\d+)\.(sft\d)\.(\w+)"
                            r"\.(weight|bias)", k)):
            put((f"sft_block{m.group(1)}", m.group(2),
                 _SFT_LEAF[m.group(3)]), m.group(4), v)
        elif (m := re.match(r"sft_branch\.(\d+)\.(conv\d)"
                            r"\.(weight|bias)", k)):
            put((f"sft_block{m.group(1)}", m.group(2)), m.group(3), v)
        elif (m := re.match(rf"sft_branch\.{final_sft}\.(\w+)"
                            r"\.(weight|bias)", k)):
            put(("sft_final", _SFT_LEAF[m.group(1)]), m.group(2), v)
        elif (m := re.match(rf"sft_branch\.{final_conv}"
                            r"\.(weight|bias)", k)):
            put(("conv_body",), m.group(1), v)

    # HR_branch Sequential: [upconv, shuffle?, act, ...] — convs by order:
    # up0, up1, ..., hr0, hr1 (last two)
    hr_idx = sorted({int(m.group(1)) for k in sd
                     if (m := re.match(r"HR_branch\.(\d+)\.", k))})
    names = [f"up{i}" for i in range(len(hr_idx) - 2)] + ["hr0", "hr1"]
    for idx, name in zip(hr_idx, names):
        for k, v in sd.items():
            if k.startswith(f"HR_branch.{idx}."):
                put((name,), k.rsplit(".", 1)[-1], v)

    cond_idx = sorted({int(m.group(1)) for k in sd
                       if (m := re.match(r"CondNet\.(\d+)\.", k))})
    for n, idx in enumerate(cond_idx):
        for k, v in sd.items():
            if k.startswith(f"CondNet.{idx}."):
                put((f"cond{n}",), k.rsplit(".", 1)[-1], v)
    return tree



def resnet_g_to_params(sd: Dict[str, np.ndarray]) -> Dict:
    """Map a CycleGAN ResnetGenerator .pth (instance-norm variant, ref
    ResNet_arch.py:11 / junyanz pytorch-CycleGAN layout) onto the flax
    ResnetGenerator tree (models/resnet_g.py): stem conv, 2 downsamples,
    block{i} conv pairs, 2 ConvTranspose upsamples, final conv.

    ConvTranspose kernels: torch stores (in, out, kh, kw) and computes
    the adjoint of a correlation; flax/lax conv_transpose with
    transpose_kernel=False expects (kh, kw, in, out) unflipped — mapped
    accordingly (verified by output parity)."""
    if any("running_mean" in k for k in sd):
        raise ValueError("batch-norm ResnetGenerator checkpoints are not "
                         "supported (use the instance-norm variant)")
    tree: Dict[str, Any] = {}

    def put(name, leaf, v, deconv=False):
        node = tree.setdefault(name, {}) if "/" not in name else None
        if "/" in name:
            a, b = name.split("/")
            node = tree.setdefault(a, {}).setdefault(b, {})
        if leaf == "weight":
            node["kernel"] = v.transpose(2, 3, 0, 1) if deconv \
                else conv_to_hwio(v)
        else:
            node["bias"] = v

    blocks = sorted({int(m.group(1)) for k in sd
                     if (m := re.match(r"model\.(\d+)\.conv_block\.", k))})
    plain = sorted({int(m.group(1)) for k in sd
                    if (m := re.match(r"model\.(\d+)\.(weight|bias)$", k))})
    n_plain = len(plain)
    # plain convs: 1 stem + D downsamples + D deconvs + 1 final
    d = (n_plain - 2) // 2
    names = (["Conv_0"] + [f"Conv_{i + 1}" for i in range(d)]
             + [f"ConvTranspose_{i}" for i in range(d)]
             + [f"Conv_{d + 1}"])
    for idx, name in zip(plain, names):
        deconv = name.startswith("ConvTranspose")
        for leaf in ("weight", "bias"):
            k = f"model.{idx}.{leaf}"
            if k in sd:
                put(name, leaf, sd[k], deconv)
    for n, idx in enumerate(blocks):
        convs = sorted({int(m.group(1)) for k in sd
                        if (m := re.match(rf"model\.{idx}\.conv_block"
                                          r"\.(\d+)\.", k))})
        for c, cidx in enumerate(convs):
            for leaf in ("weight", "bias"):
                k = f"model.{idx}.conv_block.{cidx}.{leaf}"
                if k in sd:
                    put(f"block{n}/Conv_{c}", leaf, sd[k])
    return tree



def named_to_params(sd: Dict[str, np.ndarray]) -> Dict:
    """Generic converter for nets whose torch module names match our
    flax module names 1:1 (e.g. UnetGeneratorWBC, ref WBCNet_arch.py:24):
    'a.b.weight' -> tree[a][b]['kernel'] (OIHW->HWIO), bias passthrough,
    2-D weights transposed."""
    tree: Dict[str, Any] = {}
    for k, v in sd.items():
        parts = k.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1] == "weight":
            node["kernel"] = conv_to_hwio(v) if v.ndim == 4 else v.T
        else:
            node["bias"] = v
    return tree



def dvdnet_to_params(sd: Dict[str, np.ndarray]) -> Dict:
    """Map a DVDNet .pth (ref DVDNet_arch.py:37: shared feature Sequential
    nested in model_y/model_z + per-field branch/final convs) onto the
    flax DVDNet tree (models/dvd.py)."""
    mapping = {
        "model_y.0.0.0": "fea1", "model_y.0.1.0": "fea2",
        "model_y.0.2": "fea3",
        "model_y.1": "branch_top", "model_y.2": "final_top",
        "model_z.1": "branch_bottom", "model_z.2": "final_bottom",
    }
    tree: Dict[str, Any] = {}
    for k, v in sd.items():
        prefix, leaf = k.rsplit(".", 1)
        name = mapping.get(prefix)
        if name is None:
            continue  # model_z.0.* duplicates the shared feature trunk
        node = tree.setdefault(name, {})
        node["kernel" if leaf == "weight" else "bias"] = \
            conv_to_hwio(v) if leaf == "weight" and v.ndim == 4 else v
    return tree



def aan_to_params(sd: Dict[str, np.ndarray]) -> Dict:
    """Map an A2N/AAN .pth (ref PAN_arch.py:323: AAB trunk with attention
    dropout module + PA upsample) onto the flax AAN tree
    (models/pan.py AAN)."""
    rename = {"ADM.0": "adm1", "ADM.2": "adm2"}
    top = {"conv_first": "conv_first", "trunk_conv": "trunk_conv",
           "upconv1": "upconv1", "upconv2": "upconv2",
           "HRconv1": "hrconv1", "HRconv2": "hrconv2",
           "conv_last": "conv_last"}
    tree: Dict[str, Any] = {}

    def put(path, leaf, v):
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        if leaf == "weight":
            node["kernel"] = conv_to_hwio(v) if v.ndim == 4 else v.T
        else:
            node["bias"] = v

    for k, v in sd.items():
        leaf = k.rsplit(".", 1)[-1]
        if (m := re.match(r"AAB_trunk\.(\d+)\.(.+)\.(weight|bias)", k)):
            inner = rename.get(m.group(2), m.group(2))
            put((f"aab{m.group(1)}",) + tuple(inner.split(".")),
                m.group(3), v)
        elif (m := re.match(r"att(\d)\.conv\.(weight|bias)", k)):
            put((f"att{m.group(1)}", "conv"), m.group(2), v)
        else:
            name = top.get(k.rsplit(".", 1)[0])
            if name:
                put((name,), leaf, v)
    return tree



def unet_to_params(sd: Dict[str, np.ndarray]) -> Dict:
    """Map a pix2pix UnetGenerator .pth (junyanz recursive
    UnetSkipConnectionBlock layout, ref UNet_arch.py:11, instance-norm
    variant) onto the flax UnetGenerator tree (models/unet.py:
    down{i}/Conv_0, up{i}/ConvTranspose_0)."""
    if any("running_mean" in k for k in sd):
        raise ValueError("batch-norm UNet checkpoints are not supported "
                         "(use the instance-norm variant)")
    # depth of the recursion = longest chain of '.model.' segments
    depth = max(k.count("model") for k in sd) - 1

    def chain(d: int) -> str:
        if d == 0:
            return "model.model."
        return "model.model.1.model." + "3.model." * (d - 1)

    tree: Dict[str, Any] = {}

    def put(name, sub, leaf, v, deconv=False):
        node = tree.setdefault(name, {}).setdefault(sub, {})
        if leaf == "weight":
            node["kernel"] = v.transpose(2, 3, 0, 1) if deconv \
                else conv_to_hwio(v)
        else:
            node["bias"] = v

    for d in range(depth):
        innermost = d == depth - 1
        down_key = chain(d) + ("0" if d == 0 else "1")
        up_key = "model.model.3" if d == 0 else \
            (chain(d) + ("3" if innermost else "5"))
        for leaf in ("weight", "bias"):
            if f"{down_key}.{leaf}" in sd:
                put(f"down{d}", "Conv_0", leaf, sd[f"{down_key}.{leaf}"])
            if f"{up_key}.{leaf}" in sd:
                put(f"up{d}", "ConvTranspose_0", leaf,
                    sd[f"{up_key}.{leaf}"], deconv=True)
    return tree



def abpn_to_params(sd: Dict[str, np.ndarray]) -> Dict:
    """Map an ABPN_v5 .pth (ref ABPN_arch.py:108) onto the flax ABPN
    tree — module names match 1:1; PReLU 'act.weight' scalars map to
    act/alpha; deconv kernels to the TorchDeconv (kh,kw,in,out) layout.
    The reference's down10/SA10/weight_down8 modules are dead (never
    used in its forward) and are skipped."""
    dead = ("down10.", "SA10.", "weight_down8.")
    tree: Dict[str, Any] = {}
    for k, v in sd.items():
        if k.startswith(dead):
            continue
        parts = k.split(".")
        leaf = parts[-1]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-2] == "act":
            node["alpha"] = v.reshape(())
        elif leaf == "weight":
            if "deconv" in parts:
                node["kernel"] = np.ascontiguousarray(
                    v.transpose(2, 3, 0, 1))  # (in,out,k,k)->(k,k,in,out)
            elif v.ndim == 4:
                node["kernel"] = conv_to_hwio(v)
            else:
                node["kernel"] = v.T
        else:
            node["bias"] = v
    return tree



def seg_to_params(sd: Dict[str, np.ndarray]) -> Dict:
    """Map an OutdoorSceneSeg .pth (ref seg_arch.py:29: flat 'feature.N'
    Sequential of stem convs + Res131 blocks + head, grouped 8x deconv)
    onto the flax OutdoorSceneSeg variables {params, batch_stats}
    (models/seg.py naming). Enables running SFTGAN end-to-end with the
    published segmentation model."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put_conv(scope, name, idx):
        node = params
        for p in scope:
            node = node.setdefault(p, {})
        node[name] = {"kernel": conv_to_hwio(sd[f"{idx}.weight"])}
        if f"{idx}.bias" in sd:
            node[name]["bias"] = sd[f"{idx}.bias"]

    def put_bn(scope, name, idx):
        node, snode = params, stats
        for p in scope:
            node = node.setdefault(p, {})
            snode = snode.setdefault(p, {})
        node[name] = {"scale": sd[f"{idx}.weight"],
                      "bias": sd[f"{idx}.bias"]}
        snode[name] = {"mean": sd[f"{idx}.running_mean"],
                       "var": sd[f"{idx}.running_var"]}

    # stem + head
    for conv, idx, bn in (("conv1_1", 0, 0), ("conv1_2", 3, 1),
                          ("conv1_3", 6, 2), ("conv5_4", 43, 3)):
        put_conv((), conv, f"feature.{idx}")
        put_bn((), f"BatchNorm_{bn}", f"feature.{idx + 1}")
    put_conv((), "conv6", "feature.47")
    params["deconv_kernel"] = np.ascontiguousarray(
        sd["deconv.weight"].transpose(2, 3, 1, 0))  # (in,1,k,k)->(k,k,1,in)

    block_names = (["res2a", "res2b0", "res2b1", "res3a"]
                   + [f"res3b{i}" for i in range(3)] + ["res4a"]
                   + [f"res4b{i}" for i in range(22)]
                   + [f"res5{i}" for i in range(3)])
    for n, name in enumerate(block_names):
        base = f"feature.{10 + n}"
        put_conv((name,), "conv0", f"{base}.res.0")
        put_bn((name,), "BatchNorm_0", f"{base}.res.1")
        put_conv((name,), "conv1", f"{base}.res.3")
        put_bn((name,), "BatchNorm_1", f"{base}.res.4")
        put_conv((name,), "conv2", f"{base}.res.6")
        put_bn((name,), "BatchNorm_2", f"{base}.res.7")
        if f"{base}.proj.0.weight" in sd:
            put_conv((name,), "proj", f"{base}.proj.0")
            put_bn((name,), "BatchNorm_3", f"{base}.proj.1")
    return {"params": params, "batch_stats": stats}



def edvr_to_params(sd: Dict[str, np.ndarray]) -> Dict:
    """Map a reference EDVR .pth (ref EDVR_arch.py:340 EDVR, PCDAlignment
    :77, TSAFusion:188, DCNv2Pack deformconv2d.py:127) onto the flax EDVR
    variables. Offsets keep the reference's cat(o1, o2) channel layout,
    which IS torchvision's ((g*k*k+tap)*2 + {dy,dx}) interleaving — see
    ops/deform_conv.py DCNv2Pack."""
    params: Dict[str, Any] = {}

    def node(path):
        n = params
        for q in path:
            n = n.setdefault(q, {})
        return n

    def put_conv(path, prefix, leaf_kernel="kernel"):
        n = node(path)
        n[leaf_kernel] = conv_to_hwio(sd[f"{prefix}.weight"])
        if f"{prefix}.bias" in sd:
            n["bias"] = sd[f"{prefix}.bias"]

    def put_dcn(path, prefix):
        put_conv(path + ("conv_offset",), f"{prefix}.conv_offset")
        n = node(path)
        n["kernel"] = conv_to_hwio(sd[f"{prefix}.weight"])
        n["bias"] = sd[f"{prefix}.bias"]

    if "conv_first.weight" in sd:
        put_conv(("conv_first",), "conv_first")
    n_extract = len({k.split(".")[1] for k in sd
                     if k.startswith("feature_extraction.")})
    for i in range(n_extract):
        put_conv((f"extract{i}", "conv1"), f"feature_extraction.{i}.conv1")
        put_conv((f"extract{i}", "conv2"), f"feature_extraction.{i}.conv2")
    for name in ("conv_l2_1", "conv_l2_2", "conv_l3_1", "conv_l3_2"):
        put_conv((name,), name)

    for lv in (1, 2, 3):
        put_conv(("pcd_align", f"offset_conv1_l{lv}"),
                 f"pcd_align.offset_conv1.l{lv}")
        put_conv(("pcd_align", f"offset_conv2_l{lv}"),
                 f"pcd_align.offset_conv2.l{lv}")
        if f"pcd_align.offset_conv3.l{lv}.weight" in sd:
            put_conv(("pcd_align", f"offset_conv3_l{lv}"),
                     f"pcd_align.offset_conv3.l{lv}")
        put_dcn(("pcd_align", f"dcn_l{lv}"), f"pcd_align.dcn_pack.l{lv}")
        if f"pcd_align.feat_conv.l{lv}.weight" in sd:
            put_conv(("pcd_align", f"feat_conv_l{lv}"),
                     f"pcd_align.feat_conv.l{lv}")
    put_conv(("pcd_align", "cas_offset_conv1"), "pcd_align.cas_offset_conv1")
    put_conv(("pcd_align", "cas_offset_conv2"), "pcd_align.cas_offset_conv2")
    put_dcn(("pcd_align", "cas_dcn"), "pcd_align.cas_dcnpack")

    if "fusion.weight" in sd:  # with_tsa=False: plain 1x1 fusion conv
        put_conv(("fusion",), "fusion")
    else:
        for name in ("temporal_attn1", "temporal_attn2", "feat_fusion",
                     "spatial_attn1", "spatial_attn2", "spatial_attn3",
                     "spatial_attn4", "spatial_attn5", "spatial_attn_l1",
                     "spatial_attn_l2", "spatial_attn_l3",
                     "spatial_attn_add1", "spatial_attn_add2"):
            put_conv(("fusion", name), f"fusion.{name}")

    n_recon = len({k.split(".")[1] for k in sd
                   if k.startswith("reconstruction.")})
    for i in range(n_recon):
        put_conv((f"recon{i}", "conv1"), f"reconstruction.{i}.conv1")
        put_conv((f"recon{i}", "conv2"), f"reconstruction.{i}.conv2")

    # upconv blocks: find the single 4-dim conv weight under upconv{k}.*
    for k in (1, 2, 3):
        cand = sorted(kk for kk in sd if kk.startswith(f"upconv{k}.")
                      and kk.endswith("weight")
                      and getattr(sd[kk], "ndim", 0) == 4)
        if not cand:
            continue
        prefix = cand[0][: -len(".weight")]
        put_conv((f"upconv{k}",), prefix)
    put_conv(("conv_hr",), "conv_hr")
    put_conv(("conv_last",), "conv_last")
    return {"params": params}



def srflow_to_params(sd: Dict[str, np.ndarray]) -> Dict:
    """Map a reference SRFlow .pth (ref SRFlowNet_arch.py:14; encoder
    SRFlow/RRDBNet_arch.py, flow FlowUpsamplerNet + glow primitives) onto
    the flax SRFlowNetI variables (models/srflow_interop.py).

    The unused `flowUpsamplerNet.f.*` head (constructed but never called,
    ref FlowUpsamplerNet.py:92-95) is skipped."""
    params: Dict[str, Any] = {}

    def node(path):
        n = params
        for q in path:
            n = n.setdefault(q, {})
        return n

    def put_conv(path, w_key, bias=True):
        n = node(path)
        n["kernel"] = conv_to_hwio(sd[w_key])
        b_key = w_key.replace(".weight", ".bias")
        if bias and b_key in sd:
            n["bias"] = np.asarray(sd[b_key])

    def put_actnorm(path, prefix):
        n = node(path)
        n["bias"] = np.asarray(sd[f"{prefix}.bias"]).reshape(-1)
        n["logs"] = np.asarray(sd[f"{prefix}.logs"]).reshape(-1)

    def put_glowconv(path, prefix):
        put_conv(path + ("conv",), f"{prefix}.weight", bias=False)
        put_actnorm(path + ("actnorm",), f"{prefix}.actnorm")

    def put_glowzeros(path, prefix):
        put_conv(path + ("conv",), f"{prefix}.weight")
        node(path)["logs"] = np.asarray(sd[f"{prefix}.logs"]).reshape(-1)

    def put_fnet(path, prefix):
        put_glowconv(path + ("f0",), f"{prefix}.0")
        put_glowconv(path + ("f2",), f"{prefix}.2")
        put_glowzeros(path + ("f4",), f"{prefix}.4")

    # --- encoder (RRDB.*) ---
    enc = ("encoder",)
    put_conv(enc + ("conv_first",), "RRDB.conv_first.weight")
    n_blocks = len({k.split(".")[2] for k in sd
                    if k.startswith("RRDB.RRDB_trunk.")})
    for i in range(n_blocks):
        for m in (1, 2, 3):
            for c in (1, 2, 3, 4, 5):
                put_conv(enc + (f"RRDB{i}", f"RDB{m}", f"conv{c}",
                                "Conv_0"),
                         f"RRDB.RRDB_trunk.{i}.RDB{m}.conv{c}.weight")
    for name in ("trunk_conv", "upconv1", "upconv2", "HRconv",
                 "conv_last"):
        put_conv(enc + (name,), f"RRDB.{name}.weight")

    # --- flow layers ---
    layer_ids = sorted({int(k.split(".")[2]) for k in sd
                        if k.startswith("flowUpsamplerNet.layers.")})
    for i in layer_ids:
        pre = f"flowUpsamplerNet.layers.{i}"
        lp = (f"layers_{i}",)
        if f"{pre}.actnorm.bias" in sd:  # FlowStep
            put_actnorm(lp + ("actnorm",), f"{pre}.actnorm")
            node(lp + ("invconv",))["weight"] = np.asarray(
                sd[f"{pre}.invconv.weight"])
            if f"{pre}.affine.fAffine.0.weight" in sd:
                put_fnet(lp + ("affine", "fAffine"), f"{pre}.affine.fAffine")
                put_fnet(lp + ("affine", "fFeatures"),
                         f"{pre}.affine.fFeatures")
        elif f"{pre}.conv.weight" in sd:  # Split2d
            put_glowzeros(lp + ("conv",), f"{pre}.conv")
    return {"params": params}

