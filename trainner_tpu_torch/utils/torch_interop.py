"""Weights and training state for the port's networks, in both directions
between the port and the JAX package's flax trees (``RRDBNet``,
``DiscriminatorVGG`` with its ``batch_stats``, ``VGGFeatures``, a whole
``SRTrainState`` with its Adam or SGD moments, live or as read back from a
serialized ``.state`` file), and from reference ESRGAN ``.pth`` state_dicts
in either layout. numpy on the flax side, torch on the port's; nothing of
the JAX package is imported.

The port's own copy of what it needs from
``trainner_tpu/utils/torch_interop.py`` (``detect_esrgan_arch:40``,
``_esrgan_old_to_named:50``, ``load_state_dict:21``), plus
``params_from_jax``, the inverse of the flax-side naming of
``esrgan_to_params:82``, and ``params_to_jax``, its inverse again. Flax
kernels are HWIO, torch's OIHW.

The JAX state's ``rng`` (a legacy key, two uint32 words) and the port's
latent-noise ``torch.Generator`` are tied by one rule (``key_to_seed``,
``seed_to_key``): the generator is seeded with the key's 64-bit integer
``(k0 << 32) | k1``. The two streams cannot match (ROADMAP Queue C 9); the
rule only makes a resumed JAX state give the port a seed of its own.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

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


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def discriminator_from_jax(params: Mapping[str, Any],
                           batch_stats: Optional[Mapping[str, Any]] = None
                           ) -> Dict[str, torch.Tensor]:
    """The flax ``DiscriminatorVGG`` trees -> the port's state_dict:

      conv{i}_{j}/Conv_0/{kernel,bias}      -> conv{i}_{j}.{weight,bias}
      conv{i}_{j}/BatchNorm_0/{scale,bias}  -> conv{i}_{j}.norm.{weight,bias}
      batch_stats conv{i}_{j}/BatchNorm_0/{mean,var}
                                  -> conv{i}_{j}.norm.running_{mean,var}
      linear{n}/{kernel,bias}               -> linear{n}.{weight,bias}

    ``linear0``'s rows go from the JAX module's (H, W, C) flattening to
    torch's (C, H, W). Without ``batch_stats`` (a tree of optimizer
    moments, say) only the parameters are returned."""
    if "params" in params and "linear0" not in params:
        batch_stats = params.get("batch_stats", batch_stats)
        params = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    c_last = 0
    for name in sorted(k for k in params if k.startswith("conv")):
        node = params[name]
        kernel = np.asarray(node["Conv_0"]["kernel"], np.float32)
        sd[f"{name}.weight"] = torch.from_numpy(hwio_to_oihw(kernel))
        sd[f"{name}.bias"] = _f32(node["Conv_0"]["bias"])
        c_last = kernel.shape[-1]
        if "BatchNorm_0" in node:
            sd[f"{name}.norm.weight"] = _f32(node["BatchNorm_0"]["scale"])
            sd[f"{name}.norm.bias"] = _f32(node["BatchNorm_0"]["bias"])
    for name, node in (batch_stats or {}).items():
        sd[f"{name}.norm.running_mean"] = _f32(node["BatchNorm_0"]["mean"])
        sd[f"{name}.norm.running_var"] = _f32(node["BatchNorm_0"]["var"])
    for n in (0, 1):
        w = np.asarray(params[f"linear{n}"]["kernel"], np.float32).T
        if n == 0:
            out_f, in_f = w.shape
            hw = int(round((in_f // c_last) ** 0.5))
            w = w.reshape(out_f, hw, hw, c_last).transpose(0, 3, 1, 2) \
                 .reshape(out_f, in_f)
        sd[f"linear{n}.weight"] = torch.from_numpy(np.array(w, order="C"))
        sd[f"linear{n}.bias"] = _f32(params[f"linear{n}"]["bias"])
    return sd


def vgg_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax ``VGGFeatures`` param tree (``conv{b}_{c}/{kernel,bias}``)
    -> the port's state_dict (``conv{b}_{c}.{weight,bias}``)."""
    if "params" in params:
        params = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    for name, node in params.items():
        sd[f"{name}.weight"] = torch.from_numpy(
            hwio_to_oihw(np.asarray(node["kernel"], np.float32)))
        sd[f"{name}.bias"] = _f32(node["bias"])
    return sd


_MOMENT_KEYS = ("count", "mu", "nu", "trace")


def _chain_head(opt_state):
    """The first state of an optax chain: from the live tuple (of named
    tuples), or from its serialized form, where flax writes a tuple as a
    dict keyed ``"0"``, ``"1"``, ..."""
    first = opt_state
    while True:
        if isinstance(first, Mapping) and "0" in first and \
                not any(k in first for k in _MOMENT_KEYS):
            first = first["0"]
        elif isinstance(first, (tuple, list)) and \
                not hasattr(first, "_fields"):
            first = first[0]
        else:
            break
    if hasattr(first, "_asdict"):
        first = first._asdict()
    return first


def _moments_from_jax(opt_state, convert) -> Optional[Dict[str, Any]]:
    """The moments of an optax chain's first state (``scale_by_adam``:
    count, mu, nu; ``trace``: trace) as {count, mu, nu | trace}, each tree
    brought to the port's names by ``convert``. ``opt_state`` holds numpy
    leaves: a mapping with those keys, the chain's state tuple itself, or
    its serialized form (``{"0": {count, mu, nu}}``). ``trace`` keeps no
    count: it is carried as 0."""
    if opt_state is None:
        return None
    get = _chain_head(opt_state).get
    count = get("count")
    out: Dict[str, Any] = {"count": 0 if count is None else int(count)}
    for key in ("mu", "nu", "trace"):
        tree = get(key)
        if tree is not None:
            out[key] = convert(tree)
    return out


def train_state_from_jax(g_params: Mapping[str, Any],
                         d_params: Optional[Mapping[str, Any]] = None,
                         d_batch_stats: Optional[Mapping[str, Any]] = None,
                         step: int = 0, g_opt_state=None, d_opt_state=None
                         ) -> Dict[str, Any]:
    """The numpy leaves of a JAX ``SRTrainState`` -> what
    ``load_train_state`` takes: the step, G's and D's state_dicts and, where
    given, the optimizers' moments under the port's parameter names."""
    out: Dict[str, Any] = {"step": int(step), "g": params_from_jax(g_params),
                           "g_opt": _moments_from_jax(g_opt_state,
                                                      params_from_jax)}
    if d_params is not None:
        out["d"] = discriminator_from_jax(d_params, d_batch_stats)
        out["d_opt"] = _moments_from_jax(d_opt_state, discriminator_from_jax)
    return out


def load_train_state(state, carried: Mapping[str, Any]) -> None:
    """Loads ``train_state_from_jax``'s result (or
    ``train_state_from_state_dict``'s) into a port ``SRTrainState``, in
    place. A carried ``rng`` becomes the state's key and reseeds its
    latent-noise generator by ``key_to_seed``."""
    state.step = int(carried["step"])
    for which in ("g", "d"):
        net_state = getattr(state, which)
        if net_state is None or which not in carried:
            continue
        net_state.net.load_state_dict(carried[which], strict=True)
        moments = carried.get(f"{which}_opt")
        if moments is not None and net_state.opt is not None:
            names = [n for n, _ in net_state.net.named_parameters()]
            dev = net_state.opt.params[0].device
            net_state.opt.load_state_dict({
                k: (v if k == "count" else [v[n].to(dev) for n in names])
                for k, v in moments.items()})
    if carried.get("rng") is not None:
        state.rng = np.asarray(carried["rng"], np.uint32).copy()
        if state.noise_generator is not None:
            state.noise_generator.manual_seed(key_to_seed(state.rng))


def key_to_seed(key) -> int:
    """A JAX legacy key (two uint32 words) -> the 64-bit seed of the port's
    noise generator, ``(k0 << 32) | k1``."""
    k = np.asarray(key, np.uint32).reshape(-1)
    if k.shape != (2,):
        raise ValueError(f"a key of two uint32 words, got shape {k.shape}")
    return (int(k[0]) << 32) | int(k[1])


def seed_to_key(seed: int) -> np.ndarray:
    """The inverse of ``key_to_seed``: for a seed under 2**32 it is what
    ``jax.random.PRNGKey(seed)`` holds, ``[0, seed]``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def oihw_to_hwio(w: torch.Tensor) -> np.ndarray:
    """torch OIHW -> flax HWIO."""
    return np.ascontiguousarray(
        w.detach().float().cpu().numpy().transpose(2, 3, 1, 0))


def _np(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().float().cpu().numpy())


_G_TO_JAX = {"conv_first": "fea_conv", "trunk_conv": "LR_conv",
             "HRconv": "HR_conv0", "conv_last": "HR_conv1"}


def params_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``RRDBNet`` state_dict -> the flax param tree in the
    unrolled ``RRDB{i}`` layout, numpy f32 leaves: the inverse of
    ``params_from_jax``."""
    out: Dict[str, Any] = {}
    for key, t in sd.items():
        name, leaf = key.rsplit(".", 1)
        if (m := re.fullmatch(r"RRDB_trunk\.(\d+)\.(RDB\d+)\.(conv\d+)",
                              name)):
            node = out.setdefault(f"RRDB{m.group(1)}", {}).setdefault(
                m.group(2), {}).setdefault(m.group(3), {}).setdefault(
                "Conv_0", {})
        elif (m := re.fullmatch(r"upconv(\d+)", name)):
            node = out.setdefault(f"up{int(m.group(1)) - 1}", {}).setdefault(
                "ConvBlock_0", {}).setdefault("Conv_0", {})
        elif name in _G_TO_JAX:
            node = out.setdefault(_G_TO_JAX[name], {}).setdefault(
                "Conv_0", {})
        else:
            raise ValueError(f"unexpected RRDBNet tensor {key!r}")
        if leaf == "weight":
            node["kernel"] = oihw_to_hwio(t)
        elif leaf == "bias":
            node["bias"] = _np(t)
        else:
            raise ValueError(f"unexpected RRDBNet tensor {key!r}")
    return out


def discriminator_to_jax(sd: Mapping[str, torch.Tensor]
                         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's ``DiscriminatorVGG`` state_dict (or a tree of its
    parameters alone, as optimizer moments are) -> the flax ``params`` and
    ``batch_stats`` trees: the inverse of ``discriminator_from_jax``.
    ``linear0``'s rows go from torch's (C, H, W) flattening back to the JAX
    module's (H, W, C)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    c_last = 0
    for name in sorted({k.split(".")[0] for k in sd if k.startswith("conv")}):
        w = sd[f"{name}.weight"]
        params[name] = {"Conv_0": {"kernel": oihw_to_hwio(w),
                                   "bias": _np(sd[f"{name}.bias"])}}
        c_last = w.shape[0]
        if f"{name}.norm.weight" in sd:
            params[name]["BatchNorm_0"] = {
                "scale": _np(sd[f"{name}.norm.weight"]),
                "bias": _np(sd[f"{name}.norm.bias"])}
        if f"{name}.norm.running_mean" in sd:
            stats[name] = {"BatchNorm_0": {
                "mean": _np(sd[f"{name}.norm.running_mean"]),
                "var": _np(sd[f"{name}.norm.running_var"])}}
    for n in (0, 1):
        w = _np(sd[f"linear{n}.weight"])
        if n == 0:
            out_f, in_f = w.shape
            hw = int(round((in_f // c_last) ** 0.5))
            w = w.reshape(out_f, c_last, hw, hw).transpose(0, 2, 3, 1) \
                 .reshape(out_f, in_f)
        params[f"linear{n}"] = {"kernel": np.ascontiguousarray(w.T),
                                "bias": _np(sd[f"linear{n}.bias"])}
    return params, stats


def _to_host(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """f32 copies on the host of ``tensors``, by one device-to-host copy
    (one per tensor would wait on the device as many times)."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    host = flat.cpu()
    out, i = [], 0
    for t in tensors:
        out.append(host[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def _opt_to_jax(moments: Mapping[str, Any], weight_decay: float, names,
                convert) -> Dict[str, Any]:
    """The port's optimizer state (``Optimizer.state_dict()``) -> the
    serialized optax chain state: ``{"0": {count, mu, nu}}`` for adam,
    ``{"0": {trace}}`` for sgd, and ``"1": {}`` (``add_decayed_weights``,
    which keeps no state) under weight decay."""
    head: Dict[str, Any] = {}
    if "mu" in moments:
        head["count"] = np.asarray(moments["count"], np.int32)
    for key in ("mu", "nu", "trace"):
        if key in moments:
            head[key] = convert(dict(zip(names, moments[key])))
    chain = {"0": head}
    if weight_decay:
        chain["1"] = {}
    return chain


def train_state_to_jax(state) -> Dict[str, Any]:
    """A port ``SRTrainState`` -> the state dict of the JAX package's
    ``SRTrainState`` (``trainner_tpu/train/state.py:35``), which flax's
    ``from_state_dict`` / ``from_bytes`` accepts on a JAX template of the
    same configuration: exactly its fields, ``None`` for the ones the port
    does not keep (SWA, EMA, AdaTarget, the clip history)."""
    def net(ns, convert, extra):
        sd = ns.net.state_dict()
        moments = ns.opt.state_dict() if ns.opt is not None else {}
        lists = [k for k in ("mu", "nu", "trace") if k in moments]
        host = iter(_to_host(list(sd.values())
                            + [t for k in lists for t in moments[k]]))
        sd = {k: next(host) for k in sd}
        for k in lists:
            moments[k] = [next(host) for _ in moments[k]]
        params, stats = convert(sd)
        names = [n for n, _ in ns.net.named_parameters()]
        opt = _opt_to_jax(moments, ns.opt.weight_decay, names,
                          lambda t: convert(t)[0]) \
            if ns.opt is not None else None
        return {"params": params, "opt_state": opt,
                "extra": {"batch_stats": stats} if extra else {}}

    rng = state.rng if state.rng is not None else seed_to_key(0)
    return {
        "step": np.asarray(state.step, np.int32),
        "rng": np.asarray(rng, np.uint32),
        "g": net(state.g, lambda sd: (params_to_jax(sd), None), False),
        "d": None if state.d is None else net(state.d, discriminator_to_jax,
                                              True),
        "swa_params": None, "swa_n": None, "ema_params": None,
        "loc": None, "grad_hist": None,
    }


def train_state_from_state_dict(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The tree that ``msgpack_restore`` reads from a ``.state`` file (the
    JAX package's or the port's) -> what ``load_train_state`` takes:
    the step, the key, both nets with their moments and D's running
    statistics."""
    d = tree.get("d")
    out = train_state_from_jax(
        tree["g"]["params"],
        d["params"] if d else None,
        ((d.get("extra") or {}).get("batch_stats") if d else None),
        step=int(np.asarray(tree["step"])),
        g_opt_state=tree["g"].get("opt_state"),
        d_opt_state=d.get("opt_state") if d else None)
    if tree.get("rng") is not None:
        out["rng"] = np.asarray(tree["rng"], np.uint32)
    return out


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
