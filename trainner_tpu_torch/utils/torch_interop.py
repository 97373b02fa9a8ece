"""Weights and training state for the port's networks, in both directions
between the port and the JAX package's flax trees (the generators
``RRDBNet``, ``MRRDBNet``, ``SRResNet``, ``PPON``, ``PAN`` (its
self-attention's ``gamma`` too) and ``AAN``, with their norms, PReLU slopes,
partial convs, ESRGAN+ ``conv1x1`` and a batch norm's ``batch_stats``, by
``g_to_jax`` / ``g_from_jax``; ``DiscriminatorVGG`` with its
``batch_stats``, spectral norms included,
``UNetDiscriminator``, ``VGGFeatures`` (and ``MINCFeatures``, whose tree
has the same form), ``ResNet101Features`` with its ``batch_stats``, the
LPIPS nets (``lpips_from_jax``), AdaTarget's ``LocNet``, a whole
``SRTrainState`` with the state of each optimizer (adam, sgd, rmsprop,
adamp, sgdp, ranger, madgrad, in the optax trees the JAX package builds),
its EMA and SWA weights, its LocNet and its auto-clip history, live or as
read back from a serialized ``.state`` file), and from reference ESRGAN ``.pth`` state_dicts
in either layout, and from a norm-free SRResNet ``.pth``
(``srresnet_to_params``). numpy on the flax side, torch on the port's;
nothing of the JAX package is imported.

The port's own copy of what it needs from
``trainner_tpu/utils/torch_interop.py`` (``detect_esrgan_arch:40``,
``_esrgan_old_to_named:50``, ``load_state_dict:21``). ``params_from_jax`` (the inverse of the
flax-side naming of ``esrgan_to_params:82``) and ``params_to_jax`` are
``g_from_jax`` / ``g_to_jax`` on a plain ``RRDBNet`` of the tree's widths,
for callers without a module. Flax kernels are HWIO, torch's OIHW.

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
    state_dict in the reference "new" ``.pth`` layout: ``g_from_jax`` on a
    plain ``RRDBNet`` of the tree's widths (``rrdbnet_like``)."""
    return g_from_jax(params, None, rrdbnet_like(params))


def rrdbnet_like(tree: Mapping[str, Any]) -> torch.nn.Module:
    """A plain ``RRDBNet`` (on the meta device, for its names) with the
    widths, depth, upsamplers and ``plus`` of a flax ``RRDBNet`` param tree
    or of the port's ``RRDBNet`` state_dict."""
    from ..models.rrdb import RRDBNet

    if "params" in tree and "fea_conv" not in tree:
        tree = tree["params"]
    if "fea_conv" in tree:
        tree = _unstack_trunk(tree)
        first = np.shape(tree["fea_conv"]["Conv_0"]["kernel"])
        in_nc, nf = first[2], first[3]
        out_nc = np.shape(tree["HR_conv1"]["Conv_0"]["kernel"])[3]
        gc = np.shape(tree["RRDB0"]["RDB1"]["conv1"]["Conv_0"]["kernel"])[3]
        nb = sum(re.fullmatch(r"RRDB\d+", k) is not None for k in tree)
        n_up = sum(re.fullmatch(r"up\d+", k) is not None for k in tree)
        plus = "conv1x1" in tree["RRDB0"]["RDB1"]
    else:
        nf, in_nc = tree["conv_first.weight"].shape[:2]
        out_nc = tree["conv_last.weight"].shape[0]
        gc = tree["RRDB_trunk.0.RDB1.conv1.weight"].shape[0]
        nb = len({k.split(".")[1] for k in tree
                  if k.startswith("RRDB_trunk.")})
        n_up = sum(re.fullmatch(r"upconv\d+\.weight", k) is not None
                   for k in tree)
        plus = any(".conv1x1." in k for k in tree)
    with torch.device("meta"):
        return RRDBNet(in_nc=int(in_nc), out_nc=int(out_nc), nf=int(nf),
                       nb=nb, gc=int(gc), upscale=2 ** n_up, plus=plus)

# the port's top-level module names -> the flax module's, by class
_RRDBNET_TOP = {"conv_first": "fea_conv", "trunk_conv": "LR_conv",
                "HRconv": "HR_conv0", "conv_last": "HR_conv1"}


def _flax_module_path(arch: str, name: str) -> Tuple[str, ...]:
    """A module's name in the port's G -> its path in the flax G's tree:
    ``RRDB_trunk.{i}`` is ``RRDB{i}``; RRDBNet's top-level convs are
    renamed (``_RRDBNET_TOP``, ``upconv{n}`` -> ``up{n-1}``); MRRDBNet's
    and SRResNet's other names are the flax ones."""
    parts = name.split(".") if name else []
    if parts[:1] == ["RRDB_trunk"]:
        parts = [f"RRDB{parts[1]}"] + parts[2:]
    elif arch == "RRDBNet" and parts:
        m = re.fullmatch(r"upconv(\d+)", parts[0])
        if m:
            parts[0] = f"up{int(m.group(1)) - 1}"
        else:
            parts[0] = _RRDBNET_TOP.get(parts[0], parts[0])
    return tuple(parts)


def g_flax_paths(net: torch.nn.Module) -> Dict[str, Tuple[str, tuple]]:
    """Every state_dict key of the port's generator ``net`` -> (flax
    collection, path in it):

      ConvBlock weight/bias        -> Conv_0/{kernel,bias}
        (PartialConv2D)            -> PartialConv_0/conv/kernel,
                                      PartialConv_0/bias
        norm (batch)               -> BatchNorm_0/{scale,bias}, and in
                                      batch_stats BatchNorm_0/{mean,var}
        norm (layer)               -> LayerNorm_0/{scale,bias}
        act (prelu)                -> PReLU_0/negative_slope
      UpconvBlock, PixelShuffleBlock -> ConvBlock_0/Conv_0/{kernel,bias},
                                      a PReLU at PReLU_0
      a bare conv (``conv1x1``,
        ``blocks.Conv``)           -> kernel, bias
      ``blocks.Dense``             -> kernel (transposed)
      ``SelfAttentionBlock.gamma`` -> gamma

    (flax's GroupNorm, the instance norm, holds nothing.)"""
    from ..ops.blocks import (BatchNorm, ConvBlock, Dense, LayerNorm, PReLU,
                              PixelShuffleBlock, SelfAttentionBlock,
                              UpconvBlock, _Conv)

    arch = type(net).__name__
    out: Dict[str, Tuple[str, tuple]] = {}
    for name, m in net.named_modules():
        if not isinstance(m, (_Conv, Dense, SelfAttentionBlock)):
            continue
        base = _flax_module_path(arch, name)
        pre = f"{name}." if name else ""
        if isinstance(m, Dense):
            out[pre + "weight"] = ("params", base + ("kernel",))
            continue
        if isinstance(m, SelfAttentionBlock):
            out[pre + "gamma"] = ("params", base + ("gamma",))
            continue
        if isinstance(m, ConvBlock):
            conv = ("PartialConv_0", "conv") if m.partial else ("Conv_0",)
            out[pre + "weight"] = ("params", base + conv + ("kernel",))
            if m.bias is not None:
                out[pre + "bias"] = ("params", base + conv[:1] + ("bias",))
            if isinstance(m.norm, BatchNorm):
                for leaf, flax_leaf in (("weight", "scale"), ("bias", "bias")):
                    out[f"{pre}norm.{leaf}"] = (
                        "params", base + ("BatchNorm_0", flax_leaf))
                for leaf, flax_leaf in (("running_mean", "mean"),
                                        ("running_var", "var")):
                    out[f"{pre}norm.{leaf}"] = (
                        "batch_stats", base + ("BatchNorm_0", flax_leaf))
            elif isinstance(m.norm, LayerNorm):
                for leaf, flax_leaf in (("weight", "scale"), ("bias", "bias")):
                    out[f"{pre}norm.{leaf}"] = (
                        "params", base + ("LayerNorm_0", flax_leaf))
        elif isinstance(m, (UpconvBlock, PixelShuffleBlock)):
            out[pre + "weight"] = ("params",
                                   base + ("ConvBlock_0", "Conv_0", "kernel"))
            out[pre + "bias"] = ("params",
                                 base + ("ConvBlock_0", "Conv_0", "bias"))
        else:
            out[pre + "weight"] = ("params", base + ("kernel",))
            if m.bias is not None:
                out[pre + "bias"] = ("params", base + ("bias",))
        if isinstance(getattr(m, "act", None), PReLU):
            out[pre + "act.negative_slope"] = (
                "params", base + ("PReLU_0", "negative_slope"))
    return out


def g_to_jax(sd: Mapping[str, torch.Tensor], net: torch.nn.Module
             ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A state_dict of the port's generator ``net`` (or a tree of its
    parameters alone, as optimizer moments are) -> the flax ``params`` and
    ``batch_stats`` trees, numpy f32 leaves, kernels HWIO."""
    paths = g_flax_paths(net)
    trees: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for key, t in sd.items():
        if key not in paths:
            raise ValueError(f"unexpected {type(net).__name__} tensor "
                             f"{key!r}")
        coll, path = paths[key]
        node = trees[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _kernel_to_jax(t) if path[-1] == "kernel" \
            else _np(t)
    return trees["params"], trees["batch_stats"]


def _kernel_to_jax(t: torch.Tensor) -> np.ndarray:
    """A conv's OIHW weight -> HWIO, a dense layer's (out, in) -> (in,
    out)."""
    if t.dim() == 2:
        return np.ascontiguousarray(t.detach().float().cpu().numpy().T)
    return oihw_to_hwio(t)


def _kernel_from_jax(a) -> torch.Tensor:
    """The inverse of ``_kernel_to_jax``."""
    a = np.asarray(a, np.float32)
    if a.ndim == 2:
        return torch.from_numpy(np.ascontiguousarray(a.T))
    return torch.from_numpy(hwio_to_oihw(a))


def g_from_jax(params: Mapping[str, Any],
               batch_stats: Optional[Mapping[str, Any]],
               net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The flax trees of a generator (numpy leaves, unrolled or scan
    layout; ``params`` with or without its top-level key) -> the
    state_dict of the port's ``net``: every parameter, and the running
    statistics where ``batch_stats`` is given."""
    if "params" in params and len(params) <= 2:
        batch_stats = params.get("batch_stats", batch_stats)
        params = params["params"]
    params = _unstack_trunk(params)
    trees = {"params": params, "batch_stats": batch_stats}
    paths = g_flax_paths(net)
    wanted = {path for coll, path in paths.values() if coll == "params"}
    for path in _leaf_paths(params):
        if path not in wanted:
            raise ValueError(f"unexpected {type(net).__name__} param "
                             f"{'/'.join(path)}")
    sd: Dict[str, torch.Tensor] = {}
    for key, (coll, path) in paths.items():
        node = trees[coll]
        if node is None:
            continue
        for p in path:
            node = node[p]
        sd[key] = _kernel_from_jax(node) if path[-1] == "kernel" \
            else _f32(node)
    return sd


def _leaf_paths(tree: Mapping[str, Any], pre: tuple = ()):
    """The paths of a nested mapping's leaves."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaf_paths(v, pre + (k,))
        else:
            yield pre + (k,)


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _is_unet(names) -> bool:
    """A U-Net discriminator's tree or state_dict (``conv9``, no head)."""
    return any(n.split(".")[0] == "conv9" for n in names) and \
        not any(n.startswith("linear") for n in names)


def _sn_names(key: str) -> Tuple[str, str]:
    """flax ``SpectralNorm`` variable name ``{layer}/kernel/{u|sigma}`` ->
    (layer, leaf)."""
    layer, _, leaf = key.split("/")
    return layer, leaf


def unet_from_jax(params: Mapping[str, Any],
                  batch_stats: Optional[Mapping[str, Any]] = None
                  ) -> Dict[str, torch.Tensor]:
    """The flax ``UNetDiscriminator`` trees -> the port's state_dict:

      conv{i}/{kernel,bias}              -> conv{i}.{weight,bias}
      batch_stats SpectralNorm_{j}/conv{i}/kernel/{u,sigma}
                                         -> conv{i}.sn.{u,sigma}"""
    sd: Dict[str, torch.Tensor] = {}
    for name, node in params.items():
        sd[f"{name}.weight"] = torch.from_numpy(
            hwio_to_oihw(np.asarray(node["kernel"], np.float32)))
        if "bias" in node:
            sd[f"{name}.bias"] = _f32(node["bias"])
    for node in (batch_stats or {}).values():
        for key, leaf in node.items():
            layer, which = _sn_names(key)
            sd[f"{layer}.sn.{which}"] = _f32(leaf)
    return sd


def discriminator_from_jax(params: Mapping[str, Any],
                           batch_stats: Optional[Mapping[str, Any]] = None
                           ) -> Dict[str, torch.Tensor]:
    """The flax ``DiscriminatorVGG`` (or ``UNetDiscriminator``,
    ``unet_from_jax``) trees -> the port's state_dict:

      conv{i}_{j}/Conv_0/{kernel,bias}      -> conv{i}_{j}.{weight,bias}
      conv{i}_{j}/BatchNorm_0/{scale,bias}  -> conv{i}_{j}.norm.{weight,bias}
      batch_stats conv{i}_{j}/BatchNorm_0/{mean,var}
                                  -> conv{i}_{j}.norm.running_{mean,var}
      batch_stats conv{i}_{j}/SpectralNorm_0/Conv_0/kernel/{u,sigma}
                                  -> conv{i}_{j}.sn.{u,sigma}
      linear{n}/{kernel,bias}               -> linear{n}.{weight,bias}

    ``linear0``'s rows go from the JAX module's (H, W, C) flattening to
    torch's (C, H, W). Without ``batch_stats`` (a tree of optimizer
    moments, say) only the parameters are returned."""
    if "params" in params and not any(k.startswith("conv")
                                      for k in params):
        batch_stats = params.get("batch_stats", batch_stats)
        params = params["params"]
    if _is_unet(params):
        return unet_from_jax(params, batch_stats)
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
        if "BatchNorm_0" in node:
            sd[f"{name}.norm.running_mean"] = _f32(
                node["BatchNorm_0"]["mean"])
            sd[f"{name}.norm.running_var"] = _f32(node["BatchNorm_0"]["var"])
        for key, leaf in (node.get("SpectralNorm_0") or {}).items():
            sd[f"{name}.sn.{_sn_names(key)[1]}"] = _f32(leaf)
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


def resnet_from_jax(variables: Mapping[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """The flax ``ResNet101Features`` variables (``params`` and
    ``batch_stats``) -> the port's state_dict: conv kernels as weights, a
    norm's scale and bias as ``weight`` and ``bias``, its mean and var as
    ``running_mean`` and ``running_var``."""
    sd: Dict[str, torch.Tensor] = {}
    leaves = {"kernel": "weight", "scale": "weight", "bias": "bias",
              "mean": "running_mean", "var": "running_var"}
    for coll in ("params", "batch_stats"):
        for name, node in variables[coll].items():
            for leaf, value in node.items():
                arr = np.asarray(value, np.float32)
                sd[f"{name}.{leaves[leaf]}"] = torch.from_numpy(
                    hwio_to_oihw(arr) if leaf == "kernel" else arr.copy())
    return sd


def lpips_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax ``LPIPS`` params (``net/<conv>/{kernel,bias}``,
    ``lin{i}``) -> the state_dict of ``losses/lpips.py::LPIPS``."""
    from ..losses.lpips import lpips_state_dict

    if "params" in params:
        params = params["params"]
    return lpips_state_dict({"/".join(path): _leaf(params, path)
                             for path in _leaf_paths(params)})


def _leaf(tree: Mapping[str, Any], path: tuple):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


# the keys of the optax states the JAX package's optimizers keep
_STATE_KEYS = ("count", "mu", "nu", "trace", "momentum", "slow",
               "grad_sum_sq", "s", "x0")
_LIST_KEYS = _STATE_KEYS[1:]


def _plain(tree):
    """A live optax state (tuples of named tuples) in its serialized
    form: a named tuple as a dict of its fields, a tuple as a dict keyed
    ``"0"``, ``"1"``, ...; dicts and leaves as they are."""
    if hasattr(tree, "_asdict"):
        return {k: _plain(v) for k, v in tree._asdict().items()}
    if isinstance(tree, (tuple, list)):
        return {str(i): _plain(v) for i, v in enumerate(tree)}
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def _moments_from_jax(opt_state, convert) -> Optional[Dict[str, Any]]:
    """An optimizer's optax state (live, or serialized as a ``.state``
    file holds it; numpy leaves) -> {count, [la_count], and each list by
    its optax name}, the trees brought to the port's names by
    ``convert``. The states are found by their keys in the chain (for
    ranger, Lookahead's ``{slow, count}`` gives ``la_count``); a rule that
    keeps no count (sgd, sgdp, rmsprop) is carried with 0."""
    if opt_state is None:
        return None
    out: Dict[str, Any] = {"count": 0}

    def walk(node):
        if not isinstance(node, Mapping):
            return
        if any(k in node for k in _STATE_KEYS):
            if "count" in node:
                out["la_count" if "slow" in node else "count"] = \
                    int(np.asarray(node["count"]))
            for key in _LIST_KEYS:
                if node.get(key) is not None:
                    out[key] = convert(node[key])
            return
        for k in sorted(node, key=lambda k: (len(k), k)):
            walk(node[k])

    walk(_plain(opt_state))
    return out


def train_state_from_jax(g_params: Mapping[str, Any],
                         d_params: Optional[Mapping[str, Any]] = None,
                         d_batch_stats: Optional[Mapping[str, Any]] = None,
                         step: int = 0, g_opt_state=None, d_opt_state=None,
                         ema_params: Optional[Mapping[str, Any]] = None,
                         g_net: Optional[torch.nn.Module] = None,
                         g_batch_stats: Optional[Mapping[str, Any]] = None,
                         swa_params: Optional[Mapping[str, Any]] = None,
                         swa_n=None, loc=None, grad_hist=None
                         ) -> Dict[str, Any]:
    """The numpy leaves of a JAX ``SRTrainState`` -> what
    ``load_train_state`` takes: the step, G's and D's state_dicts and, where
    given, the optimizers' states under the port's parameter names, the
    EMA and SWA weights (``ema``, ``swa``, in G's state_dict layout) with
    ``swa_n``, the LocNet (``loc``, ``loc_opt``; a ``NetState`` or its
    serialized dict) and the auto clip's history (``grad_hist``). With ``g_net`` (the
    port's G) G's trees are read by ``g_from_jax``, G's running statistics
    from ``g_batch_stats``; without, as a plain ``RRDBNet``'s
    (``rrdbnet_like``)."""
    if g_net is None:
        g_net = rrdbnet_like(g_params)

    def convert_g(tree):
        return g_from_jax(tree, None, g_net)
    out: Dict[str, Any] = {"step": int(step), "g": convert_g(g_params),
                           "g_opt": _moments_from_jax(g_opt_state,
                                                      convert_g)}
    if g_batch_stats:
        out["g"] = g_from_jax(g_params, g_batch_stats, g_net)
    if ema_params is not None:
        out["ema"] = convert_g(ema_params)
    if swa_params is not None:
        out["swa"] = convert_g(swa_params)
        out["swa_n"] = int(np.asarray(swa_n))
    if loc is not None:
        loc = _plain(loc)
        out["loc"] = loc_from_jax(loc["params"])
        out["loc_opt"] = _moments_from_jax(loc.get("opt_state"),
                                           loc_from_jax)
    if grad_hist is not None:
        out["grad_hist"] = {"vals": _f32(grad_hist["vals"]),
                            "n": int(np.asarray(grad_hist["n"]))}
    if d_params is not None:
        out["d"] = discriminator_from_jax(d_params, d_batch_stats)
        out["d_opt"] = _moments_from_jax(d_opt_state, discriminator_from_jax)
    return out


def _load_opt(opt, names, moments, dev) -> None:
    opt.load_state_dict({
        k: (v if k in ("count", "la_count") else [v[n].to(dev)
                                                  for n in names])
        for k, v in moments.items()})


def load_train_state(state, carried: Mapping[str, Any]) -> None:
    """Loads ``train_state_from_jax``'s result (or
    ``train_state_from_state_dict``'s) into a port ``SRTrainState``, in
    place. A carried ``rng`` becomes the state's key and reseeds its
    latent-noise generator by ``key_to_seed``. Carried EMA and SWA weights
    go into the state's copies of G, the LocNet and the clip history into
    its own; what the state keeps, the checkpoint must carry."""
    state.step = int(carried["step"])
    for copy_name in ("ema", "swa"):
        module = getattr(state, copy_name)
        if module is None:
            continue
        if carried.get(copy_name) is None:
            raise ValueError(f"the state keeps {copy_name.upper()} "
                             "weights; the checkpoint carries none")
        with torch.no_grad():
            for name, p in module.named_parameters():
                p.copy_(carried[copy_name][name])
    if state.swa_n is not None:
        state.swa_n.fill_(int(carried["swa_n"]))
    if state.grad_hist is not None:
        if carried.get("grad_hist") is None:
            raise ValueError("the state keeps the auto clip's history; the "
                             "checkpoint carries none")
        state.grad_hist["vals"].copy_(carried["grad_hist"]["vals"])
        state.grad_hist["n"].fill_(int(carried["grad_hist"]["n"]))
    for which in ("g", "d", "loc"):
        net_state = getattr(state, which)
        if net_state is None:
            continue
        if which not in carried:
            if which == "loc":
                raise ValueError("the state keeps AdaTarget's LocNet; the "
                                 "checkpoint carries none")
            continue
        net_state.net.load_state_dict(carried[which], strict=True)
        moments = carried.get(f"{which}_opt")
        if moments is not None and net_state.opt is not None:
            names = [n for n, _ in net_state.net.named_parameters()]
            _load_opt(net_state.opt, names, moments,
                      net_state.opt.params[0].device)
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
    """f32 C-order copy; a 0-d tensor stays 0-d (``np.ascontiguousarray``
    would make it 1-d)."""
    return np.array(t.detach().float().cpu().numpy(), order="C")


def params_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``RRDBNet`` state_dict -> the flax param tree in the
    unrolled ``RRDB{i}`` layout, numpy f32 leaves: ``g_to_jax`` on a plain
    ``RRDBNet`` of its widths, the inverse of ``params_from_jax``."""
    return g_to_jax(sd, rrdbnet_like(sd))[0]


def unet_to_jax(sd: Mapping[str, torch.Tensor]
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's ``UNetDiscriminator`` state_dict -> the flax ``params``
    and ``batch_stats`` trees: the inverse of ``unet_from_jax``. The
    spectral norms are numbered as flax creates them, in conv order."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    layers = sorted({k.split(".")[0] for k in sd}, key=lambda n: int(n[4:]))
    for name in layers:
        params[name] = {"kernel": oihw_to_hwio(sd[f"{name}.weight"])}
        if f"{name}.bias" in sd:
            params[name]["bias"] = _np(sd[f"{name}.bias"])
    sn_layers = [n for n in layers if f"{n}.sn.u" in sd]
    for j, name in enumerate(sn_layers):
        stats[f"SpectralNorm_{j}"] = {
            f"{name}/kernel/{leaf}": _np(sd[f"{name}.sn.{leaf}"])
            for leaf in ("sigma", "u")}
    return params, stats


def discriminator_to_jax(sd: Mapping[str, torch.Tensor]
                         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's ``DiscriminatorVGG`` (or ``UNetDiscriminator``,
    ``unet_to_jax``) state_dict, or a tree of its parameters alone, as
    optimizer moments are -> the flax ``params`` and ``batch_stats`` trees:
    the inverse of ``discriminator_from_jax``. ``linear0``'s rows go from
    torch's (C, H, W) flattening back to the JAX module's (H, W, C)."""
    if _is_unet(sd):
        return unet_to_jax(sd)
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
        if f"{name}.sn.u" in sd:
            stats[name] = {"SpectralNorm_0": {
                f"Conv_0/kernel/{leaf}": _np(sd[f"{name}.sn.{leaf}"])
                for leaf in ("sigma", "u")}}
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


def _opt_to_jax(opt, moments: Mapping[str, Any], names,
                convert) -> Dict[str, Any]:
    """The port's optimizer ``opt`` with its state (``opt.state_dict()``)
    -> the serialized optax state the JAX package's ``build_optimizer``
    keeps for it: a chain ``{"0": ..., "1": ...}`` of the rule's state and
    ``add_decayed_weights``' empty one under weight decay (adam:
    ``{count, mu, nu}``, sgd: ``{trace}``, rmsprop: ``{nu}``, adamp
    ``{count, mu, nu}`` and sgdp ``{momentum}`` with the decay inside);
    ranger's ``(chain, {slow, count})`` with gradient centralisation's
    empty state first under ``use_gc``; madgrad's ``{count, grad_sum_sq,
    s, x0}``."""
    wd = opt.weight_decay
    count = np.asarray(moments["count"], np.int32)

    def tree(key):
        return convert(dict(zip(names, moments[key])))

    def with_decay(head, decayed=True):
        chain = {"0": head}
        if wd and decayed:
            chain["1"] = {}
        return chain

    kind = opt.name
    if kind == "adam":
        return with_decay({"count": count, "mu": tree("mu"),
                           "nu": tree("nu")})
    if kind == "sgd":
        return with_decay({"trace": tree("trace")})
    if kind == "rmsprop":
        return with_decay({"nu": tree("nu")})
    if kind == "adamp":
        return {"0": {"count": count, "mu": tree("mu"), "nu": tree("nu")}}
    if kind == "sgdp":
        return {"0": {"momentum": tree("momentum")}}
    if kind == "madgrad":
        return {"count": count, "grad_sum_sq": tree("grad_sum_sq"),
                "s": tree("s"), "x0": tree("x0")}
    if kind == "ranger":
        parts = ([{}] if opt.use_gc else []) + \
            [{"count": count, "mu": tree("mu"), "nu": tree("nu")}] + \
            ([{}] if wd else [])
        return {"0": {str(i): v for i, v in enumerate(parts)},
                "1": {"slow": tree("slow"),
                      "count": np.asarray(moments["la_count"], np.int32)}}
    raise NotImplementedError(f"optimizer [{kind}]")


def loc_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``LocNet`` state_dict (or a tree of its parameters, as
    optimizer moments are) -> the flax ``fc1``..``fc3`` Dense tree (kernel
    (in, out))."""
    out: Dict[str, Any] = {}
    for key, t in sd.items():
        name, leaf = key.split(".")
        out.setdefault(name, {})["kernel" if leaf == "weight" else "bias"] = \
            np.ascontiguousarray(_np(t).T) if leaf == "weight" else _np(t)
    return out


def loc_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The inverse of ``loc_to_jax``."""
    sd: Dict[str, torch.Tensor] = {}
    for name, leaves in params.items():
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(leaves["kernel"], np.float32).T))
        sd[f"{name}.bias"] = _f32(leaves["bias"])
    return sd


def train_state_to_jax(state) -> Dict[str, Any]:
    """A port ``SRTrainState`` -> the state dict of the JAX package's
    ``SRTrainState`` (``trainner_tpu/train/state.py:35``), which flax's
    ``from_state_dict`` / ``from_bytes`` accepts on a JAX template of the
    same configuration: exactly its fields, ``None`` for what the state
    does not keep; the EMA and SWA weights (and ``swa_n``), the LocNet
    with its optimizer, the auto clip's history; a net's ``batch_stats``
    (G's running statistics, D's, its spectral norms' state) in its
    ``extra`` when it keeps any."""
    def net(ns, convert):
        sd = ns.net.state_dict()
        moments = ns.opt.state_dict() if ns.opt is not None else {}
        lists = [k for k in _LIST_KEYS if k in moments]
        host = iter(_to_host(list(sd.values())
                            + [t for k in lists for t in moments[k]]))
        sd = {k: next(host) for k in sd}
        for k in lists:
            moments[k] = [next(host) for _ in moments[k]]
        params, stats = convert(sd)
        names = [n for n, _ in ns.net.named_parameters()]
        opt = _opt_to_jax(ns.opt, moments, names,
                          lambda t: convert(t)[0]) \
            if ns.opt is not None else None
        return {"params": params, "opt_state": opt,
                "extra": {"batch_stats": stats} if stats else {}}

    def convert_g(sd):
        return g_to_jax(sd, state.g.net)

    def copy_of_g(module):
        named = dict(module.named_parameters())
        return convert_g(dict(zip(named, _to_host(list(named.values())))))[0]

    rng = state.rng if state.rng is not None else seed_to_key(0)
    hist = state.grad_hist
    return {
        "step": np.asarray(state.step, np.int32),
        "rng": np.asarray(rng, np.uint32),
        "g": net(state.g, convert_g),
        "d": None if state.d is None else net(state.d, discriminator_to_jax),
        "swa_params": None if state.swa is None else copy_of_g(state.swa),
        "swa_n": None if state.swa_n is None else np.asarray(
            int(state.swa_n), np.int32),
        "ema_params": None if state.ema is None else copy_of_g(state.ema),
        "loc": None if state.loc is None else net(
            state.loc, lambda sd: (loc_to_jax(sd), {})),
        "grad_hist": None if hist is None else {
            "vals": _np(hist["vals"]),
            "n": np.asarray(int(hist["n"]), np.int32)},
    }


def train_state_from_state_dict(tree: Mapping[str, Any],
                                g_net: Optional[torch.nn.Module] = None
                                ) -> Dict[str, Any]:
    """The tree that ``msgpack_restore`` reads from a ``.state`` file (the
    JAX package's or the port's) -> what ``load_train_state`` takes:
    the step, the key, both nets with their moments and running
    statistics (G's by ``g_net``, as ``train_state_from_jax`` reads
    them), and what the state keeps of SWA, the LocNet and the auto
    clip."""
    d = tree.get("d")
    out = train_state_from_jax(
        tree["g"]["params"],
        d["params"] if d else None,
        ((d.get("extra") or {}).get("batch_stats") if d else None),
        step=int(np.asarray(tree["step"])),
        g_opt_state=tree["g"].get("opt_state"),
        d_opt_state=d.get("opt_state") if d else None,
        ema_params=tree.get("ema_params"), g_net=g_net,
        g_batch_stats=(tree["g"].get("extra") or {}).get("batch_stats"),
        swa_params=tree.get("swa_params"), swa_n=tree.get("swa_n"),
        loc=tree.get("loc"), grad_hist=tree.get("grad_hist"))
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


def srresnet_to_params(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A norm-free SRResNet / SRGAN ``.pth`` state_dict (the reference's
    Sequential ``model.N`` layout, that of the published models) -> the
    flax SRResNet param tree (numpy): ``model.0`` -> fea_conv,
    ``model.1.sub.{i}.res.{0,2}`` -> res{i}/conv{0,1}, ``model.1.sub.{nb}``
    -> LR_conv, the convs after the trunk by order -> up{k}/ConvBlock_0,
    HR_conv0, HR_conv1 (the JAX ``srresnet_to_params:188``). A checkpoint
    with batch norms raises."""
    sd = {k: np.asarray(v.detach().float().numpy()
                        if isinstance(v, torch.Tensor) else v)
          for k, v in sd.items()}
    if any("running_mean" in k for k in sd):
        raise ValueError("BN-ful SRResNet checkpoints are not supported "
                         "by this converter (expected the published "
                         "noBN layout)")
    tree: Dict[str, Any] = {}

    def put(path, leaf, value):
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node["kernel" if leaf == "weight" else "bias"] = \
            np.ascontiguousarray(value.transpose(2, 3, 1, 0)) \
            if leaf == "weight" and value.ndim == 4 else value

    for k, v in sd.items():
        if k.startswith("model.0."):
            put(("fea_conv", "Conv_0"), k.rsplit(".", 1)[-1], v)
        elif (m := re.match(r"model\.1\.sub\.(\d+)\.res\.(\d+)\."
                            r"(weight|bias)", k)):
            i, j = int(m.group(1)), int(m.group(2))
            put((f"res{i}", "conv0" if j == 0 else "conv1", "Conv_0"),
                m.group(3), v)
        elif (m := re.match(r"model\.1\.sub\.(\d+)\.(weight|bias)", k)):
            put(("LR_conv", "Conv_0"), m.group(2), v)
    tail_idx = sorted({int(m.group(1)) for k in sd
                       if (m := re.match(r"model\.(\d+)\.", k))
                       and int(m.group(1)) >= 2})
    names = [f"up{i}" for i in range(len(tail_idx) - 2)] \
        + ["HR_conv0", "HR_conv1"]
    for idx, name in zip(tail_idx, names):
        sub = ("ConvBlock_0", "Conv_0") if name.startswith("up") \
            else ("Conv_0",)
        for k, v in sd.items():
            if k.startswith(f"model.{idx}."):
                put((name,) + sub, k.rsplit(".", 1)[-1], v)
    return tree


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
