"""Assembly of the on-device degradation pipeline.

Counterpart of ``trainner_tpu/data/pipeline.py`` for the fixed-order
program of a blind-SR train dataset: ``_collect:77``,
``get_unpaired_params:107``, ``_with_prob:136``, ``_cfg_for:151``,
``_blur_stage:159``, ``_atten_factor:264``, ``_atten_ratio:288``,
``_draw_att_pair:319``, ``_att_wrap:341``, ``_blur3:370``,
``_noise_stage:387``, ``_size_ratio:576``, ``_q8:605``,
``_resize_stage:613`` and ``BatchDegrader:792`` with its three programs:
``_build:1266`` (the fixed order), ``_build_routing:1171`` with its host
plan ``_routing_plan:1113`` (the per-sample shuffle, by default) and
``_build_persample:989`` (the per-sample shuffle by candidate select,
under ``TRAINNER_SHUFFLE_ROUTING=0``), dispatched as ``__call__:1312``.

The dataset options are split into the stages of the LR (or HR) pipeline;
each stage is a function ``fn(gen, x)`` (or ``fn(gen, x, att=...)`` where
it carries ``_wants_att``) that degrades the whole NHWC batch on its device
with per-sample parameters drawn from the ``torch.Generator`` ``gen``,
which lies on that device. Per-sample choices among types are computed
without branches: every candidate is computed and one is picked per
sample. Every stage's output is rounded to the 1/255 lattice (``_q8``).
Everything runs in f32, with TF32 off for the length of a call.

The in-pipeline resize goes straight to the LR size; what the reference
injects at a random intermediate size X and then shrinks is modelled by
scaling the residual of the stages after the resize by a per-sample
attenuation v = clip(LR / X, 0, 1), drawn once per call and shared by
all of them (``_draw_att_pair``), and by a bucketed double resample inside
the resize stage.

The random halves are kept apart from the arithmetic where a test needs
to feed another framework's draws: ``draw_size_ratio`` / ``_size_ratio``,
``draw_atten_ratio`` / ``_atten_ratio``, ``draw_att_pair`` / ``_att_pair``.

The realistic assets load once per degrader (``data/kernels.py``): a
KernelGAN pool from ``dataroot_kernels`` replaces the whole first resize
stage when resize code 999 is among its types (``apply_kernel_pool``: the
blur kernel on the input canvas, then the aligned subsample), and noise
patches from ``noise_data`` replace a noise stage that lists ``patches``.
Without a pool 999 is dropped; without patches, ``patches`` is gaussian
noise. Both as in the JAX package, and silently, as there.

With ``shuffle_degradations`` every sample runs the stages in an order of
its own. The routed program draws those orders on the host, as rows of
random Latin squares (``_routing_plan``, the JAX package's plan stream and
code, so its plans are the JAX package's call for call), and hands them to
the device as small int32 tensors by one pinned, non-blocking copy; the
device program reads nothing back to the host, so the host runs ahead.

Every stage and type of the JAX module runs here. ``compression: webp``
runs the DCT approximation under ``TRAINNER_DEVICE_WEBP=approx`` and raises
without it (the exact codec is a host callback, which ``otf_mode: host``
runs on the host; ROADMAP C 20).
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import degradations as D
from ..ops.blocks import wire_to_f01
from ..ops.superpixel import (draw_superpixel_structure,
                              superpixel_structure)
from ..utils.graphs import device_constant
from .kernels import (apply_kernel_pool, apply_noise_patches,
                      draw_kernel_pool, draw_noise_patches,
                      load_kernel_pool, load_noise_patches)

# (aug_name, enable_key, prob_key, types_key)
_AUG_KEYS = [
    ("auto_levels", "lr_auto_levels", "lr_rand_auto_levels", None),
    ("unsharp", "lr_unsharp_mask", "lr_rand_unsharp", None),
    ("fringes", "lr_fringes", "lr_fringes_chance", None),
    ("blur", "lr_blur", "blur_prob", "lr_blur_types"),
    ("blur2", "lr_blur2", "blur_prob2", "lr_blur_types2"),
    ("final_blur", "final_blur", "final_blur_prob", "final_blur"),
    ("resize", "lr_downscale", None, "lr_downscale_types"),
    ("resize2", "lr_downscale2", None, "lr_downscale_types2"),
    ("final_scale", "final_scale", None, "final_scale_types"),
    ("noise", "lr_noise", None, "lr_noise_types"),
    ("noise2", "lr_noise2", None, "lr_noise_types2"),
    ("compression", "compression", None, "compression"),
    ("final_compression", "final_compression", None, "final_compression"),
]

_HR_AUG_KEYS = [
    ("auto_levels", "hr_auto_levels", "hr_rand_auto_levels", None),
    ("unsharp", "hr_unsharp_mask", "hr_rand_unsharp", None),
    ("noise", "hr_noise", None, "hr_noise_types"),
]

# the seed of the host stream of routing plans (the JAX package's)
PLAN_SEED = 0x5EED_0A71


def _collect(opt: dict, keys) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for aug, enable_key, prob_key, types_key in keys:
        enabled = opt.get(enable_key)
        types = opt.get(types_key) if types_key else None
        if types_key and types_key == enable_key:
            types = enabled if isinstance(enabled, (list, tuple)) else types
        # the enable flag alone gates the stage: an explicit false disables
        # it even when the preset overlay filled in the types
        if not enabled:
            continue
        prob = opt.get(prob_key) if prob_key else None
        if prob is None:
            prob = 1.0
        weights = None
        if isinstance(types, dict):  # weighted-choice form {type: weight}
            names, ws = zip(*types.items()) if types else ((), ())
            types, weights = list(names), [float(w) for w in ws]
        elif isinstance(types, (list, tuple)):
            types = list(types)
        else:
            types = [types] if types else []
        out[aug] = {"prob": float(prob), "types": types, "weights": weights}
    return out


def get_unpaired_params(opt: dict) -> Tuple[dict, dict]:
    """Splits the dataset options into the LR and HR stage parameters. The
    in-pipeline resize stages are active only when ``resize_strat`` holds
    'in'; with the default 'pre' the dataset makes the LR image."""
    lr_augs = _collect(opt, _AUG_KEYS)
    hr_augs = _collect(opt, _HR_AUG_KEYS)
    if "in" not in str(opt.get("resize_strat") or "pre"):
        for k in ("resize", "resize2", "final_scale"):
            lr_augs.pop(k, None)
    if opt.get("shuffle_degradations"):
        lr_augs["random_shuffle"] = True
    if lr_augs:
        lr_augs["kind"] = "lr"
    if hr_augs:
        hr_augs["kind"] = "hr"
    return lr_augs, hr_augs


# ---------------------------------------------------------------------------
# the stages
# ---------------------------------------------------------------------------

_MOTION_BLURS = ("motion", "complexmotion", "complex_motion")
_NONLINEAR_BLURS = ("median", "bilateral")
_DEVICE_NOISE = ("gaussian", "jpeg", "webp", "poisson", "speckle", "s&p",
                 "sp", "quantize", "dither", "maxrgb", "camera",
                 "superpixels", "clahe")


@contextlib.contextmanager
def _full_f32():
    """The pipeline's matmuls and convs in full f32: the TF32 flags of
    cuDNN and of matmul (global in PyTorch) are off for the length of the
    call and put back after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def _bcast(mask: torch.Tensor) -> torch.Tensor:
    return mask.reshape(-1, 1, 1, 1)


def _with_prob(fn: Callable, prob: float) -> Callable:
    """``fn`` applied to each sample with probability ``prob``."""
    if prob >= 1.0:
        return fn

    def wrapped(gen, x, **kw):
        y = fn(gen, x, **kw)
        if y.shape != x.shape:
            return y
        hit = D._uniform(gen, (x.shape[0],)) < prob
        return torch.where(_bcast(hit), y, x)

    wrapped._wants_att = getattr(fn, "_wants_att", False)
    return wrapped


def _cfg_for(cfgs: Dict[str, dict], t: str, cycle: int = 1) -> dict:
    """The config of one type; a second-cycle stage prefers the '<type>2'
    entry (aniso2, camera2)."""
    if cycle == 2:
        return cfgs.get(t + "2") or cfgs.get(t) or {}
    return cfgs.get(t) or cfgs.get(t + "2") or {}


def _nonlinear_blur(t: str, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """The exact median or bilateral filter of a blur type, at its
    config's odd kernel size (at most 11)."""
    if t == "median":
        ksz = int(cfg.get("kernel_size", 3))
        return D.median_blur(x, min(ksz if ksz % 2 else ksz + 1, 11))
    ksz = int(cfg.get("kernel_size", 9))
    return D.bilateral_blur(x, min(ksz if ksz % 2 else ksz + 1, 11),
                            float(cfg.get("sigmaColor", 75.0) or 75.0),
                            float(cfg.get("sigmaSpace", 75.0) or 75.0))


def _blur_stage(types: Sequence[str], cfgs: Dict[str, dict], prob: float,
                weights=None, cycle: int = 1) -> Callable:
    """Per-sample choice of a blur type, each linear type with its own
    kernel bank padded to one size; a type applies with its config's
    ``p`` (a miss puts the delta kernel in its place); one
    ``apply_kernels`` call blurs the batch. Median and bilateral are exact
    nonlinear candidates beside it (a delta kernel in their slot of the
    bank), computed on the whole batch and kept where a sample chose
    them."""
    types = [str(t).lower() for t in types] or ["gaussian"]

    def fn(gen, x):
        b = x.shape[0]
        banks, probs = [], []
        for t in types:
            cfg = _cfg_for(cfgs, t, cycle)
            k = int(cfg.get("kernel_size", 21))
            mk = int(cfg.get("min_kernel_size", 1) or 1)
            probs.append(float(cfg.get("p", 0.5)))
            if t == "sinc":
                # a min_cutoff fixes the cutoff (and the full support)
                mc = cfg.get("min_cutoff")
                banks.append(D.sinc_kernels(D.draw_sinc_kernels(
                    gen, b, k, (float(mc), float(mc)) if mc else None,
                    max(mk, 7)), k))
            elif t in ("iso", "gaussian"):
                sx = cfg.get("sigmaX") or [0.1, 2.8]
                banks.append(D.gaussian_kernels(D.draw_gaussian_kernels(
                    gen, b, k, tuple(map(float, sx)), iso_prob=1.0,
                    min_size=mk), k))
            elif t == "aniso":
                sx = cfg.get("sigmaX") or [0.5, 8.0]
                sy = cfg.get("sigmaY") or sx
                ang = cfg.get("angle")
                banks.append(D.gaussian_kernels(D.draw_gaussian_kernels(
                    gen, b, k, tuple(map(float, sx)), iso_prob=0.0,
                    sigma_y_range=tuple(map(float, sy)), min_size=mk,
                    angle_range=tuple(math.radians(float(a)) for a in ang)
                    if ang else None), k))
            elif t in _MOTION_BLURS:
                banks.append(D.motion_kernels(D.draw_motion_kernels(gen, b),
                                              k))
            elif t in ("average", "box"):
                banks.append(D.box_kernels(D.draw_box_kernels(gen, b), k))
            elif t in _NONLINEAR_BLURS:
                banks.append(None)
            else:
                banks.append(D.gaussian_kernels(D.draw_gaussian_kernels(
                    gen, b, k, (0.2, 3.0)), k))
        kmax = max((kk.shape[-1] for kk in banks if kk is not None),
                   default=21)
        delta = torch.zeros((1, kmax, kmax), device=x.device)
        delta[0, kmax // 2, kmax // 2].fill_(1.0)  # no host copy
        banks = [delta.expand(b, kmax, kmax) if kk is None else
                 F.pad(kk, ((kmax - kk.shape[-1]) // 2,) * 4)
                 for kk in banks]
        if any(p < 1.0 for p in probs):
            u = D._uniform(gen, (b, len(banks), 1, 1))
            banks = [torch.where(u[:, i] < p, kk, delta)
                     for i, (kk, p) in enumerate(zip(banks, probs))]
        choice = D.draw_choice(gen, b, len(banks), weights) \
            if len(banks) > 1 else None
        out = D.apply_kernels(x, D.select(banks, choice))
        for i, t in enumerate(types):
            if t not in _NONLINEAR_BLURS:
                continue
            y = _nonlinear_blur(t, _cfg_for(cfgs, t, cycle), x)
            if probs[i] < 1.0:
                miss = D._uniform(gen, (b,)) >= probs[i]
                y = torch.where(_bcast(miss), x, y)
            out = y if choice is None else torch.where(
                _bcast(choice == i), y, out)
        return out

    return _with_prob(fn, prob)


def _size_ranges(res_cfg: dict, in_over_out: float):
    probs = dict(res_cfg.get("resize_prob") or {"down": 1.0})
    p_up = float(probs.get("up", 0.0))
    p_down = float(probs.get("down", 1.0))
    p_keep = float(probs.get("keep", 0.0))
    tot = max(p_up + p_down + p_keep, 1e-8)
    rd = res_cfg.get("resize_range_down") or [
        1.0 / max(in_over_out, 2.0), 2.0 / max(in_over_out, 2.0)]
    ru = res_cfg.get("resize_range_up") or [1.0, 1.5]
    return (float(rd[0]), float(rd[1])), (float(ru[0]), float(ru[1])), \
        p_down, p_up, tot


def draw_size_ratio(gen, b: int, res_cfg: dict, in_over_out: float
                    ) -> D.Params:
    """The draws of ``_size_ratio``: the down and up factors within their
    ranges and the branch coin in [0, 1)."""
    rd, ru, _, _, _ = _size_ranges(res_cfg, in_over_out)
    return {"sc_d": D._uniform(gen, (b,), *rd),
            "sc_u": D._uniform(gen, (b,), *ru),
            "u": D._uniform(gen, (b,))}


def _size_ratio(draws: D.Params, res_cfg: dict, in_over_out: float
                ) -> torch.Tensor:
    """Per-sample unclipped ratio r = X / out_size of the reference's
    random intermediate size X = in_size * U(range), the branch (down, up,
    keep) taken with the probabilities of ``resize_prob``."""
    _, _, p_down, p_up, tot = _size_ranges(res_cfg, in_over_out)
    u = draws["u"] * tot
    return torch.where(
        u < p_down, in_over_out * draws["sc_d"],
        torch.where(u < p_down + p_up, in_over_out * draws["sc_u"],
                    torch.full_like(u, in_over_out)))


def _int_types(res_types) -> List[int]:
    return [t for t in res_types if isinstance(t, int)]


def _n_plain(algos: Sequence[int]) -> int:
    return len([t for t in algos if t not in (995, 996, 997, 998, 999)])


def draw_atten_ratio(gen, b: int, res_cfg: dict, scale: int,
                     res_types: Sequence[int] = ()) -> D.Params:
    algos = _int_types(res_types)
    half = -(-scale // 2)
    n = max(_n_plain(algos), 1) + any(t in (995, 997) for t in algos) \
        + any(t == 998 for t in algos) + any(t == 999 for t in algos)
    return {"plain": draw_size_ratio(gen, b, res_cfg, float(scale)),
            "coin": D._uniform(gen, (b,)) < 0.5,
            "sp": D._uniform(gen, (b,), float(half), float(scale)),
            "a_u": D._uniform(gen, (b,)),
            "choice": D.draw_choice(gen, b, n) if n > 1 else None}


def _atten_ratio(draws: D.Params, res_cfg: dict, scale: int,
                 res_types: Sequence[int] = ()) -> torch.Tensor:
    """Per-sample canvas-size ratio r = X1 / LR, by the class of resize
    algorithm the reference would have drawn for the sample: the plain
    kernels through ``_size_ratio``; 997 (nearest aligned) at scale' in
    {ceil(s/2), s}; 998 (down_up) at s * a / s' with s' ~ U(ceil(s/2), s),
    a ~ U(down_up_min, s'); 999 at the exact LR size."""
    r_plain = _size_ratio(draws["plain"], res_cfg, float(scale))
    algos = _int_types(res_types)
    cands = [r_plain] * max(_n_plain(algos), 1)
    half = -(-scale // 2)
    if any(t in (995, 997) for t in algos):
        cands.append(torch.where(draws["coin"],
                                 torch.full_like(r_plain, scale / half),
                                 torch.ones_like(r_plain)))
    if any(t == 998 for t in algos):
        sp = draws["sp"]
        du_min = float(res_cfg.get("down_up_min", 0.5) or 0.5)
        a = du_min + draws["a_u"] * (sp - du_min)
        cands.append(scale * a / sp)
    if any(t == 999 for t in algos):
        cands.append(torch.ones_like(r_plain))
    if len(cands) == 1:
        return cands[0]
    return D.select(cands, draws["choice"])


def _clip_inverse(r: torch.Tensor) -> torch.Tensor:
    return (1.0 / r.clamp_min(1e-6)).clamp(0.0, 1.0)


def _atten_factor(gen, b: int, res_cfg: dict, scale: int,
                  res_types: Sequence[int] = (),
                  chain_cfg: Optional[dict] = None) -> torch.Tensor:
    """An independent per-sample attenuation v = clip(LR / X, 0, 1), for a
    stage called without the call's shared pair; with ``chain_cfg`` the
    canvas is X2 = X1 * f2 and the ratios compose before the clip."""
    r = _atten_ratio(draw_atten_ratio(gen, b, res_cfg, scale, res_types),
                     res_cfg, scale, res_types)
    if chain_cfg:
        r = r * _size_ratio(draw_size_ratio(gen, b, chain_cfg, 1.0),
                            chain_cfg, 1.0)
    return _clip_inverse(r)


def draw_att_pair(gen, b: int, att_cfg: dict) -> D.Params:
    ch = att_cfg.get("chain_cfg2")
    return {"ratio": draw_atten_ratio(gen, b, att_cfg.get("res_cfg") or {},
                                      int(att_cfg.get("scale", 4)),
                                      att_cfg.get("res_types") or ()),
            "chain": draw_size_ratio(gen, b, ch, 1.0) if ch else None}


def _att_pair(draws: D.Params, att_cfg: dict):
    """(v1, v2), each (b, 1, 1, 1): v1 = clip(LR / X1) for the stages on
    the X1 canvas, v2 = clip(LR / X2) for those after the second resize."""
    r = _atten_ratio(draws["ratio"], att_cfg.get("res_cfg") or {},
                     int(att_cfg.get("scale", 4)),
                     att_cfg.get("res_types") or ())
    v1 = _clip_inverse(r)
    ch = att_cfg.get("chain_cfg2")
    v2 = _clip_inverse(r * _size_ratio(draws["chain"], ch, 1.0)) if ch \
        else v1
    return _bcast(v1), _bcast(v2)


def _draw_att_pair(gen, b: int, att_cfg: dict):
    """One attenuation chain per sample for the whole call: in the
    reference the same intermediate sizes apply to every op of a sample,
    so a sample that is hit hard is hit hard by blur2, noise and
    compression together."""
    return _att_pair(draw_att_pair(gen, b, att_cfg), att_cfg)


def _att_wrap(fn: Callable, att_cfg: dict, square: bool = False,
              chain: bool = False) -> Callable:
    """Scales a spatial op's residual by the attenuation that the
    reference's final snap to the LR size applies to an op that ran on an
    intermediate canvas. Takes the call's shared pair when given."""
    def wrapped(gen, x, att=None):
        y = fn(gen, x)
        if att is not None:
            v = att[1] if chain else att[0]
        else:
            v = _bcast(_atten_factor(
                gen, x.shape[0], att_cfg.get("res_cfg") or {},
                int(att_cfg.get("scale", 4)),
                att_cfg.get("res_types") or (),
                chain_cfg=att_cfg.get("chain_cfg") if chain else None))
        if square:
            v = v * v
        return x + v.to(x.dtype) * (y - x)

    wrapped._wants_att = True
    return wrapped


def _blur3(x: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 binomial low-pass ([1, 2, 1] / 4 each way) with zero
    padding, NHWC."""
    c = x.shape[-1]
    k1 = device_constant((0.25, 0.5, 0.25), x.dtype, x.device)
    y = x.permute(0, 3, 1, 2)
    y = F.conv2d(y, k1.reshape(1, 1, 3, 1).repeat(c, 1, 1, 1),
                 padding=(1, 0), groups=c)
    y = F.conv2d(y, k1.reshape(1, 1, 1, 3).repeat(c, 1, 1, 1),
                 padding=(0, 1), groups=c)
    return y.permute(0, 2, 3, 1)


def _dither_op(t: str, cfg: dict) -> Callable:
    """A dither type by its name's parts, as the reference dispatches:
    'bw' dithers the luma; 'bayer', 'avg', 'bin', 'rnd', and 'fs' (or
    plain 'dither') pick the kind, any other name is bayer."""
    bw = "bw" in t
    if "bayer" in t:
        kind = "bayer"
    elif "avg" in t:
        kind = "avg"
    elif "bin" in t:
        kind = "bin"
    elif "rnd" in t:
        kind = "rnd"
    elif "fs" in t or t == "dither":
        kind = "fs"
    else:
        kind = "bayer"
    bits = int(cfg.get("bits", 1))
    return lambda gen, x: D.dither_batch(
        x, kind, bits, bw, D.draw_dither(gen, x.shape, kind))


def _clahe_op(cfg: dict) -> Callable:
    """CLAHE with one clip limit per batch drawn in [1, clip_limit's
    upper end]; an image the tile grid does not divide passes through."""
    cl = cfg.get("clip_limit", 4.0)
    cl_hi = float(cl[1] if isinstance(cl, (list, tuple)) else cl)
    gs = tuple(cfg.get("tile_grid_size") or (8, 8))

    def op(gen, x):
        clip = D.draw_clahe(gen, cl_hi)
        if x.shape[1] % gs[0] or x.shape[2] % gs[1]:
            return x
        return D.clahe_batch(x, clip, grid=gs)

    return op


def _noise_op(t: str, cfg: dict) -> Callable:
    """``op(gen, x)`` of one noise type with its config."""
    if t == "gaussian":
        var = cfg.get("var_limit") or [1.0, 25.0]
        # sigma_calc 'sig' (the default): var_limit is the sigma range in
        # 0-255 units; 'var' takes its square root
        if str(cfg.get("sigma_calc", "sig")) == "var":
            sig = (math.sqrt(float(var[0])), math.sqrt(float(var[1])))
        else:
            sig = (float(var[0]), float(var[1]))
        gray_prob = 1.0 - float(cfg.get("prob_color", 0.5))
        mc_prob = 0.34 if cfg.get("multi", True) else 0.0
        return lambda gen, x: D.gaussian_noise(x, D.draw_gaussian_noise(
            gen, x.shape, sig, gray_prob, mc_prob))
    if t in ("jpeg", "webp"):
        if t == "webp" and os.environ.get("TRAINNER_DEVICE_WEBP",
                                          "exact") != "approx":
            raise D.not_ported(
                "compression [webp] by the exact codec (a host callback "
                "through OpenCV; TRAINNER_DEVICE_WEBP=approx runs the DCT "
                "approximation on the device)")
        qr = (float(cfg.get("min_quality", 30)),
              float(cfg.get("max_quality", 95)))
        return lambda gen, x: D.jpeg_compress(
            x, D.draw_jpeg_quality(gen, x.shape[0], qr))
    if t == "poisson":
        sr = tuple(map(float, cfg.get("scale_range") or (0.5, 3.0)))
        return lambda gen, x: D.poisson_noise(x, D.draw_poisson_noise(
            gen, x.shape, sr))
    if t == "speckle":
        var = cfg.get("var_limit") or [0.001, 0.01]
        sig = (math.sqrt(float(var[0])), math.sqrt(float(var[1])))
        return lambda gen, x: D.speckle_noise(x, D.draw_speckle_noise(
            gen, x.shape, sig))
    if t in ("s&p", "sp"):
        amt = float(cfg.get("amount", 0.01))
        return lambda gen, x: D.salt_pepper_noise(
            x, D.draw_salt_pepper_noise(gen, x.shape, (amt / 10, amt)))
    if t in ("simplequantize", "simple_quantize"):
        n = int(cfg.get("num_colors", cfg.get("rgb_range", 32)))
        return lambda gen, x: D.quantize_colors(x, n)
    if t in ("quantize", "som_quantize"):
        n = int(cfg.get("num_colors", 32))
        return lambda gen, x: D.som_quantize(
            x, D.draw_som_quantize(gen, x.shape, n), n)
    if "quantize" in t:  # km_quantize
        n = int(cfg.get("num_colors", 32))
        return lambda gen, x: D.kmeans_quantize(
            x, D.draw_kmeans_quantize(gen, x.shape), n)
    if t == "clahe":
        return _clahe_op(cfg)
    if "dither" in t:
        return _dither_op(t, cfg)
    if t == "maxrgb":
        return lambda gen, x: D.max_rgb(x)
    if t == "camera":
        gain = tuple(map(float, cfg.get("rg_range") or (1.2, 2.4)))
        bg = tuple(map(float, cfg.get("bg_range") or (1.2, 2.4)))
        xyz = str(cfg.get("xyz_arr", "D50"))
        return lambda gen, x: D.camera_noise(x, D.draw_camera_noise(
            gen, x.shape, gain_range=gain, bg_range=bg), xyz_arr=xyz)
    if t == "superpixels":
        n_seg = int(cfg.get("n_segments", 200))
        return lambda gen, x: superpixel_structure(
            x, draw_superpixel_structure(gen, x.shape[0]), n_segments=n_seg)
    # the JAX package's last resort: gaussian noise at its defaults
    return lambda gen, x: D.gaussian_noise(x, D.draw_gaussian_noise(
        gen, x.shape))


def _noise_stage(types: Sequence[str], cfgs: Dict[str, dict], prob: float,
                 weights=None, atten: Optional[dict] = None,
                 cycle: int = 1) -> Callable:
    """Per-sample choice among noise types, each applied with its config's
    ``p``. With ``atten`` the residual of each op is scaled per sample by
    the attenuation v and low-passed towards a 3x3 binomial blur with
    strength 1 - v, renormalised so that its power stays the calibrated
    one: the reference's final antialiased downscale both shrinks and
    correlates noise that was injected on a larger canvas."""
    raw = [str(t).lower() for t in types] or ["gaussian"]
    types = [t if (t in _DEVICE_NOISE or "dither" in t or "quantize" in t)
             else "gaussian" for t in raw]
    ops = [_noise_op(t, _cfg_for(cfgs, t, cycle)) for t in types]
    op_ps = [float(_cfg_for(cfgs, t, cycle).get("p", 0.5)) for t in types]

    def fn(gen, x, att=None):
        b = x.shape[0]
        v = None
        if atten is not None:
            if att is not None:
                v = att[1] if atten.get("chain_cfg") else att[0]
            else:
                v = _bcast(_atten_factor(
                    gen, b, atten.get("res_cfg") or {},
                    int(atten.get("scale", 4)),
                    atten.get("res_types") or (),
                    chain_cfg=atten.get("chain_cfg")))

        def gated(op, p):
            y = op(gen, x)
            if v is not None:
                res = (y - x).float()
                c = (1.0 - v).clamp(0.0, 1.0)
                res_c = res + c * (_blur3(res) - res)
                s0 = torch.sqrt(res.square().mean(dim=(1, 2, 3),
                                                  keepdim=True) + 1e-12)
                s1 = torch.sqrt(res_c.square().mean(dim=(1, 2, 3),
                                                    keepdim=True) + 1e-12)
                y = x + (v * res_c * (s0 / s1)).to(x.dtype)
            if p >= 1.0:
                return y
            miss = D._uniform(gen, (b,)) >= p
            return torch.where(_bcast(miss), x, y)

        cands = [gated(op, p) for op, p in zip(ops, op_ps)]
        if len(cands) == 1:
            return cands[0]
        return D.select(cands, D.draw_choice(gen, b, len(cands), weights))

    fn._wants_att = atten is not None
    return _with_prob(fn, prob)


def _q8(x: torch.Tensor) -> torch.Tensor:
    """The uint8 wire between stages: the reference's transforms hand
    uint8 images to one another, so every stage's output lies on the 1/255
    lattice."""
    return torch.round(x.clamp(0.0, 1.0) * 255.0) * (1.0 / 255.0)


def _mid(o: int, f: float) -> int:
    """Intermediate size o * f, nudged off the sizes whose ratio to ``o``
    is an integer (a double resample through those is artificially
    clean)."""
    m = max(min(int(round(o * f)), 8 * o), 4)
    if m % o == 0 or o % max(m, 1) == 0:
        m += max(o // 10, 1)
    return m


def _resize_stage(types: Sequence[int], out_hw_fn, prob: float = 1.0,
                  down_up_types: Optional[Sequence[int]] = None,
                  weights=None, res_cfg: Optional[dict] = None,
                  scale: int = 4, in_over_out: Optional[float] = None,
                  chain_cfg: Optional[dict] = None,
                  post_cfg: Optional[dict] = None) -> Callable:
    """Per-sample choice among resize types at the static target size.
    Codes: 997 nearest aligned, 998 down_up, the rest plain kernels.

    With ``res_cfg`` the plain candidate emulates the reference's random
    intermediate size X by a bucketed double resample: X / out snaps to the
    log-nearest of a set of factors below and above the target size, each
    bucket resizes in -> X -> out with per-sample algorithms, and the
    bucket is chosen per sample from the reference's own branch
    distribution. Slot 0 is the direct single resample (X at the input
    size). The same holds for the second resize on the LR canvas
    (``in_over_out`` 1), whose ratio composes with the first stage's
    (``chain_cfg``). ``post_cfg`` (the second resize's config, given to
    the first) reroutes keep-draws through the 0.75 * in/out bucket and
    up-draws through a triple up-mid-down composite with the second
    resize's own down probability."""
    algos = _int_types(types)
    down_up_mode = any(t == 998 for t in algos)
    aligned = any(t in (995, 997) for t in algos)
    # 996 and 999 (the kernel pool, which BatchDegrader puts in place of
    # the whole stage when it has one) are left out of the plain list
    plain = [t for t in algos if t not in (995, 996, 997, 998, 999)]
    if not plain and not (down_up_mode or aligned):
        plain = [777]
    du_algos = _int_types(down_up_types or (773, 777)) or [773, 777]
    if in_over_out is None:
        in_over_out = float(scale)
    if in_over_out > 1.0:
        buckets = (0.6, 0.8, 1.25, 1.5, 2.0, 0.75 * in_over_out,
                   1.125 * in_over_out)
    else:
        # on the LR canvas only a sub-LR X2 loses anything more, plus a
        # mild 1.2 softening bucket
        buckets = (0.5, 0.7, 0.85, 1.2)
    reroute = post_cfg is not None and in_over_out > 1.0

    def rand_resize(gen, x, out_hw, algs):
        return D.random_resize(
            x, out_hw, algs, D.draw_resize_choice(gen, x.shape[0], algs))

    def plain_cand(gen, x, out_hw):
        direct = rand_resize(gen, x, out_hw, plain)
        if res_cfg is None:
            return direct
        b = x.shape[0]
        ratio = _size_ratio(draw_size_ratio(gen, b, res_cfg, in_over_out),
                            res_cfg, in_over_out)
        if chain_cfg is not None:
            sc = float(chain_cfg.get("_scale", scale))
            ratio = ratio * _size_ratio(
                draw_size_ratio(gen, b, chain_cfg, sc), chain_cfg, sc)
        if in_over_out <= 1.0:
            ratio = torch.where(ratio >= 1.35, torch.ones_like(ratio), ratio)
        facs = device_constant((max(in_over_out, 1.0),) + tuple(buckets),
                               torch.float32, x.device)
        idx = (ratio.log()[:, None] - facs.log()[None, :]).abs().argmin(
            dim=1)
        if reroute:
            pr = dict(post_cfg.get("resize_prob") or {"down": 1.0})
            p_dn = float(pr.get("down", 1.0)) / max(
                sum(float(v) for v in pr.values()), 1e-8)
            coin = D._uniform(gen, (b,)) < p_dn
            idx = torch.where((idx == 0) & coin,
                              torch.full_like(idx, len(buckets) - 1), idx)
            idx = torch.where((idx == len(buckets)) & coin,
                              torch.full_like(idx, len(buckets) + 1), idx)
        cands = [direct]
        for f in buckets:
            mid_hw = (_mid(out_hw[0], f), _mid(out_hw[1], f))
            if mid_hw == tuple(out_hw):
                mid_hw = (out_hw[0] + (1 if f > 1 else -1),
                          max(out_hw[1] + (1 if f > 1 else -1), 4))
            y = rand_resize(gen, x, mid_hw, plain)
            cands.append(rand_resize(gen, y, out_hw, plain))
        if reroute:
            up_hw = (_mid(out_hw[0], 1.125 * in_over_out),
                     _mid(out_hw[1], 1.125 * in_over_out))
            dn_hw = (_mid(out_hw[0], 0.75 * in_over_out),
                     _mid(out_hw[1], 0.75 * in_over_out))
            y = rand_resize(gen, x, up_hw, plain)
            y = rand_resize(gen, y, dn_hw, plain)
            cands.append(rand_resize(gen, y, out_hw, plain))
        return D.select(cands, idx)

    def down_up(gen, x):
        b = x.shape[0]
        return D.down_up(x, (D.draw_resize_choice(gen, b, du_algos),
                             D.draw_resize_choice(gen, b, du_algos)),
                         scale_range=(1.0, 2.0), algos=du_algos)

    def fn(gen, x):
        out_hw = tuple(out_hw_fn(x.shape))
        cands: List[torch.Tensor] = []
        if plain:
            cands.append(plain_cand(gen, x, out_hw))
        if aligned:
            s = x.shape[1] // out_hw[0]
            if s > 1 and x.shape[1] % out_hw[0] == 0:
                cands.append(D.nearest_aligned_downscale(x, s))
            else:
                cands.append(D.resize_batch(x, out_hw, 0))
        if down_up_mode:
            if out_hw == tuple(x.shape[1:3]):
                cands.append(down_up(gen, x))
            else:
                # a milder downscale with a down_up algorithm, then the
                # extra resample round trip
                cands.append(down_up(gen, rand_resize(gen, x, out_hw,
                                                      du_algos)))
        if len(cands) == 1:
            return cands[0]
        # the plain candidate carries as many slots as it has kernels
        w = ([float(len(plain))] if plain else [])
        w += [1.0] * (len(cands) - len(w))
        return D.select(cands, D.draw_choice(gen, x.shape[0], len(cands), w))

    return _with_prob(fn, prob)


def _stack_plan(plan) -> np.ndarray:
    idx, inv, act_a, act_b = plan
    return np.stack([idx, inv, act_a.astype(np.int32),
                     act_b.astype(np.int32)])


def split_plan(dev: torch.Tensor):
    """A plan's (4, k, npad) int32 device tensor -> (idx, inv, act_a,
    act_b), the last two as bool."""
    return dev[0], dev[1], dev[2].bool(), dev[3].bool()


class PlanBuffer:
    """The static device buffer of a graphed routed program's plans, at one
    (k, npad): each plan is copied in through two pinned host buffers used
    in turn, and a host buffer is written again only once its last copy has
    ended (its event), so the host never overwrites a plan in flight."""

    def __init__(self, shape, device: torch.device):
        self.dev = torch.empty((4, *shape), dtype=torch.int32, device=device)
        pin = device.type == "cuda"
        self._host = [torch.empty(self.dev.shape, dtype=torch.int32,
                                  pin_memory=pin) for _ in range(2)]
        self._done = [None, None]
        self._turn = 0

    def upload(self, plan):
        """Copies ``plan`` (idx, inv, act_a, act_b) into ``dev``, without
        blocking the host on the card; returns ``split_plan(dev)``."""
        i, self._turn = self._turn, self._turn ^ 1
        if self._done[i] is not None:
            self._done[i].synchronize()
        self._host[i].numpy()[...] = _stack_plan(plan)
        self.dev.copy_(self._host[i], non_blocking=True)
        if self.dev.is_cuda:
            self._done[i] = torch.cuda.Event()
            self._done[i].record()
        return split_plan(self.dev)


def plan_to_device(plan, device: torch.device):
    """A routing plan's (idx, inv, act_a, act_b) -> int32 and bool tensors
    on ``device``, by one copy (from pinned memory, not blocking, on the
    card)."""
    host = torch.from_numpy(_stack_plan(plan))
    if device.type == "cuda":
        host = host.pin_memory()
    return split_plan(host.to(device, non_blocking=device.type == "cuda"))


# ---------------------------------------------------------------------------
# the batch degrader
# ---------------------------------------------------------------------------


class BatchDegrader:
    """Dataset options -> batched degradation function. Call with
    ``(gen, images)``: NHWC images, uint8 or float in [0, 1], on the
    device of the ``torch.Generator`` ``gen``; gives the degraded f32
    images on the 1/255 lattice.

    kind 'lr' includes the in-pipeline downscale to 1 / scale; kind 'hr'
    keeps the size."""

    ORDER = ["blur", "resize", "noise", "compression", "auto_levels",
             "unsharp", "fringes", "blur2", "resize2", "noise2"]

    def __init__(self, dataset_opt: dict, kind: str = "lr",
                 params: Optional[dict] = None):
        self.opt = dataset_opt
        self.kind = kind
        self.scale = int(dataset_opt.get("scale", 1) or 1)
        if params is None:
            lr_p, hr_p = get_unpaired_params(dataset_opt)
            params = lr_p if kind == "lr" else hr_p
        self.params = p = params or {}
        cfgs = dataset_opt.get("aug_configs") or {}
        self.shuffle = bool(p.get("random_shuffle"))

        # the realistic assets, read once on the host (numpy banks, the
        # JAX package's bit for bit) and put on a device at first use
        self.kernel_bank = load_kernel_pool(
            dataset_opt.get("dataroot_kernels") or "")
        noise_types = (p.get("noise") or {}).get("types") or []
        self.patch_bank = None
        if any(str(t).lower() == "patches" for t in noise_types) and \
                dataset_opt.get("noise_data"):
            lr_size = int(dataset_opt.get("crop_size", 128) or 128) // \
                max(self.scale, 1)
            self.patch_bank = load_noise_patches(
                dataset_opt["noise_data"], patch_size=max(lr_size, 16))
        self._banks: Dict[tuple, torch.Tensor] = {}

        # one attenuation config for every stage after the resize
        self._att_cfg = {"res_cfg": cfgs.get("resize") or {},
                         "scale": self.scale,
                         "res_types": (p.get("resize") or {}
                                       ).get("types") or (),
                         "chain_cfg2": (cfgs.get("resize2")
                                        if "resize2" in p else None)} \
            if "resize" in p else None
        stages: List[Tuple[str, object]] = []
        for name in self.ORDER:
            if name not in p:
                continue
            conf = p[name]
            cyc = 2 if name.endswith("2") else 1
            if name in ("blur", "blur2"):
                bfn = _blur_stage(conf["types"], cfgs, conf["prob"],
                                  weights=conf.get("weights"), cycle=cyc)
                if name == "blur2" and self._att_cfg is not None:
                    # blur2 runs on the X1 canvas in the reference; the
                    # final snap shrinks its kernel by X1 / LR (linear v)
                    stages.append((name, {
                        "no": bfn,
                        "att": _att_wrap(bfn, self._att_cfg, square=False)}))
                else:
                    stages.append((name, bfn))
            elif name in ("noise", "noise2", "compression"):
                types = conf["types"] or (["jpeg"] if name == "compression"
                                          else [])
                if any(str(t).lower() == "patches" for t in types) and \
                        self.patch_bank is not None:
                    # the whole stage: a real-noise patch per sample
                    stages.append((name, _with_prob(self._patches_stage,
                                                    conf["prob"])))
                    continue
                plain_fn = _noise_stage(types, cfgs, conf["prob"],
                                        weights=conf.get("weights"),
                                        cycle=cyc)
                if "resize" in p:
                    # after the in-pipeline resize the reference injects
                    # the noise on an intermediate canvas and the final
                    # downscale attenuates it; before it, the real
                    # downscale does
                    att_cfg = dict(self._att_cfg)
                    if name == "noise2" and "resize2" in p:
                        att_cfg["chain_cfg"] = cfgs.get("resize2") or {}
                    stages.append((name, {
                        "no": plain_fn,
                        "att": _noise_stage(types, cfgs, conf["prob"],
                                            weights=conf.get("weights"),
                                            atten=att_cfg, cycle=cyc)}))
                else:
                    stages.append((name, plain_fn))
            elif name in ("resize", "resize2"):
                if kind != "lr":
                    continue
                if name == "resize":
                    s = self.scale
                    out_fn = (lambda shape, s=s:
                              (shape[1] // s, shape[2] // s))
                else:
                    out_fn = lambda shape: (shape[1], shape[2])  # noqa: E731
                if name == "resize" and self.kernel_bank is not None and \
                        any(t == 999 for t in conf["types"]):
                    # the pool replaces the whole stage, the other types
                    # of the list too
                    stages.append((name, self._pool_stage))
                    continue
                stages.append((name, _resize_stage(
                    conf["types"], out_fn, conf["prob"],
                    down_up_types=dataset_opt.get("down_up_types"),
                    weights=conf.get("weights"),
                    # the bucketed intermediate size only where the stage
                    # has a config of its own
                    res_cfg=cfgs.get(name), scale=self.scale,
                    in_over_out=(float(self.scale) if name == "resize"
                                 else 1.0),
                    chain_cfg=(dict(cfgs.get("resize") or {},
                                    _scale=self.scale)
                               if name == "resize2" else None),
                    post_cfg=(cfgs.get("resize2")
                              if name == "resize" and "resize2" in p
                              else None))))
            elif name == "auto_levels":
                stages.append((name, _with_prob(
                    lambda gen, x: D.auto_levels(x), conf["prob"])))
            elif name in ("unsharp", "fringes"):
                fn = _with_prob(self._unsharp if name == "unsharp"
                                else self._fringes, conf["prob"])
                stages.append((name, fn if self._att_cfg is None else {
                    "no": fn,
                    "att": _att_wrap(fn, self._att_cfg, square=True)}))
        self.stages = stages

        # the finals: [final_scale + final_blur] and [final_compression],
        # in an order drawn per sample
        resize_finals: List[Tuple[str, Callable]] = []
        comp_finals: List[Tuple[str, Callable]] = []
        if "final_scale" in p and kind == "lr":
            resize_finals.append(("final_scale", _resize_stage(
                p["final_scale"]["types"],
                lambda shape: (shape[1], shape[2]),
                weights=p["final_scale"].get("weights"))))
            if "final_blur" in p:
                fb = p["final_blur"]
                types = [t for t in fb["types"] if isinstance(t, str)] \
                    or ["sinc"]
                resize_finals.append(("final_blur", _blur_stage(
                    types, cfgs, fb["prob"])))
        if "final_compression" in p:
            fc_types = [t for t in p["final_compression"]["types"]
                        if isinstance(t, str)] or ["jpeg"]
            comp_finals.append(("final_compression", _noise_stage(
                fc_types, cfgs, p["final_compression"]["prob"])))
        self.finals = resize_finals + comp_finals
        self._resize_finals = resize_finals
        self._comp_finals = comp_finals
        self._programs: Dict[str, Callable] = {}
        self._plan_rng: Optional[np.random.Generator] = None

    @property
    def is_noop(self) -> bool:
        return not self.stages and not self.finals

    def _bank(self, name: str, device) -> torch.Tensor:
        """``kernel_bank`` or ``patch_bank`` on ``device``, copied there
        once (at the first, eager call; a capture then finds it)."""
        key = (name, str(device))
        if key not in self._banks:
            self._banks[key] = torch.from_numpy(getattr(self, name)).to(
                device)
        return self._banks[key]

    def _pool_stage(self, gen, x):
        """The first resize by the kernel pool: each sample blurred by a
        pool kernel of its own on the input canvas, then subsampled to the
        LR size."""
        bank = self._bank("kernel_bank", x.device)
        return apply_kernel_pool(
            x, bank, draw_kernel_pool(gen, x.shape[0], bank.shape[0]),
            self.scale)

    def _patches_stage(self, gen, x):
        bank = self._bank("patch_bank", x.device)
        return apply_noise_patches(
            x, bank, draw_noise_patches(gen, x.shape[0], bank.shape[0]))

    @staticmethod
    def _unsharp(gen, x):
        return D.unsharp_mask(x, D.draw_unsharp_mask(gen, x.shape[0]))

    @staticmethod
    def _fringes(gen, x):
        return D.fringes(x, D.draw_fringes(gen, x.shape[0]))

    def _finals(self, gen, x):
        """The finals: both orders of [final_scale + final_blur] and
        [final_compression] are computed (each with draws of its own) and
        a per-sample coin picks one."""
        res_f, comp_f = self._resize_finals, self._comp_finals

        def seg(fns, xx):
            for _, fn in fns:
                xx = _q8(fn(gen, xx))
            return xx

        if res_f and comp_f:
            y_a = seg(res_f, seg(comp_f, x))
            y_b = seg(comp_f, seg(res_f, x))
            coin = D._uniform(gen, (x.shape[0],)) < 0.5
            return torch.where(_bcast(coin), y_a, y_b)
        if res_f or comp_f:
            return seg(res_f or comp_f, x)
        return x

    def _build(self) -> Callable:
        """The fixed-order program: the stages in ``ORDER``, those after
        the resize in their attenuated variant, then the finals."""
        names = [n for n, _ in self.stages]
        res_idx = names.index("resize") if "resize" in names else -1
        stages = []
        for i, (n, fn) in enumerate(self.stages):
            if isinstance(fn, dict):
                fn = fn["att"] if (res_idx >= 0 and i > res_idx) \
                    else fn["no"]
            stages.append((n, fn))
        att_cfg = self._att_cfg

        def run(gen, x):
            x = wire_to_f01(x)
            att = _draw_att_pair(gen, x.shape[0], att_cfg) \
                if att_cfg is not None else None
            for _, fn in stages:
                x = _q8(fn(gen, x, att=att)
                        if getattr(fn, "_wants_att", False) else fn(gen, x))
            return _q8(self._finals(gen, x))

        return run

    def _shuffled(self):
        """(the stages to shuffle, the resize stage or None). The resize
        splits each sample's order into the phase on the input canvas and
        the phase after it."""
        boundary = next((i for i, (n, _) in enumerate(self.stages)
                         if n == "resize"), None)
        perm = [(n, fn) for i, (n, fn) in enumerate(self.stages)
                if i != boundary]
        resize_fn = self.stages[boundary][1] if boundary is not None \
            else None
        return perm, resize_fn

    def _variant(self, name: str, fn, att: bool) -> Callable:
        """A stage's form for the phase it runs in: blur2 and the noise
        stages carry their own {no, att} pair; stage-1 blur is wrapped
        (linear attenuation) when a sample's order puts it after the
        resize."""
        if isinstance(fn, dict):
            return fn["att" if att else "no"]
        if att and self._att_cfg is not None and name == "blur":
            return _att_wrap(fn, self._att_cfg, square=False)
        return fn

    def _build_persample(self) -> Callable:
        """The per-sample shuffle by candidate select. Each sample's order
        of [stages..., resize] is a uniform random permutation, drawn as
        iid uniform scores: the stages that score below the resize form its
        phase on the input canvas, the rest its phase after the resize.
        Each phase runs as m slots; at slot j every stage computes its
        candidate on the whole batch and each sample keeps the one of its
        own stage for that slot (itself once its phase is over), so the
        device runs 2 m^2 stages per batch. ``run(gen, x, scores=None)``
        takes the (b, m + 1) scores from a caller that has them."""
        perm, resize_fn = self._shuffled()
        m = len(perm)
        att_cfg = self._att_cfg

        def phase_exec(gen, x, order, count, att: bool, att_pair=None):
            # order: (b, m) stage index per slot; count: (b,) phase length
            for j in range(m):
                cands = []
                for n, fn in perm:
                    vfn = self._variant(n, fn, att)
                    cands.append(vfn(gen, x, att=att_pair)
                                 if getattr(vfn, "_wants_att", False)
                                 else vfn(gen, x))
                stack = torch.stack([x] + cands, dim=1)
                idx = torch.where(j < count, order[:, j] + 1,
                                  torch.zeros_like(order[:, j]))
                x = _q8(torch.take_along_dim(
                    stack, idx.reshape(-1, 1, 1, 1, 1), dim=1)[:, 0])
            return x

        def run(gen, x, scores: Optional[torch.Tensor] = None):
            x = wire_to_f01(x)
            b = x.shape[0]
            att_pair = _draw_att_pair(gen, b, att_cfg) \
                if att_cfg is not None else None
            if m and resize_fn is not None:
                if scores is None:
                    scores = D._uniform(gen, (b, m + 1))
                hr_mask = scores[:, :m] < scores[:, m:]
                inf = torch.full_like(scores[:, :m], math.inf)
                hr_order = torch.argsort(
                    torch.where(hr_mask, scores[:, :m], inf), dim=1,
                    stable=True)
                lr_order = torch.argsort(
                    torch.where(hr_mask, inf, scores[:, :m]), dim=1,
                    stable=True)
                hr_count = hr_mask.sum(dim=1)
                x = phase_exec(gen, x, hr_order, hr_count, att=False)
                x = _q8(resize_fn(gen, x))
                x = phase_exec(gen, x, lr_order, m - hr_count, att=True,
                               att_pair=att_pair)
            elif m:
                # no size boundary: one uniform permutation per sample
                if scores is None:
                    scores = D._uniform(gen, (b, m))
                order = torch.argsort(scores, dim=1, stable=True)
                x = phase_exec(gen, x, order,
                               torch.full((b,), m, device=x.device),
                               att=False)
            elif resize_fn is not None:
                x = _q8(resize_fn(gen, x))
            return _q8(self._finals(gen, x))

        return run

    def _routing_plan(self, seed, b: int):
        """The host half of the routed program: per-sample orders as rows
        of random Latin squares, so that at every slot each symbol is held
        by exactly npad / k samples. That is what lets the device run each
        stage once per slot, on a static q-slice, instead of running every
        stage on the whole batch as a candidate.

        Symbols 0..m-1 are the shuffled stages, symbol m (when there is a
        resize) the resize. A square's rows are sigma o shift_g o tau with
        sigma and tau fresh uniform permutations, so each sample's order is
        uniform over all k! permutations, as with a shuffle per sample; the
        k samples of one square never share a symbol at a slot. ``seed`` is
        a ``numpy.random.Generator`` (the stream of plans) or a seed.

        Returns (idx, inv, act_a, act_b, npad):
          idx (k, npad) int32: the gather order of each slot; positions
              [i q, (i + 1) q) hold the samples whose symbol at slot j is i
          inv (k, npad) int32: its inverse permutation
          act_a, act_b (k, npad) bool: in gathered order, whether a sample
              is still before its resize (the pass on the input canvas) or
              already after it (the pass on the LR canvas)."""
        m = len(self.stages) - (1 if any(n == "resize" for n, _ in
                                         self.stages) else 0)
        has_res = any(n == "resize" for n, _ in self.stages)
        k = m + (1 if has_res else 0)
        q = -(-b // k)
        npad = q * k
        rng = seed if isinstance(seed, np.random.Generator) \
            else np.random.default_rng(seed)
        perms = np.empty((npad, k), np.int64)
        for sq in range(q):
            sigma = rng.permutation(k)
            tau = rng.permutation(k)
            g = np.arange(k)
            perms[sq * k:(sq + 1) * k] = sigma[(g[:, None] + tau[None, :])
                                               % k]
        perms = perms[rng.permutation(npad)]
        if has_res:
            resize_pos = np.argmax(perms == m, axis=1)
        else:
            resize_pos = np.full(npad, k, np.int64)  # all before a resize
        idx = np.empty((k, npad), np.int32)
        inv = np.empty((k, npad), np.int32)
        for j in range(k):
            order = np.argsort(perms[:, j], kind="stable")
            idx[j] = order
            inv[j, order] = np.arange(npad, dtype=np.int32)
        js = np.arange(k)[:, None]
        act_a = resize_pos[idx] > js
        act_b = resize_pos[idx] < js
        return idx, inv, act_a, act_b, npad

    def _build_routing(self) -> Callable:
        """The routed per-sample shuffle: the orders of ``_routing_plan``,
        each stage run once per slot on the q samples routed to it (2 m
        full-batch stage runs per batch, against 2 m^2 for candidate
        select). The batch is padded to npad by repeating its samples, and
        cut back after the passes. ``run(gen, x, idx, inv, act_a, act_b)``
        takes the plan as device tensors."""
        perm, resize_fn = self._shuffled()
        m = len(perm)
        k = m + (1 if resize_fn is not None else 0)
        att_cfg = self._att_cfg

        def run_pass(gen, x, idx, inv, act, att: bool, att_pair):
            q = x.shape[0] // k
            for j in range(k):
                xg = x[idx[j]]
                ag = None if att_pair is None else tuple(
                    a[idx[j]] for a in att_pair)
                parts = []
                for i, (n, fn) in enumerate(perm):
                    vfn = self._variant(n, fn, att)
                    seg = xg[i * q:(i + 1) * q]
                    if getattr(vfn, "_wants_att", False):
                        a_seg = None if ag is None else tuple(
                            a[i * q:(i + 1) * q] for a in ag)
                        y = vfn(gen, seg, att=a_seg)
                    else:
                        y = vfn(gen, seg)
                    keep = act[j, i * q:(i + 1) * q]
                    parts.append(torch.where(_bcast(keep), _q8(y), seg))
                if resize_fn is not None:
                    parts.append(xg[m * q:])  # the resize's group idles
                x = torch.cat(parts, dim=0)[inv[j]]
            return x

        def run(gen, x, idx, inv, act_a, act_b):
            x = wire_to_f01(x)
            b = x.shape[0]
            npad = idx.shape[1]
            if npad > b:
                x = x.repeat(-(-npad // b), 1, 1, 1)[:npad]
            x = _q8(x)
            att_pair = _draw_att_pair(gen, npad, att_cfg) \
                if att_cfg is not None else None
            x = run_pass(gen, x, idx, inv, act_a, att=False, att_pair=None)
            if resize_fn is not None:
                x = _q8(resize_fn(gen, x))
                x = run_pass(gen, x, idx, inv, act_b, att=True,
                             att_pair=att_pair)
            return _q8(self._finals(gen, x[:b]))

        return run

    def program(self) -> Tuple[str, Callable]:
        """(name, program) of these options: ``routing`` (the per-sample
        shuffle, by default), ``persample`` (under
        ``TRAINNER_SHUFFLE_ROUTING=0``) or ``fixed``; built at first use."""
        if self.shuffle and len(self.stages) > 1:
            if os.environ.get("TRAINNER_SHUFFLE_ROUTING", "1") != "0":
                if "routing" not in self._programs:
                    self._programs["routing"] = self._build_routing()
                    # the host stream of plans, apart from ``gen``: a plan
                    # drawn on the device would have to be read back
                    # before the program could be issued
                    self._plan_rng = np.random.default_rng(
                        np.random.SeedSequence(PLAN_SEED))
                return "routing", self._programs["routing"]
            name, build = "persample", self._build_persample
        else:
            name, build = "fixed", self._build
        if name not in self._programs:
            self._programs[name] = build()
        return name, self._programs[name]

    def next_plan(self, b: int):
        """The host half of the routed program: the next plan (idx, inv,
        act_a, act_b) of the plan stream for a batch of b; None for the
        other programs."""
        if self.is_noop or self.program()[0] != "routing":
            return None
        return self._routing_plan(self._plan_rng, b)[:4]

    @torch.no_grad()
    def run(self, gen: torch.Generator, images: torch.Tensor, plan=None
            ) -> torch.Tensor:
        """The device half: the program on ``images``, with the routed
        program's plan as device tensors (``plan_to_device``). Reads
        nothing back to the host, so a graph can capture it."""
        if self.is_noop:
            return images
        if gen.device.type != images.device.type:
            raise ValueError(f"the generator lies on {gen.device}, the "
                             f"images on {images.device}")
        name, prog = self.program()
        with _full_f32():
            if name == "routing":
                return prog(gen, images, *plan)
            return prog(gen, images)

    def __call__(self, gen: torch.Generator, images: torch.Tensor
                 ) -> torch.Tensor:
        plan = self.next_plan(int(images.shape[0]))
        if plan is not None:
            plan = plan_to_device(plan, images.device)
        return self.run(gen, images, plan)
