"""Assembly of the on-device degradation pipeline.

Counterpart of ``trainner_tpu/data/pipeline.py`` for the fixed-order
program of a blind-SR train dataset: ``_collect:77``,
``get_unpaired_params:107``, ``_with_prob:136``, ``_cfg_for:151``,
``_blur_stage:159``, ``_atten_factor:264``, ``_atten_ratio:288``,
``_draw_att_pair:319``, ``_att_wrap:341``, ``_blur3:370``,
``_noise_stage:387``, ``_size_ratio:576``, ``_q8:605``,
``_resize_stage:613`` and ``BatchDegrader:792`` with ``_build:1266``.

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

Not ported yet, each raising with its ROADMAP item: the per-sample shuffle
of the stage order (``shuffle_degradations``), kernel pools and noise
patches, and every blur, noise and filter type outside the bsrgan preset.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops import degradations as D
from ..ops.blocks import wire_to_f01

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

SHUFFLE_ITEM = "ROADMAP Queue A 5.1, the per-sample shuffle of the stages"


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

_OTHER_BLURS = ("sinc", "motion", "complexmotion", "complex_motion",
                "average", "box", "median", "bilateral")
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


def _blur_stage(types: Sequence[str], cfgs: Dict[str, dict], prob: float,
                weights=None, cycle: int = 1) -> Callable:
    """Per-sample choice of a blur type, each with its own kernel bank
    padded to one size; a type applies with its config's ``p`` (a miss
    puts the delta kernel in its place); one ``apply_kernels`` call blurs
    the batch."""
    types = [str(t).lower() for t in types] or ["gaussian"]
    for t in types:
        if t in _OTHER_BLURS:
            raise D.not_ported(f"blur type [{t}]")

    def fn(gen, x):
        b = x.shape[0]
        banks, probs = [], []
        for t in types:
            cfg = _cfg_for(cfgs, t, cycle)
            k = int(cfg.get("kernel_size", 21))
            mk = int(cfg.get("min_kernel_size", 1) or 1)
            probs.append(float(cfg.get("p", 0.5)))
            if t in ("iso", "gaussian"):
                sx = cfg.get("sigmaX") or [0.1, 2.8]
                params = D.draw_gaussian_kernels(
                    gen, b, k, tuple(map(float, sx)), iso_prob=1.0,
                    min_size=mk)
            elif t == "aniso":
                sx = cfg.get("sigmaX") or [0.5, 8.0]
                sy = cfg.get("sigmaY") or sx
                ang = cfg.get("angle")
                params = D.draw_gaussian_kernels(
                    gen, b, k, tuple(map(float, sx)), iso_prob=0.0,
                    sigma_y_range=tuple(map(float, sy)), min_size=mk,
                    angle_range=tuple(math.radians(float(a)) for a in ang)
                    if ang else None)
            else:
                params = D.draw_gaussian_kernels(gen, b, k, (0.2, 3.0))
            banks.append(D.gaussian_kernels(params, k))
        kmax = max(kk.shape[-1] for kk in banks)
        delta = torch.zeros((1, kmax, kmax), device=x.device)
        delta[0, kmax // 2, kmax // 2] = 1.0
        banks = [F.pad(kk, ((kmax - kk.shape[-1]) // 2,) * 4)
                 for kk in banks]
        if any(p < 1.0 for p in probs):
            u = D._uniform(gen, (b, len(banks), 1, 1))
            banks = [torch.where(u[:, i] < p, kk, delta)
                     for i, (kk, p) in enumerate(zip(banks, probs))]
        choice = D.draw_choice(gen, b, len(banks), weights) \
            if len(banks) > 1 else None
        return D.apply_kernels(x, D.select(banks, choice))

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
    k1 = torch.tensor([0.25, 0.5, 0.25], dtype=x.dtype, device=x.device)
    y = x.permute(0, 3, 1, 2)
    y = F.conv2d(y, k1.reshape(1, 1, 3, 1).repeat(c, 1, 1, 1),
                 padding=(1, 0), groups=c)
    y = F.conv2d(y, k1.reshape(1, 1, 1, 3).repeat(c, 1, 1, 1),
                 padding=(0, 1), groups=c)
    return y.permute(0, 2, 3, 1)


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
    if t == "jpeg":
        qr = (float(cfg.get("min_quality", 30)),
              float(cfg.get("max_quality", 95)))
        return lambda gen, x: D.jpeg_compress(
            x, D.draw_jpeg_quality(gen, x.shape[0], qr))
    if t == "camera":
        gain = tuple(map(float, cfg.get("rg_range") or (1.2, 2.4)))
        bg = tuple(map(float, cfg.get("bg_range") or (1.2, 2.4)))
        xyz = str(cfg.get("xyz_arr", "D50"))
        return lambda gen, x: D.camera_noise(x, D.draw_camera_noise(
            gen, x.shape, gain_range=gain, bg_range=bg), xyz_arr=xyz)
    raise D.not_ported(f"noise type [{t}]")


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
    if any(t in (996, 999) for t in algos):
        raise D.not_ported("resize code 999 (realistic kernels)")
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
        facs = torch.tensor((max(in_over_out, 1.0),) + buckets,
                            device=x.device)
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
        if p.get("random_shuffle"):
            raise NotImplementedError(
                "shuffle_degradations (a stage order drawn per sample) is "
                f"not ported yet ({SHUFFLE_ITEM}); give "
                "shuffle_degradations: false for the fixed order")
        if dataset_opt.get("dataroot_kernels"):
            raise D.not_ported("the kernel pool of dataroot_kernels")
        for name in ("auto_levels", "unsharp", "fringes", "final_blur"):
            if name in p:
                raise D.not_ported(f"the {name} stage")

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
                if any(str(t).lower() == "patches" for t in types):
                    raise D.not_ported("noise patches")
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
        self.stages = stages

        # the finals: [final_scale] and [final_compression], in an order
        # drawn per sample
        resize_finals: List[Tuple[str, Callable]] = []
        comp_finals: List[Tuple[str, Callable]] = []
        if "final_scale" in p and kind == "lr":
            resize_finals.append(("final_scale", _resize_stage(
                p["final_scale"]["types"],
                lambda shape: (shape[1], shape[2]),
                weights=p["final_scale"].get("weights"))))
        if "final_compression" in p:
            fc_types = [t for t in p["final_compression"]["types"]
                        if isinstance(t, str)] or ["jpeg"]
            comp_finals.append(("final_compression", _noise_stage(
                fc_types, cfgs, p["final_compression"]["prob"])))
        self.finals = resize_finals + comp_finals
        self._resize_finals = resize_finals
        self._comp_finals = comp_finals
        self._program: Optional[Callable] = None

    @property
    def is_noop(self) -> bool:
        return not self.stages and not self.finals

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
        res_f, comp_f = self._resize_finals, self._comp_finals
        att_cfg = self._att_cfg

        def seg(fns, gen, x):
            for _, fn in fns:
                x = _q8(fn(gen, x))
            return x

        def run(gen, x):
            x = wire_to_f01(x)
            att = _draw_att_pair(gen, x.shape[0], att_cfg) \
                if att_cfg is not None else None
            for _, fn in stages:
                x = _q8(fn(gen, x, att=att)
                        if getattr(fn, "_wants_att", False) else fn(gen, x))
            if res_f and comp_f:
                # both orders are computed (each with draws of its own)
                # and a per-sample coin picks one
                y_a = seg(res_f, gen, seg(comp_f, gen, x))
                y_b = seg(comp_f, gen, seg(res_f, gen, x))
                coin = D._uniform(gen, (x.shape[0],)) < 0.5
                x = torch.where(_bcast(coin), y_a, y_b)
            elif res_f or comp_f:
                x = seg(res_f or comp_f, gen, x)
            return _q8(x)

        return run

    @torch.no_grad()
    def __call__(self, gen: torch.Generator, images: torch.Tensor
                 ) -> torch.Tensor:
        if self.is_noop:
            return images
        if gen.device.type != images.device.type:
            raise ValueError(f"the generator lies on {gen.device}, the "
                             f"images on {images.device}")
        if self._program is None:
            self._program = self._build()
        with _full_f32():
            return self._program(gen, images)
