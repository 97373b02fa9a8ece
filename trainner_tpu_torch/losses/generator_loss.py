"""GeneratorLoss: the option-driven stack of weighted losses. Counterpart
of ``trainner_tpu/losses/generator_loss.py`` (``_SELECTOR_TAGS:31``,
``LossEntry:46``, ``_dct_matrix:55``, ``fdpl_loss:65``,
``build_loss_list:89``, ``filter_selectors:220``, ``GeneratorLoss:231``):
every entry of the JAX package, in its order, gated as it gates them.

Every loss runs in f32 on f32 images; only the feature networks' bodies
run in ``device_dtype``, so every entry is "precise" and the flag is kept
for the logs' parity only.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import basic, regularizers as reg
from .basic import get_pixel_criterion
from .ssim import ms_ssim_loss, ssim_loss
from ..utils.graphs import device_constant

# selector tags of the PPON phases and WBC representations
_SELECTOR_TAGS = {
    "pix": ("pix",), "pixel": ("pix",),
    "fea": ("fea", "cx", "lpips"), "feature": ("fea", "cx", "lpips"),
    "cx": ("cx",), "contextual": ("cx",),
    "hfen": ("hfen",), "grad": ("grad",), "tv": ("tv",),
    "ssim": ("ssim",), "ms-ssim": ("ssim",),
    "pix-multiscale": ("ms",), "multiscale": ("ms",),
    "spl": ("spl",), "gpl": ("spl",), "cpl": ("spl",),
    "fft": ("fft",), "of": ("of",), "range": ("range",),
    "color": ("color",), "avg": ("avg",), "fdpl": ("fdpl",),
    "lpips": ("lpips",),
}

# entries that see the low-pass images under frequency separation
FS_TAGS = ("pix", "ms", "avg", "color", "tv")


@dataclass
class LossEntry:
    name: str        # log key, e.g. 'l_g_pix'
    tag: str         # selector tag, e.g. 'pix'
    weight: float
    fn: Callable     # (sr, hr) -> unweighted scalar; (sr) without a target
    needs_target: bool = True
    precise: bool = False


def _dct_matrix(n: int = 8) -> np.ndarray:
    m = np.zeros((n, n), np.float64)
    for k in range(n):
        for i in range(n):
            m[k, i] = np.cos(np.pi * k * (2 * i + 1) / (2 * n))
    m[0] *= np.sqrt(1.0 / n)
    m[1:] *= np.sqrt(2.0 / n)
    return m.astype(np.float32)


def fdpl_loss(x: torch.Tensor, y: torch.Tensor,
              weights: Optional[np.ndarray] = None) -> torch.Tensor:
    """Frequency-domain perceptual loss: the mean squared difference of
    the 8x8 blockwise DCT coefficients (H and W cut to multiples of 8),
    each frequency times ``weights`` (8, 8) when given."""
    d = device_constant(_dct_matrix(8).tolist(), torch.float32, x.device)

    def block_dct(img):
        b, h, w, c = img.shape
        hh, ww = h // 8 * 8, w // 8 * 8
        img = img[:, :hh, :ww, :].reshape(b, hh // 8, 8, ww // 8, 8, c)
        return torch.einsum("ku,bhuwvc,lv->bhkwlc", d, img, d)

    err = (block_dct(x) - block_dct(y)) ** 2
    if weights is not None:
        wt = device_constant(np.asarray(weights, np.float32).tolist(),
                             torch.float32, x.device)
        err = err * wt.reshape(1, 1, 8, 1, 8, 1)
    return err.mean()


def _tv(sr, hr=None, tv_type: str = "tv", p: int = 1):
    return reg.tv_loss(sr, tv_type, p)


def _overflow(sr, hr=None):
    return reg.overflow_loss(sr)


def _range(sr, hr=None):
    return reg.range_loss(sr)


def build_loss_list(train_opt: dict, allow_featnets: bool = True,
                    vgg_weights_path: Optional[str] = None,
                    device_dtype: torch.dtype = torch.bfloat16
                    ) -> List[LossEntry]:
    """The loss list from the train options, in the JAX package's order.
    ``allow_featnets=False`` leaves out the losses on feature networks."""
    t = train_opt
    entries: List[LossEntry] = []

    def w(key):
        return float(t[key])

    if t.get("pixel_weight") and t.get("pixel_criterion"):
        entries.append(LossEntry("l_g_pix", "pix", w("pixel_weight"),
                                 get_pixel_criterion(t["pixel_criterion"])))

    if allow_featnets and t.get("feature_weight") \
            and t.get("feature_criterion"):
        from .perceptual import PerceptualLoss

        ploss = PerceptualLoss(
            layer_weights=t.get("feature_layers") or {"conv5_4": 1.0},
            criterion=t["feature_criterion"],
            arch=str(t.get("feature_network", "vgg19")),
            weights_path=vgg_weights_path, dtype=device_dtype)
        entries.append(LossEntry("l_g_fea", "fea", w("feature_weight"),
                                 ploss))

    if allow_featnets and t.get("cx_weight") and t.get("cx_type"):
        from .contextual import ContextualLoss

        cx = ContextualLoss(
            layers_weights=dict(t.get("cx_vgg_layers")
                                or {"conv_3_2": 1, "conv_4_2": 1}),
            weights_path=vgg_weights_path, dtype=device_dtype)
        entries.append(LossEntry("l_g_cx", "cx", w("cx_weight"), cx))

    if allow_featnets and t.get("lpips_weight"):
        from .lpips import LPIPSWeightsMissing, _missing_msg
        from .perceptual import LPIPS

        if vgg_weights_path is None:
            # an lpips loss on random VGG features is no loss at all
            raise LPIPSWeightsMissing(_missing_msg("vgg"))
        entries.append(LossEntry("l_g_lpips", "lpips", w("lpips_weight"),
                                 LPIPS(weights_path=vgg_weights_path)))

    if t.get("hfen_weight") and t.get("hfen_criterion"):
        entries.append(LossEntry(
            "l_g_HFEN", "hfen", w("hfen_weight"),
            partial(reg.hfen,
                    criterion=get_pixel_criterion(t["hfen_criterion"])),
            precise=True))

    if t.get("grad_weight") and t.get("grad_type"):
        # 'grad-2d-l1', 'grad-4d-l2', ...
        parts = str(t["grad_type"]).split("-")
        crit_name = parts[-1] if parts[-1] not in ("2d", "4d", "grad") \
            else "l1"
        entries.append(LossEntry(
            "l_g_grad", "grad", w("grad_weight"),
            partial(reg.gradient_loss,
                    criterion=get_pixel_criterion(crit_name),
                    four_d="4d" in parts), precise=True))

    if t.get("tv_weight") and t.get("tv_type"):
        tv_type = "dtv" if str(t["tv_type"]).lower() in ("4d", "dtv") \
            else "tv"
        entries.append(LossEntry(
            "l_g_tv", "tv", w("tv_weight"),
            partial(_tv, tv_type=tv_type, p=int(t.get("tv_norm") or 1)),
            needs_target=False))

    if t.get("ssim_weight") and t.get("ssim_type"):
        fn = ms_ssim_loss if "ms" in str(t["ssim_type"]).lower() \
            else ssim_loss
        entries.append(LossEntry("l_g_ssim", "ssim", w("ssim_weight"), fn,
                                 precise=True))

    if t.get("spl_weight") and t.get("spl_type"):
        fn = {"gpl": reg.gp_loss, "cpl": reg.cp_loss}.get(
            str(t["spl_type"]).lower(), reg.spl_loss)
        entries.append(LossEntry("l_g_spl", "spl", w("spl_weight"), fn))

    if t.get("of_weight") and t.get("of_type"):
        entries.append(LossEntry("l_g_of", "of", w("of_weight"), _overflow,
                                 needs_target=False, precise=True))

    if t.get("range_weight"):
        entries.append(LossEntry("l_g_range", "range", w("range_weight"),
                                 _range, needs_target=False, precise=True))

    if t.get("fft_weight") and t.get("fft_type"):
        entries.append(LossEntry("l_g_fft", "fft", w("fft_weight"),
                                 reg.fft_loss, precise=True))

    if t.get("color_weight") and t.get("color_criterion"):
        crit = get_pixel_criterion(
            str(t["color_criterion"]).replace("color-", ""))
        entries.append(LossEntry("l_g_color", "color", w("color_weight"),
                                 partial(reg.color_loss, criterion=crit),
                                 precise=True))

    if t.get("avg_weight") and t.get("avg_criterion"):
        crit = get_pixel_criterion(
            str(t["avg_criterion"]).replace("avg-", ""))
        entries.append(LossEntry("l_g_avg", "avg", w("avg_weight"),
                                 partial(reg.average_loss, criterion=crit),
                                 precise=True))

    if t.get("ms_weight") and t.get("ms_criterion"):
        base = get_pixel_criterion(
            str(t["ms_criterion"]).replace("multiscale-", ""))
        entries.append(LossEntry("l_g_ms", "ms", w("ms_weight"),
                                 partial(basic.multiscale_pixel, base=base)))

    if t.get("fdpl_weight") and t.get("fdpl_type"):
        weights = np.load(t["fdpl_weights_path"]) \
            if t.get("fdpl_weights_path") else None
        entries.append(LossEntry("l_g_fdpl", "fdpl", w("fdpl_weight"),
                                 partial(fdpl_loss, weights=weights),
                                 precise=True))
    return entries


def filter_selectors(entries: List[LossEntry],
                     selectors: Optional[Sequence[str]]) -> List[LossEntry]:
    """The entries whose tag one of ``selectors`` names (all without)."""
    if not selectors:
        return entries
    allowed = set()
    for s in selectors:
        allowed.update(_SELECTOR_TAGS.get(str(s).lower(), (str(s).lower(),)))
    return [e for e in entries if e.tag in allowed]


class GeneratorLoss(torch.nn.Module):
    """(sr, hr, selectors=None, f_low=None) -> (total, logs): the weighted
    sum of the entries (those ``selectors`` names), and each weighted
    value under its log key. With ``f_low`` the entries of ``FS_TAGS``
    see the low-pass images f_low(sr), f_low(hr), the others the
    originals. Losses run in f32 on f32 images; the feature networks'
    bodies run in ``device_dtype``."""

    def __init__(self, opt: dict, allow_featnets: bool = True,
                 device_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        train_opt = opt.get("train") or {}
        vgg_path = (opt.get("path") or {}).get("vgg_weights")
        self.entries = build_loss_list(
            train_opt, allow_featnets=allow_featnets,
            vgg_weights_path=vgg_path, device_dtype=device_dtype)
        self.nets = torch.nn.ModuleList(
            [e.fn for e in self.entries if isinstance(e.fn, torch.nn.Module)])

    def forward(self, sr: torch.Tensor, hr: Optional[torch.Tensor],
                selectors: Optional[Sequence[str]] = None,
                f_low: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logs: Dict[str, torch.Tensor] = {}
        sr32 = sr.float()
        hr32 = hr.float() if hr is not None else None
        lf_sr = f_low(sr32) if f_low is not None else sr32
        lf_hr = f_low(hr32) if f_low is not None and hr32 is not None \
            else hr32
        total = sr32.new_zeros(())
        for e in filter_selectors(self.entries, selectors):
            low = f_low is not None and e.tag in FS_TAGS
            a, b = (lf_sr, lf_hr) if low else (sr32, hr32)
            weighted = e.weight * (e.fn(a, b) if e.needs_target else e.fn(a))
            logs[e.name] = weighted
            total = total + weighted
        return total, logs
