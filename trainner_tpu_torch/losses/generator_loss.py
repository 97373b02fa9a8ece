"""GeneratorLoss: the option-driven stack of weighted losses. Counterpart
of ``trainner_tpu/losses/generator_loss.py`` (``LossEntry:46``,
``build_loss_list:89``, ``GeneratorLoss:231``) for the pixel and the VGG
feature entries. Every other entry raises and names its ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .basic import get_pixel_criterion

# option key that switches an unported loss on -> what it is
_NOT_PORTED = {
    "cx_weight": "contextual loss", "lpips_weight": "LPIPS",
    "hfen_weight": "HFEN", "grad_weight": "gradient loss",
    "tv_weight": "total variation", "ssim_weight": "SSIM loss",
    "spl_weight": "SPL", "of_weight": "overflow loss",
    "range_weight": "range loss", "fft_weight": "FFT loss",
    "color_weight": "color loss", "avg_weight": "average loss",
    "ms_weight": "multiscale pixel loss", "fdpl_weight": "FDPL",
}


@dataclass
class LossEntry:
    name: str        # log key, e.g. 'l_g_pix'
    tag: str         # selector tag, e.g. 'pix'
    weight: float
    fn: Callable     # (sr, hr) -> unweighted scalar


def build_loss_list(train_opt: dict,
                    vgg_weights_path: Optional[str] = None,
                    device_dtype: torch.dtype = torch.bfloat16
                    ) -> List[LossEntry]:
    """The loss list from the train options, in the JAX package's order."""
    t = train_opt
    for key, what in _NOT_PORTED.items():
        if t.get(key):
            raise NotImplementedError(
                f"{what} ({key}) is not ported yet (ROADMAP Queue A 10.7, "
                "the other losses)")
    entries: List[LossEntry] = []
    if t.get("pixel_weight") and t.get("pixel_criterion"):
        entries.append(LossEntry(
            "l_g_pix", "pix", float(t["pixel_weight"]),
            get_pixel_criterion(t["pixel_criterion"])))
    if t.get("feature_weight") and t.get("feature_criterion"):
        from .perceptual import PerceptualLoss

        ploss = PerceptualLoss(
            layer_weights=t.get("feature_layers") or {"conv5_4": 1.0},
            criterion=t["feature_criterion"],
            arch=str(t.get("feature_network", "vgg19")),
            weights_path=vgg_weights_path, dtype=device_dtype)
        entries.append(LossEntry("l_g_fea", "fea",
                                 float(t["feature_weight"]), ploss))
    return entries


class GeneratorLoss(torch.nn.Module):
    """(sr, hr) -> (total, logs): the weighted sum of the entries, and each
    weighted value under its log key. Losses run in f32 on f32 images; the
    feature network's body runs in ``device_dtype``."""

    def __init__(self, opt: dict,
                 device_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        train_opt = opt.get("train") or {}
        vgg_path = (opt.get("path") or {}).get("vgg_weights")
        self.entries = build_loss_list(train_opt, vgg_weights_path=vgg_path,
                                       device_dtype=device_dtype)
        self.nets = torch.nn.ModuleList(
            [e.fn for e in self.entries if isinstance(e.fn, torch.nn.Module)])

    def forward(self, sr: torch.Tensor, hr: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logs: Dict[str, torch.Tensor] = {}
        sr32, hr32 = sr.float(), hr.float()
        total = sr32.new_zeros(())
        for e in self.entries:
            weighted = e.weight * e.fn(sr32, hr32)
            logs[e.name] = weighted
            total = total + weighted
        return total, logs
