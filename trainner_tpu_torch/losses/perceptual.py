"""VGG perceptual loss: counterpart of ``trainner_tpu/losses/
perceptual.py::PerceptualLoss:31`` for the feature path on a VGG
extractor. The gram-matrix style loss, the ResNet-101 and MINC extractors
and LPIPS are not ported yet (ROADMAP Queue A 10.7)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.perceptual import VGGFeatures, canonical_layer, load_vgg_npz
from .basic import get_pixel_criterion

DEFAULT_LAYER_WEIGHTS = {"conv5_4": 1.0}  # the classic ESRGAN feature layer


class PerceptualLoss(torch.nn.Module):
    """Feature-space loss over a frozen VGG extractor: the sum over the
    listened layers of weight * criterion(features(sr), features(hr)), with
    no gradient through the target's features.

    Without ``weights_path`` the extractor keeps random weights drawn from
    ``seed``, as the JAX package falls back to a random VGG: usable for
    smoke runs and parity tests, not for training to quality."""

    def __init__(self, layer_weights: Optional[Dict[str, float]] = None,
                 criterion: str = "l1", arch: str = "vgg19",
                 use_input_norm: bool = True, z_norm: bool = False,
                 style: bool = False, weights_path: Optional[str] = None,
                 perceptual_weight: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 7):
        super().__init__()
        arch = (arch or "vgg19").lower()
        if not arch.startswith("vgg") or style:
            raise NotImplementedError(
                f"perceptual loss on [{arch}]{' with style' if style else ''}"
                " is not ported yet (ROADMAP Queue A 10.7, the other "
                "losses)")
        self.layer_weights = {
            canonical_layer(k): float(v)
            for k, v in (layer_weights or DEFAULT_LAYER_WEIGHTS).items()}
        self.perceptual_weight = perceptual_weight
        self.model = VGGFeatures(arch=arch, listen=tuple(self.layer_weights),
                                 use_input_norm=use_input_norm,
                                 z_norm=z_norm, dtype=dtype)
        if weights_path:
            self.model.load_state_dict(load_vgg_npz(weights_path),
                                       strict=False)
        else:
            self.model.init_weights(torch.Generator().manual_seed(seed))
        self.model.requires_grad_(False)
        self._crit = get_pixel_criterion(criterion)

    def features(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.model(x)

    def forward(self, sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
        f_sr = self.features(sr)
        with torch.no_grad():
            f_hr = self.features(hr)
        total = 0.0
        for name, w in self.layer_weights.items():
            total = total + w * self._crit(f_sr[name], f_hr[name]) \
                * self.perceptual_weight
        return total
