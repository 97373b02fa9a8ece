"""Perceptual losses: counterpart of ``trainner_tpu/losses/perceptual.py``
(``gram_matrix:22``, ``PerceptualLoss:31``, ``LPIPS:117``): the feature
loss over a VGG (any listened layers), ResNet-101 or MINC extractor, its
gram-matrix style form, and LPIPS as a training loss on VGG16 features."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..models.perceptual import (MINCFeatures, ResNet101Features,
                                 VGGFeatures, canonical_layer, load_vgg_npz)
from .basic import get_pixel_criterion
from .lpips import bundled_lin_path

DEFAULT_LAYER_WEIGHTS = {"conv5_4": 1.0}  # the classic ESRGAN feature layer


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """(b, h, w, c) -> (b, c, c), divided by h w c."""
    b, h, w, c = feat.shape
    f = feat.reshape(b, h * w, c)
    return torch.bmm(f.transpose(1, 2), f) / (h * w * c)


class PerceptualLoss(torch.nn.Module):
    """Feature-space loss over a frozen extractor: the sum over the
    listened layers of weight * criterion(features(sr), features(hr)) (of
    their gram matrices with ``style``), with no gradient through the
    target's features.

    ``arch`` 'vgg*' listens at ``layer_weights``; 'resnet*' (ResNet-101)
    and 'minc*' give one tap, 'feat', with weight 1, as the JAX package
    does, and run on their random weights whatever ``weights_path`` says.
    Without ``weights_path`` a VGG keeps random weights drawn from
    ``seed``, as the JAX package falls back to a random VGG: usable for
    smoke runs and parity tests, not for training to quality."""

    def __init__(self, layer_weights: Optional[Dict[str, float]] = None,
                 criterion: str = "l1", arch: str = "vgg19",
                 use_input_norm: bool = True, z_norm: bool = False,
                 style: bool = False, weights_path: Optional[str] = None,
                 perceptual_weight: float = 1.0, style_weight: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 7):
        super().__init__()
        arch = (arch or "vgg19").lower()
        self.style = style
        self.perceptual_weight, self.style_weight = \
            perceptual_weight, style_weight
        self._single_tap = arch.startswith(("resnet", "minc"))
        if arch.startswith("resnet"):
            self.model = ResNet101Features(use_input_norm=use_input_norm,
                                           z_norm=z_norm, dtype=dtype)
        elif arch.startswith("minc"):
            self.model = MINCFeatures(dtype=dtype)
        else:
            self.model = VGGFeatures(
                arch=arch, listen=tuple(
                    canonical_layer(k)
                    for k in (layer_weights or DEFAULT_LAYER_WEIGHTS)),
                use_input_norm=use_input_norm, z_norm=z_norm, dtype=dtype)
        if self._single_tap:
            self.layer_weights = {"feat": 1.0}
        else:
            self.layer_weights = {
                canonical_layer(k): float(v)
                for k, v in (layer_weights or DEFAULT_LAYER_WEIGHTS).items()}
        if weights_path and not self._single_tap:
            self.model.load_state_dict(load_vgg_npz(weights_path),
                                       strict=False)
        else:
            self.model.init_weights(torch.Generator().manual_seed(seed))
        self.model.requires_grad_(False)
        self._crit = get_pixel_criterion(criterion)

    def features(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self._single_tap:
            return {"feat": self.model(x).float()}
        return self.model(x)

    def forward(self, sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
        f_sr = self.features(sr)
        with torch.no_grad():
            f_hr = self.features(hr)
        total = 0.0
        for name, w in self.layer_weights.items():
            a, b = f_sr[name], f_hr[name]
            if self.style:
                total = total + w * self._crit(
                    gram_matrix(a), gram_matrix(b)) * self.style_weight
            else:
                total = total + w * self._crit(a, b) * self.perceptual_weight
        return total


class LPIPS(torch.nn.Module):
    """LPIPS as a training loss: VGG16 ReLU taps (ImageNet input
    normalisation, f32), each normalised to unit length over its channels
    (eps 1e-10), the squared difference weighted by the bundled calibrated
    vgg lin vectors (no ReLU) and summed over channels, averaged over the
    batch and the image, summed over the taps (a plain mean where no lin
    vector is bundled).

    ``weights_path`` is a converted VGG file. A VGG19 file is read as the
    JAX package reads it: each VGG16 conv takes the file's conv of its
    name (their shapes agree), and conv3_4, conv4_4 and conv5_4 are left
    unused."""

    LAYERS = ("relu:conv1_2", "relu:conv2_2", "relu:conv3_3",
              "relu:conv4_3", "relu:conv5_3")

    def __init__(self, weights_path: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 11):
        super().__init__()
        self.model = VGGFeatures(arch="vgg16", listen=self.LAYERS,
                                 use_input_norm=True, dtype=dtype)
        if weights_path:
            self.model.load_state_dict(load_vgg_npz(weights_path),
                                       strict=False)
        else:
            self.model.init_weights(torch.Generator().manual_seed(seed))
        self.model.requires_grad_(False)
        lin_path = bundled_lin_path("vgg")
        self.n_lin = 0
        if lin_path:
            data = np.load(lin_path)
            self.n_lin = len(self.LAYERS)
            for i in range(self.n_lin):
                self.register_buffer(f"lin{i}", torch.from_numpy(
                    np.asarray(data[f"lin{i}"], np.float32).copy()))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx, fy = self.model(x), self.model(y)
        total = 0.0
        for i, name in enumerate(self.LAYERS):
            a = fx[name] / (torch.linalg.vector_norm(
                fx[name], dim=-1, keepdim=True) + 1e-10)
            b = fy[name] / (torch.linalg.vector_norm(
                fy[name], dim=-1, keepdim=True) + 1e-10)
            d = (a - b) ** 2
            if i < self.n_lin:
                total = total + (d * getattr(self, f"lin{i}")).sum(-1).mean()
            else:
                total = total + d.mean()
        return total
