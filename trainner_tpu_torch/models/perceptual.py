"""VGG feature extractor for the perceptual loss: counterpart of
``trainner_tpu/models/perceptual.py`` (``vgg_layer_names:35``,
``canonical_layer:44``, ``VGGFeatures:58``, ``load_vgg_npz:104``). The
ResNet-101 and MINC extractors are not ported yet (ROADMAP Queue A 10.7).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# number of convs per block (torchvision layout)
VGG_CFGS = {
    "vgg11": (1, 1, 2, 2, 2),
    "vgg13": (2, 2, 2, 2, 2),
    "vgg16": (2, 2, 3, 3, 3),
    "vgg19": (2, 2, 4, 4, 4),
}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg_layer_names(arch: str = "vgg19") -> List[str]:
    names = []
    for b, n in enumerate(VGG_CFGS[arch], start=1):
        names += [f"conv{b}_{c}" for c in range(1, n + 1)] + [f"pool{b}"]
    return names


def canonical_layer(name: str) -> str:
    """'conv_3_2' / 'conv3_2' / 'conv32' -> 'conv3_2'; 'relu3_2' ->
    'relu:conv3_2' (the post-activation tap)."""
    n = name.lower().replace("-", "_")
    relu = n.startswith("relu")
    n = n.replace("relu", "conv").replace("conv_", "conv")
    if "_" not in n[4:]:
        digits = [ch for ch in n if ch.isdigit()]
        if len(digits) == 2:
            n = f"conv{digits[0]}_{digits[1]}"
    return ("relu:" if relu else "") + n


class VGGFeatures(nn.Module):
    """VGG conv stack that returns the activations at the ``listen``
    layers ('conv5_4' before the ReLU, 'relu:conv5_4' after it) as f32
    NHWC, and stops after the deepest one.

    Takes NHWC in [0, 1] (or [-1, 1] with ``z_norm``). The ImageNet input
    normalisation runs in f32 before the cast to ``dtype``; parameters
    stay f32 and each conv runs in ``dtype``. Convs are named
    ``conv{b}_{c}`` as in the JAX module."""

    def __init__(self, arch: str = "vgg19",
                 listen: Sequence[str] = ("conv5_4",),
                 use_input_norm: bool = True, z_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.arch, self.dtype = arch, dtype
        self.wanted = {canonical_layer(name) for name in listen}
        self.use_input_norm, self.z_norm = use_input_norm, z_norm
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN))
        self.register_buffer("std", torch.tensor(IMAGENET_STD))
        cin = 3
        for b, n_convs in enumerate(VGG_CFGS[arch], start=1):
            cout = 64 * min(2 ** (b - 1), 8)
            for c in range(1, n_convs + 1):
                setattr(self, f"conv{b}_{c}", nn.Conv2d(cin, cout, 3,
                                                        padding=1))
                cin = cout

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights (LeCun normal, zero biases, the flax default)
        for runs without a pretrained file."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_in = m.weight[0].numel()
                    m.weight.normal_(0.0, fan_in ** -0.5,
                                     generator=generator)
                    m.bias.zero_()

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = x.float()
        if self.z_norm:
            x = (x + 1.0) / 2.0
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        deepest = max((name.split("conv")[-1] for name in self.wanted),
                      default="5_4")
        out: Dict[str, torch.Tensor] = {}

        def tap(key, t):
            if key in self.wanted:
                out[key] = t.permute(0, 2, 3, 1).float()

        for b, n_convs in enumerate(VGG_CFGS[self.arch], start=1):
            for c in range(1, n_convs + 1):
                name = f"conv{b}_{c}"
                conv = getattr(self, name)
                x = F.conv2d(x, conv.weight.to(x.dtype),
                             conv.bias.to(x.dtype), padding=1)
                tap(name, x)
                x = F.relu(x)
                tap(f"relu:{name}", x)
            if b < 5:
                x = F.max_pool2d(x, 2, stride=2)
            if len(out) == len(self.wanted) and f"{b}" >= deepest[0]:
                break
        return out


def load_vgg_npz(path: str) -> Dict[str, torch.Tensor]:
    """Converted torchvision VGG weights ('conv{b}_{c}/kernel' in HWIO and
    'conv{b}_{c}/bias') -> a state_dict for ``VGGFeatures``."""
    data = np.load(path)
    sd = {}
    for key in data.files:
        layer, leaf = key.split("/")
        arr = np.asarray(data[key], np.float32)
        if leaf == "kernel":
            sd[f"{layer}.weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
        else:
            sd[f"{layer}.bias"] = torch.from_numpy(arr.copy())
    return sd
