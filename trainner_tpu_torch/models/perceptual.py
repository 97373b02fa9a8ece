"""Feature extractors of the perceptual, contextual and LPIPS losses:
counterpart of
``trainner_tpu/models/perceptual.py`` (``vgg_layer_names:35``,
``canonical_layer:44``, ``VGGFeatures:58``, ``load_vgg_npz:104``,
``ResNet101Features:118``, ``MINCFeatures:177``). Every module keeps
flax's layer names, which ``utils/torch_interop.py`` maps one to one.
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
    'relu:conv3_2' (the post-activation tap). A name already in this form
    stays as it is: the JAX package's copy turns 'relu:conv3_2' into
    'relu:conv:conv3_2', so that ``VGGFeatures``, which canonicalises its
    ``listen`` again, never finds a ReLU tap there (its LPIPS loss raises
    KeyError; ROADMAP C 18)."""
    if name.startswith("relu:"):
        return "relu:" + canonical_layer(name[len("relu:"):])
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


def _lecun_normal_(net: nn.Module, generator: torch.Generator) -> None:
    """Every conv's weight from N(0, 1/fan_in), its bias 0 (the flax
    default init; the draws are the port's own)."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()


class _FrozenBatchNorm(nn.Module):
    """flax's ``BatchNorm`` with ``use_running_average``: ``weight`` and
    ``bias`` (flax's scale and bias) and the running statistics, applied in
    f32 whatever the input's type, eps 1e-5."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x.float() - self.running_mean[None, :, None, None])
                * mul[None, :, None, None]
                + self.bias[None, :, None, None]).to(x.dtype)


class ResNet101Features(nn.Module):
    """ResNet-101's stem and its first three bottleneck stages (3, 4 and 23
    blocks, the stride in each stage's first 3x3 conv), its batch norms on
    their running statistics: NHWC in [0, 1] (or [-1, 1] with ``z_norm``)
    -> the (b, h/16, w/16, 1024) map in ``dtype``.

    Names as flax gives them: ``conv1``, ``bn1``, the convs
    ``layer{s}_{r}_{c1,c2,c3,proj}`` and the block norms ``BatchNorm_{k}``
    numbered in call order (c1, c2, c3, then proj)."""

    PLAN = ((64, 256, 3, 1), (128, 512, 4, 2), (256, 1024, 23, 2))

    def __init__(self, use_input_norm: bool = True, z_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_input_norm, self.z_norm, self.dtype = \
            use_input_norm, z_norm, dtype
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN))
        self.register_buffer("std", torch.tensor(IMAGENET_STD))
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _FrozenBatchNorm(64)
        self.blocks = []
        cin, k = 64, 0
        for si, (mid, out, reps, stride) in enumerate(self.PLAN, start=1):
            for r in range(reps):
                name, s = f"layer{si}_{r}", stride if r == 0 else 1
                convs = [(f"{name}_c1", nn.Conv2d(cin, mid, 1, bias=False)),
                         (f"{name}_c2", nn.Conv2d(mid, mid, 3, stride=s,
                                                  padding=1, bias=False)),
                         (f"{name}_c3", nn.Conv2d(mid, out, 1, bias=False))]
                if cin != out or s != 1:
                    convs.append((f"{name}_proj",
                                  nn.Conv2d(cin, out, 1, stride=s,
                                            bias=False)))
                block = []
                for conv_name, conv in convs:
                    setattr(self, conv_name, conv)
                    setattr(self, f"BatchNorm_{k}", _FrozenBatchNorm(
                        conv.out_channels))
                    block.append((conv_name, f"BatchNorm_{k}"))
                    k += 1
                self.blocks.append(block)
                cin = out

    def init_weights(self, generator: torch.Generator) -> None:
        _lecun_normal_(self, generator)

    def _conv_bn(self, x, conv_name, bn_name):
        conv = getattr(self, conv_name)
        y = F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                     conv.padding)
        return getattr(self, bn_name)(y)

    def forward(self, x, train: bool = False) -> torch.Tensor:
        if train:
            raise ValueError("ResNet101Features runs on its running "
                             "statistics only (train=False)")
        x = x.float()
        if self.z_norm:
            x = (x + 1.0) / 2.0
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = F.relu(self._conv_bn(x, "conv1", "bn1"))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for block in self.blocks:
            h = F.relu(self._conv_bn(x, *block[0]))
            h = F.relu(self._conv_bn(h, *block[1]))
            h = self._conv_bn(h, *block[2])
            if len(block) == 4:
                x = self._conv_bn(x, *block[3])
            x = F.relu(x + h)
        return x.permute(0, 2, 3, 1)


class MINCFeatures(nn.Module):
    """MINC's VGG16 conv stack up to conv5_3 (no input normalisation, a
    ReLU after every conv but the last, 2x2 max pooling after blocks 1-4):
    NHWC -> the (b, h/16, w/16, 512) map in ``dtype``. Its first two
    blocks' convs are named ``conv11``, ``conv12``, ``conv21``, ``conv22``,
    the later ones ``conv3_1`` and so on, as in flax."""

    PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.names = []
        cin = 3
        for b, (f, n) in enumerate(self.PLAN, start=1):
            for c in range(1, n + 1):
                name = f"conv{b}{c}" if b <= 2 else f"conv{b}_{c}"
                setattr(self, name, nn.Conv2d(cin, f, 3, padding=1))
                self.names.append(name)
                cin = f

    def init_weights(self, generator: torch.Generator) -> None:
        _lecun_normal_(self, generator)

    def forward(self, x, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        i = 0
        for b, (_, n) in enumerate(self.PLAN, start=1):
            for c in range(1, n + 1):
                conv = getattr(self, self.names[i])
                x = F.conv2d(x, conv.weight.to(x.dtype),
                             conv.bias.to(x.dtype), padding=1)
                if not (b == 5 and c == n):
                    x = F.relu(x)
                i += 1
            if b < 5:
                x = F.max_pool2d(x, 2, stride=2)
        return x.permute(0, 2, 3, 1)
