"""LPIPS, the learned perceptual distance, as the validation metric:
counterpart of ``trainner_tpu/losses/lpips.py`` (``_max_pool_ceil:48``,
``SqueezeFeatures:60``, ``AlexFeatures:100``, ``VGG16Features:128``,
``LPIPS:157``, ``bundled_lin_path:193``, ``find_lpips_weights:200``,
``load_lpips_npz:210``, ``LPIPSWeightsMissing:232``, ``LPIPSMetric:249``).

A fixed backbone (squeeze, alex or vgg) gives feature taps; each is
normalised to unit length over its channels, the squared difference is
weighted by a learned per-channel vector (``lin{i}``, through a ReLU) and
averaged over the image, and the taps are summed. Convs keep flax's names.

Weights: the calibrated ``lin`` vectors are read from the files the JAX
package bundles (``trainner_tpu/losses/weights/lpips_lin_{net}.npz``; the
port reads them there and keeps no copy). Backbone weights are not in the
repository: they come from ``weights_path``, ``$TRAINNER_LPIPS_WEIGHTS`` or
the file ``lpips_{net}.npz`` dropped in that same directory, written by
``scripts/convert_torch_model.py lpips-full``. Without them the metric
refuses to run (``LPIPSWeightsMissing``); ``allow_random`` (for tests only)
draws a random backbone instead.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

# channels of each tap, per backbone
LPIPS_TAPS = {
    "squeeze": (64, 128, 256, 384, 384, 512, 512),
    "alex": (64, 192, 384, 256, 256),
    "vgg": (64, 128, 256, 512, 512),
}

# input scaling of the LPIPS nets (after the map to [-1, 1])
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

_WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "trainner_tpu", "losses", "weights")


def _max_pool_ceil(x: torch.Tensor, window: int = 3,
                   stride: int = 2) -> torch.Tensor:
    """Max pooling of NCHW with partial windows at the right and bottom
    counted (MaxPool2d's ceil_mode, as the JAX package writes it: -inf
    padding up to the next whole stride)."""
    h, w = x.shape[2], x.shape[3]
    ph = (-(h - window) % stride) if h > window else 0
    pw = (-(w - window) % stride) if w > window else 0
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


class _Backbone(nn.Module):
    """A stack of ``nn.Conv2d`` named as flax names them; ``conv(name, x,
    ...)`` runs one with its ReLU."""

    def _add(self, name: str, cin: int, cout: int, k: int, stride: int = 1,
             padding: int = 0) -> int:
        setattr(self, name, nn.Conv2d(cin, cout, k, stride, padding))
        return cout

    def conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.relu(getattr(self, name)(x))


class SqueezeFeatures(_Backbone):
    """SqueezeNet 1.1's seven taps."""

    FIRES = ((16, 64), (16, 64), (32, 128), (32, 128), (48, 192), (48, 192),
             (64, 256), (64, 256))

    def __init__(self):
        super().__init__()
        cin = self._add("conv1", 3, 64, 3, stride=2)
        for i, (s, e) in enumerate(self.FIRES, start=1):
            self._add(f"fire{i}_s", cin, s, 1)
            self._add(f"fire{i}_e1", s, e, 1)
            self._add(f"fire{i}_e3", s, e, 3, padding=1)
            cin = 2 * e

    def _fire(self, x, i):
        s = self.conv(f"fire{i}_s", x)
        return torch.cat([self.conv(f"fire{i}_e1", s),
                          self.conv(f"fire{i}_e3", s)], 1)

    def forward(self, x) -> List[torch.Tensor]:
        taps = [self.conv("conv1", x)]
        x = self._fire(self._fire(_max_pool_ceil(taps[-1]), 1), 2)
        taps.append(x)
        x = self._fire(self._fire(_max_pool_ceil(x), 3), 4)
        taps.append(x)
        x = _max_pool_ceil(x)
        for i in (5, 6, 7, 8):
            x = self._fire(x, i)
            taps.append(x)
        return taps


class AlexFeatures(_Backbone):
    """AlexNet's five taps."""

    def __init__(self):
        super().__init__()
        self._add("conv1", 3, 64, 11, stride=4, padding=2)
        self._add("conv2", 64, 192, 5, padding=2)
        self._add("conv3", 192, 384, 3, padding=1)
        self._add("conv4", 384, 256, 3, padding=1)
        self._add("conv5", 256, 256, 3, padding=1)

    def forward(self, x) -> List[torch.Tensor]:
        taps = [self.conv("conv1", x)]
        taps.append(self.conv("conv2", F.max_pool2d(taps[-1], 3, 2)))
        taps.append(self.conv("conv3", F.max_pool2d(taps[-1], 3, 2)))
        taps.append(self.conv("conv4", taps[-1]))
        taps.append(self.conv("conv5", taps[-1]))
        return taps


class VGG16Features(_Backbone):
    """VGG16's ReLU taps relu1_2 .. relu5_3."""

    PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

    def __init__(self):
        super().__init__()
        cin = 3
        for b, (f, n) in enumerate(self.PLAN, start=1):
            for c in range(1, n + 1):
                cin = self._add(f"conv{b}_{c}", cin, f, 3, padding=1)

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        for b, (_, n) in enumerate(self.PLAN, start=1):
            for c in range(1, n + 1):
                x = self.conv(f"conv{b}_{c}", x)
            taps.append(x)
            if b < 5:
                x = F.max_pool2d(x, 2, 2)
        return taps


_BACKBONES = {"squeeze": SqueezeFeatures, "alex": AlexFeatures,
              "vgg": VGG16Features}


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt((x ** 2).sum(1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """d(x, y) for NHWC images in [0, 1]: (b,) distances. The state_dict
    holds ``net.<conv>.weight|bias`` and ``lin{i}``."""

    def __init__(self, net: str = "squeeze"):
        super().__init__()
        self.net = _BACKBONES[net]()
        self.n_taps = len(LPIPS_TAPS[net])
        for i, c in enumerate(LPIPS_TAPS[net]):
            self.register_buffer(f"lin{i}", torch.ones(c))
        self.register_buffer("shift", torch.tensor(_SHIFT))
        self.register_buffer("scale", torch.tensor(_SCALE))

    def init_weights(self, generator: torch.Generator) -> None:
        """A random backbone (N(0, 1/fan_in), zero biases; the draws are
        the port's own) and lin vectors of ones, the flax init."""
        with torch.no_grad():
            for m in self.net.modules():
                if isinstance(m, nn.Conv2d):
                    m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                                     generator=generator)
                    m.bias.zero_()
            for i in range(self.n_taps):
                getattr(self, f"lin{i}").fill_(1.0)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x = ((2.0 * x - 1.0 - self.shift) / self.scale).permute(0, 3, 1, 2)
        y = ((2.0 * y - 1.0 - self.shift) / self.scale).permute(0, 3, 1, 2)
        total = 0.0
        for i, (a, b) in enumerate(zip(self.net(x), self.net(y))):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            w = F.relu(getattr(self, f"lin{i}"))
            total = total + (d * w[None, :, None, None]).sum(1).mean((1, 2))
        return total



def bundled_lin_path(net: str) -> Optional[str]:
    """The calibrated lin vectors of ``net`` that the repository bundles,
    or None."""
    p = os.path.join(_WEIGHTS_DIR, f"lpips_lin_{net}.npz")
    return p if os.path.exists(p) else None


def find_lpips_weights(net: str) -> Optional[str]:
    """Backbone (and lin) weights: ``$TRAINNER_LPIPS_WEIGHTS`` when it names
    a file, else ``lpips_{net}.npz`` in the weights directory, else None."""
    env = os.environ.get("TRAINNER_LPIPS_WEIGHTS")
    if env and os.path.exists(env):
        return env
    p = os.path.join(_WEIGHTS_DIR, f"lpips_{net}.npz")
    return p if os.path.exists(p) else None


def lpips_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax-style arrays ('net/<conv>/kernel' in HWIO, 'net/<conv>/
    bias', 'lin{i}') -> the state_dict of ``LPIPS``."""
    sd = {}
    for key, arr in flat.items():
        arr = np.asarray(arr, np.float32)
        if key.startswith("net/"):
            _, layer, leaf = key.split("/")
            if leaf == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
            sd[f"net.{layer}.{'weight' if leaf == 'kernel' else 'bias'}"] = \
                torch.from_numpy(np.array(arr, order="C"))
        else:
            sd[key] = torch.from_numpy(np.array(arr))
    return sd


def load_lpips_npz(path: str, net: Optional[str] = None
                   ) -> Dict[str, torch.Tensor]:
    """A converted LPIPS file -> ``LPIPS``'s state_dict; lin vectors that
    the file lacks come from the bundled set of ``net``."""
    data = np.load(path)
    flat = {k: data[k] for k in data.files}
    if net and not any(k.startswith("lin") for k in flat):
        lin = bundled_lin_path(net)
        if lin:
            lin_data = np.load(lin)
            flat.update({k: lin_data[k] for k in lin_data.files})
    return lpips_state_dict(flat)


class LPIPSWeightsMissing(RuntimeError):
    pass


def _missing_msg(net: str) -> str:
    return (
        f"LPIPS backbone weights for '{net}' not found. LPIPS needs "
        "pretrained torchvision features which cannot be bundled; convert "
        "them once on any machine with torchvision:\n"
        "  python scripts/convert_torch_model.py lpips-full "
        f"<torchvision_{net}.pth> lpips_{net}.npz --net {net}\n"
        "then either set TRAINNER_LPIPS_WEIGHTS=/path/to/lpips_"
        f"{net}.npz, set path.lpips_weights in the options file, or drop "
        f"the file at trainner_tpu/losses/weights/lpips_{net}.npz. "
        "(The calibrated lin vectors are already bundled in-repo.)")


class LPIPSMetric:
    """The metric ``utils/metrics.py::MetricsDict`` calls: (sr, gt) HWC
    images, uint8 or float in [0, 1] -> the distance as a float, computed
    in f32 on ``device`` (the card unless the caller names the CPU).

    Weights: ``weights_path``, else ``$TRAINNER_LPIPS_WEIGHTS``, else the
    drop point; none raises ``LPIPSWeightsMissing`` here, at construction,
    unless ``allow_random`` (tests only: a backbone drawn from
    ``torch.Generator`` seed 0)."""

    def __init__(self, net: str = "squeeze",
                 weights_path: Optional[str] = None,
                 allow_random: bool = False, device=None):
        self.net = net
        self.device = resolve_device(device)
        weights_path = weights_path or find_lpips_weights(net)
        if weights_path is None and not allow_random:
            raise LPIPSWeightsMissing(_missing_msg(net))
        self.model = LPIPS(net=net)
        if weights_path:
            self.model.load_state_dict(load_lpips_npz(weights_path, net=net),
                                       strict=False)
        else:
            self.model.init_weights(torch.Generator().manual_seed(0))
        self.model = self.model.to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def __call__(self, sr: np.ndarray, gt: np.ndarray) -> float:
        sr = np.asarray(sr, np.float32)
        gt = np.asarray(gt, np.float32)
        if sr.max() > 1.5:
            sr, gt = sr / 255.0, gt / 255.0
        d = self.model(torch.from_numpy(sr)[None].to(self.device),
                       torch.from_numpy(gt)[None].to(self.device))
        return float(d[0])
