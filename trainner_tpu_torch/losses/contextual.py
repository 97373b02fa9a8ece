"""Contextual loss (CX) over VGG features: counterpart of
``trainner_tpu/losses/contextual.py`` (``_subsample:23``, ``_cx_sim:35``,
``_cx_from_dist:46``, ``_cosine_dist:55``, ``_l2_dist:71``,
``_l1_dist:80``, ``ContextualLoss:86``).

Each listened layer's maps, subsampled with a static stride to at most
``max_points`` positions, give a (b, N, M) distance matrix (cosine, l2 or
l1); distances relative to each row's minimum become similarities by a
softmax over the target axis; the loss is -log of their mean over the
target of the max over the source. The cosine distance is centred on the
target's channel mean over the whole batch and halved. The products are
``torch.bmm`` in f32, as the JAX package's are ``einsum``s.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.perceptual import VGGFeatures, canonical_layer, load_vgg_npz


def _subsample(feat: torch.Tensor, max_points: int) -> torch.Tensor:
    """(b, h, w, c) -> (b, N, c), every ceil(hw / max_points)-th position
    when there are more than ``max_points``."""
    b, h, w, c = feat.shape
    f = feat.reshape(b, h * w, c)
    if h * w > max_points:
        f = f[:, ::-(-(h * w) // max_points), :]
    return f


def _cx_sim(dist: torch.Tensor, band_width: float,
            b: float = 1.0) -> torch.Tensor:
    """Relative distances (over each row's minimum), exp((b - d~) / h),
    normalised over the target axis."""
    d_min = dist.amin(2, keepdim=True)
    d_tilde = dist / (d_min + 1e-5)
    w = torch.exp((b - d_tilde) / band_width)
    return w / w.sum(2, keepdim=True)


def _cx_from_dist(dist: torch.Tensor, band_width: float,
                  b: float = 1.0) -> torch.Tensor:
    """The regular CX loss: max over the source positions, mean over the
    target positions, -log, mean over the batch."""
    cx = _cx_sim(dist, band_width, b).amax(1).mean(1)
    return (-torch.log(cx)).mean()


def _cosine_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(b, N, c), (b, M, c) -> (b, N, M): (1 - cos) / 2, clamped at 0, of
    the features centred on y's channel mean over batch and positions."""
    y_mu = y.mean((0, 1), keepdim=True)
    xc, yc = x - y_mu, y - y_mu
    xn = xc / torch.linalg.vector_norm(xc, dim=-1,
                                       keepdim=True).clamp_min(1e-12)
    yn = yc / torch.linalg.vector_norm(yc, dim=-1,
                                       keepdim=True).clamp_min(1e-12)
    sim = torch.bmm(xn, yn.transpose(1, 2))
    return ((1.0 - sim) / 2.0).clamp_min(0.0)


def _l2_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x2 = (x * x).sum(-1, keepdim=True)
    y2 = (y * y).sum(-1, keepdim=True)
    d = x2 - 2 * torch.bmm(x, y.transpose(1, 2)) + y2.transpose(1, 2)
    return d.clamp_min(0.0)


def _l1_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(b, N, M) pairwise L1: (b, N, M, c) in memory, small maps only."""
    return (x[:, :, None, :] - y[:, None, :, :]).abs().sum(-1)


class ContextualLoss(torch.nn.Module):
    """The CX loss at ``layers_weights`` (the ``cx_vgg_layers`` option,
    e.g. {'conv_3_2': 1, 'conv_4_2': 1}) of a frozen VGG, or on the pixels
    themselves without ``use_vgg``; ``distance_type`` cosine, l2 or l1;
    ``calc_type`` regular, symetric (both directions, halved) or bilateral
    (the feature similarities mixed with spatial ones over the normalised
    pixel grid by ``weight_sp``). Without ``weights_path`` the VGG keeps
    random weights drawn from ``seed``."""

    def __init__(self, layers_weights: Optional[Dict[str, float]] = None,
                 distance_type: str = "cosine", calc_type: str = "regular",
                 band_width: float = 0.5, b: float = 1.0,
                 weight_sp: float = 0.1, use_vgg: bool = True,
                 arch: str = "vgg19", weights_path: Optional[str] = None,
                 max_points: int = 4096,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 13):
        super().__init__()
        self.layers_weights = {
            canonical_layer(k): float(v) for k, v in (
                layers_weights or {"conv3_2": 1.0, "conv4_2": 1.0}).items()}
        self.distance_type, self.calc_type = distance_type, calc_type
        self.band_width, self.b, self.weight_sp = band_width, b, weight_sp
        self.use_vgg, self.max_points = use_vgg, max_points
        if use_vgg:
            self.model = VGGFeatures(arch=arch,
                                     listen=tuple(self.layers_weights),
                                     use_input_norm=True, dtype=dtype)
            if weights_path:
                self.model.load_state_dict(load_vgg_npz(weights_path),
                                           strict=False)
            else:
                self.model.init_weights(torch.Generator().manual_seed(seed))
            self.model.requires_grad_(False)
        else:
            self.layers_weights = {"pix": 1.0}

    def _dist(self, x, y):
        if self.distance_type == "cosine":
            return _cosine_dist(x, y)
        if self.distance_type == "l2":
            return _l2_dist(x, y)
        return _l1_dist(x, y)

    def _cx(self, x, y, hw):
        """One layer's CX; ``hw`` is the map's (h, w) for the bilateral
        grid."""
        if self.calc_type == "symetric":
            return (_cx_from_dist(self._dist(y, x), self.band_width, self.b)
                    + _cx_from_dist(self._dist(x, y), self.band_width,
                                    self.b)) / 2.0
        if self.calc_type == "bilateral":
            h, w = hw
            rows = torch.arange(h, dtype=torch.float32,
                                device=x.device) / (h + 1)
            cols = torch.arange(w, dtype=torch.float32,
                                device=x.device) / (w + 1)
            gy, gx = torch.meshgrid(rows, cols, indexing="ij")
            grid = _subsample(torch.stack([gy, gx], -1)[None],
                              self.max_points)
            cx_sp = _cx_sim(_l2_dist(grid, grid), self.band_width, self.b)
            cx_feat = _cx_sim(self._dist(x, y), self.band_width, self.b)
            cx = (1.0 - self.weight_sp) * cx_feat + self.weight_sp * cx_sp
            bb, n, p = cx.shape
            if n == h * w:
                # the source positions: max over W, then mean over H
                cs = cx.reshape(bb, h, w, p).amax(2).mean(1)
            else:  # a subsampled map: max over all source positions
                cs = cx.amax(1)
            return (-torch.log(cs + 1e-5)).mean()
        return _cx_from_dist(self._dist(x, y), self.band_width, self.b)

    def forward(self, sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
        if self.use_vgg:
            f_sr = self.model(sr)
            with torch.no_grad():
                f_hr = self.model(hr)
        else:
            f_sr, f_hr = {"pix": sr}, {"pix": hr}
        total = 0.0
        for name, w in self.layers_weights.items():
            hw = f_sr[name].shape[1:3]
            x = _subsample(f_sr[name], self.max_points).float()
            y = _subsample(f_hr[name], self.max_points).float()
            total = total + w * self._cx(x, y, hw)
        return total
