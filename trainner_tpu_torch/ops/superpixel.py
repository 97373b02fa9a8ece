"""Batched SLIC superpixels and the segment-mean recolouring, on the
device.

Counterpart of ``trainner_tpu/ops/superpixel.py`` (``_init_centers:25``,
``slic_segment_mean:35``, ``superpixel_structure:83``): SLIC k-means for
the whole batch at once, the assignment a (h w, K) distance product and
the centre update a one-hot segment-mean product, a fixed number of
iterations. Every pixel takes the mean colour of its segment (the WBC
"structure" representation), then a random gamma.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .degradations import _one_hot, _sq_dist, _uniform


def _init_centers(h: int, w: int, n_segments: int, device):
    """The starting centres on a regular gh x gw grid: (cy, cx) flat f32,
    gh, gw."""
    gh = max(1, int(round(math.sqrt(n_segments * h / w))))
    gw = max(1, (n_segments + gh - 1) // gh)
    ys = (torch.arange(gh, device=device) + 0.5) * (h / gh)
    xs = (torch.arange(gw, device=device) + 0.5) * (w / gw)
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")
    return cy.reshape(-1), cx.reshape(-1), gh, gw


def slic_segment_mean(images: torch.Tensor, n_segments: int = 200,
                      n_iter: int = 5, compactness: float = 10.0
                      ) -> torch.Tensor:
    """images (b, h, w, c) in [0, 1] -> piecewise-constant images, each
    pixel the mean colour of its SLIC segment. The output takes the last
    iteration's assignment and the centres updated after it."""
    b, h, w, c = images.shape
    dev = images.device
    cy0, cx0, _, _ = _init_centers(h, w, n_segments, dev)
    k = cy0.shape[0]
    s = math.sqrt(h * w / k)
    ratio = (compactness / s) ** 2

    py, px = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    pos = torch.stack([py.reshape(-1), px.reshape(-1)], -1)  # (hw, 2)
    pos_b = pos[None].expand(b, -1, -1)
    feat = images.reshape(b, h * w, c)
    cent_pos = torch.stack([cy0, cx0], -1)[None].expand(b, -1, -1)
    yi = cy0.to(torch.int32).clamp(0, h - 1).long()
    xi = cx0.to(torch.int32).clamp(0, w - 1).long()
    cent_col = images[:, yi, xi]  # (b, K, c)
    assign = None
    for _ in range(n_iter):
        d = _sq_dist(feat, cent_col) + ratio * _sq_dist(pos_b, cent_pos)
        assign = d.argmin(dim=-1)  # (b, hw)
        onehot = _one_hot(assign, k, torch.float32)
        cnt = onehot.sum(dim=1).clamp_min(1.0)[..., None]  # (b, K, 1)
        cent_col = (onehot.transpose(1, 2) @ feat) / cnt
        cent_pos = (onehot.transpose(1, 2) @ pos_b) / cnt
    return torch.take_along_dim(cent_col, assign[..., None], dim=1).reshape(
        b, h, w, c)


def draw_superpixel_structure(gen: torch.Generator, b: int,
                              gamma_range: Tuple[float, float] = (1.0, 1.2)
                              ) -> torch.Tensor:
    """Each sample's gamma, (b, 1, 1, 1)."""
    return _uniform(gen, (b, 1, 1, 1), *gamma_range)


def superpixel_structure(images: torch.Tensor, gamma: torch.Tensor,
                         n_segments: int = 200, n_iter: int = 5
                         ) -> torch.Tensor:
    """The WBC structure representation: the SLIC segment means raised to
    each sample's gamma."""
    sp = slic_segment_mean(images, n_segments, n_iter)
    return sp.clamp(1e-6, 1.0) ** gamma
