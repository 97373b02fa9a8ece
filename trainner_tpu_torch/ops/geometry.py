"""Batched rotations and perspective warps on the device: counterpart of
``trainner_tpu/ops/geometry.py`` (``_affine_grid:21``, ``rotate_batch:31``,
``rotate_pair:53``, ``perspective_batch:63``), sampled through
``ops/warp.py::grid_sample`` (bilinear, border, corners aligned). No JAX
module imports these; they are ported for completeness.

The JAX functions draw their angles and corner jitters from a key; here
they come from a ``torch.Generator`` (``generator``), or are given
(``angles`` in degrees, ``jitter`` (b, 4, 2)), which is how the tests hand
in JAX's draws.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .warp import grid_sample


def _base(h: int, w: int, device) -> torch.Tensor:
    """(h, w, 3): x and y in [-1, 1] (``linspace``) and 1."""
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy, torch.ones_like(gx)], -1)


def _affine_grid(theta: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """theta (b, 2, 3) over normalised coordinates -> the sampling grid
    (b, h, w, 2), corners aligned."""
    return torch.einsum("bij,hwj->bhwi", theta, _base(h, w, theta.device))


def _uniform(shape, lo: float, hi: float, generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return lo + (hi - lo) * u


def rotate_batch(x: torch.Tensor, max_deg: float = 45.0,
                 crop_to_valid: bool = True,
                 generator: Optional[torch.Generator] = None,
                 angles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each NHWC sample turned by its own angle in [-max_deg, max_deg);
    with ``crop_to_valid`` zoomed by |cos| + |sin| so that no corner
    outside the image shows."""
    b, h, w, c = x.shape
    ang = angles if angles is not None else _uniform(
        (b,), -max_deg, max_deg, generator, x.device)
    rad = ang.float().to(x.device) * math.pi / 180.0
    ct, st = torch.cos(rad), torch.sin(rad)
    zoom = ct.abs() + st.abs() if crop_to_valid else torch.ones_like(ct)
    zero = torch.zeros_like(ct)
    theta = torch.stack([torch.stack([ct * zoom, -st * zoom, zero], -1),
                         torch.stack([st * zoom, ct * zoom, zero], -1)], 1)
    return grid_sample(x, _affine_grid(theta, h, w), align_corners=True,
                       padding_mode="border")


def rotate_pair(hr: torch.Tensor, lr: torch.Tensor, max_deg: float = 45.0,
                generator: Optional[torch.Generator] = None,
                angles: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An HR/LR pair turned by the same per-sample angles."""
    if angles is None:
        angles = _uniform((hr.shape[0],), -max_deg, max_deg, generator,
                          hr.device)
    return (rotate_batch(hr, max_deg, angles=angles),
            rotate_batch(lr, max_deg, angles=angles))


def _homography(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The 3x3 homography (h33 = 1) taking the 4 points ``src`` to
    ``dst`` (each (4, 2))."""
    rows, rhs = [], []
    one, zero = src.new_ones(()), src.new_zeros(())
    for i in range(4):
        xs, ys = src[i, 0], src[i, 1]
        xd, yd = dst[i, 0], dst[i, 1]
        rows.append(torch.stack([xs, ys, one, zero, zero, zero,
                                 -xd * xs, -xd * ys]))
        rows.append(torch.stack([zero, zero, zero, xs, ys, one,
                                 -yd * xs, -yd * ys]))
        rhs.extend([xd, yd])
    sol = torch.linalg.solve(torch.stack(rows), torch.stack(rhs))
    return torch.cat([sol, src.new_ones(1)]).reshape(3, 3)


def perspective_batch(x: torch.Tensor, distortion: float = 0.2,
                      generator: Optional[torch.Generator] = None,
                      jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each NHWC sample warped by the homography that moves its four
    corners by up to ``distortion`` (normalised units), sampled through
    its inverse."""
    b, h, w, c = x.shape
    jit = jitter if jitter is not None else _uniform(
        (b, 4, 2), -distortion, distortion, generator, x.device)
    jit = jit.float().to(x.device)
    src = torch.tensor([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0],
                        [-1.0, 1.0]], device=x.device)
    hs = torch.stack([_homography(src, src + jit[i]) for i in range(b)])
    warped = torch.einsum("bij,hwj->bhwi", torch.linalg.inv(hs),
                          _base(h, w, x.device))
    grid = warped[..., :2] / warped[..., 2:3].clamp_min(1e-6)
    return grid_sample(x, grid, align_corners=True, padding_mode="border")
