"""AdaTarget: counterpart of ``trainner_tpu/ops/adatarget.py`` (``LocNet:
28``, ``_extract_patches:59``, ``_fold_patches:68``,
``_center_patches:75``, ``ada_target:94``).

LocNet reads each 7 x 7 patch of the output beside the 9 x 9 patch of the
target around it (one channel at a time) and predicts a 2 x 3 affine map,
the identity plus ``fc3``'s output (``fc3`` starts at zero). ``ada_target``
samples a 7 x 7 grid inside each target patch through its map (bilinear,
border padding, ``ops/warp.py::grid_sample``) and folds the patches back:
the target, aligned to the output patch by patch, over the region the
7-px grid covers (126 of 128 px). The patch inputs are detached; the maps
stay differentiable in LocNet's parameters, which the pixel loss trains
with G's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.graphs import device_constant
from .warp import grid_sample


class LocNet(nn.Module):
    """(N, 7, 7) output patches and (N, 9, 9) target patches -> (N, 2, 3)
    affine maps: fc1 and fc2 (130 -> 64 -> 64, ReLU) and fc3 (64 -> 6,
    zero-initialised), in f32. ``init_weights`` draws fc1's and fc2's
    weights as flax's ``Dense`` does (LeCun normal, truncated; zero
    biases)."""

    def __init__(self, patch_out: int = 7, patch_tgt: int = 9,
                 hidden: int = 64):
        super().__init__()
        self.patch_out, self.patch_tgt = patch_out, patch_tgt
        n_in = patch_out ** 2 + patch_tgt ** 2
        self.fc1 = nn.Linear(n_in, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.fc3 = nn.Linear(hidden, 6)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for fc in (self.fc1, self.fc2):
            std = (1.0 / fc.in_features) ** 0.5 / 0.87962566103423978
            w = torch.empty(fc.weight.shape)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            fc.weight.copy_(w * std)
            fc.bias.zero_()
        self.fc3.weight.zero_()
        self.fc3.bias.zero_()

    def forward(self, out_patches: torch.Tensor,
                tgt_patches: torch.Tensor) -> torch.Tensor:
        n = out_patches.shape[0]
        x = torch.cat([out_patches.reshape(n, -1),
                       tgt_patches.reshape(n, -1)], dim=-1).float()
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        identity = device_constant((1.0, 0.0, 0.0, 0.0, 1.0, 0.0),
                                   torch.float32, x.device)
        return (self.fc3(x) + identity.to(x.dtype)).reshape(n, 2, 3)


def extract_patches(x: torch.Tensor, p: int) -> torch.Tensor:
    """(b, h, w, c) -> (b * nh * nw * c, p, p), the non-overlapping p-px
    patches of the region the grid covers."""
    b, h, w, c = x.shape
    nh, nw = h // p, w // p
    x = x[:, :nh * p, :nw * p].reshape(b, nh, p, nw, p, c)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(-1, p, p)


def fold_patches(patches: torch.Tensor, b: int, h: int, w: int, c: int,
                 p: int) -> torch.Tensor:
    """The inverse of ``extract_patches``: (b, nh * p, nw * p, c)."""
    nh, nw = h // p, w // p
    x = patches.reshape(b, nh, nw, c, p, p)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(b, nh * p, nw * p, c)


def center_patches(x: torch.Tensor, p_big: int, p_small: int
                   ) -> torch.Tensor:
    """The p_big patches centred on the p_small grid (edge padding), as
    (b * nh * nw * c, p_big, p_big), by one unfold per axis."""
    b, h, w, c = x.shape
    pad = (p_big - p_small) // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad),
               mode="replicate").permute(0, 2, 3, 1)
    nh, nw = h // p_small, w // p_small
    win = xp.unfold(1, p_big, p_small)[:, :nh].unfold(2, p_big,
                                                       p_small)[:, :, :nw]
    # (b, nh, nw, c, p_big(y), p_big(x))
    return win.reshape(-1, p_big, p_big)


def _grid_1d(po: int, pt: int) -> tuple:
    """``jnp.linspace(-po / pt, po / pt, po)``'s formula, start (1 - t) +
    stop t at t = i / (po - 1) in f32, the last point ``stop`` itself
    (XLA's fused rounding puts two points an ulp away)."""
    start, stop = np.float32(-po / pt), np.float32(po / pt)
    t = np.arange(po, dtype=np.float32) / np.float32(po - 1)
    out = start * (np.float32(1) - t) + stop * t
    out[-1] = stop
    return tuple(float(v) for v in out.astype(np.float32))


def ada_target(output: torch.Tensor, target: torch.Tensor, loc_net: LocNet,
               patch_out: int = 7, patch_tgt: int = 9) -> torch.Tensor:
    """The target aligned to ``output`` patch by patch: (b, nh * 7, nw * 7,
    c), differentiable in ``loc_net``'s parameters alone."""
    b, h, w, c = output.shape
    po, pt = patch_out, patch_tgt
    out_p = extract_patches(output.detach().float(), po)
    tgt_big = center_patches(target.detach().float(), pt, po)
    theta = loc_net(out_p, tgt_big)
    g = device_constant(_grid_1d(po, pt), torch.float32,
                        output.device).to(theta.dtype)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    coords = torch.einsum("nij,hwj->nhwi", theta, base)
    warped = grid_sample(tgt_big[..., None], coords, align_corners=True,
                         padding_mode="border")
    return fold_patches(warped[..., 0], b, h, w, c, po)
