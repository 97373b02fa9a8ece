"""SSIM and MS-SSIM as differentiable losses: counterpart of
``trainner_tpu/losses/ssim.py`` (``_filt:25``, ``ssim:46``,
``_downsample2:76``, ``ms_ssim:86``, ``ssim_loss:121``,
``ms_ssim_loss:125``). NHWC in [0, data_range], f32.

The separable gaussian window runs VALID by default (``use_padding`` pads
symmetrically first); variances are clamped at 0. MS-SSIM shrinks the
window to the map when a level is smaller than it (sigma rescaled with
it), zero-pads odd sizes before each 2x average pooling, clamps every
factor at 1e-6 before its power (x ** w has an infinite derivative at 0),
and raises ssim_L to w_L in every row of the product, as the JAX package
does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.filters import gaussian_kernel_1d
from ..utils.graphs import device_constant

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _symmetric_pad(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """numpy's 'symmetric' padding (the edge repeated) of NCHW's last two
    axes, which ``F.pad`` lacks."""
    for dim in (2, 3):
        n = x.shape[dim]
        parts = [x.narrow(dim, 0, before).flip(dim), x,
                 x.narrow(dim, n - after, after).flip(dim)]
        x = torch.cat(parts, dim)
    return x


def _filt(x: torch.Tensor, window: int, sigma: float,
          use_padding: bool = False) -> torch.Tensor:
    """The gaussian window along H, then along W, per channel, on NHWC."""
    k = device_constant(gaussian_kernel_1d(window, sigma).tolist(),
                        torch.float32, x.device).to(x.dtype)
    c = x.shape[-1]
    y = x.permute(0, 3, 1, 2)
    if use_padding:
        pad = (window - 1) // 2
        y = _symmetric_pad(y, pad, window - 1 - pad)
    y = F.conv2d(y, k.reshape(1, 1, window, 1).expand(c, 1, window, 1),
                 groups=c)
    y = F.conv2d(y, k.reshape(1, 1, 1, window).expand(c, 1, 1, window),
                 groups=c)
    return y.permute(0, 2, 3, 1)


def ssim(x: torch.Tensor, y: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, data_range: float = 1.0, full: bool = False,
         use_padding: bool = False, shave: int = 0, per_image: bool = False):
    """Mean SSIM over the batch (per image with ``per_image``); with
    ``full`` also the contrast-structure term, as (ssim, cs)."""
    if shave:
        x = x[:, shave:-shave, shave:-shave, :]
        y = y[:, shave:-shave, shave:-shave, :]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def filt(t):
        return _filt(t, window_size, sigma, use_padding)

    mu_x, mu_y = filt(x), filt(y)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = (filt(x * x) - mu_x2).clamp_min(0.0)
    sig_y = (filt(y * y) - mu_y2).clamp_min(0.0)
    sig_xy = filt(x * y) - mu_xy
    cs_map = (2 * sig_xy + c2) / (sig_x + sig_y + c2)
    ssim_map = ((2 * mu_xy + c1) / (mu_x2 + mu_y2 + c1)) * cs_map

    def reduce(m):
        return m.mean((1, 2, 3)) if per_image else m.mean()

    if full:
        return reduce(ssim_map), reduce(cs_map)
    return reduce(ssim_map)


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling of NHWC, an odd axis zero-padded by one on each
    side first."""
    ph, pw = x.shape[1] % 2, x.shape[2] % 2
    y = x.permute(0, 3, 1, 2)
    if ph or pw:
        y = F.pad(y, (pw, pw, ph, ph))
    return F.avg_pool2d(y, 2).permute(0, 2, 3, 1)


def ms_ssim(x: torch.Tensor, y: torch.Tensor, window_size: int = 11,
            sigma: float = 1.5, data_range: float = 1.0, levels: int = 5,
            use_padding: bool = False) -> torch.Tensor:
    """Multi-scale SSIM, the MATLAB weighting: the mean over images of
    prod_i cs_i^w_i * ssim_L^w_L, i < L, with ssim_L^w_L in each of the
    L - 1 factors."""
    win, sig = window_size, sigma
    vals = []
    for i in range(levels):
        h, w = x.shape[1], x.shape[2]
        if win > h or win > w:
            new_win = min(win, h, w)
            if new_win % 2 == 0:
                new_win -= 1
            sig = new_win * sig / win if win else 0.0
            win = new_win
        s, cs = ssim(x, y, win, sig, data_range, full=True,
                     use_padding=use_padding, per_image=True)
        vals.append(s if i == levels - 1 else cs)
        if i != levels - 1:
            x, y = _downsample2(x), _downsample2(y)
    vals = torch.stack(vals).clamp_min(1e-6)
    weights = _MSSSIM_WEIGHTS[:levels]
    per_img = torch.ones_like(vals[-1])
    last = vals[-1] ** weights[-1]
    for i in range(levels - 1):
        per_img = per_img * (vals[i] ** weights[i] * last)
    return per_img.mean()


def ssim_loss(x: torch.Tensor, y: torch.Tensor, **kw) -> torch.Tensor:
    return 1.0 - ssim(x, y, **kw)


def ms_ssim_loss(x: torch.Tensor, y: torch.Tensor, **kw) -> torch.Tensor:
    return 1.0 - ms_ssim(x, y, **kw)
