"""Structural and regularising losses: counterpart of
``trainner_tpu/losses/regularizers.py`` (``hfen:27``, ``tv_loss:47``,
``_grads:63``, ``gradient_loss:84``, ``_spl:102``, ``_spl_trace:111``,
``gp_loss:119``, ``cp_loss:129``, ``spl_loss:151``, ``fft_loss:160``,
``overflow_loss:170``, ``range_loss:177``, ``color_loss:185``,
``average_loss:199``). NHWC, f32.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..ops.colors import rgb_to_yuv
from ..ops.filters import filter2d, log_kernel
from ..utils.graphs import device_constant
from .basic import l1


def hfen(x: torch.Tensor, y: torch.Tensor, criterion: Callable = l1,
         kernel_size: int = 15, sigma: float = 2.5,
         norm: bool = False) -> torch.Tensor:
    """criterion(LoG(x), LoG(y)), the Laplacian of Gaussian zero-padded;
    with ``norm`` divided by ||LoG(y)||."""
    k = device_constant(log_kernel(kernel_size, sigma).tolist(),
                        torch.float32, x.device)
    lx = filter2d(x, k, pad_mode="constant")
    ly = filter2d(y, k, pad_mode="constant")
    val = criterion(lx, ly)
    if norm:
        val = val / torch.linalg.vector_norm(ly.reshape(-1)).clamp_min(1e-8)
    return val


def _zero_last(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with its last row (dim 1) or column (dim 2) set to 0, built by
    concatenation: an indexed write of a host scalar would copy it to the
    card, which a graph capture refuses."""
    n = t.shape[dim]
    return torch.cat([t.narrow(dim, 0, n - 1),
                      torch.zeros_like(t.narrow(dim, n - 1, 1))], dim)


def _grads(x: torch.Tensor, four_d: bool):
    """Same-size finite differences, the last row or column 0: [dx, dy],
    and with ``four_d`` also the diagonals [dp, dn] (dp's last row 0)."""
    zc = torch.zeros_like(x[:, :, :1, :])
    zr = torch.zeros_like(x[:, :1, :, :])
    dx = torch.cat([x[:, :, 1:, :] - x[:, :, :-1, :], zc], 2)
    dy = torch.cat([x[:, 1:, :, :] - x[:, :-1, :, :], zr], 1)
    if not four_d:
        return [dx, dy]
    right = torch.cat([x[:, :, 1:, :], zc], 2)
    bottom = torch.cat([x[:, 1:, :, :], zr], 1)
    botright = torch.cat([torch.cat([x[:, 1:, 1:, :], zc[:, 1:]], 2), zr], 1)
    dn = botright - x
    dp = _zero_last(right - bottom, 1)
    return [dx, dy, dp, dn]


def tv_loss(x: torch.Tensor, tv_type: str = "tv", p: int = 1
            ) -> torch.Tensor:
    """Total variation over dx, dy ('tv') and the diagonals ('dtv', '4d'):
    the mean |g| (p 1) or g^2 (p 2) of each, summed."""
    loss = 0.0
    for g in _grads(x, tv_type in ("dtv", "4d")):
        loss = loss + (g.abs().mean() if p == 1 else (g * g).mean())
    return loss


def gradient_loss(x: torch.Tensor, y: torch.Tensor, criterion: Callable = l1,
                  four_d: bool = False) -> torch.Tensor:
    """criterion over the image gradients, averaged over the directions."""
    gx, gy = _grads(x, four_d), _grads(y, four_d)
    return sum(criterion(a, b) for a, b in zip(gx, gy)) / len(gx)


def _l2n(v: torch.Tensor, dim: int) -> torch.Tensor:
    """v / max(||v||, 1e-12) along ``dim`` (``F.normalize``)."""
    return F.normalize(v, dim=dim, eps=1e-12)


def _spl(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spatial-profile similarity: column profiles (normalised along H)
    plus row profiles (along W), times -1 / (H B)."""
    h_term = (_l2n(a, 1) * _l2n(b, 1)).sum()
    w_term = (_l2n(a, 2) * _l2n(b, 2)).sum()
    return -(h_term + w_term) / (a.shape[1] * a.shape[0])


def _spl_trace(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The trace form: row sums over H, column sums over W, -mean over the
    batch."""
    rows = (_l2n(a, 2) * _l2n(b, 2)).sum((1, 2, 3)) / a.shape[1]
    cols = (_l2n(a, 1) * _l2n(b, 1)).sum((1, 2, 3)) / a.shape[2]
    return -(rows + cols).sum() / a.shape[0]


def gp_loss(x: torch.Tensor, y: torch.Tensor, trace: bool = False,
            spl_denorm: bool = False) -> torch.Tensor:
    """Gradient-profile loss: the profile similarity of dx and of dy."""
    if spl_denorm:
        x, y = (x + 1) / 2, (y + 1) / 2
    sim = _spl_trace if trace else _spl
    return sum(sim(a, b) for a, b in zip(_grads(x, False), _grads(y, False)))


def cp_loss(x: torch.Tensor, y: torch.Tensor, rgb: bool = True,
            yuv: bool = True, yuvgrad: bool = True, trace: bool = False,
            spl_denorm: bool = False, yuv_denorm: bool = False
            ) -> torch.Tensor:
    """Colour-profile loss: the profile similarity of RGB, of YUV and of
    YUV's gradients."""
    if spl_denorm:
        x, y = (x + 1) / 2, (y + 1) / 2
    if yuv_denorm and not spl_denorm:
        x, y = (x + 1) / 2, (y + 1) / 2
    sim = _spl_trace if trace else _spl
    total = 0.0
    if rgb:
        total = total + sim(x, y)
    if yuv or yuvgrad:
        xy_, yy_ = rgb_to_yuv(x), rgb_to_yuv(y)
        if yuv:
            total = total + sim(xy_, yy_)
        if yuvgrad:
            total = total + sum(sim(a, b) for a, b in zip(
                _grads(xy_, False), _grads(yy_, False)))
    return total


def spl_loss(x: torch.Tensor, y: torch.Tensor, **kw) -> torch.Tensor:
    return gp_loss(x, y, **kw) + cp_loss(x, y, **kw)


def fft_loss(x: torch.Tensor, y: torch.Tensor,
             criterion: Callable = l1) -> torch.Tensor:
    """criterion on the 2-D FFT over H and W, real and imaginary parts
    stacked last."""
    fx = torch.fft.fft2(x, dim=(1, 2))
    fy = torch.fft.fft2(y, dim=(1, 2))
    return criterion(torch.stack([fx.real, fx.imag], -1),
                     torch.stack([fy.real, fy.imag], -1))


def overflow_loss(x: torch.Tensor, legit_range=(0.0, 1.0)) -> torch.Tensor:
    """The mean log1p of each excursion outside ``legit_range``."""
    clipped = x.clamp(legit_range[0], legit_range[1])
    return torch.log1p((x - clipped).abs()).mean()


def range_loss(x: torch.Tensor, legit_range=(0.0, 1.0)) -> torch.Tensor:
    """The mean linear excursion outside ``legit_range``."""
    return torch.maximum((x - legit_range[1]).clamp_min(0.0),
                         (legit_range[0] - x).clamp_min(0.0)).mean()


def _pool(z: torch.Tensor, ds_f: int) -> torch.Tensor:
    """ds_f x ds_f average pooling of NHWC, VALID."""
    return F.avg_pool2d(z.permute(0, 3, 1, 2), ds_f).permute(0, 2, 3, 1)


def color_loss(x: torch.Tensor, y: torch.Tensor, criterion: Callable = l1,
               ds_f: int = 4) -> torch.Tensor:
    """criterion on the U and V channels of the pooled images."""
    return criterion(rgb_to_yuv(_pool(x, ds_f))[..., 1:],
                     rgb_to_yuv(_pool(y, ds_f))[..., 1:])


def average_loss(x: torch.Tensor, y: torch.Tensor, criterion: Callable = l1,
                 ds_f: int = 4) -> torch.Tensor:
    """criterion on the pooled (downscaled) pair."""
    return criterion(_pool(x, ds_f), _pool(y, ds_f))
