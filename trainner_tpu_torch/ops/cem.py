"""CEM, the consistency-enforcing module: counterpart of
``trainner_tpu/ops/cem.py`` (``downscale:31``, ``upscale:37``,
``_nearest_up:42``, ``_box_down:48``, ``cem_project:53``).

``cem_project`` moves a super-resolved image onto the affine set
{x : downscale(x) = lr} by the least L2 correction. With the ``box`` kernel
that is closed form: the box downscale of each s x s block is its mean, so
adding the nearest-upsampled residual makes the downscale equal ``lr``.
With another kernel D is the MATLAB-style antialiased downscale of
``ops/imresize.py`` (dense f32 matrices per axis); the correction is
Dᵀ y with (D Dᵀ) y = lr - D sr, solved by conjugate gradients for a fixed
``n_iter`` (20, as in the JAX package). Dᵀ is the transpose of D's
matrices. Plain PyTorch with no host synchronisation, so it captures into
``eval_step``'s and the step's CUDA graphs, and gradients flow through it.
"""

from __future__ import annotations

import torch

from .imresize import _device_matrix, _sizes, imresize


def downscale(x: torch.Tensor, scale: int,
              kernel: str = "cubic") -> torch.Tensor:
    """The linear downscale by ``scale`` (no clipping), NHWC."""
    return imresize(x, scale=1.0 / scale, kernel=kernel, clip=False)


def upscale(x: torch.Tensor, scale: int,
            kernel: str = "cubic") -> torch.Tensor:
    return imresize(x, scale=float(scale), kernel=kernel, clip=False)


def _nearest_up(x: torch.Tensor, s: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, s, w, s, c)
    return x.reshape(b, h * s, w * s, c)


def _box_down(x: torch.Tensor, s: int) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // s, s, w // s, s, c).mean(dim=(2, 4))


def _downscale_transpose(y: torch.Tensor, shape, scale: int,
                         kernel: str) -> torch.Tensor:
    """Dᵀ y for D = ``downscale`` of an NHWC tensor of ``shape``: the
    transposes of D's two matrices, W then H."""
    _, _, (in_h, out_h, sc_h), (in_w, out_w, sc_w) = _sizes(
        shape, 1.0 / scale, None)
    wh = _device_matrix(in_h, out_h, kernel, True, sc_h, y.device)
    ww = _device_matrix(in_w, out_w, kernel, True, sc_w, y.device)
    y = torch.matmul(ww.T, y)
    return torch.matmul(wh.T, y.flatten(-2)).unflatten(-1, y.shape[-2:])


def cem_project(sr: torch.Tensor, lr: torch.Tensor, scale: int,
                n_iter: int = 20, kernel: str = "box") -> torch.Tensor:
    """``sr`` (NHWC) projected so that its downscale is ``lr``, in f32:
    closed form for ``box``, else ``n_iter`` conjugate-gradient steps on
    D Dᵀ y = lr - D sr and sr + Dᵀ y."""
    sr = sr.float()
    lr = lr.float()
    if kernel == "box":
        return sr + _nearest_up(lr - _box_down(sr, scale), scale)

    def dt(y):
        return _downscale_transpose(y, sr.shape, scale, kernel)

    e = lr - downscale(sr, scale, kernel)
    y, r, p = torch.zeros_like(e), e, e
    for _ in range(n_iter):
        ap = downscale(dt(p), scale, kernel)
        rr = (r * r).sum()
        alpha = rr / ((p * ap).sum() + 1e-12)
        y = y + alpha * p
        r_new = r - alpha * ap
        beta = (r_new * r_new).sum() / (rr + 1e-12)
        p = r_new + beta * p
        r = r_new
    return sr + dt(y)
