"""The realistic degradation assets: a KernelGAN kernel pool and real noise
patches.

Counterpart of ``trainner_tpu/data/kernels.py`` (``load_kernel_pool:21``,
``_center_fit:59``, ``load_noise_patches:73``, ``apply_kernel_pool:112``,
``apply_noise_patches:128``). The loaders read a user's directory on the
host into one numpy bank each, the JAX package's bank bit for bit; the
pipeline puts a bank on the device once and draws per-sample indices into
it. Each ``apply_*`` takes its draws from a
``draw_*`` half, as the ops of ``ops/degradations.py`` do.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import degradations as D


def load_kernel_pool(path: str, kernel_size: int = 21,
                     max_kernels: int = 256) -> Optional[np.ndarray]:
    """Estimated downscale kernels (``.npy``, or the first 2-D array of a
    ``.mat``) in the directory's name order -> one (N, k, k) f32 bank,
    each kernel centre-padded or centre-cropped to ``kernel_size`` and
    divided by its sum (a kernel summing to 0 is left out); at most
    ``max_kernels``. None when ``path`` is not a directory or holds no
    kernel."""
    if not path or not os.path.isdir(path):
        return None
    kernels = []
    for f in sorted(os.listdir(path)):
        p = os.path.join(path, f)
        try:
            if f.endswith(".npy"):
                k = np.load(p)
            elif f.endswith(".mat"):
                from scipy.io import loadmat

                m = loadmat(p)
                k = next(v for v in m.values()
                         if isinstance(v, np.ndarray) and v.ndim == 2)
            else:
                continue
        except Exception:
            continue  # an unreadable file is skipped, as in the JAX loader
        k = np.asarray(k, np.float64).squeeze()
        if k.ndim != 2:
            continue
        k = _center_fit(k, kernel_size)
        s = k.sum()
        if abs(s) < 1e-8:
            continue
        kernels.append((k / s).astype(np.float32))
        if len(kernels) >= max_kernels:
            break
    if not kernels:
        return None
    return np.stack(kernels)


def _center_fit(k: np.ndarray, size: int) -> np.ndarray:
    """A kernel centre-padded or centre-cropped to (size, size)."""
    h, w = k.shape
    out = np.zeros((size, size), k.dtype)
    sy = max((h - size) // 2, 0)
    sx = max((w - size) // 2, 0)
    dy = max((size - h) // 2, 0)
    dx = max((size - w) // 2, 0)
    ch = min(h, size)
    cw = min(w, size)
    out[dy:dy + ch, dx:dx + cw] = k[sy:sy + ch, sx:sx + cw]
    return out


def load_noise_patches(path: str, patch_size: int = 32,
                       n_patches: int = 256, grayscale: bool = False,
                       seed: int = 0) -> Optional[np.ndarray]:
    """Zero-mean noise patches cut at random from the images under
    ``path`` (the positions from a numpy generator seeded with ``seed``,
    an equal share per image) -> one (N, p, p, c) f32 bank; None when there
    is no directory, no image or no image large enough."""
    from .common import read_img, scan_images

    if not path or not os.path.isdir(path):
        return None
    paths = scan_images(path)
    if not paths:
        return None
    rng = np.random.default_rng(seed)
    patches = []
    per_img = max(1, n_patches // len(paths))
    for p in paths:
        img = read_img(p)
        if grayscale:
            img = img.mean(-1, keepdims=True)
        h, w = img.shape[:2]
        if h < patch_size or w < patch_size:
            continue
        for _ in range(per_img):
            y = int(rng.integers(0, h - patch_size + 1))
            x = int(rng.integers(0, w - patch_size + 1))
            crop = img[y:y + patch_size, x:x + patch_size]
            patches.append(crop - crop.mean(axis=(0, 1), keepdims=True))
            if len(patches) >= n_patches:
                break
        if len(patches) >= n_patches:
            break
    if not patches:
        return None
    return np.stack(patches).astype(np.float32)


def draw_kernel_pool(gen: torch.Generator, b: int, n: int) -> torch.Tensor:
    """Each sample's kernel of a pool of n, (b,)."""
    return torch.randint(0, n, (b,), generator=gen, device=gen.device)


def apply_kernel_pool(x: torch.Tensor, bank: torch.Tensor,
                      idx: torch.Tensor, scale: Optional[int] = None
                      ) -> torch.Tensor:
    """Each sample blurred by its pool kernel ``bank[idx]`` through
    ``apply_kernels`` (the blur kernel), then, with ``scale`` > 1, the
    aligned subsample ``[::scale, ::scale]``."""
    y = D.apply_kernels(x, bank[idx])
    if scale and scale > 1:
        y = y[:, ::scale, ::scale, :]
    return y


def draw_noise_patches(gen: torch.Generator, b: int, n: int
                       ) -> Dict[str, torch.Tensor]:
    """Each sample's patch of a bank of n, (b,), and its horizontal flip,
    (b, 1, 1, 1) bool."""
    return {"idx": torch.randint(0, n, (b,), generator=gen,
                                 device=gen.device),
            "flip": D._uniform(gen, (b, 1, 1, 1)) < 0.5}


def apply_noise_patches(x: torch.Tensor, bank: torch.Tensor,
                        params: Dict[str, torch.Tensor],
                        noise_amp: float = 1.0) -> torch.Tensor:
    """Each sample plus its real-noise patch, tiled over the image where it
    is smaller, flipped left-right where drawn, clipped to [0, 1]; a
    one-channel patch is repeated on every channel."""
    b, h, w, c = x.shape
    n, p, _, pc = bank.shape
    patches = bank[params["idx"]]  # (b, p, p, pc)
    tiled = patches.repeat(1, -(-h // p), -(-w // p), 1)[:, :h, :w, :]
    if pc == 1 and c > 1:
        tiled = tiled.expand(b, h, w, c)
    tiled = torch.where(params["flip"], tiled.flip(2), tiled)
    return (x + noise_amp * tiled[..., :c]).clamp(0.0, 1.0)
