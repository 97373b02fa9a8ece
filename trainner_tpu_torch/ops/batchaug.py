"""Batch augmentations: counterpart of ``trainner_tpu/ops/batchaug.py``
(``_rand_box:25``, ``_box_mask:42``, ``blend:48``, ``rgb_perm:57``,
``mixup:63``, ``cutmix:72``, ``cutmixup:86``, ``cutblur:102``,
``cutout:118``, ``BatchAugment:140``) on NHWC pairs of equal size.

Each augmentation is split into a draw and an apply. ``BatchAugment.draw``
draws the choice (one of the augmentations, ``none`` among them, by the
normalised probabilities) and every augmentation's random quantities from
a ``torch.Generator`` on the batch's device; ``BatchAugment.apply``
computes each augmentation and keeps the chosen one with ``torch.where``
on the device, where the JAX package runs one branch of ``lax.switch``. A
CUDA graph holds the whole mixture; the tests feed the apply the
quantities JAX draws from its keys.

The draws: uniforms and normals from the generator; mixup's and
cutmixup's Beta(alpha, alpha) from two gamma draws, each by Marsaglia and
Tsang's method over a fixed number of candidates (the first accepted one;
alpha < 1 boosted from alpha + 1 by U^(1/alpha)), since torch's Beta and
gamma samplers take no generator; permutations as the argsort of
uniforms; the choice by the probabilities' running sums.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..utils.graphs import device_constant
from .diffaug import randint, uniform

Draw = Dict[str, torch.Tensor]
GAMMA_CANDIDATES = 16  # all rejected: about 1e-21 at alpha >= 1


def gamma(gen, alpha: float, shape, device) -> torch.Tensor:
    """Gamma(alpha, 1) in f32 from ``gen`` (Marsaglia-Tsang over
    ``GAMMA_CANDIDATES`` candidates, the first accepted one kept)."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    shape = tuple(shape)
    x = torch.randn(shape + (GAMMA_CANDIDATES,), generator=gen,
                    device=device, dtype=torch.float64)
    u = torch.rand(shape + (GAMMA_CANDIDATES,), generator=gen,
                   device=device, dtype=torch.float64)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                    + d * torch.log(v.clamp_min(1e-300)))
    first = torch.argmax(ok.to(torch.int8), dim=-1, keepdim=True)
    g = d * torch.gather(v, -1, first)[..., 0]
    if alpha < 1.0:
        g = g * uniform(gen, shape, device).double() ** (1.0 / alpha)
    return g.float()


def beta(gen, alpha: float, shape, device) -> torch.Tensor:
    """Beta(alpha, alpha) in f32: X / (X + Y) of two gamma draws."""
    x = gamma(gen, alpha, shape, device).double()
    y = gamma(gen, alpha, shape, device).double()
    return (x / (x + y)).float()


def permutation(gen, n: int, device) -> torch.Tensor:
    """A uniform random permutation of range(n), as int64."""
    return torch.argsort(uniform(gen, (n,), device))


def _box(h: int, w: int, cut: torch.Tensor, d: Draw):
    """``_rand_box``'s corners from its draws: the normal ``n`` (times a
    spread of 0, as every caller gives) and the centre (cy, cx)."""
    ratio = torch.clamp(cut + 0.0 * d["n"], 0.1, 0.9)
    ch = (ratio * h).to(torch.int32)
    cw = (ratio * w).to(torch.int32)
    y0 = torch.clamp(d["cy"] - torch.div(ch, 2, rounding_mode="floor"), 0, h)
    x0 = torch.clamp(d["cx"] - torch.div(cw, 2, rounding_mode="floor"), 0, w)
    y1 = torch.clamp(d["cy"] + torch.div(ch, 2, rounding_mode="floor"), 0, h)
    x1 = torch.clamp(d["cx"] + torch.div(cw, 2, rounding_mode="floor"), 0, w)
    return y0, y1, x0, x1


def _box_mask(h: int, w: int, y0, y1, x0, x1, device) -> torch.Tensor:
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return ((ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1))[None, :, :, None]


def _draw_box(gen, h: int, w: int, device) -> Draw:
    return {"n": torch.randn((), generator=gen, device=device),
            "cy": randint(gen, 0, h, (), device),
            "cx": randint(gen, 0, w, (), device)}


def _take(x: torch.Tensor, perm: torch.Tensor, dim: int) -> torch.Tensor:
    return x.index_select(dim, perm)


# -- the augmentations: draw(gen, shape, device, alpha) and apply ------------
def draw_blend(gen, shape, device, alpha: float = 0.6) -> Draw:
    b, _, _, c = shape
    return {"c": uniform(gen, (b, 1, 1, c), device),
            "v": alpha + (1 - alpha) * uniform(gen, (), device)}


def blend(img1, img2, d: Draw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blend both with one random solid colour per sample."""
    v, c = d["v"], d["c"]
    return v * img1 + (1 - v) * c, v * img2 + (1 - v) * c


def draw_rgb(gen, shape, device) -> Draw:
    return {"perm": permutation(gen, shape[-1], device)}


def rgb_perm(img1, img2, d: Draw):
    """One random channel order for both."""
    return _take(img1, d["perm"], 3), _take(img2, d["perm"], 3)


def draw_mixup(gen, shape, device, alpha: float = 1.2) -> Draw:
    return {"lam": beta(gen, alpha, (), device),
            "perm": permutation(gen, shape[0], device)}


def mixup(img1, img2, d: Draw):
    """A convex combination with the batch in another order."""
    lam, perm = d["lam"], d["perm"]
    return (lam * img1 + (1 - lam) * _take(img1, perm, 0),
            lam * img2 + (1 - lam) * _take(img2, perm, 0))


def draw_cutmix(gen, shape, device, alpha: float = 0.7) -> Draw:
    b, h, w, _ = shape
    return {"lam": uniform(gen, (), device) * alpha,
            **_draw_box(gen, h, w, device),
            "perm": permutation(gen, b, device)}


def cutmix(img1, img2, d: Draw):
    """A random box pasted from the batch in another order."""
    _, h, w, _ = img1.shape
    mask = _box_mask(h, w, *_box(h, w, torch.sqrt(d["lam"]), d),
                     img1.device)
    perm = d["perm"]
    return (torch.where(mask, _take(img1, perm, 0), img1),
            torch.where(mask, _take(img2, perm, 0), img2))


def draw_cutmixup(gen, shape, device, mixup_alpha: float = 1.2,
                  cutmix_alpha: float = 0.7) -> Draw:
    b, h, w, _ = shape
    return {"lam": beta(gen, mixup_alpha, (), device),
            "u": uniform(gen, (), device) * cutmix_alpha,
            **_draw_box(gen, h, w, device),
            "perm": permutation(gen, b, device)}


def cutmixup(img1, img2, d: Draw):
    """cutmix's box filled with mixup's blend."""
    _, h, w, _ = img1.shape
    mask = _box_mask(h, w, *_box(h, w, torch.sqrt(d["u"]), d), img1.device)
    lam, perm = d["lam"], d["perm"]
    mix1 = lam * img1 + (1 - lam) * _take(img1, perm, 0)
    mix2 = lam * img2 + (1 - lam) * _take(img2, perm, 0)
    return torch.where(mask, mix1, img1), torch.where(mask, mix2, img2)


def draw_cutblur(gen, shape, device, alpha: float = 0.7) -> Draw:
    _, h, w, _ = shape
    return {"u": uniform(gen, (), device) * alpha,
            **_draw_box(gen, h, w, device),
            "inside": uniform(gen, (), device) < 0.5}


def cutblur(hr, lr_up, d: Draw):
    """A random box swapped between HR and the up-scaled LR in the input:
    HR inside the box, or outside it."""
    _, h, w, _ = hr.shape
    mask = _box_mask(h, w, *_box(h, w, torch.sqrt(d["u"]), d), hr.device)
    lr_aug = torch.where(d["inside"], torch.where(mask, hr, lr_up),
                         torch.where(mask, lr_up, hr))
    return hr, lr_aug


def draw_cutout(gen, shape, device, alpha: float = 0.001) -> Draw:
    b, h, w, _ = shape
    return {"keep": uniform(gen, (b, h, w, 1), device) < 1.0 - alpha}


def cutout(img, d: Draw):
    """Random pixel dropout: (img * mask, mask)."""
    mask = d["keep"].to(img.dtype)
    return img * mask, mask


_AUGS = {"blend": (draw_blend, blend), "rgb": (draw_rgb, rgb_perm),
         "mixup": (draw_mixup, mixup), "cutmix": (draw_cutmix, cutmix),
         "cutmixup": (draw_cutmixup, cutmixup),
         "cutblur": (draw_cutblur, cutblur), "cutout": (draw_cutout, cutout)}
_DEFAULT_ALPHA = {"cutout": 0.001, "cutblur": 0.7}


class BatchAugment:
    """The mixture of ``augs`` (their names, ``none`` among them) with
    ``probs`` (normalised; uniform by default) and ``alphas`` by name, on
    (hr, lr) pairs of one size (the trainer brings LR to HR's size first).
    ``draw`` then ``apply``, or ``__call__`` for both."""

    def __init__(self, augs: Sequence[str],
                 probs: Optional[Sequence[float]] = None,
                 alphas: Optional[Dict[str, float]] = None):
        self.augs = [a.lower() for a in augs]
        for a in self.augs:
            if a != "none" and a not in _AUGS:
                raise ValueError(f"unknown batch aug [{a}]")
        p = torch.tensor(probs if probs is not None
                         else [1.0 / len(self.augs)] * len(self.augs),
                         dtype=torch.float32)
        self.probs = (p / p.sum()).tolist()
        # the running sums that split [0, 1) among the choices
        self._bounds = torch.cumsum(torch.tensor(
            self.probs, dtype=torch.float64), 0)[:-1].tolist() or [2.0]
        self.alphas = dict(alphas or {})

    def _kw(self, name: str) -> dict:
        if name in _DEFAULT_ALPHA:
            return {"alpha": self.alphas.get(name, _DEFAULT_ALPHA[name])}
        return {"alpha": self.alphas[name]} if name in self.alphas else {}

    def draw(self, gen, shape, device) -> Dict[str, Draw]:
        """The choice (``idx``, an int64 0-d tensor) and each named
        augmentation's draws."""
        cum = device_constant(self._bounds, torch.float64, device)
        u = torch.rand((), generator=gen, device=device, dtype=torch.float64)
        idx = (u >= cum).sum()
        out: Dict[str, Draw] = {"choice": {"idx": idx}}
        for name in self.augs:
            if name != "none" and name not in out:
                draw = _AUGS[name][0]
                out[name] = draw(gen, tuple(shape), device, **self._kw(name))
        return out

    def apply(self, draws: Dict[str, Draw], hr: torch.Tensor,
              lr: torch.Tensor):
        """(hr_aug, lr_aug, mask): every augmentation of the mixture
        computed, the chosen one kept; ``mask`` is all ones unless cutout
        was chosen."""
        idx = draws["choice"]["idx"].to(hr.device)
        ones = torch.ones((*hr.shape[:3], 1), dtype=hr.dtype,
                          device=hr.device)
        out_h, out_l, out_m = hr, lr, ones
        for i, name in enumerate(self.augs):
            if name == "none":
                continue
            d = {k: v.to(hr.device) for k, v in draws[name].items()}
            m = ones
            if name == "cutout":
                h2 = hr
                l2, m = cutout(lr, d)
            else:
                h2, l2 = _AUGS[name][1](hr, lr, d)
            pick = idx == i
            out_h = torch.where(pick, h2, out_h)
            out_l = torch.where(pick, l2, out_l)
            out_m = torch.where(pick, m, out_m)
        return out_h, out_l, out_m

    def __call__(self, gen, hr: torch.Tensor, lr: torch.Tensor):
        return self.apply(self.draw(gen, hr.shape, hr.device), hr, lr)
