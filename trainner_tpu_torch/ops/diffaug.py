"""DiffAugment for D's inputs: counterpart of ``trainner_tpu/ops/
diffaug.py`` (``rand_brightness:20`` ... ``rand_offset:110``,
``AUGMENT_FNS:122``, ``diff_augment:136``) with every policy: ``color``
(brightness, saturation, contrast), ``translation``, ``cutout``, ``flip``,
``rotate``, ``zoom_in``, ``zoom_out``, ``offset``, ``offset_h``,
``offset_v``, on NHWC batches.

Each transform is split into a draw and an apply. ``draw_diff_augment``
draws every random quantity a policy needs (the per-sample uniforms,
offsets and flips, the batch's rotation and zoom offsets) from a
``torch.Generator`` on the batch's device; ``apply_diff_augment`` applies
them. The trainer draws once and applies the same draws to the fake and
the real batch, as the JAX step applies one key to both; the tests feed
the apply the quantities JAX draws from its keys. Every choice is made on
the device (index maps, ``torch.where``), so a CUDA graph holds it, and
every apply is differentiable in its input.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .imresize import jax_resize

Draw = Dict[str, torch.Tensor]


def uniform(gen, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device)


def randint(gen, lo: int, hi: int, shape, device) -> torch.Tensor:
    """Integers uniform in [lo, hi), as int64 (an f64 uniform scaled and
    floored)."""
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    return (lo + torch.floor(u * (hi - lo))).long().clamp_(lo, hi - 1)


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)


# -- color -----------------------------------------------------------------
def _draw_unit(gen, shape, device) -> Draw:
    return {"u": uniform(gen, (shape[0], 1, 1, 1), device)}


def brightness(x, d: Draw):
    return x + (d["u"] - 0.5)


def saturation(x, d: Draw):
    mean = x.mean(-1, keepdim=True)
    return (x - mean) * d["u"] * 2.0 + mean


def contrast(x, d: Draw):
    mean = x.mean((1, 2, 3), keepdim=True)
    return (x - mean) * (d["u"] + 0.5) + mean


# -- translation and cutout -------------------------------------------------
def _draw_translation(gen, shape, device, ratio: float = 0.125) -> Draw:
    b, h, w = shape[:3]
    rh, rw = int(h * ratio + 0.5), int(w * ratio + 0.5)
    return {"ty": randint(gen, -rh, rh + 1, (b,), device),
            "tx": randint(gen, -rw, rw + 1, (b,), device)}


def translation(x, d: Draw):
    """Shift each sample by (ty, tx), zeros coming in."""
    b, h, w, c = x.shape
    pad = F.pad(x, (0, 0, 1, 1, 1, 1))
    yi = (_iota(h, x.device)[None] + d["ty"][:, None] + 1).clamp(0, h + 1)
    xi = (_iota(w, x.device)[None] + d["tx"][:, None] + 1).clamp(0, w + 1)
    rows = pad.gather(1, yi[:, :, None, None].expand(b, h, w + 2, c))
    return rows.gather(2, xi[:, None, :, None].expand(b, h, w, c))


def _cut(h: int, ratio: float = 0.5) -> int:
    return int(h * ratio + 0.5)


def _draw_cutout(gen, shape, device, ratio: float = 0.5) -> Draw:
    b, h, w = shape[:3]
    ch, cw = _cut(h, ratio), _cut(w, ratio)
    return {"oy": randint(gen, 0, h + (1 - ch % 2), (b,), device),
            "ox": randint(gen, 0, w + (1 - cw % 2), (b,), device)}


def cutout(x, d: Draw, ratio: float = 0.5):
    """Zero a (h/2, w/2) box centred at each sample's (oy, ox)."""
    b, h, w, _ = x.shape
    ch, cw = _cut(h, ratio), _cut(w, ratio)
    ys = _iota(h, x.device)[None, :, None]
    xs = _iota(w, x.device)[None, None, :]
    y0 = d["oy"][:, None, None] - ch // 2
    x0 = d["ox"][:, None, None] - cw // 2
    inside = (ys >= y0) & (ys < y0 + ch) & (xs >= x0) & (xs < x0 + cw)
    return x * (~inside)[..., None].to(x.dtype)


# -- flip and rotate --------------------------------------------------------
def _draw_flip(gen, shape, device, prob: float = 0.5) -> Draw:
    return {"flip": uniform(gen, (shape[0], 1, 1, 1), device) < prob}


def flip(x, d: Draw):
    return torch.where(d["flip"], x.flip(2), x)


def _draw_rotate(gen, shape, device) -> Draw:
    return {"k": randint(gen, 0, 4, (), device)}


def rotate(x, d: Draw):
    """One rot90 k of the whole batch (square inputs), picked on the
    device."""
    rots = torch.stack([torch.rot90(x, i, (1, 2)) for i in range(4)])
    return torch.index_select(rots, 0, d["k"].reshape(1))[0]


# -- zooms and offsets ------------------------------------------------------
def _zoomed(h: int, w: int, z: float):
    return int(h * z), int(w * z)


def _draw_zoom_in(gen, shape, device, max_zoom: float = 1.25) -> Draw:
    h, w = shape[1:3]
    hz, wz = _zoomed(h, w, max_zoom)
    return {"oy": randint(gen, 0, hz - h + 1, (), device),
            "ox": randint(gen, 0, wz - w + 1, (), device)}


def zoom_in(x, d: Draw, max_zoom: float = 1.25):
    """The bilinear (antialiased) enlargement by max_zoom, cropped back to
    (h, w) at (oy, ox)."""
    _, h, w, _ = x.shape
    big = jax_resize(x, _zoomed(h, w, max_zoom), "linear", antialias=True)
    big = big.index_select(1, d["oy"] + _iota(h, x.device))
    return big.index_select(2, d["ox"] + _iota(w, x.device))


def _draw_zoom_out(gen, shape, device, min_zoom: float = 0.8) -> Draw:
    h, w = shape[1:3]
    hz, wz = _zoomed(h, w, min_zoom)
    return {"oy": randint(gen, 0, h - hz + 1, (), device),
            "ox": randint(gen, 0, w - wz + 1, (), device)}


def zoom_out(x, d: Draw, min_zoom: float = 0.8):
    """The bilinear (antialiased) reduction by min_zoom, pasted at (oy, ox)
    on a canvas of 0.5."""
    _, h, w, _ = x.shape
    hz, wz = _zoomed(h, w, min_zoom)
    small = jax_resize(x, (hz, wz), "linear", antialias=True)
    ry = _iota(h, x.device) - d["oy"]
    rx = _iota(w, x.device) - d["ox"]
    small = small.index_select(1, ry.clamp(0, hz - 1))
    small = small.index_select(2, rx.clamp(0, wz - 1))
    inside = ((ry >= 0) & (ry < hz))[None, :, None, None] & \
        ((rx >= 0) & (rx < wz))[None, None, :, None]
    return torch.where(inside, small, torch.full_like(small, 0.5))


def _draw_offset(gen, shape, device, ratio_h: float = 1.0,
                 ratio_v: float = 1.0) -> Draw:
    h, w = shape[1:3]
    rv, rh = int(h * ratio_v + 0.5), int(w * ratio_h + 0.5)
    return {"sh": randint(gen, -rv, rv + 1, (), device),
            "sw": randint(gen, -rh, rh + 1, (), device)}


def offset(x, d: Draw):
    """A circular shift by (sh, sw), as ``jnp.roll``."""
    _, h, w, _ = x.shape
    x = x.index_select(1, torch.remainder(_iota(h, x.device) - d["sh"], h))
    return x.index_select(2, torch.remainder(_iota(w, x.device) - d["sw"],
                                             w))


def _offset_draw(**kw) -> Callable:
    return lambda gen, shape, device: _draw_offset(gen, shape, device, **kw)


# policy -> its transforms in order, each (draw, apply)
AUGMENT_FNS = {
    "color": [(_draw_unit, brightness), (_draw_unit, saturation),
              (_draw_unit, contrast)],
    "translation": [(_draw_translation, translation)],
    "cutout": [(_draw_cutout, cutout)],
    "flip": [(_draw_flip, flip)],
    "rotate": [(_draw_rotate, rotate)],
    "zoom_in": [(_draw_zoom_in, zoom_in)],
    "zoom_out": [(_draw_zoom_out, zoom_out)],
    "offset": [(_draw_offset, offset)],
    "offset_h": [(_offset_draw(ratio_v=0.0), offset)],
    "offset_v": [(_offset_draw(ratio_h=0.0), offset)],
}


def _policies(policy: str) -> List[str]:
    out = [p.strip() for p in (policy or "").split(",") if p.strip()]
    for p in out:
        if p not in AUGMENT_FNS:
            raise KeyError(f"DiffAugment policy [{p}]")
    return out


def draw_diff_augment(gen: Optional[torch.Generator], policy: str,
                      shape: Sequence[int], device,
                      shared: Optional[List[Draw]] = None) -> List[Draw]:
    """The draws of ``policy`` for a batch of ``shape`` (b, h, w, c), one
    dict per transform in order. ``shared``: the draws of the same policy
    for a batch of the same (h, w) whose batch-wide (0-d) draws are taken
    over, as the JAX package's one key gives them to both of a step's
    batch sizes."""
    out: List[Draw] = []
    for p in _policies(policy):
        for draw, _ in AUGMENT_FNS[p]:
            d = draw(gen, tuple(shape), device)
            if shared is not None:
                prev = shared[len(out)]
                d = {k: prev[k] if v.dim() == 0 else v for k, v in d.items()}
            out.append(d)
    return out


def apply_diff_augment(x: torch.Tensor, policy: str,
                       draws: List[Draw]) -> torch.Tensor:
    """``policy``'s transforms applied to ``x`` with ``draws``."""
    fns = [apply for p in _policies(policy) for _, apply in AUGMENT_FNS[p]]
    if len(fns) != len(draws):
        raise ValueError(f"{len(draws)} draws for {len(fns)} transforms")
    for apply, d in zip(fns, draws):
        x = apply(x, {k: v.to(x.device) for k, v in d.items()})
    return x


def diff_augment(x: torch.Tensor, policy: str = "",
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Draw and apply ``policy`` on ``x`` (comma-separated)."""
    if not policy:
        return x
    return apply_diff_augment(x, policy, draw_diff_augment(
        generator, policy, x.shape, x.device))
