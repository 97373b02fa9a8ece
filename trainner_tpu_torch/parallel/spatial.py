"""Band-parallel inference: counterpart of
``trainner_tpu/parallel/spatial.py`` (``spatial_infer:54``,
``receptive_radius:121``, ``effective_radius:139``).

A large image is cut into horizontal bands, one per device of a list;
each band takes ``halo`` rows from its neighbours (zero rows at the
image's outer edges, as the JAX package's two ``ppermute``s deliver
them), the full network runs on band plus halos, and the halo crop is cut
away. In PyTorch's idiom this is one process with a list of devices: band
*i* runs on device *i*, its halos cut from the whole image. The host
queues the bands one after another and waits for none until all are
queued, so a card runs its band while the host queues the next ones: the
cards overlap as far as the host's launches let them. With a list that
repeats one device, the bands run one after another on that card.

Numerics (as in the JAX package): band seams are exact wherever ``halo``
covers the network's effective receptive field; the outer rows see zero
halos where one forward would pad each conv, so they differ within the
field's reach of the image's edge.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

Device = Union[str, torch.device]


def spatial_infer(apply_fn: Callable[[torch.Tensor, torch.device],
                                     torch.Tensor],
                  lr_img: torch.Tensor, devices: Sequence[Device],
                  halo: int = 16, scale: int = 1,
                  out_device: Device = None) -> torch.Tensor:
    """``apply_fn(band, device)`` over ``lr_img`` (NHWC) cut into
    ``len(devices)`` bands of its height: H padded with zero rows at the
    bottom to a multiple of the number of bands, each band with ``halo``
    rows of its neighbours (zeros beyond the image), band i on device i;
    the outputs' halo rows and the pad cut away and the bands joined on
    ``out_device`` (``lr_img``'s device by default). ``halo`` above the
    band's height raises."""
    n = len(devices)
    b, h, w, c = lr_img.shape
    pad = (-h) % n
    band = (h + pad) // n
    if halo > band:
        raise ValueError(f"halo {halo} > band height {band}; "
                         f"use fewer shards or a larger image")
    out_device = torch.device(out_device) if out_device is not None \
        else lr_img.device
    if n == 1:
        x = F.pad(lr_img, (0, 0, 0, 0, 0, pad)) if pad else lr_img
        out = apply_fn(x.to(devices[0]), torch.device(devices[0]))
        return out[:, : h * scale].to(out_device)
    # the image with `halo` zero rows above, `halo` + pad below
    z = F.pad(lr_img, (0, 0, 0, 0, halo, halo + pad))
    hs = halo * scale
    outs = []
    for i, dev in enumerate(devices):
        dev = torch.device(dev)
        x = z[:, i * band: i * band + band + 2 * halo].to(
            dev, non_blocking=True)
        y = apply_fn(x, dev)
        outs.append(y[:, hs: hs + band * scale])
    out = torch.cat([y.to(out_device, non_blocking=True) for y in outs], 1)
    return out[:, : h * scale]


def receptive_radius(n_convs_3x3: int, scale: int = 1) -> int:
    """The receptive-field radius in input rows of a plain stack of
    ``n_convs_3x3`` SAME 3x3 convs: one row each (up-sampling at the end
    does not widen it). A bound too loose to pick a halo for a deep
    residual net: measure ``effective_radius`` on the served weights."""
    del scale
    return n_convs_3x3


def effective_radius(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                     x: torch.Tensor, rtol: float = 1e-4, scale: int = 1,
                     delta: float = 0.5) -> int:
    """The measured receptive radius of ``apply_fn`` at ``x`` (NHWC): the
    centre input row moved by ``delta``, the largest distance in input rows
    at which an output row moves by more than ``rtol`` times the largest
    move. ``halo >= effective_radius(...)`` keeps band seams within that
    relative level. Two forwards; the result depends on the weights."""
    h = x.shape[1]
    row = h // 2
    x2 = x.clone()
    x2[:, row] += delta
    with torch.inference_mode():
        y1 = apply_fn(x)
        y2 = apply_fn(x2)
    d = (y2 - y1).abs().amax(dim=(0, 2, 3)).float().cpu().numpy()
    peak = float(d.max())
    if peak == 0.0:
        return 0
    hot = np.nonzero(d > rtol * peak)[0]
    out_row = row * scale + (scale - 1) / 2
    reach = max(abs(hot[0] - out_row), abs(hot[-1] - out_row))
    return int(np.ceil(reach / scale))
