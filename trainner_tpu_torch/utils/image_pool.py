"""The replay buffer of generated images for CycleGAN's discriminators:
counterpart of ``trainner_tpu/utils/image_pool.py`` (``ImagePool:16``,
``query:22``).

Each image of a queried batch is stored while the pool holds fewer than
``pool_size``; once it is full, with probability 0.5 a random stored image
is handed out in its place and the new one stored in that slot, else the
image passes through. The choices come from
``numpy.random.default_rng(seed)`` on the host, drawn in the JAX pool's
order, so both packages make the same choices; they depend on nothing but
the count of images seen. The stored images stay on the device of the
batch: a swap is a device copy at host-chosen indices, nothing is read
back to the host, and no step's graph holds it (the trainer runs it
between the G stage's replay and the D stage's).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class ImagePool:
    def __init__(self, pool_size: int = 50, seed: int = 0):
        self.pool_size = pool_size
        self.rng = np.random.default_rng(seed)
        self.images: Optional[torch.Tensor] = None  # (pool_size, h, w, c)
        self.count = 0  # images stored so far

    def query(self, images: torch.Tensor) -> torch.Tensor:
        """``images``: a (b, h, w, c) batch of fresh fakes -> the batch the
        discriminator sees (a new tensor; ``images`` is left as it is)."""
        if self.pool_size <= 0:
            return images
        if self.images is None:
            self.images = torch.empty((self.pool_size, *images.shape[1:]),
                                      dtype=images.dtype,
                                      device=images.device)
        out = images.clone()
        for i in range(images.shape[0]):
            if self.count < self.pool_size:
                self.images[self.count].copy_(images[i])
                self.count += 1
            elif self.rng.random() > 0.5:
                idx = int(self.rng.integers(0, self.pool_size))
                out[i].copy_(self.images[idx])
                self.images[idx].copy_(images[i])
        return out
