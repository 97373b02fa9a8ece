"""Training state: what ``trainner_tpu/train/state.py`` keeps in
``NetState:20`` and ``SRTrainState:35``, as plain mutable objects. The JAX
package carries an immutable pytree through a jitted step; the port
updates parameters, optimizer moments and batch-norm statistics in place,
and ``train_step`` returns the same state object. SWA, EMA, the AdaTarget
net and the auto-clip history are not ported yet.

``rng`` is the JAX state's key (two uint32 words) that a checkpoint
carries; the latent noise is drawn from ``noise_generator``, which the key
seeds (``utils/torch_interop.py::key_to_seed``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .optimizers import Optimizer


@dataclass
class NetState:
    """One network with its optimizer (None for a net that is only run)."""

    net: torch.nn.Module
    opt: Optional[Optimizer] = None


@dataclass
class SRTrainState:
    """G, D (when there is a GAN loss), the step counter, the generator
    that the latent noise is drawn from and the key that seeded it."""

    step: int
    g: NetState
    d: Optional[NetState] = None
    noise_generator: Optional[torch.Generator] = None
    rng: Optional[np.ndarray] = None
