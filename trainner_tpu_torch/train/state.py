"""Training state: what ``trainner_tpu/train/state.py`` keeps in
``NetState:20`` and ``SRTrainState:35``, as plain mutable objects. The JAX
package carries an immutable pytree through a jitted step; the port
updates parameters, optimizer moments and batch-norm statistics in place,
and ``train_step`` returns the same state object. SWA, EMA, the AdaTarget
net and the auto-clip history are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .optimizers import Optimizer


@dataclass
class NetState:
    """One network with its optimizer (None for a net that is only run)."""

    net: torch.nn.Module
    opt: Optional[Optimizer] = None


@dataclass
class SRTrainState:
    """G, D (when there is a GAN loss), the step counter and the generator
    that the latent noise is drawn from."""

    step: int
    g: NetState
    d: Optional[NetState] = None
    noise_generator: Optional[torch.Generator] = None
