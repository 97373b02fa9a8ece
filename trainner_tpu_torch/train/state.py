"""Training state: what ``trainner_tpu/train/state.py`` keeps in
``NetState:20`` and ``SRTrainState:35``, as plain mutable objects. The JAX
package carries an immutable pytree through a jitted step; the port
updates parameters, optimizer moments and batch-norm statistics in place,
and ``train_step`` returns the same state object. EMA weights are a copy
of G (``ema``, from ``init_ema``) that ``ema_update`` moves towards G's
parameters after every step (``train/state.py:74``). SWA, the AdaTarget
net and the auto-clip history are not ported yet.

``rng`` is the JAX state's key (two uint32 words) that a checkpoint
carries; the latent noise and wgan-gp's interpolation weights are drawn
from ``noise_generator``, which the key seeds
(``utils/torch_interop.py::key_to_seed``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..models.rrdb import drop_packed
from ..utils.graphs import device_constant
from .optimizers import Optimizer


@dataclass
class NetState:
    """One network with its optimizer (None for a net that is only run)."""

    net: torch.nn.Module
    opt: Optional[Optimizer] = None


@dataclass
class SRTrainState:
    """G, D (when there is a GAN loss), the step counter, the generator
    that the latent noise is drawn from and the key that seeded it, and
    with ``use_ema`` the EMA copy of G."""

    step: int
    g: NetState
    d: Optional[NetState] = None
    noise_generator: Optional[torch.Generator] = None
    rng: Optional[np.ndarray] = None
    ema: Optional[torch.nn.Module] = None

    @property
    def ema_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The EMA weights by G's parameter names, or None."""
        return None if self.ema is None else dict(
            self.ema.named_parameters())


def init_ema(state: SRTrainState) -> None:
    """``ema``: a copy of G (its parameters as they are now, no gradients,
    in eval mode), sharing G's latent-noise generator, which eval mode
    never draws from."""
    net = state.g.net
    memo = {id(m.generator): m.generator for m in net.modules()
            if getattr(m, "generator", None) is not None}
    ema = copy.deepcopy(net, memo)
    drop_packed(ema)
    state.ema = ema.requires_grad_(False).eval()


@torch.no_grad()
def ema_update(state: SRTrainState, decay: float) -> None:
    """e <- decay e + (1 - decay) p for every parameter, in f32, rounded as
    the JAX package's jitted step rounds it: 1 - decay rounded to f32, its
    product with p rounded, and decay e + that product rounded once (XLA
    fuses the multiply and the add; ``addcmul`` does the same here, where
    two roundings or ``lerp`` would differ in the last place). The sums run
    over G's and the EMA's parameters flattened into one buffer each, and
    are copied back in place: the copies move the EMA parameters' version
    counters, which the blocks' packed weights are checked against. G's
    buffers (a batch norm's running statistics) are copied into the EMA
    copy, which evaluates with G's statistics as the JAX package's EMA
    weights do."""
    ema = list(state.ema.parameters())
    e = torch.cat([p.reshape(-1) for p in ema])
    g = torch.cat([p.detach().reshape(-1)
                   for p in state.g.net.parameters()])
    d = device_constant((decay,), torch.float32, e.device)
    new = torch.addcmul(g.mul_(1.0 - decay), e, d)
    torch._foreach_copy_(ema, [v.view_as(p) for v, p in zip(
        new.split([p.numel() for p in ema]), ema)])
    buffers = list(state.ema.buffers())
    if buffers:
        torch._foreach_copy_(buffers, list(state.g.net.buffers()))
