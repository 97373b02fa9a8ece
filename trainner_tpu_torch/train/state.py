"""Training state: what ``trainner_tpu/train/state.py`` keeps in
``NetState:20`` and ``SRTrainState:35``, as plain mutable objects. The JAX
package carries an immutable pytree through a jitted step; the port
updates parameters, optimizer moments and batch-norm statistics in place,
and ``train_step`` returns the same state object. EMA weights are a copy
of G (``ema``, from ``init_ema``) that ``ema_update`` moves towards G's
parameters after every step (``train/state.py:74``). SWA weights are
another copy (``swa``, from ``init_swa:61``) that ``swa_update:66``
averages G's parameters into, ``swa_n`` (an int32 device tensor) counting
the updates; ``refresh_bn_stats:79`` recomputes a G's batch-norm
statistics for them. ``loc`` is AdaTarget's LocNet with its optimizer, and
``grad_hist`` the auto clip's ring buffer of G's gradient norms.

``rng`` is the JAX state's key (two uint32 words) that a checkpoint
carries; the latent noise, wgan-gp's interpolation weights and the
augmentations' draws come from ``noise_generator``, which the key seeds
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
    that the latent noise and the augmentations are drawn from and the key
    that seeded it; with ``use_ema`` the EMA copy of G, with ``use_swa``
    the SWA copy and its count, with ``use_atg`` the LocNet, with
    ``grad_clip: auto`` the norm history."""

    step: int
    g: NetState
    d: Optional[NetState] = None
    noise_generator: Optional[torch.Generator] = None
    rng: Optional[np.ndarray] = None
    ema: Optional[torch.nn.Module] = None
    swa: Optional[torch.nn.Module] = None
    swa_n: Optional[torch.Tensor] = None
    loc: Optional[NetState] = None
    grad_hist: Optional[Dict[str, torch.Tensor]] = None

    @property
    def ema_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The EMA weights by G's parameter names, or None."""
        return None if self.ema is None else dict(
            self.ema.named_parameters())


def _g_copy(net: torch.nn.Module) -> torch.nn.Module:
    """A copy of G (its parameters as they are now, no gradients, in eval
    mode), sharing G's latent-noise generator, which eval mode never draws
    from."""
    memo = {id(m.generator): m.generator for m in net.modules()
            if getattr(m, "generator", None) is not None}
    out = copy.deepcopy(net, memo)
    drop_packed(out)
    return out.requires_grad_(False).eval()


def init_ema(state: SRTrainState) -> None:
    """``ema``: a copy of G."""
    state.ema = _g_copy(state.g.net)


def init_swa(state: SRTrainState) -> None:
    """``swa``: a copy of G, and ``swa_n`` = 0 (int32, on G's device)."""
    state.swa = _g_copy(state.g.net)
    state.swa_n = torch.zeros((), dtype=torch.int32,
                              device=next(state.g.net.parameters()).device)


@torch.no_grad()
def swa_update(state: SRTrainState) -> None:
    """a <- (a n + p) / (n + 1) for every parameter, in f32, each product,
    sum and quotient rounded as the JAX package's ``swa_update`` rounds
    them, with n the count made a float; then n += 1. One pass of foreach
    ops on the card, reading nothing back; G's buffers (a batch norm's
    running statistics) are copied into the SWA copy, whose evaluation
    uses G's statistics as the JAX package's does."""
    swa = list(state.swa.parameters())
    n = state.swa_n.float()
    torch._foreach_mul_(swa, n)
    torch._foreach_add_(swa, [p.detach() for p in
                              state.g.net.parameters()])
    torch._foreach_div_(swa, n + 1.0)
    state.swa_n.add_(1)
    buffers = list(state.swa.buffers())
    if buffers:
        torch._foreach_copy_(buffers, list(state.g.net.buffers()))


@torch.no_grad()
def refresh_bn_stats(net: torch.nn.Module, batches, prepare=None
                     ) -> Optional[Dict[str, torch.Tensor]]:
    """The batch-norm running statistics of ``net`` recomputed over
    ``batches`` as the JAX package's ``refresh_bn_stats`` does (torch's
    ``update_bn`` with momentum None): per batch, one train-mode pass from
    zeroed statistics, whose update 0.99 * 0 + 0.01 * stat is divided by
    0.01 again; the mean of those over the batches. Returns them by buffer
    name (the net's own buffers are left as they were), or None when the
    net has no batch norm or there is no batch. ``prepare`` maps a batch
    to the net's input."""
    from ..ops.blocks import BatchNorm

    norms = {name: m for name, m in net.named_modules()
             if isinstance(m, BatchNorm)}
    if not norms or not batches:
        return None
    saved = {n: (m.running_mean.clone(), m.running_var.clone())
             for n, m in norms.items()}
    acc: Dict[str, torch.Tensor] = {}
    was_training = net.training
    net.train()
    try:
        for x in batches:
            for m in norms.values():
                m.running_mean.zero_()
                m.running_var.zero_()
            net(prepare(x) if prepare is not None else x)
            for name, m in norms.items():
                for leaf, new in zip(("running_mean", "running_var"),
                                     m.pending):
                    v = new / (1.0 - m.momentum)
                    key = f"{name}.{leaf}"
                    acc[key] = v if key not in acc else acc[key] + v
                m.pending = None
    finally:
        net.train(was_training)
        for n, m in norms.items():
            m.running_mean.copy_(saved[n][0])
            m.running_var.copy_(saved[n][1])
    return {k: v / float(len(batches)) for k, v in acc.items()}


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
