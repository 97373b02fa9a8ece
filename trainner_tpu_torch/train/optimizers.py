"""Optimizers: counterpart of ``trainner_tpu/train/optimizers.py``
(``Optimizer:278``, ``build_optimizer:299``) for adam / adamw and sgd, with
the learning rate given at update time. The other optimizers (rmsprop,
adamp, sgdp, ranger, madgrad) are not ported yet (ROADMAP Queue A 10.9).

The update rules are those of the optax chains the JAX package builds:

* adam: ``scale_by_adam`` (bias-corrected m / (sqrt(v) + eps), eps 1e-8:
  torch's Adam formula), then ``add_decayed_weights``: the weight decay is
  *decoupled*, u = adam_direction + wd * p, so a non-zero ``weight_decay``
  is AdamW's rule, not Adam's L2 penalty;
* sgd: ``trace(decay=momentum)``: t = g + momentum * t (torch's SGD with
  dampening 0), then the same decoupled decay;
* p <- p - lr * u.

They are a few lines of ``torch._foreach`` tensor code, so that the state
(``count``, ``mu``, ``nu`` / ``trace``) is the optax state leaf for leaf and
can be carried across from a JAX run.

A step reads nothing from the host that changes from step to step, so a
CUDA graph can replay it: the learning rate is a 0-d f32 tensor, ``count``
an int32 tensor on the parameters' device, and Adam's bias corrections
1 - beta**count are f32 device scalars, computed as XLA computes optax's
``1 - decay**count`` (binary exponentiation in f32: beta, beta^2, beta^4,
... each rounded to f32, the factors of count's set bits multiplied in from
the lowest bit up). The state dict keeps ``count`` an int, as the JAX
format does; loads write into the state's tensors in place, so a graph
captured before a load stays valid.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np
import torch

_COUNT_BITS = 31  # an int32 count


def _power_table(beta: float) -> np.ndarray:
    """beta^(2^i) for i < 31, each square rounded to f32."""
    out = np.empty(_COUNT_BITS, np.float32)
    sq = np.float32(beta)
    for i in range(_COUNT_BITS):
        out[i] = sq
        sq = np.float32(sq * sq)
    return out


class Optimizer:
    """Holds the parameters it updates and their state. ``step(lr)`` applies
    one update from the parameters' ``.grad``; a parameter without a
    gradient is left alone."""

    def __init__(self, params: Sequence[torch.nn.Parameter], name: str,
                 beta1: float, beta2: float, eps: float, weight_decay: float,
                 momentum: float):
        self.params: List[torch.nn.Parameter] = list(params)
        self.name = name
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.weight_decay = weight_decay
        self.momentum = momentum
        device = self.params[0].device if self.params else None
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa
        if name == "adam":
            self.mu, self.nu = zeros(), zeros()
            # the bias corrections' factors beta^(2^i), made once: a copy
            # from the host inside a capture would wait for the card
            self._powers = torch.from_numpy(np.stack(
                [_power_table(beta1), _power_table(beta2)], 1)).to(device)
        else:
            self.trace = zeros()

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _corrections(self):
        """(1 - beta1**count, 1 - beta2**count) as f32 device scalars."""
        shifts = torch.arange(_COUNT_BITS, dtype=torch.int32,
                              device=self.count.device)
        bits = ((self.count >> shifts) & 1).bool()[:, None]
        factors = torch.where(bits, self._powers,
                              torch.ones_like(self._powers))
        acc = factors[0]
        for i in range(1, _COUNT_BITS):
            acc = acc * factors[i]
        c = 1.0 - acc
        return c[0], c[1]

    @torch.no_grad()
    def step(self, lr: Union[torch.Tensor, float]) -> None:
        """One update with learning rate ``lr`` (a 0-d f32 tensor on the
        parameters' device; a float is made into one)."""
        idx = [i for i, p in enumerate(self.params) if p.grad is not None]
        if not idx:
            return
        if not isinstance(lr, torch.Tensor):
            lr = torch.full((), lr, dtype=torch.float32,
                            device=self.count.device)
        params = [self.params[i] for i in idx]
        grads = [self.params[i].grad.float() for i in idx]
        self.count.add_(1)
        if self.name == "adam":
            mu = [self.mu[i] for i in idx]
            nu = [self.nu[i] for i in idx]
            torch._foreach_mul_(mu, self.beta1)
            torch._foreach_add_(mu, grads, alpha=1 - self.beta1)
            torch._foreach_mul_(nu, self.beta2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - self.beta2)
            c1, c2 = self._corrections()
            denom = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            update = torch._foreach_div(mu, c1)
            torch._foreach_div_(update, denom)
        else:
            trace = [self.trace[i] for i in idx]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
            update = [t.clone() for t in trace]
        if self.weight_decay:
            torch._foreach_add_(update, torch._foreach_mul(
                params, self.weight_decay))
        # p - lr * u, rounded as optax's p + (-lr * u)
        torch._foreach_mul_(update, lr)
        torch._foreach_sub_(params, update)

    def state_dict(self) -> Dict:
        state = {"count": int(self.count)}
        for key in ("mu", "nu", "trace"):
            if hasattr(self, key):
                state[key] = [t.clone() for t in getattr(self, key)]
        return state

    def load_state_dict(self, state: Dict) -> None:
        """In place: ``count`` and the moments keep their storage."""
        self.count.fill_(int(state["count"]))
        for key in ("mu", "nu", "trace"):
            if hasattr(self, key):
                for mine, theirs in zip(getattr(self, key), state[key]):
                    mine.copy_(theirs)


def build_optimizer(params: Sequence[torch.nn.Parameter],
                    name: str = "adam", *, beta1: float = 0.9,
                    beta2: float = 0.999, eps: float = 1e-8,
                    weight_decay: float = 0.0, momentum: float = 0.9
                    ) -> Optimizer:
    """String -> Optimizer over ``params``."""
    name = (name or "adam").lower()
    if name == "adamw":
        name = "adam"
    if name not in ("adam", "sgd"):
        raise NotImplementedError(
            f"optimizer [{name}] is not ported yet (ROADMAP Queue A 10.9, "
            "the other optimizers and schedulers)")
    return Optimizer(params, name, beta1, beta2, eps, weight_decay,
                     momentum)
