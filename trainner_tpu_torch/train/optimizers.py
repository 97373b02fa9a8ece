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
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch


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
        self.count = 0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa
        if name == "adam":
            self.mu, self.nu = zeros(), zeros()
        else:
            self.trace = zeros()

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, lr: float) -> None:
        idx = [i for i, p in enumerate(self.params) if p.grad is not None]
        if not idx:
            return
        params = [self.params[i] for i in idx]
        grads = [self.params[i].grad.float() for i in idx]
        self.count += 1
        if self.name == "adam":
            mu = [self.mu[i] for i in idx]
            nu = [self.nu[i] for i in idx]
            torch._foreach_mul_(mu, self.beta1)
            torch._foreach_add_(mu, grads, alpha=1 - self.beta1)
            torch._foreach_mul_(nu, self.beta2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - self.beta2)
            c1 = 1 - self.beta1 ** self.count
            c2 = 1 - self.beta2 ** self.count
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
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_add_(params, update, alpha=-lr)

    def state_dict(self) -> Dict:
        state = {"count": self.count}
        for key in ("mu", "nu", "trace"):
            if hasattr(self, key):
                state[key] = [t.clone() for t in getattr(self, key)]
        return state

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
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
