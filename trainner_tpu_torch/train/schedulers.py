"""Learning-rate schedules: counterpart of ``trainner_tpu/train/
schedulers.py`` (``_multistep:21``, ``Scheduler:83``,
``build_scheduler:145``) for MultiStepLR with warmup. The schedule runs on
the host as a pure ``lr(step)`` function; the trainer hands the value to
the optimizer at every update. The other schemes, the SWA switch-over and
the plateau state are not ported yet (ROADMAP Queue A 10.9).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence


def _multistep(base_lr: float, milestones: Sequence[int], gamma: float,
               step: int) -> float:
    return base_lr * gamma ** bisect.bisect_right(sorted(milestones), step)


@dataclass
class Scheduler:
    """Host-side lr provider: ``get_lr(step)``, with a linear warmup from 0
    over ``warmup_iters`` steps."""

    fn: Callable[[int], float]
    base_lr: float
    warmup_iters: int = 0

    def get_lr(self, step: int) -> float:
        lr = self.fn(step)
        if self.warmup_iters and step < self.warmup_iters:
            lr = lr * (step + 1) / self.warmup_iters
        return max(lr, 0.0)

    def get_lrs(self, step0: int, k: int) -> List[float]:
        """The learning rates of the k steps from ``step0``: what the JAX
        ``SRTrainer.train_steps`` hands its scanned window."""
        return [self.get_lr(step0 + i) for i in range(k)]


def build_scheduler(train_opt: dict, base_lr: Optional[float] = None,
                    niter: int = 500000) -> Scheduler:
    """From the train options ``lr_scheme``, ``lr_steps``, ``lr_gamma`` and
    ``warmup_iters`` (the same keys as the JAX package)."""
    train_opt = train_opt or {}
    scheme = train_opt.get("lr_scheme") or "MultiStepLR"
    if scheme.lower() not in ("multisteplr", "multistep"):
        raise NotImplementedError(
            f"lr_scheme [{scheme}] is not ported yet (ROADMAP Queue A 10.9, "
            "the other optimizers and schedulers)")
    if train_opt.get("swa_start_iter") is not None and \
            train_opt.get("swa_lr"):
        raise NotImplementedError(
            "the SWA learning-rate switch-over is not ported yet (ROADMAP "
            "Queue A 10.10, SWA and EMA)")
    lr = float(base_lr if base_lr is not None
               else train_opt.get("lr_G", 1e-4) or 1e-4)
    gamma = float(train_opt.get("lr_gamma", 0.5) or 0.5)
    steps = list(train_opt.get("lr_steps") or
                 train_opt.get("lr_steps_rel") or [])
    return Scheduler(fn=lambda s: _multistep(lr, steps, gamma, s),
                     base_lr=lr,
                     warmup_iters=int(train_opt.get("warmup_iters", 0) or 0))
