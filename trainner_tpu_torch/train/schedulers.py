"""Learning-rate schedules: counterpart of ``trainner_tpu/train/
schedulers.py`` (``_multistep:21``, ``_multistep_restart:26``,
``_step_lr:41``, ``_cosine:45``, ``_cosine_restart:51``, ``_linear:66``,
``_flat_cosine:74``, ``Scheduler:83``, ``build_scheduler:145``): every
scheme of ``lr_scheme`` with its aliases (MultiStepLR and its restarts,
StepLR, ProgressiveMultiStepLR, CosineAnnealingLR and its restarts,
Linear, FlatCosineDecay, LambdaLR, ReduceLROnPlateau), the linear warmup
over ``warmup_iters``, the SWA switch-over to a constant ``swa_lr`` once
the step is past ``swa_start_iter`` (strictly), and the plateau state.

The schedule runs on the host as a pure ``lr(step)`` function; the trainer
hands the value to the optimizer at every update (into the step graph's
learning-rate tensor on the card). ``plateau_step(metric)`` moves the
plateau state; the training CLI never calls it, as the JAX CLI does not,
so ReduceLROnPlateau trains at a constant rate there (ROADMAP C 19).
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence


def _multistep(base_lr: float, milestones: Sequence[int], gamma: float,
               step: int) -> float:
    return base_lr * gamma ** bisect.bisect_right(sorted(milestones), step)


def _multistep_restart(base_lr: float, milestones: Sequence[int],
                       gamma: float, restarts: Sequence[int],
                       restart_weights: Sequence[float], step: int) -> float:
    """At each restart the rate goes back to base_lr times the restart's
    weight, and the milestones count from there."""
    restarts = sorted(restarts or [])
    weights = list(restart_weights or [1.0] * len(restarts))
    seg = bisect.bisect_right(restarts, step)
    seg_start = restarts[seg - 1] if seg > 0 else 0
    w = weights[seg - 1] if seg > 0 else 1.0
    local = step - seg_start
    ms = sorted(m - seg_start for m in milestones if m > seg_start)
    return base_lr * w * gamma ** bisect.bisect_right(ms, local)


def _step_lr(base_lr: float, step_size: int, gamma: float, step: int) -> float:
    return base_lr * gamma ** (step // max(step_size, 1))


def _cosine(base_lr: float, t_max: int, eta_min: float, step: int) -> float:
    t = min(step, t_max)
    return eta_min + (base_lr - eta_min) * \
        (1 + math.cos(math.pi * t / max(t_max, 1))) / 2


def _cosine_restart(base_lr: float, periods: Sequence[int],
                    restart_weights: Sequence[float], eta_min: float,
                    step: int) -> float:
    """Consecutive cosine periods, each scaled by its restart weight."""
    cum = 0
    for i, p in enumerate(periods):
        if step < cum + p or i == len(periods) - 1:
            w = restart_weights[i] if i < len(restart_weights) else 1.0
            return eta_min + (base_lr * w - eta_min) * \
                (1 + math.cos(math.pi * min(step - cum, p) / max(p, 1))) / 2
        cum += p
    return eta_min


def _linear(base_lr: float, niter: int, fixed: int, step: int) -> float:
    """Constant for ``fixed`` steps, then linear to 0 at ``niter``."""
    if step <= fixed:
        return base_lr
    denom = max(niter - fixed, 1)
    return base_lr * max(0.0, 1.0 - (step - fixed) / denom)


def _flat_cosine(base_lr: float, niter: int, fixed: int, step: int) -> float:
    """Constant for ``fixed`` steps, then a half cosine to 0 at ``niter``."""
    if step <= fixed:
        return base_lr
    t = (step - fixed) / max(niter - fixed, 1)
    return base_lr * (1 + math.cos(math.pi * min(t, 1.0))) / 2


@dataclass
class Scheduler:
    """Host-side lr provider: ``get_lr(step)``, with a linear warmup from 0
    over ``warmup_iters`` steps, the SWA rate after ``swa_start_iter`` and,
    for a plateau schedule, the scale that ``plateau_step`` keeps."""

    fn: Callable[[int], float]
    base_lr: float
    warmup_iters: int = 0
    swa_start_iter: Optional[int] = None
    swa_lr: float = 0.0
    plateau: bool = False
    plateau_mode: str = "max"
    plateau_factor: float = 0.5
    plateau_patience: int = 10
    plateau_threshold: float = 1e-4
    plateau_min_lr: float = 0.0
    _plateau_scale: float = field(default=1.0, repr=False)
    _plateau_best: Optional[float] = field(default=None, repr=False)
    _plateau_bad: int = field(default=0, repr=False)

    def get_lr(self, step: int) -> float:
        if self.swa_start_iter is not None and step > self.swa_start_iter \
                and self.swa_lr:
            return self.swa_lr
        lr = self.fn(step) * self._plateau_scale
        if self.warmup_iters and step < self.warmup_iters:
            lr = lr * (step + 1) / self.warmup_iters
        return max(lr, self.plateau_min_lr if self.plateau else 0.0)

    def get_lrs(self, step0: int, k: int) -> List[float]:
        """The learning rates of the k steps from ``step0``: what the JAX
        ``SRTrainer.train_steps`` hands its scanned window."""
        return [self.get_lr(step0 + i) for i in range(k)]

    def plateau_step(self, metric: float) -> None:
        """One validation's metric: after more than ``plateau_patience``
        readings without a gain of ``plateau_threshold`` the scale shrinks
        by ``plateau_factor``."""
        if not self.plateau:
            return
        better = (self._plateau_best is None or
                  (metric > self._plateau_best + self.plateau_threshold
                   if self.plateau_mode == "max" else
                   metric < self._plateau_best - self.plateau_threshold))
        if better:
            self._plateau_best = metric
            self._plateau_bad = 0
        else:
            self._plateau_bad += 1
            if self._plateau_bad > self.plateau_patience:
                self._plateau_scale *= self.plateau_factor
                self._plateau_bad = 0

    def state_dict(self) -> Dict:
        return {"plateau_scale": self._plateau_scale,
                "plateau_best": self._plateau_best,
                "plateau_bad": self._plateau_bad}

    def load_state_dict(self, d: Dict) -> None:
        self._plateau_scale = d.get("plateau_scale", 1.0)
        self._plateau_best = d.get("plateau_best")
        self._plateau_bad = d.get("plateau_bad", 0)


def build_scheduler(train_opt: dict, base_lr: Optional[float] = None,
                    niter: int = 500000) -> Scheduler:
    """From the JAX package's train-option keys: ``lr_scheme``,
    ``lr_steps`` (or ``lr_steps_rel``), ``lr_gamma``, ``restarts``,
    ``restart_weights``, ``T_period``, ``T_max``, ``eta_min``,
    ``lr_step_size`` (or ``lr_step_sizes``), ``fixed_niter`` (or
    ``fixed_niter_rel``), ``warmup_iters``, ``swa_start_iter`` /
    ``swa_lr`` and the ``plateau_*`` knobs."""
    train_opt = train_opt or {}
    scheme = (train_opt.get("lr_scheme") or "MultiStepLR")
    lr = float(base_lr if base_lr is not None
               else train_opt.get("lr_G", 1e-4) or 1e-4)
    gamma = float(train_opt.get("lr_gamma", 0.5) or 0.5)
    steps = list(train_opt.get("lr_steps") or
                 train_opt.get("lr_steps_rel") or [])
    restarts = list(train_opt.get("restarts") or [])
    rweights = list(train_opt.get("restart_weights") or [])
    eta_min = float(train_opt.get("eta_min", 0.0) or 0.0)
    fixed = int(train_opt.get("fixed_niter", 0) or
                train_opt.get("fixed_niter_rel", 0) or 0)
    key = scheme.lower()

    if key in ("multisteplr", "multistep", "progressivemultisteplr"):
        def fn(s):
            return _multistep(lr, steps, gamma, s)
    elif key in ("multisteplr_restart", "multistep_restart"):
        def fn(s):
            return _multistep_restart(lr, steps, gamma, restarts, rweights,
                                      s)
    elif key in ("steplr", "steplr_restart", "step"):
        size = int(train_opt.get("lr_step_size",
                                 train_opt.get("lr_step_sizes", [50000])[0]
                                 if train_opt.get("lr_step_sizes")
                                 else 50000))

        def fn(s):
            return _step_lr(lr, size, gamma, s)
    elif key in ("cosineannealinglr", "cosine"):
        t_max = int(train_opt.get("T_max", niter) or niter)

        def fn(s):
            return _cosine(lr, t_max, eta_min, s)
    elif key in ("cosineannealinglr_restart", "cosine_restart"):
        periods = list(train_opt.get("T_period") or [niter])

        def fn(s):
            return _cosine_restart(lr, periods, rweights, eta_min, s)
    elif key in ("linear", "lambdalr"):
        def fn(s):
            return _linear(lr, niter, fixed, s)
    elif key in ("flatcosine", "flatcosinedecay"):
        def fn(s):
            return _flat_cosine(lr, niter, fixed, s)
    elif key in ("reducelronplateau", "plateau"):
        def fn(s):
            return lr
    else:
        raise NotImplementedError(f"lr_scheme [{scheme}] not recognized")

    return Scheduler(
        fn=fn, base_lr=lr,
        warmup_iters=int(train_opt.get("warmup_iters", 0) or 0),
        swa_start_iter=train_opt.get("swa_start_iter"),
        swa_lr=float(train_opt.get("swa_lr", 0.0) or 0.0),
        plateau=key in ("reducelronplateau", "plateau"),
        plateau_mode=train_opt.get("plateau_mode", "max"),
        plateau_factor=float(train_opt.get("plateau_factor", 0.5) or 0.5),
        plateau_patience=int(train_opt.get("plateau_patience", 10) or 10),
        plateau_threshold=float(train_opt.get("plateau_threshold", 1e-4)
                                or 1e-4),
        plateau_min_lr=float(train_opt.get("plateau_min_lr", 0.0) or 0.0))
