"""The PBR material trainer: counterpart of
``trainner_tpu/train/pbr_trainer.py`` (``PBRTrainer:32``,
``_map_keys:70``, ``_train_step:74``, ``train_step:112``,
``eval_step:134``) for ``model: pbr`` and its aliases ``sr_pbr`` and
``pbr_sr``.

One G (any ``sr`` generator of ``define_G``; with the flagship
``rrdb_net`` every residual dense block runs the hand-written kernels)
super-resolves every map of a material batch (``LR_{map}`` against
``HR_{map}``, the maps in sorted order), one G pass per map: a
three-channel map (diffuse, albedo, normal) under the whole loss stack,
a one-channel map (ao, height, metalness, reflection, roughness) fed to G
as three repeated channels, the output's channel mean taken, under the
stack without its feature-network losses (``allow_featnets=False``). The
latent noise draws once per step and every map's pass reuses that draw
(``GaussianNoise.hold``), as the JAX step feeds one key to all of them
(ROADMAP C 27). The logs are the stacks' logs suffixed with the map's
name and ``l_g_total``. No D: the JAX trainer builds none. G's optimizer
is ``optim_G`` at its defaults (no beta is read) at ``lr_G`` (1e-4 by
default).

On the card the step is one CUDA graph per map-key set and batch
signature, as the JAX package jits one step per ``map_keys``
(``graphs=False`` runs it eagerly); ``eval_step`` serves G on the
primary map (``LR``) as the ``sr`` trainer's does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..losses.generator_loss import GeneratorLoss
from ..ops.blocks import GaussianNoise, commit_stats
from .sr_trainer import Trainer, _GraphedStep, clip_grads
from .state import SRTrainState


class PBRTrainer(Trainer):
    """``model: pbr`` / ``sr_pbr`` / ``pbr_sr``."""

    def __init__(self, opt: dict, dtype: torch.dtype = torch.float32,
                 device=None, graphs: Optional[bool] = None):
        super().__init__(opt, dtype=dtype, device=device, graphs=graphs)
        self.use_gan = False
        self.adversarial = self.schedD = None
        if self.is_train:
            self.loss_3ch = self.generator_loss
            self.loss_1ch = GeneratorLoss(opt, allow_featnets=False,
                                          device_dtype=dtype
                                          ).to(self.device)

    @staticmethod
    def map_keys(batch) -> List[str]:
        """The batch's map names in sorted order."""
        return sorted(k[3:] for k in batch
                      if k.startswith("LR_") and k != "LR_path")

    def _pbr_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor],
                  lr_g, lr_d, *, map_keys: tuple) -> Dict[str, torch.Tensor]:
        """The step's program: one G pass per map, their losses summed,
        one update; nothing here reads the device."""
        netG = state.g.net.train()
        noises = [m for m in netG.modules() if isinstance(m, GaussianNoise)]
        for m in noises:
            m.hold, m.held = True, None
        state.g.opt.zero_grad()
        total, logs = None, {}
        try:
            for name in map_keys:
                lr_map = self._to_device(batch[f"LR_{name}"])
                hr_map = self._to_device(batch[f"HR_{name}"])
                one = lr_map.shape[-1] == 1
                fake = self._g(netG, lr_map.repeat(1, 1, 1, 3) if one
                               else lr_map)
                if one:
                    fake = fake.mean(-1, keepdim=True)
                loss_fn = self.loss_1ch if one else self.loss_3ch
                l, sub = loss_fn(fake, hr_map)
                total = l if total is None else total + l
                for k, v in sub.items():
                    logs[f"{k}_{name}"] = v
        finally:
            for m in noises:
                m.hold, m.held = False, None
        total.backward()
        commit_stats(netG)
        clip_grads(state.g.opt.params, self.grad_clip, self.grad_clip_value)
        state.g.opt.step(lr_g)
        logs["l_g_total"] = total
        return {k: v.detach() for k, v in logs.items()}

    def train_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[SRTrainState, Dict[str, torch.Tensor]]:
        """One step on a material batch (``LR_{map}`` and ``HR_{map}``
        for each map: NHWC); updates ``state`` in place."""
        if not self.is_train:
            raise RuntimeError("this trainer was built with is_train: false")
        if self.graphs:
            self._bind(state)
        step = state.step
        keys = tuple(self.map_keys(batch))
        fn = self._step_fns.get(("pbr", keys))
        if fn is None:
            def fn(st, b, lr_g, lr_d, keys=keys):
                return self._pbr_step(st, b, lr_g, lr_d, map_keys=keys)
            if self.graphs:
                fn = _GraphedStep(self, fn, tuple(
                    f"{side}_{k}" for k in keys for side in ("LR", "HR")))
            self._step_fns[("pbr", keys)] = fn
        logs = fn(state, batch, self.schedG.get_lr(step), 0.0)
        state.step = step + 1
        return state, logs
