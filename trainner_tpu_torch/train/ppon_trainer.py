"""PPON's three-phase trainer: counterpart of
``trainner_tpu/train/ppon_trainer.py`` (``_PHASE_PREFIXES:26``,
``PPONTrainer:33``, ``current_phase:47``, ``_mask_to_phase:60``,
``_train_step_ppon:74``, ``train_step:155``, ``eval_step:174``).

The phase comes from a host-side step counter against ``ppon_stages``
([50000, 75000] by default): 1 (content) before the first milestone, 2
(structure) from it, 3 (perceptual) from the second. The counter starts
from ``state.step`` at the trainer's first ``train_step`` and then counts
the trainer's own calls, so a resume lands in the phase its step is in.
Each phase trains its branch of G (the parameter prefixes of
``PHASE_PREFIXES``) on the phase's output (``out_c``, ``out_s``,
``out_p``) under its loss selectors (``p1_losses`` pix, ``p2_losses``
pix-multiscale and ms-ssim, ``p3_losses`` contextual): every parameter
outside the branch, and any that the loss does not reach, gets a zero
gradient, so the optimizer still moves its moments, as optax does on the
JAX package's masked gradients; the other branches get their parameters
back after the update. The GAN (G's adversarial term and
D's update) runs in phase 3 alone. The logs carry ``ppon_phase``.

The step is the JAX package's own function, not the ``sr`` step: it reads
none of the ``sr`` trainer's other options (ROADMAP C 20 lists them). On
the card each ``(phase, update_d)`` program is its own CUDA graph.
``eval_step`` returns the output of ``ppon_phase`` (3 by default) from G's
weights.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from ..parallel.collectives import average_grads, mean_logs
from .sr_trainer import SRTrainer, _GraphedStep, _no_param_grad
from .state import SRTrainState

# each phase's branch: G's parameter-name prefixes (the flax names)
PHASE_PREFIXES = {
    1: ("fea_conv", "rb", "lr_conv", "up_c", "hr0_c", "hr1_c"),
    2: ("ssim", "up_s", "hr0_s", "hr1_s"),
    3: ("gan", "up_p", "hr0_p", "hr1_p"),
}


def phase_params(net: torch.nn.Module, phase: int
                 ) -> Tuple[list, list]:
    """(the parameters ``phase`` trains, the others), by name prefix."""
    prefixes = PHASE_PREFIXES[phase]
    live, frozen = [], []
    for name, p in net.named_parameters():
        (live if name.startswith(prefixes) else frozen).append(p)
    return live, frozen


class PPONTrainer(SRTrainer):
    """``SRTrainer`` with PPON's phased step and its ``eval_step``."""

    def __init__(self, opt: dict, dtype: torch.dtype = torch.float32,
                 device=None, graphs: Optional[bool] = None, mesh=None):
        super().__init__(opt, dtype=dtype, device=device, graphs=graphs,
                         mesh=mesh)
        train_opt = opt.get("train") or {}
        self.p1_losses = list(train_opt.get("p1_losses") or ["pix"])
        self.p2_losses = list(train_opt.get("p2_losses") or
                              ["pix-multiscale", "ms-ssim"])
        self.p3_losses = list(train_opt.get("p3_losses") or ["contextual"])
        self.stages_m = list(train_opt.get("ppon_stages") or
                             [50000, 75000])
        self.inference_phase = int(opt.get("ppon_phase", 3) or 3)
        self._host_step: Optional[int] = None

    def current_phase(self, step: int) -> int:
        phase = 1
        for i, s in enumerate(self.stages_m):
            if step >= s:
                phase = i + 2
        return min(phase, 3)

    def _selectors(self, phase: int) -> list:
        return {1: self.p1_losses, 2: self.p2_losses,
                3: self.p3_losses}[phase]

    def _ppon_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor],
                   lr_g, lr_d, *, phase: int) -> Dict[str, torch.Tensor]:
        """One phase's program: reads the batch, the learning rates and the
        state's tensors, updates the state's tensors in place and returns
        the logs; nothing here reads the device."""
        lr_img = self._to_device(batch["LR"])
        hr_img = self._to_device(batch["HR"])
        netG = state.g.net.train()
        use_gan = self.use_gan and phase == 3
        state.g.opt.zero_grad()
        out = netG(lr_img)[phase - 1].float()
        total, logs = self.generator_loss(out, hr_img,
                                          selectors=self._selectors(phase))
        if use_gan:
            netD = state.d.net

            def d_fn(x, want_maps=False):
                return netD(x, train=True, return_feats=want_maps)

            with _no_param_grad(netD):
                l_g_gan = self.adversarial.generator_loss(d_fn, out, hr_img)
            logs["l_g_gan"] = l_g_gan
            total = total + l_g_gan
        if total.requires_grad:  # a phase whose selectors name no loss
            total.backward()    # has none: every gradient is zero
        for p in netG.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        average_grads(state.g.opt.params)
        _, frozen = phase_params(netG, phase)
        for p in frozen:
            p.grad.zero_()
        kept = [p.detach().clone() for p in frozen]
        state.g.opt.step(lr_g)
        with torch.no_grad():
            torch._foreach_copy_(frozen, kept)
        logs["l_g_total"] = total.detach()
        logs["ppon_phase"] = torch.full((), float(phase),
                                        device=self.device)
        if use_gan:
            netD = state.d.net
            state.d.opt.zero_grad()
            l_d, dlogs = self.adversarial.discriminator_loss(
                lambda x: netD(x, train=True), out.detach(), hr_img,
                generator=state.noise_generator)
            l_d.backward()
            average_grads(state.d.opt.params)
            netD.commit_stats()
            state.d.opt.step(lr_d)
            logs.update(dlogs)
            logs["l_d_total"] = l_d
        return mean_logs({k: v.detach() for k, v in logs.items()})

    def _get_ppon_fn(self, phase: int):
        update_d = self.use_gan and phase == 3
        key = (phase, update_d)
        fn = self._step_fns.get(key)
        if fn is None:
            fn = self._in_mesh(functools.partial(self._ppon_step,
                                                 phase=phase))
            if self.graphs:
                fn = _GraphedStep(self, fn)
            self._step_fns[key] = fn
        return fn

    def train_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[SRTrainState, Dict[str, torch.Tensor]]:
        """One step of the phase that the host counter is in; updates
        ``state`` in place and returns it with the logs."""
        if not self.is_train:
            raise RuntimeError("this trainer was built with is_train: false")
        if self.graphs:
            self._bind(state)
        if self._host_step is None:
            self._host_step = int(state.step)
        step = self._host_step
        self._host_step += 1
        phase = self.current_phase(step)
        lr_g = self.schedG.get_lr(step)
        lr_d = self.schedD.get_lr(step) if self.use_gan else 0.0
        logs = self._get_ppon_fn(phase)(state, batch, lr_g, lr_d)
        state.step = state.step + 1
        return state, logs

    def can_scan_steps(self) -> bool:
        """A window runs as ``train_step`` calls: the phase may change."""
        return False

    def _eval_forward(self, state: SRTrainState, x: torch.Tensor,
                      net: str = "g", cem: bool = False) -> torch.Tensor:
        """G's output of ``ppon_phase`` on ``x``: G's weights whatever
        ``which`` says, no CEM and no unshuffle, as the JAX step serves."""
        return state.g.net.eval()(x.float())[self.inference_phase - 1] \
            .float()
