"""pix2pix's trainer: counterpart of ``trainner_tpu/train/pix2pix_trainer.py``
(``Pix2PixTrainer:31``, ``init_state:89``, ``_g_apply:118``,
``_d_apply:128``, ``_train_step:139``, ``train_step:199``,
``eval_step:226``).

G (``network_G``: the U-Net, the ResNet generator, ...) maps A to B. The G
stage: the loss stack on G(A) against B plus, with a GAN, the conditional
adversarial loss, in the standard form unless ``gan_opt.form`` says
otherwise: D sees A concatenated in front of the image, so its input has
A's and B's channels (``in_nc``, which torch needs up front). G's batch
statistics come from its one pass; D runs in train mode in the G stage
and its statistics are dropped. The D stage: the conditional D loss on
the detached G(A) and B, D keeping its real pass's statistics. Adam's
beta1 is ``beta1_G`` / ``beta1_D``, 0.5 by default (0 counts as unset);
no other optimizer option is read; the learning rates default to 2e-4.
A and B are read from the batch as the JAX step reads them (``znorm`` on
by default); the ``aligned`` mode gives LR/HR, which this trainer does
not read (ROADMAP C 22). Dropout draws from the state's generator, which
the step's graph registers, so each replay draws a new mask.
``eval_step`` serves G in eval mode: no dropout, BN's running statistics.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..losses.gan import build_adversarial
from ..models.networks import define_D
from ..ops.blocks import commit_stats
from ..parallel.collectives import average_grads, mean_logs
from .optimizers import build_optimizer, jax_view
from .schedulers import build_scheduler
from .sr_trainer import SRTrainer, _GraphedStep, _no_param_grad, clip_grads
from .state import SRTrainState


class Pix2PixTrainer(SRTrainer):
    """``model: pix2pix``."""

    def __init__(self, opt: dict, dtype: torch.dtype = torch.float32,
                 device=None, graphs: Optional[bool] = None, mesh=None):
        super().__init__(opt, dtype=dtype, device=device, graphs=graphs,
                         mesh=mesh)
        self.scale = 1
        self.znorm = bool(((opt.get("datasets") or {}).get("train")
                           or {}).get("znorm", True))
        if not self.is_train:
            return
        t = self.train_opt
        niter = int(float(t.get("niter", 5e5) or 5e5))
        self.schedG = build_scheduler(t, base_lr=t.get("lr_G", 2e-4),
                                      niter=niter)
        if self.use_gan:
            self.schedD = build_scheduler(
                t, base_lr=t.get("lr_D", t.get("lr_G", 2e-4)), niter=niter)
            self.adversarial = build_adversarial(t, conditional=True)
            self.adversarial.form = (t.get("gan_opt") or {}).get(
                "form", "standard")

    def _make_d(self) -> torch.nn.Module:
        cfg = self.opt.get("network_G") or {}
        return define_D(self.opt, dtype=self.dtype,
                        in_nc=cfg.get("input_nc", 3) + cfg.get("output_nc",
                                                               3))

    def _optimizer(self, net: torch.nn.Module, which: str):
        params = list(net.parameters())
        return build_optimizer(
            params, self.train_opt.get(f"optim_{which}", "adam"),
            beta1=float(self.train_opt.get(f"beta1_{which}", 0.5) or 0.5),
            views=[jax_view(p) for p in params])

    def _p2p_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor],
                  lr_g, lr_d) -> Dict[str, torch.Tensor]:
        """The step's program: updates the state's tensors in place and
        returns the logs; nothing here reads the device."""
        real_a = self._to_device(batch["A"])
        real_b = self._to_device(batch["B"])
        netG = state.g.net.train()
        logs: Dict[str, torch.Tensor] = {}
        state.g.opt.zero_grad()
        fake_b = netG(real_a).float()
        total, glogs = self.generator_loss(fake_b, real_b)
        if self.use_gan:
            netD = state.d.net

            def d_fn(x, want_maps=False):
                return netD(x, train=True, return_feats=want_maps)

            with _no_param_grad(netD):
                l_g_gan = self.adversarial.generator_loss(
                    d_fn, fake_b, real_b, condition=real_a)
            glogs["l_g_gan"] = l_g_gan
            total = total + l_g_gan
        total.backward()
        commit_stats(netG)
        average_grads(state.g.opt.params)
        clip_grads(state.g.opt.params, self.grad_clip, self.grad_clip_value)
        state.g.opt.step(lr_g)
        logs.update(glogs)
        logs["l_g_total"] = total
        if self.use_gan:
            netD = state.d.net
            state.d.opt.zero_grad()
            l_d, dlogs = self.adversarial.discriminator_loss(
                lambda x: netD(x, train=True), fake_b.detach(), real_b,
                condition=real_a, generator=state.noise_generator)
            l_d.backward()
            average_grads(state.d.opt.params)
            clip_grads(state.d.opt.params, self.grad_clip,
                       self.grad_clip_value)
            netD.commit_stats()
            state.d.opt.step(lr_d)
            logs.update(dlogs)
            logs["l_d_total"] = l_d
        return mean_logs({k: v.detach() for k, v in logs.items()})

    def train_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[SRTrainState, Dict[str, torch.Tensor]]:
        """One step on ``batch`` ({"A", "B"}: NHWC, float or uint8);
        updates ``state`` in place."""
        if not self.is_train:
            raise RuntimeError("this trainer was built with is_train: false")
        if self.graphs:
            self._bind(state)
        step = state.step
        fn = self._step_fns.get(("p2p",))
        if fn is None:
            fn = self._in_mesh(self._p2p_step)
            if self.graphs:
                fn = _GraphedStep(self, fn, ("A", "B"))
            self._step_fns[("p2p",)] = fn
        logs = fn(state, batch, self.schedG.get_lr(step),
                  self.schedD.get_lr(step) if self.use_gan else 0.0)
        state.step = step + 1
        return state, logs

    def can_scan_steps(self) -> bool:
        return False

    def _eval_forward(self, state: SRTrainState, x: torch.Tensor,
                      net: str = "g", cem: bool = False) -> torch.Tensor:
        """G(A) in eval mode, in f32, from G's weights."""
        return state.g.net.eval()(x.float()).float()
