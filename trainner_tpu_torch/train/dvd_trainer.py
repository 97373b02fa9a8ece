"""The deinterlacing trainer: counterpart of
``trainner_tpu/train/dvd_trainer.py`` (``DVDTrainer:27``,
``_train_step:92``, ``train_step:171``, ``eval_step:189``,
``eval_step_both:193``) for ``model: dvd``.

G (``dvd_net``) predicts the top and bottom frames of an interlaced batch
(``in``); the loss stack supervises each against its target (``top``,
``bottom``), the logs suffixed ``_T`` and ``_B``. With ``gan_weight`` (0
by default) one D judges both frames: the G stage adds both adversarial
losses (``l_g_gan``; D in train mode, its statistics dropped), then D
steps on the detached frames (top first), its statistics from the last
(the bottom's real) pass, wgan-gp's penalty with one alpha for both, as
the JAX step shares one key. G's and D's optimizers are ``optim_G`` /
``optim_D`` at their defaults (no beta is read) at ``lr_G`` (1e-4 by
default) and ``lr_D`` (``lr_G``'s by default).

On the card the step is one CUDA graph per batch signature
(``graphs=False`` runs it eagerly); ``eval_step`` returns the top frame
and ``eval_step_both`` both, one graph per input shape.

Under a mesh each rank runs the step on its slice of the global batch:
wgan-gp's alpha is drawn for the global batch and this rank keeps its
rows (``sample_draw``), D's batch norms see the global batch, G's and
D's gradients are averaged before their clips and the logs are
averaged.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.blocks import commit_stats, discard_stats
from ..parallel.collectives import average_grads, mean_logs, sample_draw
from .sr_trainer import Trainer, _GraphedStep, _no_param_grad, clip_grads
from .state import SRTrainState


class DVDTrainer(Trainer):
    """``model: dvd``."""

    def __init__(self, opt: dict, dtype: torch.dtype = torch.float32,
                 device=None, graphs: Optional[bool] = None, mesh=None):
        super().__init__(opt, dtype=dtype, device=device, graphs=graphs,
                         mesh=mesh)
        self.scale = 1

    def _dvd_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor],
                  lr_g, lr_d) -> Dict[str, torch.Tensor]:
        """The step's program: updates the state's tensors in place and
        returns the logs; nothing here reads the device."""
        x = self._to_device(batch["in"])
        top = self._to_device(batch["top"])
        bottom = self._to_device(batch["bottom"])
        netG = state.g.net.train()
        state.g.opt.zero_grad()
        fake_t, fake_b = netG(x)
        fake_t, fake_b = fake_t.float(), fake_b.float()
        l_t, logs_t = self.generator_loss(fake_t, top)
        l_b, logs_b = self.generator_loss(fake_b, bottom)
        total = l_t + l_b
        logs = {f"{k}_T": v for k, v in logs_t.items()}
        logs.update({f"{k}_B": v for k, v in logs_b.items()})
        if self.use_gan:
            netD = state.d.net

            def d_fn(v, want_maps=False):
                return netD(v, train=True, return_feats=want_maps)

            with _no_param_grad(netD):
                l_gan = self.adversarial.generator_loss(d_fn, fake_t, top) \
                    + self.adversarial.generator_loss(d_fn, fake_b, bottom)
            logs["l_g_gan"] = l_gan
            total = total + l_gan
        total.backward()
        commit_stats(netG)
        average_grads(state.g.opt.params)
        clip_grads(state.g.opt.params, self.grad_clip, self.grad_clip_value)
        state.g.opt.step(lr_g)
        logs["l_g_total"] = total
        if self.use_gan:
            netD = state.d.net
            discard_stats(netD)  # the G stage's passes leave nothing
            state.d.opt.zero_grad()
            alpha = None
            if self.adversarial.uses_penalty:
                alpha = sample_draw(lambda n: torch.rand(
                    (n, 1, 1, 1), generator=state.noise_generator,
                    device=top.device), top.shape[0])
            l_dt, dlogs = self.adversarial.discriminator_loss(
                lambda v: netD(v, train=True), fake_t.detach(), top,
                alpha=alpha)
            l_db, _ = self.adversarial.discriminator_loss(
                lambda v: netD(v, train=True), fake_b.detach(), bottom,
                alpha=alpha)
            l_d = l_dt + l_db
            l_d.backward()
            average_grads(state.d.opt.params)
            clip_grads(state.d.opt.params, self.grad_clip,
                       self.grad_clip_value)
            netD.commit_stats()  # the last (bottom real) pass's statistics
            state.d.opt.step(lr_d)
            logs.update(dlogs)
            logs["l_d_total"] = l_d
        return mean_logs({k: v.detach() for k, v in logs.items()})

    def train_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[SRTrainState, Dict[str, torch.Tensor]]:
        """One step on ``batch`` ({"in", "top", "bottom"}: NHWC); updates
        ``state`` in place."""
        if not self.is_train:
            raise RuntimeError("this trainer was built with is_train: false")
        if self.graphs:
            self._bind(state)
        step = state.step
        fn = self._step_fns.get(("dvd",))
        if fn is None:
            fn = self._in_mesh(self._dvd_step)
            if self.graphs:
                fn = _GraphedStep(self, fn, ("in", "top", "bottom"))
            self._step_fns[("dvd",)] = fn
        logs = fn(state, batch, self.schedG.get_lr(step),
                  self.schedD.get_lr(step) if self.use_gan else 0.0)
        state.step = step + 1
        return state, logs

    def _both(self, state: SRTrainState, x: torch.Tensor) -> torch.Tensor:
        """Both frames of G in eval mode, in f32, stacked on a leading
        axis."""
        t, b = state.g.net.eval()(x.float())
        return torch.stack([t.float(), b.float()])

    @torch.inference_mode()
    def eval_step_both(self, state: SRTrainState, interlaced: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(top frame, bottom frame) of an interlaced NHWC batch, f32 on
        the trainer's device (with graphs, one graph per input shape and
        type, as ``Trainer.eval_step``)."""
        x = interlaced.to(self.device, non_blocking=interlaced.is_pinned())
        if not self.graphs:
            out = self._both(state, x)
        else:
            out = self._eval_graphed(state, (tuple(x.shape), x.dtype, "dvd"),
                                     [x], lambda t: self._both(state, t))
        return out[0], out[1]

    def eval_step(self, state: SRTrainState, interlaced: torch.Tensor,
                  which: str = "auto", apply_cem=None) -> torch.Tensor:
        """The top frame: the deinterlaced output."""
        return self.eval_step_both(state, interlaced)[0]
