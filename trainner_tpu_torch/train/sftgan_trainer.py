"""SFTGAN's trainer: counterpart of ``trainner_tpu/train/sftgan_trainer.py``
(``_xent:28``, ``SFTGANTrainer:34``, ``init_state:80``, ``_d_apply:111``,
``_train_step:121``, ``train_step:190``, ``eval_step:206``).

G is ``SFTNet`` built from ``network_G``'s ``nf``, ``cond_nf`` and
``n_blocks`` (``define_G`` reads none of them, ROADMAP C 22), fed
the LR batch and the HR-size segmentation maps (``seg``). D is the
auxiliary-classifier ``ACDVGGBN96`` whatever ``network_D`` says (96 px
inputs). The class labels are the batch's ``category`` or, without one,
the argmax of each image's mean map. The G stage: the loss stack on G's
output plus, with a GAN, ``gan_weight`` times the GAN loss of D's logit
and the class cross-entropy of D's class logits, unscaled; D runs in
train mode there and its statistics are dropped. The D stage: (real +
fake) / 2 plus the cross-entropies of both passes; D keeps the batch
statistics of its real pass only. Each net's optimizer is ``optim_G`` /
``optim_D`` at its defaults: the JAX trainer reads no betas and no weight
decay. The learning rates follow the schedules, G's and D's step every
step. ``eval_step`` serves G with the given maps, or uniform 1/8 maps.

On the card the step is one CUDA graph per batch signature (the batch's
``LR``, ``HR``, ``seg`` and, when it has one, ``category``);
``graphs=False`` runs it eagerly. ``eval_step`` runs eagerly.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..losses.gan import gan_loss
from ..models.sft import ACDVGGBN96, SFTNet
from ..ops.blocks import commit_stats, discard_stats
from .optimizers import build_optimizer, jax_view
from .sr_trainer import SRTrainer, _GraphedStep, _no_param_grad, clip_grads
from .state import SRTrainState


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean over the batch of -sum(log_softmax(logits) * one_hot)."""
    return -(F.log_softmax(logits.float(), -1).gather(
        1, labels.long()[:, None])).mean()


def seg_labels(seg: torch.Tensor) -> torch.Tensor:
    """Each image's dominant class: the argmax of its mean map."""
    return torch.argmax(seg.mean((1, 2)), -1)


class SFTGANTrainer(SRTrainer):
    """``model: sftgan`` / ``sftgan_acd``."""

    def __init__(self, opt: dict, dtype: torch.dtype = torch.float32,
                 device=None, graphs: Optional[bool] = None):
        super().__init__(opt, dtype=dtype, device=device, graphs=graphs)
        cfg = opt.get("network_G") or {}
        self.nf = cfg.get("nf", 64)
        self.cond_nf = cfg.get("cond_nf", 32)
        self.n_blocks = cfg.get("n_blocks", 16)
        self.gan_type = self.train_opt.get("gan_type", "vanilla")
        if self.adversarial is not None:
            # the JAX step takes gan_loss alone: no penalty pass
            self.adversarial.gp_weight = None

    def _make_g(self) -> torch.nn.Module:
        return SFTNet(nf=self.nf, cond_nf=self.cond_nf,
                      n_blocks=self.n_blocks, dtype=self.dtype)

    def _make_d(self) -> torch.nn.Module:
        return ACDVGGBN96(dtype=self.dtype)

    def _optimizer(self, net: torch.nn.Module, which: str):
        params = list(net.parameters())
        return build_optimizer(params, self.train_opt.get(
            f"optim_{which}", "adam"), views=[jax_view(p) for p in params])

    def _sft_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor],
                  lr_g, lr_d) -> Dict[str, torch.Tensor]:
        """The step's program: updates the state's tensors in place and
        returns the logs; nothing here reads the device."""
        lr_img = self._to_device(batch["LR"])
        hr_img = self._to_device(batch["HR"])
        seg = batch["seg"].to(self.device).float()
        labels = batch["category"].to(self.device).long() \
            if "category" in batch else seg_labels(seg)
        netG = state.g.net.train()
        logs: Dict[str, torch.Tensor] = {}
        state.g.opt.zero_grad()
        fake = netG(lr_img, seg).float()
        total, glogs = self.generator_loss(fake, hr_img)
        if self.use_gan:
            netD = state.d.net
            with _no_param_grad(netD):
                gan_logits, cls_logits = netD(fake, train=True)
            l_gan = self.gan_weight * gan_loss(self.gan_type, gan_logits,
                                               True)
            l_cls = xent(cls_logits, labels)
            glogs["l_g_gan"], glogs["l_g_cls"] = l_gan, l_cls
            total = total + l_gan + l_cls
        total.backward()
        commit_stats(netG)
        clip_grads(state.g.opt.params, self.grad_clip, self.grad_clip_value)
        state.g.opt.step(lr_g)
        logs.update(glogs)
        logs["l_g_total"] = total
        if self.use_gan:
            netD = state.d.net
            discard_stats(netD)  # the G stage's pass leaves nothing
            state.d.opt.zero_grad()
            gan_r, cls_r = netD(hr_img, train=True)
            netD.commit_stats()  # the real pass's statistics alone
            gan_f, cls_f = netD(fake.detach(), train=True)
            discard_stats(netD)
            l_real = gan_loss(self.gan_type, gan_r, True, is_disc=True)
            l_fake = gan_loss(self.gan_type, gan_f, False, is_disc=True)
            l_cls = xent(cls_r, labels) + xent(cls_f, labels)
            l_d = (l_real + l_fake) * 0.5 + l_cls
            l_d.backward()
            clip_grads(state.d.opt.params, self.grad_clip,
                       self.grad_clip_value)
            state.d.opt.step(lr_d)
            logs.update({"l_d_real": l_real, "l_d_fake": l_fake,
                         "l_d_cls": l_cls, "D_real": gan_r.mean(),
                         "D_fake": gan_f.mean(), "l_d_total": l_d})
        return {k: v.detach() for k, v in logs.items()}

    def train_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[SRTrainState, Dict[str, torch.Tensor]]:
        """One step on ``batch`` ({"LR", "HR", "seg"} and optionally
        ``category``; NHWC); updates ``state`` in place."""
        if not self.is_train:
            raise RuntimeError("this trainer was built with is_train: false")
        if self.graphs:
            self._bind(state)
        step = state.step
        fn = self._step_fns.get(("sft",))
        if fn is None:
            fn = self._sft_step
            if self.graphs:
                fn = _GraphedStep(self, fn, ("LR", "HR", "seg", "category"))
            self._step_fns[("sft",)] = fn
        logs = fn(state, batch, self.schedG.get_lr(step),
                  self.schedD.get_lr(step) if self.use_gan else 0.0)
        state.step = step + 1
        return state, logs

    def can_scan_steps(self) -> bool:
        return False

    @torch.inference_mode()
    def eval_step(self, state: SRTrainState, lr_img: torch.Tensor,
                  seg: Optional[torch.Tensor] = None,
                  which: str = "auto") -> torch.Tensor:
        """G's f32 NHWC output for an LR batch and its HR-size maps
        (uniform 1/8 maps without ``seg``); ``which`` is read as the
        ``sr`` trainer reads it (G's weights: SFTGAN keeps no other)."""
        self._eval_net(state, which)
        x = lr_img.to(self.device).float()
        if seg is None:
            b, h, w, _ = x.shape
            seg = torch.full((b, h * 4, w * 4, 8), 1.0 / 8,
                             device=self.device)
        return state.g.net.eval()(x, seg.to(self.device).float()).float()

    def eval_step_x8(self, *args, **kwargs):
        raise NotImplementedError(
            "x8 self-ensemble with model [sftgan]: the JAX SFTGANTrainer "
            "has no eval_step_x8 (its CLI raises AttributeError)")

    def eval_step_chop(self, *args, **kwargs):
        raise NotImplementedError(
            "chop with model [sftgan]: the JAX SFTGANTrainer has no "
            "eval_step_chop (its CLI raises AttributeError)")
