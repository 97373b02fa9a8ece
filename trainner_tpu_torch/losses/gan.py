"""Adversarial losses: counterpart of ``trainner_tpu/losses/gan.py``
(``gan_loss:32``, ``gradient_penalty:52``, ``_as_list:65``,
``AdversarialLoss:73``, ``build_adversarial:184``): the vanilla, lsgan,
hinge and wgan(-gp) objectives in the relativistic and standard forms, the
conditional (pix2pix) concatenation, multiscale D outputs, the
D-feature-matching term and wgan-gp's gradient penalty.

The loss is a function of ``d_fn``, a callable x -> logits (or, with
``want_maps``, (logits, feats)) that the trainer binds to D. All math in
f32; ``detach`` takes the place of ``stop_gradient``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.collectives import batch_mean, sample_draw
from .basic import get_pixel_criterion

WGAN_GP = ("wgan-gp", "wgangp")


def _bce_logits(x: torch.Tensor, target: float) -> torch.Tensor:
    """BCE with logits against a constant target, in the stable form."""
    return (x.clamp_min(0) - x * target
            + torch.log1p(torch.exp(-x.abs()))).mean()


def gan_loss(gan_type: str, x: torch.Tensor, target_is_real: bool,
             is_disc: bool = False, real_label: float = 1.0,
             fake_label: float = 0.0) -> torch.Tensor:
    """The core GAN objective on logits x."""
    gt = gan_type.lower()
    if gt == "hinge":
        if is_disc:
            return F.relu(1.0 + (-x if target_is_real else x)).mean()
        return (-x).mean()
    if gt in WGAN_GP + ("wgan",):
        return -x.mean() if target_is_real else x.mean()
    label = real_label if target_is_real else fake_label
    if gt in ("vanilla", "srpgan", "nsgan"):
        return _bce_logits(x, label)
    if gt == "lsgan":
        return ((x - label) ** 2).mean()
    raise NotImplementedError(f"GAN type [{gan_type}] is not implemented")


def gradient_penalty(d_fn: Callable, interp: torch.Tensor,
                     constant: float = 1.0, eps: float = 1e-16
                     ) -> torch.Tensor:
    """WGAN-GP's penalty: the mean over samples of (||dD/dx||_2 -
    constant)^2 at ``interp``, each sample's gradient plus ``eps``
    flattened. The gradient keeps its graph, so the penalty's own
    backward reaches D's parameters (a double backward through D)."""
    interp = interp.detach().requires_grad_(True)
    grads, = torch.autograd.grad(d_fn(interp).sum(), interp,
                                 create_graph=True)
    g = (grads + eps).reshape(grads.shape[0], -1)
    return ((torch.linalg.vector_norm(g, dim=1) - constant) ** 2).mean()


def _as_list(pred) -> List[torch.Tensor]:
    """A multiscale D's list of outputs, or one output as a list."""
    return list(pred) if isinstance(pred, (list, tuple)) else [pred]


@dataclass
class AdversarialLoss:
    """Builds the G-stage and D-stage adversarial losses from the train
    options: gan_type, gan_weight, form ('relativistic' | 'standard'),
    conditional, gan_featmaps with dis_feature_criterion /
    dis_feature_weight, and gp_weight (wgan-gp's penalty)."""

    gan_type: str = "vanilla"
    gan_weight: float = 1.0
    form: str = "relativistic"
    conditional: bool = False
    use_featmaps: bool = False
    dis_feature_criterion: str = "l1"
    dis_feature_weight: float = 1e-4
    gp_weight: Optional[float] = None

    def __post_init__(self):
        gan_loss(self.gan_type, torch.zeros(1), True)  # refuses early

    @property
    def uses_penalty(self) -> bool:
        return self.gan_type in WGAN_GP and bool(self.gp_weight)

    def _cond(self, x, condition):
        """With ``conditional``, the condition concatenated in front of x
        on the channels."""
        if self.conditional and condition is not None:
            return torch.cat([condition, x], -1)
        return x

    def generator_loss(self, d_fn: Callable, fake: torch.Tensor,
                       real: Optional[torch.Tensor] = None,
                       condition=None) -> torch.Tensor:
        """G-stage loss, already times ``gan_weight``. The caller keeps D's
        parameters out of the gradient."""
        fake_in = self._cond(fake, condition)
        feats_fake = feats_real = None
        pred_real = None
        if self.use_featmaps:
            pred_fake, feats_fake = d_fn(fake_in, True)
            pred_real, feats_real = d_fn(
                self._cond(real.detach(), condition), True)
        else:
            pred_fake = d_fn(fake_in)
            if self.form != "standard":
                pred_real = d_fn(self._cond(real.detach(), condition))

        fakes, reals = _as_list(pred_fake), _as_list(pred_real)
        total = 0.0
        for i, pf in enumerate(fakes):
            if self.form == "standard":
                total = total + gan_loss(self.gan_type, pf, True)
            else:
                pr = reals[i].detach()
                total = total + (
                    gan_loss(self.gan_type, pr - batch_mean(pf.mean()), False)
                    + gan_loss(self.gan_type, pf - batch_mean(pr.mean()),
                               True)) / 2.0
        l_g = self.gan_weight * total

        if feats_fake is not None:
            crit = get_pixel_criterion(self.dis_feature_criterion)
            l_fea = sum(crit(sf, hf.detach())
                        for sf, hf in zip(feats_fake, feats_real)
                        ) / len(feats_fake)
            l_g = l_g + self.dis_feature_weight * l_fea
        return l_g

    def discriminator_loss(self, d_fn: Callable, fake: torch.Tensor,
                           real: torch.Tensor, condition=None,
                           generator: Optional[torch.Generator] = None,
                           alpha: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """D-stage loss 0.5 * (fake + real) and its logs. D sees the fake
        batch first and the real batch second. With wgan-gp and
        ``gp_weight``, plus gp_weight times the penalty at alpha * fake +
        (1 - alpha) * real (D's third pass), logged as ``l_d_gp``; alpha
        (b, 1, 1, 1) is drawn uniform from ``generator`` unless given."""
        fake = fake.detach()
        pred_fake = d_fn(self._cond(fake, condition))
        pred_real = d_fn(self._cond(real, condition))
        fakes, reals = _as_list(pred_fake), _as_list(pred_real)
        l_d_real = l_d_fake = 0.0
        for pf, pr in zip(fakes, reals):
            if self.form == "standard":
                l_d_real = l_d_real + gan_loss(self.gan_type, pr, True,
                                               is_disc=True)
                l_d_fake = l_d_fake + gan_loss(self.gan_type, pf, False,
                                               is_disc=True)
            else:
                l_d_real = l_d_real + gan_loss(
                    self.gan_type, pr - batch_mean(pf.mean()), True,
                    is_disc=True)
                l_d_fake = l_d_fake + gan_loss(
                    self.gan_type, pf - batch_mean(pr.mean()), False,
                    is_disc=True)
        l_d_total = (l_d_fake + l_d_real) * 0.5
        logs = {"l_d_real": l_d_real, "l_d_fake": l_d_fake,
                "D_real": reals[0].mean(), "D_fake": fakes[0].mean()}
        if self.uses_penalty:
            if alpha is None:
                alpha = sample_draw(lambda n: torch.rand(
                    (n, 1, 1, 1), generator=generator, device=real.device),
                    real.shape[0])
            interp = alpha * fake + (1 - alpha) * real
            l_gp = float(self.gp_weight) * gradient_penalty(
                lambda x: _as_list(d_fn(self._cond(x, condition)))[0],
                interp)
            l_d_total = l_d_total + l_gp
            logs["l_d_gp"] = l_gp
        return l_d_total, logs


def build_adversarial(train_opt: dict,
                      conditional: bool = False) -> AdversarialLoss:
    """From the parsed train options (the same keys as the JAX package)."""
    gan_opt = train_opt.get("gan_opt") or {}
    return AdversarialLoss(
        gan_type=train_opt.get("gan_type", "vanilla"),
        gan_weight=float(train_opt.get("gan_weight", 1.0)),
        form=gan_opt.get("form", "relativistic"),
        conditional=conditional,
        use_featmaps=bool(train_opt.get("gan_featmaps")),
        dis_feature_criterion=train_opt.get("dis_feature_criterion", "l1"),
        dis_feature_weight=float(train_opt.get("dis_feature_weight", 1e-4)),
        gp_weight=train_opt.get("gp_weight"))
