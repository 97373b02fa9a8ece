"""Adversarial losses: counterpart of ``trainner_tpu/losses/gan.py``
(``gan_loss:32``, ``AdversarialLoss:73``, ``build_adversarial:184``) for
the vanilla, lsgan and hinge objectives in the relativistic and standard
forms, with the D-feature-matching term. wgan-gp and the conditional
(pix2pix) form are not ported yet.

The loss is a function of ``d_fn``, a callable x -> logits (or, with
``want_maps``, (logits, feats)) that the trainer binds to D. All math in
f32; ``detach`` takes the place of ``stop_gradient``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .basic import get_pixel_criterion


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
    label = real_label if target_is_real else fake_label
    if gt in ("vanilla", "srpgan", "nsgan"):
        return _bce_logits(x, label)
    if gt == "lsgan":
        return ((x - label) ** 2).mean()
    if gt in ("wgan-gp", "wgangp", "wgan"):
        raise NotImplementedError(
            f"GAN type [{gan_type}] is not ported yet (ROADMAP Queue A "
            "10.7, the other losses)")
    raise NotImplementedError(f"GAN type [{gan_type}] is not implemented")


@dataclass
class AdversarialLoss:
    """Builds the G-stage and D-stage adversarial losses from the train
    options: gan_type, gan_weight, form ('relativistic' | 'standard'),
    gan_featmaps with dis_feature_criterion / dis_feature_weight."""

    gan_type: str = "vanilla"
    gan_weight: float = 1.0
    form: str = "relativistic"
    use_featmaps: bool = False
    dis_feature_criterion: str = "l1"
    dis_feature_weight: float = 1e-4

    def __post_init__(self):
        gan_loss(self.gan_type, torch.zeros(1), True)  # refuses early

    def generator_loss(self, d_fn: Callable, fake: torch.Tensor,
                       real: Optional[torch.Tensor] = None) -> torch.Tensor:
        """G-stage loss, already times ``gan_weight``. The caller keeps D's
        parameters out of the gradient."""
        feats_fake = feats_real = None
        pred_real = None
        if self.use_featmaps:
            pred_fake, feats_fake = d_fn(fake, True)
            pred_real, feats_real = d_fn(real.detach(), True)
        else:
            pred_fake = d_fn(fake)
            if self.form != "standard":
                pred_real = d_fn(real.detach())

        if self.form == "standard":
            total = gan_loss(self.gan_type, pred_fake, True)
        else:
            pr = pred_real.detach()
            total = (gan_loss(self.gan_type, pr - pred_fake.mean(), False)
                     + gan_loss(self.gan_type, pred_fake - pr.mean(), True)
                     ) / 2.0
        l_g = self.gan_weight * total

        if feats_fake is not None:
            crit = get_pixel_criterion(self.dis_feature_criterion)
            l_fea = sum(crit(sf, hf.detach())
                        for sf, hf in zip(feats_fake, feats_real)
                        ) / len(feats_fake)
            l_g = l_g + self.dis_feature_weight * l_fea
        return l_g

    def discriminator_loss(self, d_fn: Callable, fake: torch.Tensor,
                           real: torch.Tensor
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """D-stage loss 0.5 * (fake + real) and its logs. D sees the fake
        batch first and the real batch second."""
        pred_fake = d_fn(fake.detach())
        pred_real = d_fn(real)
        if self.form == "standard":
            l_d_real = gan_loss(self.gan_type, pred_real, True, is_disc=True)
            l_d_fake = gan_loss(self.gan_type, pred_fake, False, is_disc=True)
        else:
            l_d_real = gan_loss(self.gan_type, pred_real - pred_fake.mean(),
                                True, is_disc=True)
            l_d_fake = gan_loss(self.gan_type, pred_fake - pred_real.mean(),
                                False, is_disc=True)
        logs = {"l_d_real": l_d_real, "l_d_fake": l_d_fake,
                "D_real": pred_real.mean(), "D_fake": pred_fake.mean()}
        return (l_d_fake + l_d_real) * 0.5, logs


def build_adversarial(train_opt: dict) -> AdversarialLoss:
    """From the parsed train options (the same keys as the JAX package)."""
    gan_opt = train_opt.get("gan_opt") or {}
    return AdversarialLoss(
        gan_type=train_opt.get("gan_type", "vanilla"),
        gan_weight=float(train_opt.get("gan_weight", 1.0)),
        form=gan_opt.get("form", "relativistic"),
        use_featmaps=bool(train_opt.get("gan_featmaps")),
        dis_feature_criterion=train_opt.get("dis_feature_criterion", "l1"),
        dis_feature_weight=float(train_opt.get("dis_feature_weight", 1e-4)))
