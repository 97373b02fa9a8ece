"""SR trainer, inference only: counterpart of
``trainner_tpu/train/sr_trainer.py::SRTrainer`` (``init_state:222``,
``_eval_step:644``, ``eval_step:655``) and of ``train.py::create_trainer:95``
for ``model: sr``.

This slice builds G only. Losses, D, optimizers and the training step wait
for the training slice (ROADMAP Queue A, the training step); x8, chop and
CEM inference for their own items.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..models.networks import define_G
from ..utils.checkpoint import load_params
from ..utils.device import resolve_device


class SRTrainer:
    """Owns the options, the dtype policy and the device. ``init_state``
    returns G with its weights, the state that ``eval_step`` runs."""

    def __init__(self, opt: dict, dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device, None] = None):
        for key, item in (("use_cem", "CEM inference"),
                          ("unshuffle_scale", "the pixel-unshuffle wrapper"),
                          ("use_ema", "EMA weights"),
                          ("use_swa", "SWA weights")):
            if opt.get(key):
                raise NotImplementedError(
                    f"{item} is not ported yet (ROADMAP Queue A, deferred "
                    "inference branches)")
        self.opt = opt
        self.dtype = dtype
        self.device = resolve_device(device)

    def init_state(self, seed: int = 0,
                   g_path: Optional[str] = None) -> torch.nn.Module:
        """G with random weights drawn from a ``torch.Generator`` seeded
        with ``seed``, then ``g_path``'s weights when one is given."""
        netG = define_G(self.opt, dtype=self.dtype)
        netG.init_weights(torch.Generator().manual_seed(seed))
        if g_path:
            netG.load_state_dict(load_params(g_path), strict=True)
        return netG.to(self.device).eval()

    @torch.inference_mode()
    def eval_step(self, g: torch.nn.Module, lr_img: torch.Tensor
                  ) -> torch.Tensor:
        """Inference forward: NHWC LR batch -> f32 NHWC SR batch on the
        trainer's device."""
        lr_img = lr_img.to(self.device, non_blocking=lr_img.is_pinned())
        return g(lr_img.float()).float()


def create_trainer(opt: dict, device: Union[str, torch.device, None] = None
                   ) -> SRTrainer:
    """Model-strategy factory for ``model: sr``. Inference runs in f32
    unless ``use_amp`` asks for bf16; training (not ported yet) would
    default to bf16, as in the JAX package."""
    model = (opt.get("model") or "sr").lower()
    if model not in ("sr", "srgan", "srragan"):
        raise NotImplementedError(
            f"model [{model}] is not ported yet (ROADMAP Queue A, other "
            "generator types)")
    if opt.get("is_train", True):
        raise NotImplementedError(
            "training is not ported yet (ROADMAP Queue A, the training "
            "step)")
    dtype = torch.bfloat16 if opt.get("use_amp", False) else torch.float32
    return SRTrainer(opt, dtype=dtype, device=device)
