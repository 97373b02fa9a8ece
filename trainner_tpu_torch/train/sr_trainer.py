"""SR / restoration GAN trainer: counterpart of
``trainner_tpu/train/sr_trainer.py::SRTrainer`` (``__init__:105``,
``init_state:222``, ``_train_step:300``, ``train_step:538``,
``eval_step:655``) and of ``train.py::create_trainer:95`` for ``model: sr``.

One training step is the flagship ESRGAN step: G (every residual dense
block on the hand-written forward and backward kernels) under the pixel,
VGG-feature and relativistic GAN losses, then D on the detached output of
that same G forward; Adam or SGD with the learning rate of a host-side
schedule. The network bodies run in the trainer's dtype (bf16 by default
when training) with f32 parameters, gradients and losses; there is no
autocast and no loss scaling.

Not ported yet, each raising with its ROADMAP item: batch augmentations,
DiffAugment, frequency separation, CEM, AdaTarget, FreezeD, the
pixel-unshuffle wrapper, ``grad_clip: auto``, a virtual batch, SWA and
EMA; x8, chop and CEM inference.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple, Union

import torch

from ..losses.gan import build_adversarial
from ..losses.generator_loss import GeneratorLoss
from ..models.networks import define_D, define_G
from ..ops.blocks import GaussianNoise, wire_to_f01
from ..utils.checkpoint import load_params
from ..utils.device import resolve_device
from ..utils.torch_interop import key_to_seed, seed_to_key
from .optimizers import build_optimizer
from .schedulers import build_scheduler
from .state import NetState, SRTrainState

# option (in opt or opt["train"]) -> (what it is, its ROADMAP item)
_NOT_PORTED = {
    "use_cem": ("CEM", "Queue A 2.3, deferred inference branches"),
    "unshuffle_scale": ("the pixel-unshuffle wrapper",
                        "Queue A 10.11, the other trainer options"),
    "use_unshuffle": ("the pixel-unshuffle wrapper",
                      "Queue A 10.11, the other trainer options"),
    "use_ema": ("EMA weights", "Queue A 10.10, SWA and EMA"),
    "use_swa": ("SWA weights", "Queue A 10.10, SWA and EMA"),
    "use_atg": ("AdaTarget", "Queue A 10.8, the other ops"),
    "mixup": ("batch augmentations", "Queue A 10.8, the other ops"),
    "diffaug": ("DiffAugment", "Queue A 10.8, the other ops"),
    "fs": ("frequency separation", "Queue A 10.8, the other ops"),
    "freeze_d": ("FreezeD", "Queue A 10.11, the other trainer options"),
    "freeze_loc": ("FreezeD", "Queue A 10.11, the other trainer options"),
}


@contextlib.contextmanager
def _no_param_grad(net: torch.nn.Module):
    """Runs ``net`` with its parameters out of the graph: gradients still
    reach its input, none is left on its parameters."""
    params = [p for p in net.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def clip_grads(params, mode: Optional[str], value: float) -> None:
    """value / norm gradient clipping, in place on ``.grad``."""
    if not mode:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if mode == "value":
        for g in grads:
            g.clamp_(-value, value)
    elif mode == "norm":
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        scale = torch.clamp(value / (gnorm + 1e-6), max=1.0)
        torch._foreach_mul_(grads, scale)
    elif mode == "auto":
        raise NotImplementedError(
            "grad_clip [auto] is not ported yet (ROADMAP Queue A 10.11, "
            "the other trainer options)")
    else:
        raise NotImplementedError(f"grad_clip [{mode}]")


class SRTrainer:
    """Owns the options, the dtype policy, the device, the losses and the
    schedules. The state (networks, optimizers, step) is made by
    ``init_state`` and updated in place by ``train_step``."""

    def __init__(self, opt: dict, dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device, None] = None):
        train_opt = opt.get("train") or {}
        for key, (what, item) in _NOT_PORTED.items():
            if opt.get(key) or train_opt.get(key):
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP {item})")
        if int(train_opt.get("virtual_batch_size") or 0) > 1:
            raise NotImplementedError(
                "a virtual batch (gradient accumulation) is not ported yet "
                "(ROADMAP Queue A 10.11, the other trainer options)")
        self.opt = opt
        self.train_opt = train_opt
        self.dtype = dtype
        self.device = resolve_device(device)
        self.is_train = bool(opt.get("is_train", True))
        self.scale = int(opt.get("scale", 4) or 4)
        self.znorm = bool(((opt.get("datasets") or {}).get("train")
                           or {}).get("znorm"))
        self.gan_weight = float(train_opt.get("gan_weight") or 0.0)
        self.use_gan = bool(self.gan_weight) and self.is_train
        self.generator_loss = self.adversarial = None
        self.schedG = self.schedD = None
        if not self.is_train:
            return

        self.generator_loss = GeneratorLoss(opt, device_dtype=dtype
                                            ).to(self.device)
        niter = int(float(train_opt.get("niter", 5e5) or 5e5))
        self.schedG = build_scheduler(
            train_opt, base_lr=train_opt.get("lr_G", 1e-4), niter=niter)
        if self.use_gan:
            self.adversarial = build_adversarial(train_opt)
            self.schedD = build_scheduler(
                train_opt, niter=niter,
                base_lr=train_opt.get("lr_D", train_opt.get("lr_G", 1e-4)))
        self.d_update_ratio = int(train_opt.get("D_update_ratio", 1) or 1)
        self.d_init_iters = int(train_opt.get("D_init_iters", 0) or 0)
        self.grad_clip = train_opt.get("grad_clip")
        self.grad_clip_value = float(train_opt.get("grad_clip_value", 0.1)
                                     or 0.1)
        if self.grad_clip == "auto":
            clip_grads([], "auto", 0.0)

    def _optimizer(self, net: torch.nn.Module, which: str):
        t = self.train_opt
        return build_optimizer(
            list(net.parameters()), t.get(f"optim_{which}", "adam"),
            beta1=float(t.get(f"beta1_{which}", 0.9) or 0.9),
            beta2=float(t.get(f"beta2_{which}", 0.999) or 0.999),
            weight_decay=float(t.get(f"weight_decay_{which}", 0) or 0))

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0,
                   g_path: Optional[str] = None) -> SRTrainState:
        """Networks with random weights drawn from ``torch.Generator``s
        seeded from ``seed`` (then ``g_path``'s weights for G when one is
        given), on the trainer's device; when training, also D, the
        optimizers and the generator of the latent noise, seeded with
        ``seed + 2`` (the state's ``rng`` is that seed's key). A checkpoint
        of a run resumes into this state with
        ``utils/checkpoint.py::load_state``."""
        netG = define_G(self.opt, dtype=self.dtype)
        netG.init_weights(torch.Generator().manual_seed(seed))
        if g_path:
            netG.load_state_dict(load_params(g_path), strict=True)
        netG = netG.to(self.device).eval()
        if not self.is_train:
            return SRTrainState(step=0, g=NetState(netG))
        rng = seed_to_key(seed + 2)
        noise = torch.Generator(device=self.device).manual_seed(
            key_to_seed(rng))
        for m in netG.modules():
            if isinstance(m, GaussianNoise):
                m.generator = noise
        state = SRTrainState(step=0,
                             g=NetState(netG, self._optimizer(netG, "G")),
                             noise_generator=noise, rng=rng)
        if self.use_gan:
            netD = define_D(self.opt, dtype=self.dtype)
            netD.init_weights(torch.Generator().manual_seed(seed + 1))
            netD = netD.to(self.device)
            state.d = NetState(netD, self._optimizer(netD, "D"))
        return state

    # ------------------------------------------------------------------
    # train step
    # ------------------------------------------------------------------
    def _to_device(self, x: torch.Tensor) -> torch.Tensor:
        return wire_to_f01(x.to(self.device, non_blocking=x.is_pinned()),
                           self.znorm)

    def _train_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor],
                    lr_g: float, lr_d: float, *, update_d: bool,
                    update_g: bool) -> Dict[str, torch.Tensor]:
        lr_img = self._to_device(batch["LR"])
        hr_img = self._to_device(batch["HR"])
        netG = state.g.net.train()
        netD = state.d.net if self.use_gan else None
        logs: Dict[str, torch.Tensor] = {}

        if update_g:
            state.g.opt.zero_grad()
            fake = netG(lr_img).float()
            total, glogs = self.generator_loss(fake, hr_img)
            if self.use_gan:
                # D runs in train mode here too (batch statistics, which
                # G's gradient flows through); its running statistics are
                # not written, the D stage owns their one update per step
                def d_fn(x, want_maps=False):
                    return netD(x, train=True, return_feats=want_maps)

                with _no_param_grad(netD):
                    l_g_gan = self.adversarial.generator_loss(d_fn, fake,
                                                              hr_img)
                glogs["l_g_gan"] = l_g_gan
                total = total + l_g_gan
            total.backward()
            clip_grads(state.g.opt.params, self.grad_clip,
                       self.grad_clip_value)
            # D sees the output of G's forward before this update
            state.g.opt.step(lr_g)
            logs.update(glogs)
            logs["l_g_total"] = total
            fake_for_d = fake.detach()
        else:
            with torch.no_grad():
                fake_for_d = netG(lr_img).float()

        if self.use_gan and update_d:
            state.d.opt.zero_grad()
            l_d, dlogs = self.adversarial.discriminator_loss(
                lambda x: netD(x, train=True), fake_for_d, hr_img)
            l_d.backward()
            clip_grads(state.d.opt.params, self.grad_clip,
                       self.grad_clip_value)
            state.d.opt.step(lr_d)
            # fake went first, real second: the real batch's statistics
            # are the step's one update of the running statistics
            netD.commit_stats()
            logs.update(dlogs)
            logs["l_d_total"] = l_d
        return {k: v.detach() for k, v in logs.items()}

    def train_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[SRTrainState, Dict[str, torch.Tensor]]:
        """One optimization step on ``batch`` ({"LR", "HR"}: NHWC, float in
        [0, 1] or uint8). The schedule is decided on the host: the learning
        rates of this step, and whether G is updated (``D_update_ratio``,
        ``D_init_iters``). Updates ``state`` in place and returns it with
        the logs (0-d tensors on the device: reading one synchronises)."""
        if not self.is_train:
            raise RuntimeError("this trainer was built with is_train: false")
        step = state.step
        lr_g = self.schedG.get_lr(step)
        lr_d = self.schedD.get_lr(step) if self.schedD else 0.0
        update_g = (not self.use_gan) or (
            step % self.d_update_ratio == 0 and step >= self.d_init_iters)
        logs = self._train_step(state, batch, lr_g, lr_d,
                                update_d=self.use_gan, update_g=update_g)
        state.step = step + 1
        return state, logs

    # ------------------------------------------------------------------
    # eval
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def eval_step(self, state: SRTrainState, lr_img: torch.Tensor
                  ) -> torch.Tensor:
        """Inference forward: NHWC LR batch -> f32 NHWC SR batch on the
        trainer's device."""
        lr_img = lr_img.to(self.device, non_blocking=lr_img.is_pinned())
        return state.g.net.eval()(lr_img.float()).float()


def create_trainer(opt: dict, device: Union[str, torch.device, None] = None
                   ) -> SRTrainer:
    """Model-strategy factory for ``model: sr``. Training runs the network
    bodies in bf16 and inference in f32, unless ``use_amp`` says otherwise,
    as in the JAX package. Runs on ``cuda`` unless ``device`` names the
    CPU, and raises when no card is present."""
    model = (opt.get("model") or "sr").lower()
    if model not in ("sr", "srgan", "srragan"):
        raise NotImplementedError(
            f"model [{model}] is not ported yet (ROADMAP Queue A, other "
            "generator types)")
    amp_default = bool(opt.get("is_train", True))
    dtype = torch.bfloat16 if opt.get("use_amp", amp_default) \
        else torch.float32
    return SRTrainer(opt, dtype=dtype, device=device)
