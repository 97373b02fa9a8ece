"""The SRFlow trainer: counterpart of
``trainner_tpu/train/srflow_trainer.py`` (``SRFlowTrainer:28``,
``init_state:54``, ``_train_step:73``, ``train_step:104``, ``_sample:119``,
``eval_step:125``) for ``model: srflow``, with ``srflow_net`` or the
reference-exact ``srflow_interop`` net.

The loss is ``fl_weight`` (``or 1.0``: 0 means 1, as in the JAX package)
times the batch's mean NLL of HR given LR, with the quantisation noise
drawn from the state's ``noise_generator`` (or ``draw_hook``). G runs in
f32 whatever ``use_amp`` says. The encoder (``RRDB``) is frozen until
step ``train_RRDB_delay * niter``, which a host-side counter decides (it
starts from ``state.step`` at the trainer's first step, as ``_host_step``
does): while frozen the encoder runs without autograd, so no block
backward runs, and the optimizer gets zeros for its gradients (Adam's
moments and the clip's norm see them, as optax sees the JAX step's zeroed
subtree). Then ``grad_clip`` (norm by default, to ``grad_clip_value``,
1.0 by default) over every gradient, and ``optim_G`` (Adam by default,
at the JAX ``build_optimizer``'s defaults: no betas, no weight decay
read) at the ``lr_G`` (2e-4 by default) of the MultiStepLR schedule. On
the card each freeze state is its own CUDA graph per batch signature.

``eval_step(state, lr, heat)`` samples at temperature ``heat`` from draws
made by a generator seeded with 0 on every call, as the JAX ``_sample``
draws from ``PRNGKey(0)``: every draw at one heat is the same image, on
either package (their streams differ, so only heat 0 agrees between them;
ROADMAP C 26). The draws are made outside the graph and copied into it,
so a replay gives what the eager call gives.

Under a mesh each rank runs the step on its slice of the global batch:
the quantisation noise is drawn for the global batch and this rank keeps
its rows (``sample_draw``), the gradients are averaged before the
global-norm clip and the logs are averaged; the freeze counter starts
from the state's step, which is the same on every rank.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch

from ..models.networks import define_G
from ..parallel.collectives import average_grads, mean_logs, sample_draw
from ..utils.checkpoint import load_params
from ..utils.torch_interop import key_to_seed, seed_to_key
from .optimizers import build_optimizer, jax_view
from .schedulers import build_scheduler
from .sr_trainer import SRTrainer, _GraphedStep, clip_grads
from .state import NetState, SRTrainState


class SRFlowTrainer(SRTrainer):
    """``model: srflow``."""

    def __init__(self, opt: dict, dtype: torch.dtype = torch.float32,
                 device=None, graphs: Optional[bool] = None, mesh=None):
        # the sr trainer's losses and schedules read none of SRFlow's
        # options: its state and graph machinery are what this one shares
        super().__init__({**opt, "train": {}}, dtype=torch.float32,
                         device=device, graphs=graphs, mesh=mesh)
        train_opt = opt.get("train") or {}
        self.opt, self.train_opt = opt, train_opt
        self.generator_loss = None
        self.fl_weight = float(train_opt.get("fl_weight", 1.0) or 1.0)
        niter = int(float(train_opt.get("niter", 5e5) or 5e5))
        delay = train_opt.get("train_RRDB_delay")
        self.rrdb_unfreeze_iter = int(float(delay) * niter) if delay else 0
        self.grad_clip = train_opt.get("grad_clip", "norm")
        self.grad_clip_value = float(train_opt.get("grad_clip_value", 1.0)
                                     or 1.0)
        self.schedG = build_scheduler(
            train_opt, base_lr=train_opt.get("lr_G", 2e-4), niter=niter) \
            if self.is_train else None
        self._host_step: Optional[int] = None
        # one generator, reseeded with 0 before every sample's draws
        self._sample_gen: Optional[torch.Generator] = None

    def _make_g(self) -> torch.nn.Module:
        return define_G(self.opt, dtype=torch.float32)

    def init_state(self, seed: int = 0,
                   g_path: Optional[str] = None) -> SRTrainState:
        """G with random weights from ``seed`` (then ``g_path``'s), on the
        trainer's device; when training, ``optim_G`` over all of it and
        the quantisation noise's generator, seeded from ``seed + 2``."""
        netG = self._make_g()
        netG.init_weights(torch.Generator().manual_seed(seed))
        if g_path:
            netG.load_state_dict(load_params(g_path, netG), strict=True)
        netG = netG.to(self.device).eval()
        if not self.is_train:
            return SRTrainState(step=0, g=NetState(netG))
        params = list(netG.parameters())
        opt = build_optimizer(params, self.train_opt.get("optim_G", "adam"),
                              views=[jax_view(p) for p in params])
        rng = seed_to_key(seed + 2)
        noise = torch.Generator(device=self.device).manual_seed(
            key_to_seed(rng))
        state = SRTrainState(step=0, g=NetState(netG, opt),
                             noise_generator=noise, rng=rng)
        self._place(state)
        return state

    # ------------------------------------------------------------------
    # train step
    # ------------------------------------------------------------------
    def _draws(self, state: SRTrainState, shapes: dict) -> dict:
        """The step's random draws: ``noise``, the quantisation noise's
        uniform draws of the HR batch's shape, from the state's
        ``noise_generator`` (or ``draw_hook``)."""
        if self.draw_hook is not None:
            return self.draw_hook(shapes)
        return {"noise": torch.rand(shapes["noise"],
                                    generator=state.noise_generator,
                                    device=self.device)}

    def _flow_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor],
                   lr_g, lr_d, *, train_rrdb: bool) -> Dict[str, torch.Tensor]:
        """One step's program: updates the state's tensors in place and
        returns the logs; nothing here reads the device."""
        lr_img = self._to_device(batch["LR"])
        hr_img = self._to_device(batch["HR"])
        netG = state.g.net.train()
        netG.train_encoder = train_rrdb
        state.g.opt.zero_grad()
        rest = tuple(hr_img.shape[1:])
        noise = sample_draw(lambda n: self._draws(
            state, {"noise": (n, *rest)})["noise"], hr_img.shape[0])
        _, nll, _ = netG(gt=hr_img, lr=lr_img, noise=noise)
        nll = nll.mean()
        loss = self.fl_weight * nll
        loss.backward()
        for p in state.g.opt.params:
            if p.grad is None:  # the frozen encoder, the unread head
                p.grad = torch.zeros_like(p)
        average_grads(state.g.opt.params)
        clip_grads(state.g.opt.params, self.grad_clip, self.grad_clip_value)
        state.g.opt.step(lr_g)
        return mean_logs({"nll": nll.detach(), "l_g_total": loss.detach()})

    def train_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[SRTrainState, Dict[str, torch.Tensor]]:
        """One NLL step on ``batch`` ({"LR", "HR"}, NHWC), the encoder
        frozen or not as the host counter says; updates ``state`` in place
        and returns it with the logs (``nll``, ``l_g_total``)."""
        if not self.is_train:
            raise RuntimeError("this trainer was built with is_train: false")
        if self.graphs:
            self._bind(state)
        if self._host_step is None:
            self._host_step = int(state.step)
        step = self._host_step
        self._host_step += 1
        train_rrdb = step >= self.rrdb_unfreeze_iter
        fn = self._step_fns.get(("flow", train_rrdb))
        if fn is None:
            fn = self._in_mesh(functools.partial(self._flow_step,
                                                 train_rrdb=train_rrdb))
            if self.graphs:
                fn = _GraphedStep(self, fn)
            self._step_fns[("flow", train_rrdb)] = fn
        logs = fn(state, batch, self.schedG.get_lr(step), 0.0)
        state.step = state.step + 1
        return state, logs

    def can_scan_steps(self) -> bool:
        """A window runs as ``train_step`` calls: the unfreeze may fall
        inside it."""
        return False

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def _latents(self, net, shape, heat: float) -> List[torch.Tensor]:
        """The sample's standard normal draws times ``heat``, from a
        generator seeded with 0 (the JAX ``_sample``'s fixed key)."""
        if self._sample_gen is None:
            self._sample_gen = torch.Generator(device=self.device)
        gen = self._sample_gen.manual_seed(0)
        return [torch.randn(s, generator=gen, device=self.device) * heat
                for s in net.sample_shapes(shape)]

    @staticmethod
    def _sample(state: SRTrainState, x, draws) -> torch.Tensor:
        return state.g.net.eval().sample_from(x, draws).float()

    @torch.inference_mode()
    def eval_step(self, state: SRTrainState, lr_img: torch.Tensor,
                  heat: float = 0.0) -> torch.Tensor:
        """SR samples of an NHWC LR batch at temperature ``heat`` (f32 NHWC
        on the trainer's device, the caller's own tensor). With graphs, one
        graph per input shape, captured at its ``EVAL_CAPTURE_AT``-th call,
        the draws its inputs."""
        x = lr_img.to(self.device, non_blocking=lr_img.is_pinned()).float()
        draws = self._latents(state.g.net, x.shape, float(heat))
        if not self.graphs:
            return self._sample(state, x, draws)
        return self._eval_graphed(
            state, (tuple(x.shape), x.dtype), [x, *draws],
            lambda xx, *dd: self._sample(state, xx, list(dd)))

    def eval_step_x8(self, *args, **kwargs):
        raise NotImplementedError(
            "x8 self-ensemble with SRFlow: the JAX CLI samples srflow before "
            "it reads self_ensemble, and SRFlowTrainer has no eval_step_x8")

    def eval_step_chop(self, *args, **kwargs):
        raise NotImplementedError(
            "chop with SRFlow: the JAX CLI samples srflow before it reads "
            "chop, and SRFlowTrainer has no eval_step_chop")
