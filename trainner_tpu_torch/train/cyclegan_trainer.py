"""CycleGAN's trainer: counterpart of
``trainner_tpu/train/cyclegan_trainer.py`` (``CycleGANState:40``,
``CycleGANTrainer:56``, ``init_state:124``, ``_g_step:176``,
``_d_step:237``, ``train_step:272``, ``eval_step:297``).

G_A maps A to B and G_B maps B to A (``network_G`` each); D_A judges B
and D_B judges A (``network_D`` each). A step has two stages. The G
stage: the cycle loss lambda_A |G_B(G_A(A)) - A| + lambda_B |G_A(G_B(B))
- B|, with ``lambda_identity`` > 0 the identity terms lambda_identity
(|G_A(B) - B| lambda_B + |G_B(A) - A| lambda_A) (the lambdas cross, as in
the JAX trainer), and with a GAN each G's adversarial loss (``lsgan`` by
default, the standard form) on its D in train mode, whose statistics are
dropped; one optimizer over both Gs. G_A's batch statistics come from
its G_A(A) pass and G_B's from its G_B(G_A(A)) pass. Between the stages
each fake batch goes through its replay pool (``utils/image_pool.py``,
both seeded 0; a resume starts with empty pools). The D stage: each D's
loss on its pooled fake and its real batch, halved. ``gan_weight: 0``
counts as 1 (ROADMAP C 22). Adam's beta1 is ``beta1_G`` / ``beta1_D``
(0.5 by default), the learning rates 2e-4 by default.

On the card each stage is one CUDA graph (``_GraphedStep``): the G
stage's outputs are its logs and the two fake batches, the pools' swap
runs on the device between the two replays, and the D stage's graph
reads the pooled batches from its static inputs. ``graphs=False`` runs
both stages eagerly. ``eval_step`` serves G_A.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..losses.basic import get_pixel_criterion
from ..losses.gan import build_adversarial
from ..models.networks import define_D
from ..ops.blocks import Dropout, commit_stats, discard_stats
from ..utils.image_pool import ImagePool
from ..utils.torch_interop import key_to_seed, seed_to_key
from .pix2pix_trainer import Pix2PixTrainer
from .schedulers import build_scheduler
from .sr_trainer import SRTrainer, _GraphedStep, _no_param_grad, clip_grads
from .state import NetState


@dataclass
class CycleGANState:
    """G_A and G_B in one ``ModuleDict`` (``g.net``) under one optimizer,
    D_A and D_B with theirs, the step, the generator that dropout draws
    from and the key that seeded it. The ``sr`` state's other fields are
    None: the code that serves and saves a state reads them."""

    D_FIELDS = ("d_a", "d_b")

    step: int
    g: NetState
    d_a: Optional[NetState] = None
    d_b: Optional[NetState] = None
    noise_generator: Optional[torch.Generator] = None
    rng: Optional[np.ndarray] = None
    d = None
    ema = None
    swa = None
    swa_n = None
    loc = None
    grad_hist = None
    ema_params = None

    def named_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Each net's parameters by name, as the JAX state's
        ``named_params`` gives its trees: ``G_A``, ``G_B``, ``D_A``,
        ``D_B``."""
        out = {n: dict(self.g.net[n].named_parameters())
               for n in ("G_A", "G_B")}
        for name, ns in (("D_A", self.d_a), ("D_B", self.d_b)):
            if ns is not None:
                out[name] = dict(ns.net.named_parameters())
        return out


class CycleGANTrainer(SRTrainer):
    """``model: cyclegan``."""

    def __init__(self, opt: dict, dtype: torch.dtype = torch.float32,
                 device=None, graphs: Optional[bool] = None):
        super().__init__(opt, dtype=dtype, device=device, graphs=graphs)
        self.scale = 1
        self.znorm = bool(((opt.get("datasets") or {}).get("train")
                           or {}).get("znorm", True))
        t = self.train_opt
        self.gan_weight = float(t.get("gan_weight") or 1.0)
        self.use_gan = self.is_train and bool(self.gan_weight)
        if not self.is_train:
            return
        self.lambda_a = float(t.get("lambda_A", 10.0) or 10.0)
        self.lambda_b = float(t.get("lambda_B", 10.0) or 10.0)
        self.lambda_idt = float(t.get("lambda_identity", 0.5) or 0.0)
        self.cycle_crit = get_pixel_criterion(t.get("cycle_criterion", "l1"))
        self.idt_crit = get_pixel_criterion(t.get("idt_criterion", "l1"))
        niter = int(float(t.get("niter", 5e5) or 5e5))
        self.schedG = build_scheduler(t, base_lr=t.get("lr_G", 2e-4),
                                      niter=niter)
        self.adversarial = self.schedD = None
        if self.use_gan:
            self.adversarial = build_adversarial(
                {**t, "gan_type": t.get("gan_type", "lsgan")})
            self.adversarial.form = (t.get("gan_opt") or {}).get(
                "form", "standard")
            self.schedD = build_scheduler(
                t, base_lr=t.get("lr_D", t.get("lr_G", 2e-4)), niter=niter)
        pool_size = int(opt.get("pool_size", 50) or 50)
        self.fake_a_pool = ImagePool(pool_size)
        self.fake_b_pool = ImagePool(pool_size)

    _optimizer = Pix2PixTrainer._optimizer

    def init_state(self, seed: int = 0,
                   g_path: Optional[str] = None) -> CycleGANState:
        """G_A, G_B, D_A and D_B with random weights from generators
        seeded ``seed`` to ``seed + 3``; ``g_path``'s weights for G_A (a
        G_A file) or for both Gs (a tree of ``G_A`` and ``G_B``). When
        training, also the optimizers and dropout's generator, seeded
        from the key of ``seed + 4``."""
        nets = {}
        for i, name in enumerate(("G_A", "G_B")):
            net = self._make_g()
            net.init_weights(torch.Generator().manual_seed(seed + i))
            nets[name] = net
        g_net = nn.ModuleDict(nets)
        if g_path:
            _load_g(g_net, g_path)
        g_net = g_net.to(self.device).eval()
        if not self.is_train:
            return CycleGANState(step=0, g=NetState(g_net))
        rng = seed_to_key(seed + 4)
        noise = torch.Generator(device=self.device).manual_seed(
            key_to_seed(rng))
        for m in g_net.modules():
            if isinstance(m, Dropout):
                m.generator = noise
        state = CycleGANState(step=0,
                              g=NetState(g_net, self._optimizer(g_net, "G")),
                              noise_generator=noise, rng=rng)
        if self.use_gan:
            cfg = self.opt.get("network_G") or {}
            for i, (which, nc) in enumerate(
                    (("d_a", cfg.get("output_nc", 3)),
                     ("d_b", cfg.get("input_nc", 3)))):
                net = define_D(self.opt, dtype=self.dtype, in_nc=nc)
                net.init_weights(torch.Generator().manual_seed(seed + 2 + i))
                net = net.to(self.device)
                setattr(state, which, NetState(net,
                                               self._optimizer(net, "D")))
        return state

    def _g_stage(self, state: CycleGANState, batch: Dict[str, torch.Tensor],
                 lr_g, lr_d) -> Dict[str, torch.Tensor]:
        """The G stage's program: both Gs' update; returns the logs and
        the fakes ``fake_A`` = G_B(B), ``fake_B`` = G_A(A)."""
        real_a = self._to_device(batch["A"])
        real_b = self._to_device(batch["B"])
        ga = state.g.net["G_A"].train()
        gb = state.g.net["G_B"].train()
        state.g.opt.zero_grad()
        fake_b = ga(real_a).float()
        commit_stats(ga)  # G_A's statistics: its G_A(A) pass
        rec_a = gb(fake_b).float()
        commit_stats(gb)  # G_B's: its G_B(G_A(A)) pass
        fake_a = gb(real_b).float()
        rec_b = ga(fake_a).float()
        loss = self.lambda_a * self.cycle_crit(rec_a, real_a) + \
            self.lambda_b * self.cycle_crit(rec_b, real_b)
        logs = {"l_cycle": loss}
        if self.lambda_idt > 0:
            idt_a = ga(real_b).float()
            idt_b = gb(real_a).float()
            l_idt = self.lambda_idt * (
                self.idt_crit(idt_a, real_b) * self.lambda_b
                + self.idt_crit(idt_b, real_a) * self.lambda_a)
            logs["l_idt"] = l_idt
            loss = loss + l_idt
        if self.use_gan:
            da, db = state.d_a.net, state.d_b.net

            def d_fn(net):
                return lambda x, want_maps=False: net(
                    x, train=True, return_feats=want_maps)

            with _no_param_grad(da), _no_param_grad(db):
                l_gan_a = self.adversarial.generator_loss(d_fn(da), fake_b,
                                                          real_b)
                l_gan_b = self.adversarial.generator_loss(d_fn(db), fake_a,
                                                          real_a)
            logs["l_g_gan_A"], logs["l_g_gan_B"] = l_gan_a, l_gan_b
            loss = loss + l_gan_a + l_gan_b
        loss.backward()
        discard_stats(state.g.net)  # the other passes leave nothing
        clip_grads(state.g.opt.params, self.grad_clip, self.grad_clip_value)
        state.g.opt.step(lr_g)
        logs["l_g_total"] = loss
        out = {k: v.detach() for k, v in logs.items()}
        out["fake_A"], out["fake_B"] = fake_a.detach(), fake_b.detach()
        return out

    def _d_stage(self, state: CycleGANState, batch: Dict[str, torch.Tensor],
                 lr_g, lr_d) -> Dict[str, torch.Tensor]:
        """The D stage's program on the pooled fakes (``fake_A``,
        ``fake_B``): each D's halved loss and update."""
        real_a = self._to_device(batch["A"])
        real_b = self._to_device(batch["B"])
        logs = {}
        for tag, ns, fake, real in (("A", state.d_a, batch["fake_B"], real_b),
                                    ("B", state.d_b, batch["fake_A"],
                                     real_a)):
            net = ns.net
            ns.opt.zero_grad()
            l_d, _ = self.adversarial.discriminator_loss(
                lambda x, n=net: n(x, train=True), fake, real,
                generator=state.noise_generator)
            l_d = l_d * 0.5
            l_d.backward()
            clip_grads(ns.opt.params, self.grad_clip, self.grad_clip_value)
            net.commit_stats()
            ns.opt.step(lr_d)
            logs[f"l_d_{tag}"] = l_d.detach()
        return logs

    def _stage(self, which: str):
        fn = self._step_fns.get((which,))
        if fn is None:
            if which == "g":
                fn, keys = self._g_stage, ("A", "B")
            else:
                fn, keys = self._d_stage, ("A", "B", "fake_A", "fake_B")
            if self.graphs:
                fn = _GraphedStep(self, fn, keys)
            self._step_fns[(which,)] = fn
        return fn

    def train_step(self, state: CycleGANState,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[CycleGANState, Dict[str, torch.Tensor]]:
        """The G stage, the pools' swap, the D stage; updates ``state`` in
        place."""
        if not self.is_train:
            raise RuntimeError("this trainer was built with is_train: false")
        if self.graphs:
            self._bind(state)
        step = state.step
        logs = self._stage("g")(state, batch, self.schedG.get_lr(step), 0.0)
        fake_a, fake_b = logs.pop("fake_A"), logs.pop("fake_B")
        if self.use_gan:
            pooled = {"A": batch["A"], "B": batch["B"],
                      "fake_A": self.fake_a_pool.query(fake_a),
                      "fake_B": self.fake_b_pool.query(fake_b)}
            logs.update(self._stage("d")(state, pooled, 0.0,
                                         self.schedD.get_lr(step)))
        state.step = step + 1
        return state, logs

    def can_scan_steps(self) -> bool:
        return False

    def _eval_forward(self, state: CycleGANState, x: torch.Tensor,
                      net: str = "g", cem: bool = False) -> torch.Tensor:
        """G_A(x) in eval mode, in f32."""
        return state.g.net["G_A"].eval()(x.float()).float()


def _load_g(g_net: nn.ModuleDict, path: str) -> None:
    """A G checkpoint into the Gs: a tree of ``G_A`` and ``G_B`` loads
    both, a single net's tree (a ``{tag}_G_A.ckpt``) G_A."""
    from ..utils.checkpoint import msgpack_restore
    from ..utils.torch_interop import g_from_jax, nets_from_jax

    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if set(tree) == {"G_A", "G_B"}:
        sd = nets_from_jax(tree, None, dict(g_net.items()))
        missing, unexpected = g_net.load_state_dict(sd, strict=False)
    else:
        missing, unexpected = g_net["G_A"].load_state_dict(
            g_from_jax(tree, None, g_net["G_A"]), strict=False)
    buffers = {n for n, _ in g_net.named_buffers()} | \
        {n for n, _ in g_net["G_A"].named_buffers()}
    if unexpected or set(missing) - buffers:
        raise KeyError(f"{path}: missing {missing}, unexpected {unexpected}")
