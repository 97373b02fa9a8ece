"""SR / restoration GAN trainer: counterpart of
``trainner_tpu/train/sr_trainer.py::SRTrainer`` (``__init__:105``,
``init_state:222``, ``_g_apply:270``, ``_train_step:300``,
``_get_step_fn:521``, ``train_step:538``, ``can_scan_steps:565``,
``train_steps:573``, ``_eval_step:643``, ``eval_step:657``,
``eval_step_chop:672``, ``eval_step_x8:748``) and of
``train.py::create_trainer:95`` for ``model: sr``.

One training step is the ESRGAN step: G (``rrdb_net``, ``mrrdb_net`` or
``sr_resnet``; every residual dense block of the flagship form on the
hand-written forward and backward kernels) under the pixel, VGG-feature
and relativistic GAN losses, then D on the detached output of that same G
forward; Adam or SGD with the learning rate of a host-side schedule. With
``use_unshuffle`` G reads its input pixel-unshuffled by
``unshuffle_scale`` (``space_to_depth``); with ``use_cem`` the G stage's
output and ``eval_step``'s are projected by CEM (``ops/cem.py``; the
kernel from ``cem.kernel``, ``box`` by default). A G with batch norms
takes its running statistics from the step's one G pass, committed once
per step, as D's are. The network bodies run in the trainer's dtype (bf16
by default when training) with f32 parameters, gradients and losses; there
is no autocast and no loss scaling.

On the card, where the JAX package jits, the port replays CUDA graphs
(``utils/graphs.py``): the step as one graph per ``(update_d, update_g)``
and batch signature, all of a trainer's graphs in one memory pool, and
``eval_step`` as one graph per input shape and type. ``train_steps`` runs a
window of k steps as k replays. ``graphs=False`` runs the same programs
eagerly (on the CPU they always are).

Not ported yet, each raising with its ROADMAP item: batch augmentations,
DiffAugment, frequency separation, AdaTarget, FreezeD, ``grad_clip:
auto``, a virtual batch and SWA; band-parallel inference. With ``use_ema`` the EMA copy of G
(``train/state.py``) is updated at the end of every step, inside its
graph, and ``eval_step`` runs it by default, as the JAX package does.
"""

from __future__ import annotations

import collections
import contextlib
import functools
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from ..losses.gan import build_adversarial
from ..losses.generator_loss import GeneratorLoss
from ..models.networks import define_D, define_G
from ..models.rrdb import drop_packed
from ..ops.blocks import (GaussianNoise, commit_stats, space_to_depth,
                          wire_to_f01)
from ..ops.cem import cem_project
from ..utils.checkpoint import load_params
from ..utils.device import resolve_device
from ..utils.graphs import Captured, signature, warm_up
from ..utils.torch_interop import key_to_seed, seed_to_key
from .optimizers import build_optimizer
from .schedulers import build_scheduler
from .state import NetState, SRTrainState, ema_update, init_ema

# option (in opt or opt["train"]) -> (what it is, its ROADMAP item)
_NOT_PORTED = {
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
    ``init_state`` and updated in place by ``train_step``.

    ``graphs`` (default: on for ``cuda``, off for the CPU) runs the step
    and ``eval_step`` as CUDA graphs. The graphs hold the tensors of the
    state they were captured for; a call with another state object drops
    them and captures anew."""

    # eval_step keeps at most this many graphs (one per input shape and
    # type), the least recently used going first: a test set of many sizes
    # holds at most this many static buffers and captures in the pool.
    EVAL_GRAPHS = 8
    # eval_step captures a shape at its EVAL_CAPTURE_AT-th call. One
    # image's x8 calls a shape at most eight times (a square image: all
    # eight), and a capture costs more than the replays of one image save,
    # so a test set of one size per image runs eagerly, plain or x8; a
    # shape that recurs over images (a test set of one size, chop's chunks
    # of 32 tiles) replays. The calls of at most EVAL_SEEN shapes not yet
    # captured are counted, the least recently met going first.
    EVAL_CAPTURE_AT = 9
    EVAL_SEEN = 64

    def __init__(self, opt: dict, dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device, None] = None,
                 graphs: Optional[bool] = None):
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
        self.graphs = self.device.type == "cuda" if graphs is None \
            else bool(graphs)
        if self.graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs run on cuda, not {self.device}")
        self._step_fns: Dict[Tuple[bool, bool], Callable] = {}
        self._eval_graphs: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._eval_seen: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._graph_state = None
        self._pool = None
        # a step's replay changes G's weights behind the packed caches'
        # version check: set then, cleared where the caches are dropped
        self._packs_stale = False
        self.use_ema = False
        self.is_train = bool(opt.get("is_train", True))
        self.scale = int(opt.get("scale", 4) or 4)
        self.znorm = bool(((opt.get("datasets") or {}).get("train")
                           or {}).get("znorm"))
        self.unshuffle_scale = int(opt.get("unshuffle_scale") or 0) \
            if opt.get("use_unshuffle") else 0
        self.use_cem = bool(opt.get("use_cem"))
        self.cem_kernel = (opt.get("cem") or {}).get("kernel", "box") \
            if isinstance(opt.get("cem"), dict) else "box"
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
        self.use_ema = bool(opt.get("use_ema") or train_opt.get("use_ema"))
        self.ema_decay = float(train_opt.get("ema_decay", 0.999) or 0.999)
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
        ``seed + 2`` (the state's ``rng`` is that seed's key), and with
        ``use_ema`` the EMA copy of G. A checkpoint
        of a run resumes into this state with
        ``utils/checkpoint.py::load_state``."""
        netG = define_G(self.opt, dtype=self.dtype)
        netG.init_weights(torch.Generator().manual_seed(seed))
        if g_path:
            # a G checkpoint holds parameters; running statistics stay
            missing, unexpected = netG.load_state_dict(
                load_params(g_path, netG), strict=False)
            buffers = {n for n, _ in netG.named_buffers()}
            if unexpected or set(missing) - buffers:
                raise KeyError(f"{g_path}: missing {missing}, unexpected "
                               f"{unexpected}")
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
        if self.use_ema:
            init_ema(state)
        return state

    # ------------------------------------------------------------------
    # train step
    # ------------------------------------------------------------------
    def _to_device(self, x: torch.Tensor) -> torch.Tensor:
        return wire_to_f01(x.to(self.device, non_blocking=x.is_pinned()),
                           self.znorm)

    def _g(self, net: torch.nn.Module, lr_img: torch.Tensor
           ) -> torch.Tensor:
        """G on an NHWC LR batch, unshuffled first with ``use_unshuffle``;
        the output in f32."""
        if self.unshuffle_scale:
            lr_img = space_to_depth(lr_img, self.unshuffle_scale)
        return net(lr_img).float()

    def _train_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor],
                    lr_g, lr_d, *, update_d: bool,
                    update_g: bool) -> Dict[str, torch.Tensor]:
        """The step's program: reads the batch, the learning rates (floats
        or 0-d f32 tensors) and the state's tensors, updates the state's
        tensors in place and returns the logs. Nothing here reads the
        device or moves a host counter, so a graph can capture it."""
        lr_img = self._to_device(batch["LR"])
        hr_img = self._to_device(batch["HR"])
        netG = state.g.net.train()
        netD = state.d.net if self.use_gan else None
        logs: Dict[str, torch.Tensor] = {}

        if update_g:
            state.g.opt.zero_grad()
            fake = self._g(netG, lr_img)
            commit_stats(netG)
            if self.use_cem:
                fake = cem_project(fake, lr_img, self.scale,
                                   kernel=self.cem_kernel)
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
                fake_for_d = self._g(netG, lr_img)
            commit_stats(netG)

        if self.use_gan and update_d:
            state.d.opt.zero_grad()
            l_d, dlogs = self.adversarial.discriminator_loss(
                lambda x: netD(x, train=True), fake_for_d, hr_img)
            l_d.backward()
            clip_grads(state.d.opt.params, self.grad_clip,
                       self.grad_clip_value)
            # fake went first, real second: the real batch's pass, from the
            # weights before this update, gives the step's one update of
            # D's state (running statistics; spectral norms' u and sigma,
            # which both passes give alike); the G stage's passes left none
            netD.commit_stats()
            state.d.opt.step(lr_d)
            logs.update(dlogs)
            logs["l_d_total"] = l_d
        if self.use_ema:
            ema_update(state, self.ema_decay)
        return {k: v.detach() for k, v in logs.items()}

    # ------------------------------------------------------------------
    # graphs
    # ------------------------------------------------------------------
    def _bind(self, state: SRTrainState) -> None:
        """The graphs hold ``state``'s tensors: for another state object
        they are dropped, to be captured anew."""
        if self._graph_state is not state:
            for fn in self._step_fns.values():
                if isinstance(fn, _GraphedStep):
                    fn.entries.clear()
            self._eval_graphs.clear()
            self._fresh_packs()
            self._graph_state = state

    def _fresh_packs(self) -> None:
        """Drops the packed-weight caches of the bound state's G when a
        step's replay has changed its weights since they were packed (a
        replay runs no Python, so no version counter moves); an eager run
        of the blocks packs anew."""
        if self._packs_stale and self._graph_state is not None:
            drop_packed(self._graph_state.g.net)
            if self._graph_state.ema is not None:
                drop_packed(self._graph_state.ema)
        self._packs_stale = False

    def graph_pool(self):
        """The one memory pool of this trainer's graphs."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _get_step_fn(self, update_d: bool, update_g: bool) -> Callable:
        """The step program of one ``(update_d, update_g)``, cached as the
        JAX package caches its jitted steps: ``fn(state, batch, lr_g,
        lr_d) -> logs``. With graphs it is a ``_GraphedStep``, else the
        eager ``_train_step``. Neither moves ``state.step``."""
        key = (update_d, update_g)
        fn = self._step_fns.get(key)
        if fn is None:
            fn = functools.partial(self._train_step, update_d=update_d,
                                   update_g=update_g)
            if self.graphs:
                fn = _GraphedStep(self, fn)
            self._step_fns[key] = fn
        return fn

    def step_graphs(self) -> Dict[tuple, Captured]:
        """Every captured step graph by ``(update_d, update_g, batch
        signature)``."""
        return {(*key, sig): cap for key, fn in self._step_fns.items()
                if isinstance(fn, _GraphedStep)
                for sig, (_, _, cap) in fn.entries.items()}

    def eval_graphs(self) -> Dict[tuple, Captured]:
        """Every cached ``eval_step`` graph by input (shape, dtype)."""
        return {key: cap for key, (_, cap) in self._eval_graphs.items()}

    # ------------------------------------------------------------------
    # train step
    # ------------------------------------------------------------------
    def train_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[SRTrainState, Dict[str, torch.Tensor]]:
        """One optimization step on ``batch`` ({"LR", "HR"}: NHWC, float in
        [0, 1] or uint8). The schedule is decided on the host: the learning
        rates of this step, and whether G is updated (``D_update_ratio``,
        ``D_init_iters``), which picks the program. Updates ``state`` in
        place and returns it with the logs (0-d tensors on the device, the
        caller's own: reading one synchronises)."""
        if not self.is_train:
            raise RuntimeError("this trainer was built with is_train: false")
        if self.graphs:
            self._bind(state)
        step = state.step
        lr_g = self.schedG.get_lr(step)
        lr_d = self.schedD.get_lr(step) if self.schedD else 0.0
        update_g = (not self.use_gan) or (
            step % self.d_update_ratio == 0 and step >= self.d_init_iters)
        logs = self._get_step_fn(self.use_gan, update_g)(state, batch,
                                                         lr_g, lr_d)
        state.step = step + 1
        return state, logs

    def can_scan_steps(self) -> bool:
        """True when a window of steps runs one program throughout: no
        host-side schedule transition inside it (with a GAN, G is updated
        at every step). SWA and AdaTarget, the JAX package's other
        transitions, are not ported."""
        return not (self.use_gan and (self.d_update_ratio != 1
                                      or self.d_init_iters > 0))

    def train_steps(self, state: SRTrainState,
                    batches: Dict[str, torch.Tensor]
                    ) -> Tuple[SRTrainState, Dict[str, torch.Tensor]]:
        """k optimization steps, ``batches`` holding each tensor with a
        leading (k, ...) step axis: the JAX package's scanned window.
        When ``can_scan_steps`` holds, k calls of the ``(use_gan, True)``
        program (k replays of its graph on the card) with the schedule's
        per-step learning rates, so a MultiStep boundary inside the window
        is exact; every log stacked to shape (k,). Otherwise k
        ``train_step`` calls, the logs stacked over the union of their keys
        with NaN where a step made no entry. ``state.step`` moves by k once
        the window has run."""
        if not self.is_train:
            raise RuntimeError("this trainer was built with is_train: false")
        k = int(batches["LR"].shape[0])
        if not self.can_scan_steps():
            out = []
            for i in range(k):
                state, logs = self.train_step(
                    state, {kk: v[i] for kk, v in batches.items()})
                out.append(logs)
            keys = sorted({kk for lg in out for kk in lg})
            nan = torch.full((), float("nan"), device=self.device)
            return state, {kk: torch.stack([lg.get(kk, nan).float()
                                            for lg in out]) for kk in keys}
        if self.graphs:
            self._bind(state)
        step0 = state.step
        lrs_g = self.schedG.get_lrs(step0, k)
        lrs_d = self.schedD.get_lrs(step0, k) if self.schedD else [0.0] * k
        fn = self._get_step_fn(self.use_gan, True)
        out = [fn(state, {kk: v[i] for kk, v in batches.items()},
                  lrs_g[i], lrs_d[i]) for i in range(k)]
        state.step = step0 + k
        return state, {kk: torch.stack([lg[kk] for lg in out])
                       for kk in out[0]}

    # ------------------------------------------------------------------
    # eval
    # ------------------------------------------------------------------
    @staticmethod
    def _eval_net(state: SRTrainState, which: str) -> str:
        """'ema' for ``which`` 'ema' or 'auto' when the state has EMA
        weights, else 'g' (SWA is not ported, so 'swa' gives G, as in the
        JAX package when a state has no SWA weights)."""
        if which not in ("g", "ema", "swa", "auto"):
            raise ValueError(f"which [{which}]: 'g', 'ema', 'swa' or 'auto'")
        return "ema" if which in ("ema", "auto") and state.ema is not None \
            else "g"

    def _eval_forward(self, state: SRTrainState, x: torch.Tensor,
                      net: str = "g", cem: bool = False) -> torch.Tensor:
        module = state.ema if net == "ema" else state.g.net
        x = x.float()
        y = self._g(module.eval(), x)
        if cem:
            y = cem_project(y, x, self.scale, kernel=self.cem_kernel)
        return y

    @torch.inference_mode()
    def eval_step(self, state: SRTrainState, lr_img: torch.Tensor,
                  which: str = "auto",
                  apply_cem: Optional[bool] = None) -> torch.Tensor:
        """Inference forward: NHWC LR batch -> f32 NHWC SR batch on the
        trainer's device, the caller's own tensor. ``which``: 'g', 'ema',
        'swa' or 'auto' (the EMA weights when the state has them, else G).
        ``apply_cem`` overrides ``use_cem`` (the test CLI's ``out_orig``).
        With graphs, one graph per input shape and type, net and CEM, at
        most
        ``EVAL_GRAPHS`` of them (the least recently used is dropped first).
        The first calls of a shape run eagerly; the ``EVAL_CAPTURE_AT``-th
        runs eagerly and captures, and later ones replay: the shapes of a
        test set of one size per image cost no capture and no pool memory,
        plain or x8."""
        x = lr_img.to(self.device, non_blocking=lr_img.is_pinned())
        net = self._eval_net(state, which)
        cem = self.use_cem if apply_cem is None else bool(apply_cem)
        if not self.graphs:
            return self._eval_forward(state, x, net, cem)
        self._bind(state)
        key = (tuple(x.shape), x.dtype, net, cem)
        entry = self._eval_graphs.get(key)
        if entry is not None:
            self._eval_graphs.move_to_end(key)
            static, cap = entry
            static.copy_(x)
            return cap.replay().clone()
        self._fresh_packs()
        calls = self._eval_seen.pop(key, 0) + 1
        if calls < self.EVAL_CAPTURE_AT:
            self._eval_seen[key] = calls
            while len(self._eval_seen) > self.EVAL_SEEN:
                self._eval_seen.popitem(last=False)
            return self._eval_forward(state, x, net, cem)
        out = warm_up(lambda: self._eval_forward(state, x, net, cem))
        static = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        cap = Captured(lambda: self._eval_forward(state, static, net, cem),
                       pool=self.graph_pool())
        self._eval_graphs[key] = (static, cap)
        while len(self._eval_graphs) > self.EVAL_GRAPHS:
            self._eval_graphs.popitem(last=False)
        return out

    def eval_step_chop(self, state: SRTrainState, lr_img: torch.Tensor,
                       patch_size: int = 128,
                       overlap: int = 16) -> torch.Tensor:
        """Tiled inference for large inputs: tiles of ``min(patch_size, h,
        w)`` at a stride of that less ``overlap``, the last row and column
        of tiles pinned to the edge, run through ``eval_step`` 32 rows of
        tiles at a time (so at most two input shapes), the outputs added
        and divided by how many tiles cover each pixel."""
        x = lr_img.to(self.device, non_blocking=lr_img.is_pinned())
        b, h, w, _ = x.shape
        s = self.scale
        p = min(patch_size, h, w)
        step = max(p - overlap, 1)
        ys = list(range(0, max(h - p, 0) + 1, step))
        xs = list(range(0, max(w - p, 0) + 1, step))
        if ys[-1] != h - p:
            ys.append(h - p)
        if xs[-1] != w - p:
            xs.append(w - p)
        tiles = torch.cat([x[:, y:y + p, x0:x0 + p, :]
                           for y in ys for x0 in xs], dim=0)
        out_tiles = torch.cat([self.eval_step(state, tiles[i:i + 32])
                               for i in range(0, tiles.shape[0], 32)], dim=0)
        acc = torch.zeros((b, h * s, w * s, out_tiles.shape[-1]),
                          dtype=torch.float32, device=self.device)
        cnt = torch.zeros((b, h * s, w * s, 1), dtype=torch.float32,
                          device=self.device)
        k = 0
        for y in ys:
            for x0 in xs:
                win = (slice(None), slice(y * s, (y + p) * s),
                       slice(x0 * s, (x0 + p) * s))
                acc[win] += out_tiles[k * b:(k + 1) * b]
                cnt[win] += 1.0
                k += 1
        return acc / cnt

    def eval_step_x8(self, state: SRTrainState, lr_img: torch.Tensor
                     ) -> torch.Tensor:
        """x8 geometric self-ensemble: ``eval_step`` on the four rotations
        over (h, w), each with and without a flip of w, each output turned
        back, and the mean of the eight. A non-square input meets two
        shapes, (h, w) and (w, h)."""
        x = lr_img.to(self.device, non_blocking=lr_img.is_pinned())
        outs = []
        for rot in range(4):
            for flip in (False, True):
                xi = torch.rot90(x, rot, (1, 2))
                if flip:
                    xi = xi.flip(2)
                y = self.eval_step(state, xi)
                if flip:
                    y = y.flip(2)
                outs.append(torch.rot90(y, -rot, (1, 2)))
        return torch.stack(outs).mean(0)


class _GraphedStep:
    """The step program of one ``(update_d, update_g)`` as CUDA graphs,
    one per batch signature. The first batch of a signature runs the eager
    program as a real step (on a side stream) and then captures it into
    static buffers: ``LR`` and ``HR`` at the batch's shape and type, the
    two learning rates as 0-d f32 tensors, the logs as static outputs.
    Every later call copies the batch in, fills the learning rates and
    replays; the logs come back as clones."""

    def __init__(self, trainer: SRTrainer, eager: Callable):
        self.trainer = trainer
        self.eager = eager
        self.entries: Dict[tuple, tuple] = {}

    def __call__(self, state: SRTrainState, batch: Dict[str, torch.Tensor],
                 lr_g, lr_d) -> Dict[str, torch.Tensor]:
        sig = signature(batch, ("LR", "HR"))
        entry = self.entries.get(sig)
        if entry is None:
            self.trainer._fresh_packs()
            logs = warm_up(lambda: self.eager(state, batch, lr_g, lr_d))
            self.entries[sig] = self._capture(state, batch)
            return logs
        inputs, lrs, cap = entry
        for k, buf in inputs.items():
            buf.copy_(batch[k], non_blocking=True)
        lrs[0].fill_(float(lr_g))
        lrs[1].fill_(float(lr_d))
        self.trainer._packs_stale = True
        return {k: v.clone() for k, v in cap.replay().items()}

    def _capture(self, state: SRTrainState, batch) -> tuple:
        dev = self.trainer.device
        inputs = {k: torch.empty(batch[k].shape, dtype=batch[k].dtype,
                                 device=dev) for k in ("LR", "HR")}
        lrs = (torch.zeros((), dtype=torch.float32, device=dev),
               torch.zeros((), dtype=torch.float32, device=dev))
        cap = Captured(lambda: self.eager(state, inputs, *lrs),
                       pool=self.trainer.graph_pool(),
                       generators=[state.noise_generator])
        return inputs, lrs, cap


def create_trainer(opt: dict, device: Union[str, torch.device, None] = None,
                   graphs: Optional[bool] = None) -> SRTrainer:
    """Model-strategy factory for ``model: sr``. Training runs the network
    bodies in bf16 and inference in f32, unless ``use_amp`` says otherwise,
    as in the JAX package. Runs on ``cuda`` unless ``device`` names the
    CPU, and raises when no card is present. ``graphs`` (default: on for
    ``cuda``) runs the step and ``eval_step`` as CUDA graphs; ``False``
    runs them eagerly, to compare the two."""
    model = (opt.get("model") or "sr").lower()
    if model not in ("sr", "srgan", "srragan"):
        raise NotImplementedError(
            f"model [{model}] is not ported yet (ROADMAP Queue A, other "
            "generator types)")
    amp_default = bool(opt.get("is_train", True))
    dtype = torch.bfloat16 if opt.get("use_amp", amp_default) \
        else torch.float32
    return SRTrainer(opt, dtype=dtype, device=device, graphs=graphs)
