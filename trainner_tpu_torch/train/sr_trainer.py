"""SR / restoration GAN trainer: counterpart of
``trainner_tpu/train/sr_trainer.py::SRTrainer`` (``__init__:105``,
``init_state:222``, ``_g_apply:270``, ``_train_step:300``,
``_get_step_fn:521``, ``train_step:538``, ``can_scan_steps:565``,
``train_steps:573``, ``_eval_step:643``, ``eval_step:657``,
``eval_step_chop:672``, ``eval_step_x8:748``, ``refresh_swa_bn:766``;
``clip_grads:50``, ``agc_hist_percentile:73``,
``agc_percentile_clip:83``) and of
``train.py::create_trainer:95`` for ``model: sr``.

One training step is the ESRGAN step: G (``rrdb_net``, ``mrrdb_net`` or
``sr_resnet``; every residual dense block of the flagship form on the
hand-written forward and backward kernels) under the loss stack of
``losses/generator_loss.py`` and the adversarial loss, then D on the
detached output of that same G forward (with wgan-gp's gradient penalty,
a third D pass at interpolates whose weights come from the state's
generator); each net's optimizer with the learning rate of a host-side
schedule. With
``use_unshuffle`` G reads its input pixel-unshuffled by
``unshuffle_scale`` (``space_to_depth``); with ``use_cem`` the G stage's
output and ``eval_step``'s are projected by CEM (``ops/cem.py``; the
kernel from ``cem.kernel``, ``box`` by default). A G with batch norms
takes its running statistics from the step's one G pass, committed once
per step, as D's are. The network bodies run in the trainer's dtype (bf16
by default when training) with f32 parameters, gradients and losses; there
is no autocast and no loss scaling.

The trainer options of the JAX ``SRTrainer`` all run: the optimizers and
schedules of ``optimizers.py`` / ``schedulers.py``; batch augmentations
(``mixup``, ``mixopts``, ``mixprob``, ``mixalpha``: ``ops/batchaug.py``, on
the pair brought to one size by a nearest up-scale of LR and down again;
cutout's mask multiplies the loss's inputs and the G stage's D inputs);
DiffAugment on D's inputs in both stages, one draw for the fake and the
real batch (``diffaug``, ``dapolicy``: ``ops/diffaug.py``); frequency
separation (``fs``, ``lpf_type``, ``hpf_type``: the low pass to the loss
stack, the high pass on D's inputs); AdaTarget (``use_atg``,
``atg_start_iter``: ``ops/adatarget.py``, the LocNet trained jointly with G
through the pixel loss under ``optim_G``'s rule and clipped by norm to
``grad_clip_value``); FreezeD (``freeze_loc``: the first names of D's flax
parameter tree, sorted, get zero gradients); ``grad_clip`` value, norm or
auto (G's gradient norm recorded in a 256-entry ring buffer on the
device, G clipped to the 10th percentile of it, D to that of G's history
after G's update); a virtual batch (``virtual_batch_size`` A: A
microbatches in one step, gradients summed and divided by A, the logs
averaged, batch statistics from the last one; AdaTarget's G stage ignores
it, as in the JAX package); SWA (``use_swa``, ``swa_start_iter``,
``swa_lr``: ``train/state.py``) and EMA. The augmentations' random draws,
like the latent noise and wgan-gp's alpha, come from the state's
``noise_generator`` (or from ``draw_hook``, which the tests and the card's
smoke run use to share draws). The JAX behaviours the port keeps are
listed in ROADMAP C 19.

On the card, where the JAX package jits, the port replays CUDA graphs
(``utils/graphs.py``): the step as one graph per ``(update_d, update_g,
atg_on)`` and batch signature, all of a trainer's graphs in one memory
pool, and ``eval_step`` as one graph per input shape and type.
``train_steps`` runs a window of k steps as k replays, or as k
``train_step`` calls where a host transition (SWA, AdaTarget, the D ratio)
may fall inside it. ``graphs=False`` runs the same programs eagerly (on
the CPU they always are). With ``use_ema`` the EMA copy of G
(``train/state.py``) is updated at the end of every step, inside its
graph, and ``eval_step`` runs it by default, as the JAX package does; the
SWA average is one pass of foreach ops launched after the step.

Several cards (``mesh``, ``parallel/mesh.py``): one process per card runs
the step on its slice of the global batch inside ``Mesh.active``, so that
what couples samples sees the global batch (batch norms, the relativistic
GAN's means, the batch augmentations, a virtual batch's microbatches,
per-sample draws) and the gradients are averaged over the group in the
step (``average_grads``) before the clips and the optimizers read them;
the logs are averaged too. Every model runs it: the base ``Trainer``
broadcasts the state's nets and splits its optimizers (``_place``), runs
a step's program inside the mesh (``_in_mesh``) and queries an image
pool with the global batch (``_pooled``); each model's step averages its
nets' gradients and its logs. ``eval_step_spatial`` serves an image in
bands over a list of devices (``parallel/spatial.py``).
"""

from __future__ import annotations

import collections
import contextlib
import functools
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..losses.gan import build_adversarial
from ..losses.generator_loss import GeneratorLoss
from ..models.discriminators import DiscriminatorVGG
from ..models.networks import define_D, define_G
from ..models.rrdb import drop_packed
from ..ops.adatarget import LocNet, ada_target
from ..ops.batchaug import BatchAugment
from ..ops.blocks import (BatchNorm, Dropout, GaussianNoise, commit_stats,
                          interpolate, space_to_depth, wire_to_f01)
from ..ops.cem import cem_project
from ..ops.diffaug import apply_diff_augment, draw_diff_augment
from ..ops.filters import filter_high, filter_low
from ..parallel.collectives import (average_grads, batch_world,
                                    gather_batch, local_rows, mean_logs)
from ..parallel.mesh import Mesh, replicate_state, shard_optimizers
from ..utils.checkpoint import load_params
from ..utils.device import resolve_device
from ..utils.graphs import Captured, signature, warm_up
from ..utils.torch_interop import g_to_jax, key_to_seed, seed_to_key
from .optimizers import build_optimizer, jax_view
from .schedulers import build_scheduler
from .state import (NetState, SRTrainState, ema_update, init_ema, init_swa,
                    refresh_bn_stats, swa_update)

AGC_HISTORY = 256  # the auto clip's ring buffer of G's gradient norms
VIDEO_MODELS = ("vsr", "vsrgan", "evsrgan", "video")
PBR_MODELS = ("pbr", "sr_pbr", "pbr_sr")


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


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in f32."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def clip_grads(params, mode: Optional[str], value) -> None:
    """value / norm gradient clipping, in place on ``.grad``; ``auto``
    clips by norm to ``value`` here (the LocNet's, and D's to G's
    percentile). ``value`` may be a 0-d device tensor."""
    if not mode:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if mode == "value":
        for g in grads:
            g.clamp_(-value, value)
    elif mode in ("norm", "auto"):
        scale = torch.clamp(value / (global_norm(grads) + 1e-6), max=1.0)
        torch._foreach_mul_(grads, scale)
    else:
        raise NotImplementedError(f"grad_clip [{mode}]")


def init_grad_hist(device) -> Dict[str, torch.Tensor]:
    """The auto clip's history: ``vals`` (256 f32) and ``n`` (int32), the
    norms recorded so far."""
    return {"vals": torch.zeros(AGC_HISTORY, dtype=torch.float32,
                                device=device),
            "n": torch.zeros((), dtype=torch.int32, device=device)}


def agc_hist_percentile(hist: Dict[str, torch.Tensor],
                        percentile: float = 10.0) -> torch.Tensor:
    """The ``percentile``-th percentile of the recorded norms as
    ``jnp.nanpercentile`` computes it (linear between the two nearest
    ranks, q = percentile / 100 in f32 times count - 1); inf while the
    history is empty. On the device, reading nothing back."""
    vals, n = hist["vals"], hist["n"]
    k = vals.shape[0]
    idx = torch.arange(k, device=vals.device)
    valid = torch.where(idx < torch.clamp(n, max=k), vals,
                        torch.full_like(vals, float("nan")))
    ranked = torch.sort(valid).values  # NaN last
    counts = (~torch.isnan(ranked)).sum().float()
    q = (counts - 1) * float(np.float32(percentile) / np.float32(100.0))
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1 - high_w
    low = torch.clamp(torch.minimum(low, counts - 1), min=0).long()
    high = torch.clamp(torch.minimum(high, counts - 1), min=0).long()
    value = ranked.index_select(0, low.reshape(1))[0] * low_w + \
        ranked.index_select(0, high.reshape(1))[0] * high_w
    return torch.where(n > 0, value, torch.full_like(value, float("inf")))


def agc_percentile_clip(params, hist: Dict[str, torch.Tensor],
                        percentile: float = 10.0) -> None:
    """Auto clip: records the gradients' global norm in the ring buffer
    (in place), then clips them by norm to the percentile of the history
    that includes it."""
    grads = [p.grad for p in params if p.grad is not None]
    gnorm = global_norm(grads)
    vals, n = hist["vals"], hist["n"]
    slot = torch.remainder(n, vals.shape[0]).long().reshape(1)
    vals.index_copy_(0, slot, gnorm.reshape(1))
    n.add_(1)
    clip = agc_hist_percentile(hist, percentile)
    torch._foreach_mul_(grads, torch.clamp(clip / (gnorm + 1e-6), max=1.0))


def d_flax_names(net: torch.nn.Module) -> Dict[str, str]:
    """Each D parameter's top-level name in the JAX package's flax tree
    (``conv0_0``, ..., ``linear1`` for D-VGG; ``conv0`` ... for the U-Net),
    which ``utils/torch_interop.py::discriminator_to_jax`` writes."""
    return {name: name.split(".")[0] for name, _ in net.named_parameters()}


class Trainer:
    """What every model's trainer shares: the options, the dtype policy,
    the device, the loss stack, the schedules (with a GAN the adversarial
    loss and D's), the state's init (G, and D with a GAN), the CUDA graphs
    and G's inference. A model's trainer adds its step (``train_step``).
    The state (networks, optimizers, step) is made by ``init_state`` and
    updated in place by ``train_step``. The ``sr`` step's own options are
    read by ``SRTrainer`` alone; the code here sees them off.

    Under a ``mesh`` the parts shared here are the mesh's plumbing: a
    state's nets broadcast from rank 0 and its optimizers split over the
    fsdp axis (``_place``, which a model's own ``init_state`` calls too),
    a step's program run inside ``Mesh.active`` (``_in_mesh``, eager or
    captured) and an image pool queried with the global batch
    (``_pooled``). What is per model: averaging each net's gradients
    before its clip (``average_grads``), averaging the logs
    (``mean_logs``) and drawing per-sample randomness for the global batch
    (``sample_draw``).

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
    # the sr step's options that the shared code reads (SRTrainer's own)
    use_ema = use_swa = use_atg = use_cem = False
    unshuffle_scale = 0
    cem_kernel = "box"

    def __init__(self, opt: dict, dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device, None] = None,
                 graphs: Optional[bool] = None, mesh: Optional[Mesh] = None):
        train_opt = opt.get("train") or {}
        self.opt = opt
        self.train_opt = train_opt
        self.dtype = dtype
        self.device = resolve_device(device)
        self.graphs = self.device.type == "cuda" if graphs is None \
            else bool(graphs)
        if self.graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs run on cuda, not {self.device}")
        self.mesh = mesh
        if mesh is not None and mesh.distributed and self.graphs and \
                mesh.backend != "nccl":
            raise ValueError(
                f"a step over a {mesh.backend} group cannot be a CUDA graph "
                "(its collectives wait on the host): pass graphs=False")
        self._step_fns: Dict[Tuple[bool, bool, bool], Callable] = {}
        # () -> the step's draws in place of the generator's (the tests
        # give JAX's; the smoke run shares the CPU's with the card)
        self.draw_hook: Optional[Callable[[dict], dict]] = None
        self._eval_graphs: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._eval_seen: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._graph_state = None
        self._pool = None
        # a step's replay changes G's weights behind the packed caches'
        # version check: set then, cleared where the caches are dropped
        self._packs_stale = False
        # band serving's copies of an eval net on other cards, by (net,
        # card): [source module, its weights' stamp or None, the copy]
        self._twins: Dict[tuple, list] = {}
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
        self.grad_clip = train_opt.get("grad_clip")
        self.grad_clip_value = float(train_opt.get("grad_clip_value", 0.1)
                                     or 0.1)
        if self.grad_clip not in (None, "", False, "value", "norm", "auto"):
            raise NotImplementedError(f"grad_clip [{self.grad_clip}]")

    def _optimizer(self, net: torch.nn.Module, which: str):
        """``optim_{which}`` over ``net``'s parameters at the JAX
        ``build_optimizer``'s defaults (no beta or weight decay read), as
        the DVD and PBR trainers build theirs."""
        params = list(net.parameters())
        return build_optimizer(params, self.train_opt.get(f"optim_{which}",
                                                          "adam"),
                               views=[jax_view(p) for p in params])

    def can_scan_steps(self) -> bool:
        """True when a window of steps may run as replays of one program
        (``SRTrainer.train_steps``); a model's own step does not."""
        return False

    def _make_g(self) -> torch.nn.Module:
        """G as the options build it (``define_G``), in the trainer's
        dtype."""
        return define_G(self.opt, dtype=self.dtype)

    def _make_d(self) -> torch.nn.Module:
        """D as the options build it (``define_D``), in the trainer's
        dtype."""
        return define_D(self.opt, dtype=self.dtype)

    def init_state(self, seed: int = 0,
                   g_path: Optional[str] = None) -> SRTrainState:
        """Networks with random weights drawn from ``torch.Generator``s
        seeded from ``seed`` (then ``g_path``'s weights for G when one is
        given), on the trainer's device; when training, also D, the
        optimizers and the generator of the latent noise, seeded with
        ``seed + 2`` (the state's ``rng`` is that seed's key); with
        ``use_ema`` the EMA copy of G, with ``use_swa`` the SWA copy, with
        ``use_atg`` the LocNet (weights from ``seed + 3``) and its
        optimizer, with ``grad_clip: auto`` the norm history. A checkpoint
        of a run resumes into this state with
        ``utils/checkpoint.py::load_state``."""
        netG = self._make_g()
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
            if isinstance(m, (GaussianNoise, Dropout)):
                m.generator = noise
        state = SRTrainState(step=0,
                             g=NetState(netG, self._optimizer(netG, "G")),
                             noise_generator=noise, rng=rng)
        if self.use_gan:
            netD = self._make_d()
            if self.adversarial.uses_penalty and any(
                    isinstance(m, BatchNorm) for m in netD.modules()):
                raise NotImplementedError(
                    "wgan-gp's gradient penalty with a D that has batch "
                    "norm: the JAX step raises there (UnexpectedTracerError:"
                    " the penalty's D pass inside jax.grad writes D's batch"
                    " statistics, trainner_tpu/train/sr_trainer.py:470-481),"
                    " so the port refuses it too; take a D without batch "
                    "statistics (discriminator_vgg_128_sn, the U-Net, or "
                    "norm_type: none) (ROADMAP C 18)")
            netD.init_weights(torch.Generator().manual_seed(seed + 1))
            netD = netD.to(self.device)
            state.d = NetState(netD, self._optimizer(netD, "D"))
        if self.use_atg:
            loc = LocNet()
            loc.init_weights(torch.Generator().manual_seed(seed + 3))
            loc = loc.to(self.device)
            state.loc = NetState(loc, self._optimizer(loc, "G"))
        if self.grad_clip == "auto":
            state.grad_hist = init_grad_hist(self.device)
        if self.use_swa:
            init_swa(state)
        if self.use_ema:
            init_ema(state)
        self._place(state)
        return state

    def _place(self, state) -> None:
        """With a mesh: the state's nets broadcast from rank 0 and its
        optimizers split over the fsdp axis."""
        if self.mesh is not None:
            replicate_state(state, self.mesh)
            shard_optimizers(state, self.mesh)

    def _in_mesh(self, fn: Callable) -> Callable:
        """``fn`` run inside the mesh's ``active`` context (the step's
        program, eager or captured), or ``fn`` without a mesh."""
        if self.mesh is None:
            return fn
        mesh = self.mesh

        @functools.wraps(fn)
        def run(*args, **kwargs):
            with mesh.active():
                return fn(*args, **kwargs)
        return run

    def _pooled(self, pool, fakes: torch.Tensor) -> torch.Tensor:
        """``pool.query`` (``utils/image_pool.py``) on the global batch of
        fakes, as the JAX pool sees the gathered sharded array: under a
        mesh every rank gathers the fakes, queries its own copy of the
        pool (each seeded 0, so every copy makes the same choices) and
        keeps its rows. Runs between a step's graphs, eagerly."""
        if self.mesh is None:
            return pool.query(fakes)
        with self.mesh.active():
            return local_rows(pool.query(gather_batch(fakes)))

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
            for net in (self._graph_state.g.net, self._graph_state.ema,
                        self._graph_state.swa):
                if net is not None:
                    drop_packed(net)
            for entry in self._twins.values():
                entry[1] = None
        self._packs_stale = False

    def graph_pool(self):
        """The one memory pool of this trainer's graphs."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def step_graphs(self) -> Dict[tuple, Captured]:
        """Every captured step graph by ``(update_d, update_g, atg_on,
        batch signature)``."""
        return {(*key, sig): cap for key, fn in self._step_fns.items()
                if isinstance(fn, _GraphedStep)
                for sig, (_, _, cap) in fn.entries.items()}

    def eval_graphs(self) -> Dict[tuple, Captured]:
        """Every cached ``eval_step`` graph by input (shape, dtype)."""
        return {key: cap for key, (_, cap) in self._eval_graphs.items()}

    @staticmethod
    def _eval_net(state: SRTrainState, which: str) -> str:
        """'ema' for ``which`` 'ema' or 'auto' when the state has EMA
        weights, 'swa' for 'swa' when it has SWA weights, else 'g', as the
        JAX package's ``eval_step`` picks."""
        if which not in ("g", "ema", "swa", "auto"):
            raise ValueError(f"which [{which}]: 'g', 'ema', 'swa' or 'auto'")
        if which in ("ema", "auto") and state.ema is not None:
            return "ema"
        if which == "swa" and state.swa is not None:
            return "swa"
        return "g"

    def _eval_forward(self, state: SRTrainState, x: torch.Tensor,
                      net: str = "g", cem: bool = False) -> torch.Tensor:
        module = {"ema": state.ema, "swa": state.swa}.get(net, state.g.net)
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
        return self._eval_graphed(
            state, (tuple(x.shape), x.dtype, net, cem), [x],
            lambda t: self._eval_forward(state, t, net, cem))

    def _eval_graphed(self, state: SRTrainState, key: tuple, inputs: list,
                      fn: Callable) -> torch.Tensor:
        """``fn(*inputs)`` as ``eval_step`` runs it with graphs: eagerly
        until the ``EVAL_CAPTURE_AT``-th call of ``key``, which also
        captures it over static copies of ``inputs``; later calls copy
        their inputs in and replay (at most ``EVAL_GRAPHS`` graphs kept,
        the least recently used going first)."""
        self._bind(state)
        entry = self._eval_graphs.get(key)
        if entry is not None:
            self._eval_graphs.move_to_end(key)
            statics, cap = entry
            for buf, t in zip(statics, inputs):
                buf.copy_(t)
            return cap.replay().clone()
        self._fresh_packs()
        calls = self._eval_seen.pop(key, 0) + 1
        if calls < self.EVAL_CAPTURE_AT:
            self._eval_seen[key] = calls
            while len(self._eval_seen) > self.EVAL_SEEN:
                self._eval_seen.popitem(last=False)
            return fn(*inputs)
        out = warm_up(lambda: fn(*inputs))
        statics = [torch.empty_like(t) for t in inputs]
        cap = Captured(lambda: fn(*statics), pool=self.graph_pool())
        self._eval_graphs[key] = (statics, cap)
        while len(self._eval_graphs) > self.EVAL_GRAPHS:
            self._eval_graphs.popitem(last=False)
        return out

    def eval_step_chop(self, state: SRTrainState, lr_img: torch.Tensor,
                       patch_size: int = 128, overlap: int = 16,
                       which: str = "auto") -> torch.Tensor:
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
        out_tiles = torch.cat([self.eval_step(state, tiles[i:i + 32],
                                              which)
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

    def eval_step_spatial(self, state: SRTrainState, lr_img: torch.Tensor,
                          devices=None, halo: int = 16,
                          which: str = "auto") -> torch.Tensor:
        """Band-parallel inference (``parallel/spatial.py::spatial_infer``):
        the image's height cut into one band per device of ``devices``
        (``[self.device] * 4`` by default), each band with ``halo`` rows
        of its neighbours run through G (the EMA or SWA weights as
        ``which`` picks them, with CEM under ``use_cem``, as ``eval_step``
        serves), the halo rows cut away. A band on the trainer's device
        goes through ``eval_step``; on another card through that card's
        copy of the net (``_twin``), eagerly. Equal to ``eval_step``
        wherever ``halo`` covers G's effective receptive field."""
        from ..parallel.spatial import spatial_infer

        home = self.device
        if home.type == "cuda" and home.index is None:
            home = torch.device("cuda", torch.cuda.current_device())
        devices = [torch.device(d) for d in (devices or [home] * 4)]
        devices = [home if d == self.device else d for d in devices]
        net = self._eval_net(state, which)

        def apply_fn(x, dev):
            if dev == home:
                return self.eval_step(state, x, which)
            twin = self._twin(state, net, dev)
            with torch.inference_mode():
                y = self._g(twin, x.float())
                if self.use_cem:
                    y = cem_project(y, x.float(), self.scale,
                                    kernel=self.cem_kernel)
            return y

        x = lr_img.to(self.device, non_blocking=lr_img.is_pinned())
        return spatial_infer(apply_fn, x, devices, halo=halo,
                             scale=self.scale, out_device=self.device)

    def _twin(self, state: SRTrainState, net: str, dev: torch.device
              ) -> torch.nn.Module:
        """The eval net ``net`` ('g', 'ema' or 'swa') of ``state`` on card
        ``dev``: copied there at its first use and kept, with its
        packed-weight caches; its weights copied in again where the
        source's have changed since (an in-place update moves their
        version counters, a step's replay marks every copy stale in
        ``_fresh_packs``)."""
        module = {"ema": state.ema, "swa": state.swa}.get(net, state.g.net)
        self._fresh_packs()
        tensors = list(module.parameters()) + list(module.buffers())
        stamp = tuple(t._version for t in tensors)
        entry = self._twins.get((net, dev))
        if entry is None or entry[0] is not module:
            entry = [module, stamp, _net_copy(module).to(dev).eval()]
            self._twins[(net, dev)] = entry
        elif entry[1] != stamp:
            twin = entry[2]
            with torch.no_grad():
                torch._foreach_copy_(
                    list(twin.parameters()) + list(twin.buffers()),
                    tensors)
            drop_packed(twin)
            entry[1] = stamp
        return entry[2]

    def eval_step_x8(self, state: SRTrainState, lr_img: torch.Tensor,
                     which: str = "auto") -> torch.Tensor:
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
                y = self.eval_step(state, xi, which)
                if flip:
                    y = y.flip(2)
                outs.append(torch.rot90(y, -rot, (1, 2)))
        return torch.stack(outs).mean(0)


class SRTrainer(Trainer):
    """``model: sr`` and its aliases: the ESRGAN step and the ``sr`` step's
    own options, which this trainer alone reads (the other models' trainers
    extend ``Trainer``, or this class where their JAX trainers read them)."""

    batchaug = None
    dapolicy = ""
    f_low = f_high = None

    def __init__(self, opt: dict, dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device, None] = None,
                 graphs: Optional[bool] = None, mesh: Optional[Mesh] = None):
        super().__init__(opt, dtype=dtype, device=device, graphs=graphs,
                         mesh=mesh)
        self.unshuffle_scale = int(opt.get("unshuffle_scale") or 0) \
            if opt.get("use_unshuffle") else 0
        self.use_cem = bool(opt.get("use_cem"))
        self.cem_kernel = (opt.get("cem") or {}).get("kernel", "box") \
            if isinstance(opt.get("cem"), dict) else "box"
        if not self.is_train:
            return
        train_opt = self.train_opt
        self.d_update_ratio = int(train_opt.get("D_update_ratio", 1) or 1)
        self.d_init_iters = int(train_opt.get("D_init_iters", 0) or 0)
        self.use_ema = bool(opt.get("use_ema") or train_opt.get("use_ema"))
        self.ema_decay = float(train_opt.get("ema_decay", 0.999) or 0.999)
        self.accumulations = max(1, int(
            (train_opt.get("virtual_batch_size") or 0) or 1))
        self.use_swa = bool(opt.get("use_swa"))
        self.swa_start_iter = int(float(train_opt.get(
            "swa_start_iter", 0) or 0))
        self.use_atg = bool(opt.get("use_atg"))
        self.atg_start_iter = int(float(train_opt.get("atg_start_iter", 0)
                                        or 0))
        self.freeze_loc = int(train_opt.get("freeze_loc", 0) or 0) \
            if train_opt.get("freeze_d") or train_opt.get("freeze_loc") \
            else 0
        if train_opt.get("mixup"):
            mixopts = train_opt.get("mixopts",
                                    ["blend", "rgb", "mixup", "cutmix",
                                     "cutmixup"])
            alphas = dict(zip(mixopts, train_opt.get("mixalpha", []) or []))
            self.batchaug = BatchAugment(
                list(mixopts) + ["none"],
                (list(train_opt.get("mixprob", []) or
                      [1.0] * len(mixopts)) + [1.0]), alphas)
        self.dapolicy = (train_opt.get("dapolicy", "") or "") \
            if train_opt.get("diffaug") else ""
        if bool(train_opt.get("fs")):
            lpf = train_opt.get("lpf_type", "average")
            hpf = train_opt.get("hpf_type", "average")
            self.f_low = functools.partial(filter_low, kernel_size=9,
                                           filter_type=lpf)
            self.f_high = functools.partial(filter_high, kernel_size=9,
                                            filter_type=hpf)

    def _optimizer(self, net: torch.nn.Module, which: str):
        """``optim_{which}`` over ``net``'s parameters, with each weight's
        JAX layout for the rules that read it (AdamP's projection)."""
        t = self.train_opt
        params = list(net.parameters())
        return build_optimizer(
            params, t.get(f"optim_{which}", "adam"),
            beta1=float(t.get(f"beta1_{which}", 0.9) or 0.9),
            beta2=float(t.get(f"beta2_{which}", 0.999) or 0.999),
            weight_decay=float(t.get(f"weight_decay_{which}", 0) or 0),
            views=[jax_view(p) for p in params])

    def _frozen(self, netD: torch.nn.Module) -> list:
        """FreezeD's parameters: those under the first ``freeze_loc``
        top-level names of D's flax tree, in sorted order."""
        if not self.freeze_loc:
            return []
        names = d_flax_names(netD)
        frozen = set(sorted(set(names.values()))[:self.freeze_loc])
        return [p for n, p in netD.named_parameters() if names[n] in frozen]

    def _draw_shapes(self, hr_shape, update_d: bool, update_g: bool,
                     atg_on: bool) -> dict:
        """The shapes the step's draws are made for: ``aug`` (the batch
        augmentation's pair), ``da_g`` (D's inputs in the G stage: one
        microbatch, AdaTarget's region) and ``da_d`` (in the D stage)."""
        b, h, w, c = hr_shape
        shapes = {}
        if self.batchaug is not None:
            shapes["aug"] = (b, h, w, c)
        if self.use_gan and self.dapolicy:
            if update_g:
                a = 1 if atg_on else self.accumulations
                if atg_on:
                    h, w = h // 7 * 7, w // 7 * 7
                shapes["da_g"] = (b // a, h, w, c)
            if update_d:
                shapes["da_d"] = tuple(hr_shape)
        return shapes

    def _draws(self, state: SRTrainState, shapes: dict) -> dict:
        """The step's random draws, from ``state.noise_generator`` (or
        ``draw_hook``): the batch augmentation's choice and quantities,
        and DiffAugment's for each stage. The D stage reuses the G stage's
        draws when the shapes agree, and takes over its batch-wide ones
        when only the batch size differs, as one JAX key gives them."""
        if self.draw_hook is not None:
            return self.draw_hook(shapes)
        gen, dev = state.noise_generator, self.device
        out = {}
        if "aug" in shapes:
            out["aug"] = self.batchaug.draw(gen, shapes["aug"], dev)
        if "da_g" in shapes:
            out["da_g"] = draw_diff_augment(gen, self.dapolicy,
                                            shapes["da_g"], dev)
        if "da_d" in shapes:
            g_shape = shapes.get("da_g")
            if g_shape == shapes["da_d"]:
                out["da_d"] = out["da_g"]
            else:
                shared = out["da_g"] if g_shape is not None and \
                    g_shape[1:] == shapes["da_d"][1:] else None
                out["da_d"] = draw_diff_augment(gen, self.dapolicy,
                                                shapes["da_d"], dev, shared)
        return out

    def _d_inputs(self, fa: torch.Tensor, ra: torch.Tensor, draws):
        """D's inputs as the options shape them: the high pass (``fs``),
        then DiffAugment with one draw for both."""
        if self.f_high is not None:
            fa, ra = self.f_high(fa), self.f_high(ra)
        if self.dapolicy:
            fa = apply_diff_augment(fa, self.dapolicy, draws)
            ra = apply_diff_augment(ra, self.dapolicy, draws)
        return fa, ra

    def _forward_g(self, state: SRTrainState, lr_c, hr_c, msk, draws,
                   atg_on: bool):
        """G's loss on one (micro)batch: (total, logs, G's output). With
        AdaTarget the target is aligned first and the loss reads the region
        its grid covers; a cutout mask multiplies the loss's and D's
        inputs."""
        netG = state.g.net
        fake = self._g(netG, lr_c)
        if self.use_cem:
            fake = cem_project(fake, lr_c, self.scale, kernel=self.cem_kernel)
        if atg_on:
            hr_c = ada_target(fake, hr_c, state.loc.net)
        ha, wa = hr_c.shape[1:3]
        fake_l = fake[:, :ha, :wa] if fake.shape[1:3] != (ha, wa) else fake
        if msk is not None:
            msk = msk[:, :ha, :wa]
            fake_l, hr_c = fake_l * msk, hr_c * msk
        total, glogs = self.generator_loss(fake_l, hr_c, f_low=self.f_low)
        if self.use_gan:
            netD = state.d.net
            if (ha, wa) != tuple(fake.shape[1:3]) and \
                    isinstance(netD, DiscriminatorVGG):
                raise NotImplementedError(
                    f"AdaTarget's {ha}x{wa} region of a {fake.shape[1]}x"
                    f"{fake.shape[2]} crop goes to a D of fixed input size "
                    "(D-VGG's network_D size): the JAX step raises "
                    "there (flax ScopeParamShapeError), so the port does; "
                    "take a crop that is a multiple of 7 and of the scale, "
                    "or a D of any size (ROADMAP C 19)")
            fa, ra = self._d_inputs(fake_l, hr_c, draws.get("da_g"))

            # D runs in train mode here too (batch statistics, which G's
            # gradient flows through); its running statistics are not
            # written, the D stage owns their one update per step
            def d_fn(x, want_maps=False):
                return netD(x, train=True, return_feats=want_maps)

            with _no_param_grad(netD):
                l_g_gan = self.adversarial.generator_loss(d_fn, fa, ra)
            glogs["l_g_gan"] = l_g_gan
            total = total + l_g_gan
        return total, glogs, fake

    def _accumulated(self, runs, params, a: int):
        """Sums what ``runs`` (a loss, logs and output per microbatch,
        each loss already backpropagated) give over ``a`` microbatches:
        the gradients on ``params`` divided by ``a``, the mean loss and
        logs, the outputs joined."""
        totals, logs, outs = zip(*runs)
        if a == 1:
            return totals[0], logs[0], outs[0]
        grads = [p.grad for p in params if p.grad is not None]
        torch._foreach_div_(grads, float(a))
        total = totals[0]
        for t in totals[1:]:
            total = total + t
        mean = {k: torch.stack([lg[k] for lg in logs]).mean()
                for k in logs[0]}
        return total / a, mean, torch.cat(outs) if outs[0] is not None \
            else None

    def _train_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor],
                    lr_g, lr_d, *, update_d: bool, update_g: bool,
                    atg_on: bool = False) -> Dict[str, torch.Tensor]:
        """The step's program: reads the batch, the learning rates (floats
        or 0-d f32 tensors) and the state's tensors, updates the state's
        tensors in place and returns the logs. Nothing here reads the
        device or moves a host counter, so a graph can capture it."""
        lr_img = self._to_device(batch["LR"])
        hr_img = self._to_device(batch["HR"])
        netG = state.g.net.train()
        netD = state.d.net if self.use_gan else None
        logs: Dict[str, torch.Tensor] = {}
        b = hr_img.shape[0]
        a = self.accumulations
        if b % a:
            share = " (this rank's share)" if self.mesh is not None else ""
            raise ValueError(
                f"virtual_batch_size {a} does not divide the batch of "
                f"{b}{share}: the JAX package takes it as the number of "
                "microbatches (ROADMAP C 19)")
        # under a data axis the draws are made for the global batch and
        # what mixes samples runs on it; each microbatch of it is then
        # split over the ranks (``local_rows``), this rank's parts in turn
        w = batch_world()
        draws = self._draws(state, self._draw_shapes(
            (b * w, *hr_img.shape[1:]), update_d, update_g, atg_on))
        regroup = w > 1 and (self.batchaug is not None or a > 1)
        if regroup:
            lr_img, hr_img = gather_batch(lr_img), gather_batch(hr_img)

        mask = None
        if self.batchaug is not None:
            # the pair at one size: a nearest up-scale is exact for an
            # integer scale, so the regions no augmentation touches come
            # back bit for bit from the nearest down-scale
            up = self.scale > 1
            if up:
                lr_img = interpolate(lr_img, scale=self.scale,
                                     mode="nearest")
            hr_img, lr_img, mask = self.batchaug.apply(draws["aug"], hr_img,
                                                       lr_img)
            if up:
                lr_img = interpolate(lr_img, scale=1.0 / self.scale,
                                     mode="nearest")
        if regroup:
            lr_img, hr_img = local_rows(lr_img, a), local_rows(hr_img, a)
            if mask is not None:
                mask = local_rows(mask, a)
        if w > 1:
            draws = self._local_draws(draws, a, atg_on)

        if update_g:
            state.g.opt.zero_grad()
            ag = 1 if atg_on else a
            if atg_on:
                state.loc.opt.zero_grad()
            runs = []
            for i in range(ag):
                part = slice(i * b // ag, (i + 1) * b // ag)
                total, glogs, fake = self._forward_g(
                    state, lr_img[part], hr_img[part],
                    None if mask is None else mask[part], draws, atg_on)
                total.backward()
                runs.append((total.detach(), glogs, fake.detach()))
            commit_stats(netG)
            total, glogs, fake_for_d = self._accumulated(
                runs, state.g.opt.params, ag)
            average_grads(state.g.opt.params)
            if atg_on:
                average_grads(state.loc.opt.params)
                # the LocNet's gradients clipped as the JAX step clips
                # them, by its grad_clip with grad_clip_value
                clip_grads(state.loc.opt.params, self.grad_clip,
                           self.grad_clip_value)
                state.loc.opt.step(lr_g)
            if self.grad_clip == "auto":
                agc_percentile_clip(state.g.opt.params, state.grad_hist)
            else:
                clip_grads(state.g.opt.params, self.grad_clip,
                           self.grad_clip_value)
            # D sees the output of G's forward before this update
            state.g.opt.step(lr_g)
            logs.update(glogs)
            logs["l_g_total"] = total
        else:
            with torch.no_grad():
                fake_for_d = self._g(netG, lr_img)
            commit_stats(netG)

        if self.use_gan and update_d:
            state.d.opt.zero_grad()
            fa, ra = self._d_inputs(fake_for_d, hr_img, draws.get("da_d"))
            runs = []
            for i in range(a):
                part = slice(i * b // a, (i + 1) * b // a)
                l_d, dlogs = self.adversarial.discriminator_loss(
                    lambda x: netD(x, train=True), fa[part], ra[part],
                    generator=state.noise_generator)
                l_d.backward()
                runs.append((l_d.detach(), dlogs, None))
            l_d, dlogs, _ = self._accumulated(runs, state.d.opt.params, a)
            average_grads(state.d.opt.params)
            if self.grad_clip == "auto":
                # D by norm to the percentile of G's history (after G's
                # update, or as it was on a step without one)
                clip_grads(state.d.opt.params, "norm",
                           agc_hist_percentile(state.grad_hist))
            else:
                clip_grads(state.d.opt.params, self.grad_clip,
                           self.grad_clip_value)
            for p in self._frozen(netD):
                # FreezeD: zero gradients; the optimizer still moves the
                # parameter on its moments, as optax does
                if p.grad is not None:
                    p.grad.zero_()
            # fake went first, real second: the last microbatch's real
            # pass, from the weights before this update, gives the step's
            # one update of D's state (running statistics; spectral norms'
            # u and sigma, which every pass gives alike, the penalty's
            # too); the G stage's passes left none
            netD.commit_stats()
            state.d.opt.step(lr_d)
            logs.update(dlogs)
            logs["l_d_total"] = l_d
        if self.use_ema:
            ema_update(state, self.ema_decay)
        return mean_logs({k: v.detach() for k, v in logs.items()})

    def _local_draws(self, draws: dict, a: int, atg_on: bool) -> dict:
        """The step's draws for the global batch cut to this rank's
        samples (``local_rows``): the batch augmentation's whole (it ran
        on the global batch), DiffAugment's in the G stage per microbatch
        (the whole batch under AdaTarget) and in the D stage for the batch
        in the step's local order; batch-wide (0-d) draws as they are."""
        def cut(ds, groups):
            return [{k: local_rows(v, groups) if v.dim() > 0 else v
                     for k, v in d.items()} for d in ds]

        out = dict(draws)
        if "da_g" in draws:
            out["da_g"] = cut(draws["da_g"], a if atg_on else 1)
        if "da_d" in draws:
            out["da_d"] = cut(draws["da_d"], a)
        return out

    def _get_step_fn(self, update_d: bool, update_g: bool,
                     atg_on: bool = False) -> Callable:
        """The step program of one ``(update_d, update_g, atg_on)``, cached
        as the JAX package caches its jitted steps: ``fn(state, batch,
        lr_g, lr_d) -> logs``. With graphs it is a ``_GraphedStep``, else
        the eager ``_train_step``. Neither moves ``state.step``."""
        key = (update_d, update_g, atg_on)
        fn = self._step_fns.get(key)
        if fn is None:
            fn = self._in_mesh(functools.partial(
                self._train_step, update_d=update_d, update_g=update_g,
                atg_on=atg_on))
            if self.graphs:
                fn = _GraphedStep(self, fn)
            self._step_fns[key] = fn
        return fn

    def train_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[SRTrainState, Dict[str, torch.Tensor]]:
        """One optimization step on ``batch`` ({"LR", "HR"}: NHWC, float in
        [0, 1] or uint8). The schedule is decided on the host: the learning
        rates of this step, whether G is updated (``D_update_ratio``,
        ``D_init_iters``) and whether AdaTarget is on (``atg_start_iter``),
        which pick the program; then, with ``use_swa``, the SWA update from
        ``swa_start_iter`` on. Updates ``state`` in place and returns it
        with the logs (0-d tensors on the device, the caller's own: reading
        one synchronises)."""
        if not self.is_train:
            raise RuntimeError("this trainer was built with is_train: false")
        if self.graphs:
            self._bind(state)
        step = state.step
        lr_g = self.schedG.get_lr(step)
        lr_d = self.schedD.get_lr(step) if self.schedD else 0.0
        update_g = (not self.use_gan) or (
            step % self.d_update_ratio == 0 and step >= self.d_init_iters)
        atg_on = self.use_atg and step >= self.atg_start_iter
        logs = self._get_step_fn(self.use_gan, update_g, atg_on)(
            state, batch, lr_g, lr_d)
        state.step = step + 1
        # from swa_start_iter itself, where the rate's switch-over waits
        # for the step after it (ROADMAP C 19)
        if self.use_swa and step >= self.swa_start_iter:
            if state.swa is None:
                init_swa(state)
            swa_update(state)
        return state, logs

    def can_scan_steps(self) -> bool:
        """True when a window of steps runs one program throughout: no
        host-side schedule transition inside it (SWA averaging, AdaTarget's
        start, and with a GAN a G that is not updated at every step)."""
        return not (self.use_swa or self.use_atg
                    or (self.use_gan and (self.d_update_ratio != 1
                                          or self.d_init_iters > 0)))

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

    def refresh_swa_bn(self, state: SRTrainState, batches
                       ) -> Optional[dict]:
        """The ``extra`` of the SWA weights: G's batch-norm statistics
        recomputed for them over ``batches`` of LR images
        (``train/state.py::refresh_bn_stats``), as the flax collections
        ``{"batch_stats": ...}``; None without SWA or without batch norms.
        The batches are normalised as the step normalises them; G reads
        them as the JAX package's refresh passes them (no unshuffle)."""
        if state.swa is None:
            return None
        stats = refresh_bn_stats(state.swa, list(batches),
                                 prepare=self._to_device)
        if stats is None:
            return None
        sd = {**{n: p for n, p in state.swa.named_parameters()}, **stats}
        return {"batch_stats": g_to_jax(sd, state.swa)[1]}


class _GraphedStep:
    """The step program of one ``(update_d, update_g)`` as CUDA graphs,
    one per batch signature. The first batch of a signature runs the eager
    program as a real step (on a side stream) and then captures it into
    static buffers: the batch's ``keys`` (``LR`` and ``HR`` by default)
    that it holds, at their shapes and types, the two learning rates as
    0-d f32 tensors, the logs (and whatever else the program returns in
    its dict) as static outputs. Every later call copies the batch in,
    fills the learning rates and replays; the outputs come back as
    clones."""

    def __init__(self, trainer: Trainer, eager: Callable,
                 keys: tuple = ("LR", "HR")):
        self.trainer = trainer
        self.eager = eager
        self.keys = keys
        self.entries: Dict[tuple, tuple] = {}

    def __call__(self, state: SRTrainState, batch: Dict[str, torch.Tensor],
                 lr_g, lr_d) -> Dict[str, torch.Tensor]:
        sig = signature(batch, self.keys)
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
                                 device=dev) for k in self.keys
                  if k in batch}
        lrs = (torch.zeros((), dtype=torch.float32, device=dev),
               torch.zeros((), dtype=torch.float32, device=dev))
        mesh = self.trainer.mesh
        cap = Captured(lambda: self.eager(state, inputs, *lrs),
                       pool=self.trainer.graph_pool(),
                       generators=[state.noise_generator],
                       capture_error_mode="thread_local"
                       if mesh is not None and mesh.distributed
                       else "global")
        return inputs, lrs, cap


def _net_copy(net: torch.nn.Module) -> torch.nn.Module:
    """A copy of a net for another card: its weights as they are now,
    without the packed-weight caches."""
    import copy

    out = copy.deepcopy(net)
    drop_packed(out)
    return out


def create_trainer(opt: dict, device: Union[str, torch.device, None] = None,
                   graphs: Optional[bool] = None,
                   mesh: Optional[Mesh] = None) -> SRTrainer:
    """Model-strategy factory for ``model: sr`` (and its aliases),
    ``model: ppon`` (``ppon_trainer.PPONTrainer``), ``sftgan`` /
    ``sftgan_acd`` (``sftgan_trainer.SFTGANTrainer``), ``pix2pix``
    (``pix2pix_trainer.Pix2PixTrainer``), ``cyclegan``
    (``cyclegan_trainer.CycleGANTrainer``), ``vsr`` / ``vsrgan`` /
    ``evsrgan`` / ``video`` (``vsr_trainer.VSRTrainer``), ``srflow``
    (``srflow_trainer.SRFlowTrainer``, always f32), ``dvd``
    (``dvd_trainer.DVDTrainer``), ``wbc`` (``wbc_trainer.WBCTrainer``) and
    ``pbr`` / ``sr_pbr`` / ``pbr_sr`` (``pbr_trainer.PBRTrainer``): every
    model of the JAX ``train.py::create_trainer``. Training runs the
    network bodies in bf16 and inference in f32, unless ``use_amp`` says
    otherwise, as in the JAX package. Runs on ``cuda`` unless ``device``
    names the CPU, and raises when no card is present. ``graphs``
    (default: on for ``cuda``) runs the step and ``eval_step`` as CUDA
    graphs; ``False`` runs them eagerly, to compare the two. ``mesh``
    (``parallel/mesh.py``) runs every model's step on a data (and fsdp)
    axis."""
    model = (opt.get("model") or "sr").lower()
    if model not in ("sr", "srgan", "srragan", "ppon", "sftgan",
                     "sftgan_acd", "pix2pix", "cyclegan", "srflow", "dvd",
                     "wbc") + PBR_MODELS + VIDEO_MODELS:
        raise NotImplementedError(f"model [{model}] not recognized")
    amp_default = bool(opt.get("is_train", True))
    dtype = torch.bfloat16 if opt.get("use_amp", amp_default) \
        else torch.float32
    if model == "ppon":
        from .ppon_trainer import PPONTrainer as cls
    elif model in ("sftgan", "sftgan_acd"):
        from .sftgan_trainer import SFTGANTrainer as cls
    elif model == "pix2pix":
        from .pix2pix_trainer import Pix2PixTrainer as cls
    elif model == "cyclegan":
        from .cyclegan_trainer import CycleGANTrainer as cls
    elif model in VIDEO_MODELS:
        from .vsr_trainer import VSRTrainer as cls
    elif model == "srflow":
        from .srflow_trainer import SRFlowTrainer as cls
    elif model == "dvd":
        from .dvd_trainer import DVDTrainer as cls
    elif model == "wbc":
        from .wbc_trainer import WBCTrainer as cls
    elif model in PBR_MODELS:
        from .pbr_trainer import PBRTrainer as cls
    else:
        cls = SRTrainer
    return cls(opt, dtype=dtype, device=device, graphs=graphs, mesh=mesh)
