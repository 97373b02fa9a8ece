"""The white-box cartoonization trainer: counterpart of
``trainner_tpu/train/wbc_trainer.py`` (``WBCState:50``, ``_sel:65``,
``WBCTrainer:72``, ``init_state:157``, ``_representations:200``,
``_g_step:229``, ``_d_step:324``, ``train_step:358``, ``eval_step:385``)
for ``model: wbc``.

G (``wbcunet_net``) maps the photos A towards the cartoons B; its output
is smoothed by a guided filter against A (``guided_filter_r`` 1,
``guided_filter_eps`` 1e-2): fake_B. Four representations drive the
loss: surface, the guided filter of an image against itself
(``surf_guided_filter_r`` 5, ``surf_guided_filter_eps`` 0.2) of fake_B
and of B; texture, both under one random grey projection
(``ops/colors.py::color_shift``); structure, the SLIC segment means of
the detached fake_B (``sp_n_segments``, 200) raised to a random gamma in
[1, 1.2) (``ops/superpixel.py``); content, fake_B against A. The G stage
adds the two adversarial losses (D_S on the surfaces, D_T on the grey
textures; in train mode, their statistics dropped) times ``surf_scale``
and ``text_scale``, the loss stack on each representation through its
selector list (``surf_losses`` [], ``text_losses`` [], ``struct_losses``
[fea], ``cont_losses`` [fea], and ``reg_losses`` [tv] on fake_B against
B) times its scale (``struct_scale``, ``content_scale``, ``reg_scale``),
and with ``lambda_identity`` the stack's ``idt_losses`` ([pix]) on G(B)
filtered against B. The D stage: each D's loss on its pooled fake
(``utils/image_pool.py``, one pool each, seeded 0) and its real
representation, each D's statistics from its real pass. The JAX
behaviours kept are ROADMAP C 27: ``gan_weight`` only switches the Ds
on, and 0 counts as 1 (so training always has them); a ``*_scale`` of 0
counts as 1; D_T sees one grey channel, which flax infers and the port
states (``define_D(..., in_nc=1)``). Adam's beta1 is ``beta1_G`` /
``beta1_D`` (0.5 by default), the learning rates 2e-4 by default, lsgan
in the standard form unless ``gan_type`` / ``gan_opt.form`` say
otherwise.

The grey weights and the gammas come from the state's generator
(``_draws``, or ``draw_hook``). On the card each stage is one CUDA graph
per batch signature (``_GraphedStep``): the G stage returns its logs and
the four representations the Ds read, the pools' swap runs on the device
between the two replays, as in ``cyclegan_trainer.py``. ``sp_exact: true``
takes the host's exact superpixels (``data/host_superpixels.py::
superpixels``, ``sp_algo``, ``sp_kind``, ``sp_reduction``,
``sp_max_size``) on the clipped fake_B and the same gamma: the batch goes
to the host and back inside the step, as the JAX step's
``pure_callback`` does, which a CUDA graph cannot hold, so that G stage
runs eagerly on the card (its D stage is still a graph). ``eval_step``
serves G and the guided filter.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..losses.gan import build_adversarial
from ..models.networks import define_D
from ..ops.blocks import commit_stats, discard_stats
from ..ops.colors import color_shift, draw_color_shift
from ..ops.filters import guided_filter
from ..ops.superpixel import draw_superpixel_structure, superpixel_structure
from ..utils.checkpoint import load_params
from ..utils.image_pool import ImagePool
from ..utils.torch_interop import key_to_seed, seed_to_key
from .pix2pix_trainer import Pix2PixTrainer
from .schedulers import build_scheduler
from .sr_trainer import Trainer, _GraphedStep, _no_param_grad, clip_grads
from .state import NetState


@dataclass
class WBCState:
    """G, D_S and D_T, each with its optimizer, the step, the generator
    the draws come from and the key that seeded it. The ``sr`` state's
    other fields are None: the code that serves and saves a state reads
    them."""

    D_FIELDS = ("d_s", "d_t")

    step: int
    g: NetState
    d_s: Optional[NetState] = None
    d_t: Optional[NetState] = None
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
        ``named_params`` gives its trees: ``G``, ``D_S``, ``D_T``."""
        out = {"G": dict(self.g.net.named_parameters())}
        for name, ns in (("D_S", self.d_s), ("D_T", self.d_t)):
            if ns is not None:
                out[name] = dict(ns.net.named_parameters())
        return out


def _sel(train_opt: dict, key: str, default: list) -> list:
    v = train_opt.get(key)
    if v is None:
        return default
    return list(v) if isinstance(v, (list, tuple)) else [v]


class WBCTrainer(Trainer):
    """``model: wbc``."""

    def __init__(self, opt: dict, dtype: torch.dtype = torch.float32,
                 device=None, graphs: Optional[bool] = None):
        super().__init__(opt, dtype=dtype, device=device, graphs=graphs)
        self.scale = 1
        self.znorm = bool(((opt.get("datasets") or {}).get("train")
                           or {}).get("znorm", True))
        t = self.train_opt
        self.gan_weight = float(t.get("gan_weight") or 1.0)
        self.use_gan = self.is_train and bool(self.gan_weight)
        self.gf_r = int(t.get("guided_filter_r", 1) or 1)
        self.gf_eps = float(t.get("guided_filter_eps", 1e-2))
        if not self.is_train:
            return
        self.surf_w = float(t.get("surf_scale", 1.0) or 1.0)
        self.text_w = float(t.get("text_scale", 1.0) or 1.0)
        self.stru_w = float(t.get("struct_scale", 1.0) or 1.0)
        self.cont_w = float(t.get("content_scale", 1.0) or 1.0)
        self.reg_w = float(t.get("reg_scale", 1.0) or 1.0)
        self.lambda_idt = float(t.get("lambda_identity", 0) or 0)
        self.surf_losses = _sel(t, "surf_losses", [])
        self.text_losses = _sel(t, "text_losses", [])
        self.struct_losses = _sel(t, "struct_losses", ["fea"])
        self.cont_losses = _sel(t, "cont_losses", ["fea"])
        self.reg_losses = _sel(t, "reg_losses", ["tv"])
        self.idt_losses = _sel(t, "idt_losses", ["pix"])
        self.gf_surf_r = int(t.get("surf_guided_filter_r", 5) or 5)
        self.gf_surf_eps = float(t.get("surf_guided_filter_eps", 2e-1))
        self.sp_n_segments = int(t.get("sp_n_segments", 200) or 200)
        self.sp_exact = bool(t.get("sp_exact"))
        self.sp_algo = str(t.get("sp_algo", "sk_felzenszwalb"))
        self.sp_reduction = t.get("sp_reduction", "selective")
        self.sp_kind = str(t.get("sp_kind", "mix"))
        self.sp_max_size = t.get("sp_max_size")
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
        self.fake_s_pool = ImagePool(pool_size)
        self.fake_t_pool = ImagePool(pool_size)

    _optimizer = Pix2PixTrainer._optimizer

    def init_state(self, seed: int = 0,
                   g_path: Optional[str] = None) -> WBCState:
        """G with random weights from a generator seeded ``seed`` (then
        ``g_path``'s weights, a ``{tag}_G.ckpt``); when training also the
        optimizers, D_S and D_T (from ``seed + 1`` and ``seed + 2``) and
        the draws' generator, seeded from the key of ``seed + 3``."""
        netG = self._make_g()
        netG.init_weights(torch.Generator().manual_seed(seed))
        if g_path:
            missing, unexpected = netG.load_state_dict(
                load_params(g_path, netG), strict=False)
            if unexpected or missing:
                raise KeyError(f"{g_path}: missing {missing}, unexpected "
                               f"{unexpected}")
        netG = netG.to(self.device).eval()
        if not self.is_train:
            return WBCState(step=0, g=NetState(netG))
        rng = seed_to_key(seed + 3)
        noise = torch.Generator(device=self.device).manual_seed(
            key_to_seed(rng))
        state = WBCState(step=0, g=NetState(netG, self._optimizer(netG, "G")),
                         noise_generator=noise, rng=rng)
        if self.use_gan:
            for i, (which, nc) in enumerate((("d_s", None), ("d_t", 1))):
                net = define_D(self.opt, dtype=self.dtype, in_nc=nc)
                net.init_weights(torch.Generator().manual_seed(seed + 1 + i))
                net = net.to(self.device)
                setattr(state, which, NetState(net,
                                               self._optimizer(net, "D")))
        return state

    def _draws(self, state: WBCState, shapes: dict) -> dict:
        """The G stage's draws: the grey projection's three weights
        (``cs``) and each sample's gamma of the structure (``gamma``, b x 1
        x 1 x 1), from ``state.noise_generator`` (or ``draw_hook``)."""
        if self.draw_hook is not None:
            return self.draw_hook(shapes)
        gen = state.noise_generator
        return {"cs": draw_color_shift(gen),
                "gamma": draw_superpixel_structure(gen, shapes["b"])}

    def _host_superpixels(self, images: torch.Tensor) -> torch.Tensor:
        """``sp_exact``: each image's exact superpixels on the host (the
        batch clipped to [0, 1], read back and sent again)."""
        from ..data.host_superpixels import superpixels

        imgs = images.float().clamp(0.0, 1.0).cpu().numpy()
        out = np.stack([superpixels(im, n_segments=self.sp_n_segments,
                                    algo=self.sp_algo, kind=self.sp_kind,
                                    reduction=self.sp_reduction,
                                    max_size=self.sp_max_size)
                        for im in imgs]).astype(np.float32)
        return torch.from_numpy(out).to(images.device)

    def _structure(self, fake_b: torch.Tensor, gamma: torch.Tensor
                   ) -> torch.Tensor:
        """The structure representation of the detached fake_B."""
        sp_in = fake_b.detach()
        if self.sp_exact:
            return self._host_superpixels(sp_in).clamp(1e-6, 1.0) ** gamma
        return superpixel_structure(sp_in, gamma,
                                    n_segments=self.sp_n_segments)

    def _representations(self, draws: dict, fake_b, real_b):
        fake_blur = guided_filter(fake_b, fake_b, self.gf_surf_r,
                                  self.gf_surf_eps)
        real_blur = guided_filter(real_b, real_b, self.gf_surf_r,
                                  self.gf_surf_eps)
        fake_gray, real_gray = color_shift(draws["cs"], fake_b, real_b)
        sp_real = self._structure(fake_b, draws["gamma"])
        return fake_blur, real_blur, fake_gray, real_gray, sp_real

    def _g_stage(self, state: WBCState, batch: Dict[str, torch.Tensor],
                 lr_g, lr_d) -> Dict[str, torch.Tensor]:
        """The G stage's program: G's update; returns the logs and the
        representations the D stage reads (``fake_blur``, ``fake_gray``,
        ``real_blur``, ``real_gray``)."""
        real_a = self._to_device(batch["A"])
        real_b = self._to_device(batch["B"])
        draws = self._draws(state, {"b": real_a.shape[0]})
        netG = state.g.net.train()
        state.g.opt.zero_grad()
        fake_b = guided_filter(real_a, netG(real_a).float(), self.gf_r,
                               self.gf_eps)
        commit_stats(netG)
        fake_blur, real_blur, fake_gray, real_gray, sp_real = \
            self._representations(draws, fake_b, real_b)
        logs: Dict[str, torch.Tensor] = {}
        total = None

        def add(v):
            nonlocal total
            total = v if total is None else total + v

        if self.lambda_idt > 0:
            idt_b = guided_filter(real_b, netG(real_b).float(), self.gf_r,
                                  self.gf_eps)
            l_idt, _ = self.generator_loss(idt_b, real_b,
                                           selectors=self.idt_losses)
            add(self.lambda_idt * l_idt)
            logs["l_idt"] = l_idt
        if self.use_gan:
            ds, dt = state.d_s.net, state.d_t.net

            def d_fn(net):
                return lambda x, want_maps=False: net(
                    x, train=True, return_feats=want_maps)

            with _no_param_grad(ds), _no_param_grad(dt):
                l_gan_s = self.adversarial.generator_loss(
                    d_fn(ds), fake_blur, real_blur)
                l_gan_t = self.adversarial.generator_loss(
                    d_fn(dt), fake_gray, real_gray)
            logs["l_g_gan_S"], logs["l_g_gan_T"] = l_gan_s, l_gan_t
            add(self.surf_w * l_gan_s + self.text_w * l_gan_t)
        reps = (("surf", fake_blur, real_blur, self.surf_losses,
                 self.surf_w),
                ("text", fake_gray, real_gray, self.text_losses,
                 self.text_w),
                ("struct", fake_b, sp_real, self.struct_losses, self.stru_w),
                ("cont", fake_b, real_a, self.cont_losses, self.cont_w),
                ("reg", fake_b, real_b, self.reg_losses, self.reg_w))
        for name, fake, real, sel, wgt in reps:
            if not sel:
                continue
            if fake.shape[-1] < real.shape[-1]:
                fake = fake.repeat_interleave(
                    real.shape[-1] // fake.shape[-1], dim=-1)
            l, llogs = self.generator_loss(fake, real, selectors=sel)
            add(wgt * l)
            for k, v in llogs.items():
                logs[f"{k}_{name}"] = v
        if total is None:
            total = fake_b.sum() * 0.0
        total.backward()
        if self.use_gan:
            discard_stats(state.d_s.net)  # the G stage's passes leave
            discard_stats(state.d_t.net)  # nothing
        clip_grads(state.g.opt.params, self.grad_clip, self.grad_clip_value)
        state.g.opt.step(lr_g)
        logs["l_g_total"] = total
        out = {k: v.detach() for k, v in logs.items()}
        out.update(fake_blur=fake_blur.detach(), fake_gray=fake_gray.detach(),
                   real_blur=real_blur.detach(), real_gray=real_gray.detach())
        return out

    def _d_stage(self, state: WBCState, batch: Dict[str, torch.Tensor],
                 lr_g, lr_d) -> Dict[str, torch.Tensor]:
        """The D stage's program on the pooled fakes: each D's loss and
        update."""
        logs = {}
        for tag, ns, fake, real in (
                ("S", state.d_s, batch["fake_blur"], batch["real_blur"]),
                ("T", state.d_t, batch["fake_gray"], batch["real_gray"])):
            net = ns.net
            ns.opt.zero_grad()
            l_d, _ = self.adversarial.discriminator_loss(
                lambda x, n=net: n(x, train=True), fake, real,
                generator=state.noise_generator)
            l_d.backward()
            clip_grads(ns.opt.params, self.grad_clip, self.grad_clip_value)
            net.commit_stats()  # its real pass's statistics
            ns.opt.step(lr_d)
            logs[f"l_d_{tag}"] = l_d.detach()
        return logs

    def _stage(self, which: str):
        fn = self._step_fns.get((which,))
        if fn is None:
            if which == "g":
                fn, keys = self._g_stage, ("A", "B")
            else:
                fn, keys = self._d_stage, ("fake_blur", "fake_gray",
                                           "real_blur", "real_gray")
            # sp_exact's host round trip cannot be captured: eager G stage
            if self.graphs and not (which == "g" and self.sp_exact):
                fn = _GraphedStep(self, fn, keys)
            self._step_fns[(which,)] = fn
        return fn

    def train_step(self, state: WBCState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[WBCState, Dict[str, torch.Tensor]]:
        """The G stage, the pools' swap, the D stage; updates ``state`` in
        place."""
        if not self.is_train:
            raise RuntimeError("this trainer was built with is_train: false")
        if self.graphs:
            self._bind(state)
        step = state.step
        out = self._stage("g")(state, batch, self.schedG.get_lr(step), 0.0)
        reps = {k: out.pop(k) for k in ("fake_blur", "fake_gray",
                                        "real_blur", "real_gray")}
        logs = out
        if self.use_gan:
            reps["fake_blur"] = self.fake_s_pool.query(reps["fake_blur"])
            reps["fake_gray"] = self.fake_t_pool.query(reps["fake_gray"])
            logs.update(self._stage("d")(state, reps, 0.0,
                                         self.schedD.get_lr(step)))
        state.step = step + 1
        return state, logs

    def _eval_forward(self, state: WBCState, x: torch.Tensor,
                      net: str = "g", cem: bool = False) -> torch.Tensor:
        """G(x) in eval mode, guided-filtered against x, in f32."""
        x = x.float()
        return guided_filter(x, state.g.net.eval()(x).float(), self.gf_r,
                             self.gf_eps)
