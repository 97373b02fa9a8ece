"""The video SR trainer: counterpart of ``trainner_tpu/train/vsr_trainer.py``
(``tv_sum:33``, ``ofr_loss:40``, ``VSRTrainer:48``: ``_g_forward``,
``_train_step``, ``train_step``, ``eval_step``, ``eval_step_chop``) for
``model: vsr``, ``vsrgan``, ``evsrgan`` and ``video``.

G is any video generator of ``define_G``: SOF-VSR (which also returns its
three levels of flows), SR3D, EDVR or EVSRGAN's Conv3D ``RRDBNet``, fed
the LR clip (b, t, h, w, c). The loss stack and, with ``gan_weight``, the
adversarial loss (D in train mode, its statistics dropped) supervise the
centre frame of the HR clip. With SOF-VSR and ``ofr_weight`` the flow
reconstruction term is added: for each non-centre frame, |x_c - warp(x_i,
flow)| + ``ofr_reg`` times the flow's total variation (sums over the batch
divided by b) at the three levels, the half-size level on the frames
resized as ``jax.image.resize(..., "linear")`` (antialiased,
``ops/imresize.py::jax_resize``), weighted ``ofr_wl1``, ``ofr_wl2`` and 1,
averaged over the frames and times ``ofr_weight``. Then D on the detached
output (fake first, real second; its statistics from the real pass). G's
and D's optimizers step every step at their schedules' rates; no EMA, SWA,
AdaTarget or batch augmentation (the JAX trainer reads none of them).

On the card the step is one CUDA graph per batch signature
(``graphs=False`` runs it eagerly); the SOF-VSR step adds in a fixed
order throughout (``ops/warp.py``, ``ops/blocks.py::resize_torch``), so
a replay equals the eager step bit for bit. ``eval_step`` serves G's SR
frame (a graph per input shape, as the ``sr`` trainer's);
``eval_step_chop`` splits a clip into four quadrants with an 8 px margin
until each has at most 128² pixels. The traps of this slice (atomics in
backward passes, the latent noise, the antialiased half-size resize,
the tail options ``_build_sofvsr`` fixes) are ROADMAP C 25.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.blocks import commit_stats, discard_stats
from ..ops.imresize import jax_resize
from ..ops.warp import flow_warp_vsr
from .sr_trainer import SRTrainer, _GraphedStep, _no_param_grad, clip_grads
from .state import SRTrainState


def tv_sum(flow: torch.Tensor) -> torch.Tensor:
    """The flow's total variation, summed and divided by the batch."""
    dh = (flow[:, 1:] - flow[:, :-1]).abs()
    dw = (flow[:, :, 1:] - flow[:, :, :-1]).abs()
    return dh.sum() / flow.shape[0] + dw.sum() / flow.shape[0]


def ofr_loss(x0: torch.Tensor, x1: torch.Tensor, flow: torch.Tensor,
             reg_weight: float = 0.1) -> torch.Tensor:
    """|x1 - warp(x0, flow)| (mean) + ``reg_weight`` TV(flow)."""
    warped = flow_warp_vsr(x0, flow)
    return (x1 - warped).abs().mean() + reg_weight * tv_sum(flow)


def _half(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return jax_resize(x, (h // 2, w // 2), "linear", antialias=True)


class VSRTrainer(SRTrainer):
    """``model: vsr`` / ``vsrgan`` / ``evsrgan`` / ``video``."""

    def __init__(self, opt: dict, dtype: torch.dtype = torch.float32,
                 device=None, graphs: Optional[bool] = None):
        super().__init__(opt, dtype=dtype, device=device, graphs=graphs)
        # the JAX trainer reads none of the sr trainer's other options
        self.use_ema = self.use_swa = self.use_atg = False
        self.batchaug, self.dapolicy = None, ""
        self.f_low = self.f_high = None
        self.accumulations = 1
        t = self.train_opt
        self.ofr_weight = float(t.get("ofr_weight", 0) or 0)
        self.ofr_wl1 = float(t.get("ofr_wl1", 0.1) or 0.1)
        self.ofr_wl2 = float(t.get("ofr_wl2", 0.2) or 0.2)
        self.ofr_reg = float(t.get("ofr_reg", 0.1) or 0.1)

    def _split(self, out) -> Tuple[Optional[tuple], torch.Tensor]:
        """G's output -> (the flows or None, the SR frame in f32)."""
        if isinstance(out, (tuple, list)) and len(out) == 4:
            return tuple(out[:3]), out[3].float()
        return None, out.float()

    def _g(self, net: torch.nn.Module, lr_clip: torch.Tensor
           ) -> torch.Tensor:
        return self._split(net(lr_clip))[1]

    def _ofr(self, flows, lr_clip, hr_clip, hr_center) -> torch.Tensor:
        n = lr_clip.shape[1]
        center = (n - 1) // 2
        others = [i for i in range(n) if i != center]
        f1, f2, f3 = flows
        total = None
        for k, i in enumerate(others):
            x_i, x_c = lr_clip[:, i], lr_clip[:, center]
            l1 = ofr_loss(_half(x_i), _half(x_c), f1[k], self.ofr_reg)
            l2 = ofr_loss(x_i, x_c, f2[k], self.ofr_reg)
            l3 = ofr_loss(hr_clip[:, i] if hr_clip.dim() == 5 else hr_center,
                          hr_center, f3[k], self.ofr_reg)
            term = l3 + self.ofr_wl2 * l2 + self.ofr_wl1 * l1
            total = term if total is None else total + term
        return self.ofr_weight * total / max(len(others), 1)

    def _vsr_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor],
                  lr_g, lr_d) -> Dict[str, torch.Tensor]:
        """The step's program: updates the state's tensors in place and
        returns the logs; nothing here reads the device."""
        lr_clip = self._to_device(batch["LR"])
        hr_clip = self._to_device(batch["HR"])
        center = (lr_clip.shape[1] - 1) // 2
        hr_center = hr_clip[:, center] if hr_clip.dim() == 5 else hr_clip
        netG = state.g.net.train()
        logs: Dict[str, torch.Tensor] = {}
        state.g.opt.zero_grad()
        flows, sr = self._split(netG(lr_clip))
        total, glogs = self.generator_loss(sr, hr_center)
        if flows is not None and self.ofr_weight:
            l_ofr = self._ofr(flows, lr_clip, hr_clip, hr_center)
            glogs["ofr"] = l_ofr
            total = total + l_ofr
        if self.use_gan:
            netD = state.d.net

            def d_fn(x, want_maps=False):
                return netD(x, train=True, return_feats=want_maps)

            with _no_param_grad(netD):
                l_g_gan = self.adversarial.generator_loss(d_fn, sr,
                                                          hr_center)
            glogs["l_g_gan"] = l_g_gan
            total = total + l_g_gan
        total.backward()
        commit_stats(netG)
        clip_grads(state.g.opt.params, self.grad_clip, self.grad_clip_value)
        state.g.opt.step(lr_g)
        logs.update(glogs)
        logs["l_g_total"] = total
        if self.use_gan:
            netD = state.d.net
            discard_stats(netD)  # the G stage's passes leave nothing
            state.d.opt.zero_grad()
            l_d, dlogs = self.adversarial.discriminator_loss(
                lambda x: netD(x, train=True), sr.detach(), hr_center,
                generator=state.noise_generator)
            l_d.backward()
            clip_grads(state.d.opt.params, self.grad_clip,
                       self.grad_clip_value)
            netD.commit_stats()  # the last (real) pass's statistics
            state.d.opt.step(lr_d)
            logs.update(dlogs)
            logs["l_d_total"] = l_d
        return {k: v.detach() for k, v in logs.items()}

    def train_step(self, state: SRTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[SRTrainState, Dict[str, torch.Tensor]]:
        """One step on ``batch`` ({"LR", "HR"}: clips (b, t, h, w, c), or
        an HR centre frame (b, h, w, c)); updates ``state`` in place."""
        if not self.is_train:
            raise RuntimeError("this trainer was built with is_train: false")
        if self.graphs:
            self._bind(state)
        step = state.step
        fn = self._step_fns.get(("vsr",))
        if fn is None:
            fn = self._vsr_step
            if self.graphs:
                fn = _GraphedStep(self, fn)
            self._step_fns[("vsr",)] = fn
        logs = fn(state, batch, self.schedG.get_lr(step),
                  self.schedD.get_lr(step) if self.use_gan else 0.0)
        state.step = step + 1
        return state, logs

    def can_scan_steps(self) -> bool:
        return False

    def eval_step_chop(self, state: SRTrainState, lr_clip: torch.Tensor,
                       min_size: int = 128, which: str = "auto"
                       ) -> torch.Tensor:
        """The clip split into four quadrants (each half plus 8 px) until
        each has at most ``min_size``² pixels, each served by
        ``eval_step``, the centre frame reassembled from each quadrant's
        own corner."""
        x = lr_clip.to(self.device, non_blocking=lr_clip.is_pinned())
        b, t, h, w, c = x.shape
        if h * w <= min_size * min_size:
            return self.eval_step(state, x, which)
        s = self.scale
        h2, w2 = h // 2, w // 2
        oh, ow = h2 + 8, w2 + 8
        quads = [x[:, :, :oh, :ow], x[:, :, :oh, -ow:],
                 x[:, :, -oh:, :ow], x[:, :, -oh:, -ow:]]
        outs = [self.eval_step_chop(state, q, min_size, which)
                for q in quads]
        out = torch.zeros((b, h * s, w * s, outs[0].shape[-1]),
                          dtype=torch.float32, device=self.device)
        hs, ws = h2 * s, w2 * s
        out[:, :hs, :ws] = outs[0][:, :hs, :ws]
        out[:, :hs, ws:] = outs[1][:, :hs, -(w * s - ws):]
        out[:, hs:, :ws] = outs[2][:, -(h * s - hs):, :ws]
        out[:, hs:, ws:] = outs[3][:, -(h * s - hs):, -(w * s - ws):]
        return out

    def eval_step_x8(self, *args, **kwargs):
        raise NotImplementedError(
            "x8 self-ensemble with a video model: the JAX VSRTrainer has no "
            "eval_step_x8 (its CLI raises AttributeError)")
