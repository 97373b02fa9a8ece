"""The cases of tests/test_torch_parallel.py and
tests/test_torch_parallel_models.py, and one rank that runs them.

Imports torch and the port alone, no JAX, so that a rank starts fast:
``python tests/torch_parallel_worker.py SPEC.json`` joins a gloo group
through the spec's file store, runs each job of the spec (a case on a
``(data, fsdp, tensor)`` mesh for some steps, from the port's init or
from saved weights, a checkpoint and a resume, or the training CLI on an
options file with ``parallel:``) and rank 0 writes the results with
``torch.save``. The test runs the same
cases in one process without a group for the one-rank step.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from trainner_tpu_torch.options.config import parse_dict  # noqa: E402
from trainner_tpu_torch.parallel import mesh as M  # noqa: E402
from trainner_tpu_torch.train.sr_trainer import create_trainer  # noqa: E402
from trainner_tpu_torch.utils import checkpoint  # noqa: E402

BATCH = 8  # the global batch of every case but those in BATCHES
# the cases of every other model (tests/test_torch_parallel_models.py)
MODEL_CASES = ("cyclegan", "wbc", "pbr", "sofvsr", "sr3d", "edvr",
               "evsrgan", "srflow", "srflow_interop", "sftgan", "dvd",
               "dvd_gp")
BATCHES = {"sftgan": 4, "edvr": 4}
# the nets of a state, by field, with the names their results carry
NET_FIELDS = ("g", "d", "d_a", "d_b", "d_s", "d_t")


def _sr(**train):
    """tests/test_parallel.py's trainer: RRDBNet nf 8, nb 1, gc 4, x2,
    D-VGG size 16, base_nf 8 (batch norms), f32; D by SGD (under Adam a
    conv bias in front of a batch norm, whose gradient is rounding noise,
    moves by a full step either way)."""
    return {"name": "par_sr", "model": "sr", "scale": 2, "use_amp": False,
            "datasets": {"train": {"name": "t", "mode": "aligned",
                                   "dataroot_HR": "/x", "crop_size": 16,
                                   "batch_size": BATCH}},
            "network_G": {"type": "rrdb_net", "nf": 8, "nb": 1, "gc": 4,
                          "upscale": 2, "gaussian_noise": True},
            "network_D": {"type": "discriminator_vgg", "size": 16,
                          "base_nf": 8},
            "path": {"root": "/tmp/par_sr"},
            "train": {"lr_G": 1e-3, "lr_D": 1e-2, "optim_D": "sgd",
                      "pixel_criterion": "l1",
                      "pixel_weight": 1.0, "lr_scheme": "MultiStepLR",
                      "lr_steps": [100], "niter": 100, **train}}


def options(case: str) -> dict:
    """The parsed options of a case:

    * ``sr``: pixel L1 with a GAN (relativistic, D with batch norms) and
      G's latent noise, Adam;
    * ``srragan``: the same GAN with mixup (a batch augmentation that
      mixes samples), DiffAugment, norm clipping and a virtual batch of
      2 microbatches;
    * ``srragan_auto``: the auto clip (``grad_clip: auto``);
    * ``ppon``: PPON in phase 3 (its GAN and pixel loss);
    * ``pix2pix``: the U-Net G and the PatchGAN, both with batch norms,
      G with dropout;
    * ``sr_adamp``, ``sr_sgdp``, ``sr_ranger_gc``: ``sr`` with G under
      AdamP, SGDP, or ranger with gradient centralisation
      (``WHOLE_WEIGHT_CASES``), weight decay 1e-2;
    * ``sr_plain``: ``sr`` without G's latent noise;
    * ``sr_wide``: ``sr`` at the flagship's widths in one RRDB (nf 64,
      gc 32) with a D of base_nf 64 (lr_D 1e-3), no latent noise.
    """
    if case == "sr":
        opt = _sr(gan_type="vanilla", gan_weight=5e-3)
    elif case == "srragan":
        opt = _sr(gan_type="vanilla", gan_weight=5e-3, mixup=True,
                  mixopts=["mixup", "cutmix", "blend"],
                  mixprob=[1.0, 1.0, 1.0], diffaug=True,
                  dapolicy="color,translation,cutout", grad_clip="norm",
                  grad_clip_value=0.5, virtual_batch_size=2)
        opt["model"] = "srragan"
    elif case == "srragan_auto":
        opt = _sr(gan_type="vanilla", gan_weight=5e-3, grad_clip="auto")
        opt["model"] = "srragan"
    elif case == "ppon":
        opt = {"name": "par_ppon", "model": "ppon", "scale": 4,
               "use_amp": False,
               "datasets": {"train": {"name": "t", "mode": "aligned",
                                      "dataroot_HR": "/x", "crop_size": 32,
                                      "batch_size": BATCH}},
               "network_G": {"type": "ppon", "nf": 8, "nb": 1},
               "network_D": {"type": "discriminator_vgg", "nf": 8},
               "path": {"root": "/tmp/par_ppon"},
               "train": {"lr_G": 1e-2, "lr_D": 1e-2, "optim_G": "sgd",
                         "optim_D": "sgd", "pixel_criterion": "l1",
                         "pixel_weight": 1.0, "gan_type": "vanilla",
                         "gan_weight": 5e-3, "p3_losses": ["pix"],
                         "ppon_stages": [0, 0], "lr_scheme": "MultiStepLR",
                         "lr_steps": [50]}}
    elif case == "pix2pix":
        opt = {"name": "par_p2p", "model": "pix2pix", "scale": 1,
               "use_amp": False,
               "datasets": {"train": {"name": "t", "mode": "unaligned",
                                      "dataroot_A": "/x", "dataroot_B": "/y",
                                      "crop_size": 32, "batch_size": BATCH,
                                      "znorm": True}},
               "network_G": {"type": "unet_net", "num_downs": 5, "ngf": 8,
                             "norm_type": "batch", "use_dropout": True},
               "network_D": {"type": "patchgan", "ndf": 8, "n_layers": 3},
               "path": {"root": "/tmp/par_p2p"},
               "train": {"lr_G": 1e-2, "lr_D": 1e-2, "optim_G": "sgd",
                         "optim_D": "sgd", "pixel_criterion": "l1",
                         "pixel_weight": 100.0, "gan_type": "vanilla",
                         "gan_weight": 1.0, "lr_scheme": "MultiStepLR",
                         "lr_steps": [50]}}
    elif case in WHOLE_WEIGHT_CASES:
        # the rules that read whole weights, on G (A 9 f)
        opt = _sr(gan_type="vanilla", gan_weight=5e-3,
                  optim_G=WHOLE_WEIGHT_CASES[case][0], weight_decay_G=1e-2)
    elif case == "sr_plain":
        # sr without G's latent noise: the step that the JAX package's
        # own tensor step is held to from the same weights
        opt = _sr(gan_type="vanilla", gan_weight=5e-3)
        opt["network_G"]["gaussian_noise"] = False
    elif case == "sr_wide":
        # the flagship's widths in one RRDB (nf 64, gc 32) and a D of
        # base_nf 64: at the rule's 2^16, conv5 of each block and four D
        # leaves split
        opt = _sr(gan_type="vanilla", gan_weight=5e-3)
        opt["network_G"].update(nf=64, gc=32, gaussian_noise=False)
        opt["network_D"]["base_nf"] = 64
        opt["train"]["lr_D"] = 1e-3
    else:
        opt = {"use_amp": False, **_model_options(case)}
    return dict(parse_dict(copy.deepcopy(opt), is_train=True))


# case -> (optim_G, use_gc: G's optimizer built with gradient
# centralisation, which no option of the sr trainer asks for)
WHOLE_WEIGHT_CASES = {"sr_adamp": ("adamp", False),
                      "sr_sgdp": ("sgdp", False),
                      "sr_ranger_gc": ("ranger", True)}


def _sgd(**train):
    return {"lr_G": 1e-2, "lr_D": 1e-2, "optim_G": "sgd", "optim_D": "sgd",
            "lr_scheme": "MultiStepLR", "lr_steps": [50],
            "pixel_criterion": "l1", "pixel_weight": 1.0, **train}


def _model_options(case: str) -> dict:
    """The options of the other models' cases, at narrow widths:

    * ``cyclegan``: the ResNet G (ngf 8, 1 block, instance norm) and a
      batch-norm PatchGAN, lsgan, identity terms, pools of 4 (so that the
      pools swap within the first step);
    * ``wbc``: the WBC U-Net (nf 8) and a batch-norm PatchGAN, pools of 4,
      the pixel loss on every representation, 20 superpixels;
    * ``pbr``: RRDBNet nf 8, nb 1, gc 4 with latent noise, Adam, four maps
      (two of one channel);
    * ``sofvsr``: SOF-VSR (8 channels, its rrdb tail nf 8, nb 1) with the
      OFR term and a batch-norm PatchGAN (vsrgan); ``sr3d``, ``edvr``,
      ``evsrgan``: each other video G under the pixel loss;
    * ``srflow`` / ``srflow_interop``: both flow nets (nf 8, nb 2, gc 4,
      K 2, L 3), the encoder frozen for the first step, the global-norm
      clip; SGD (under Adam a weight whose gradient is rounding noise
      moves by a share of lr either way, as D's biases do in ``_sr``);
    * ``sftgan``: SFTNet (nf 8, 1 block) and the ACD D with batch norms,
      96 px;
    * ``dvd``: the DVD net (nf 8) with a batch-norm PatchGAN under lsgan;
      ``dvd_gp``: wgan-gp with a PatchGAN without norms.
    """
    px = {"cyclegan": 32, "wbc": 32, "sftgan": 96, "dvd": 32,
          "dvd_gp": 32}.get(case)
    if case in ("cyclegan", "wbc"):
        ds = {"name": "t", "mode": "unaligned", "dataroot_A": "/x",
              "dataroot_B": "/y", "crop_size": px, "batch_size": BATCH}
        d = {"type": "patchgan", "ndf": 8, "n_layers": 2}
        if case == "cyclegan":
            return {"name": "par_cyc", "model": "cyclegan", "scale": 1,
                    "pool_size": 4, "datasets": {"train": ds},
                    "network_G": {"type": "resnet_net", "n_blocks": 1,
                                  "ngf": 8, "norm_type": "instance"},
                    "network_D": d, "path": {"root": "/tmp/par_cyc"},
                    "train": _sgd(gan_type="lsgan", gan_weight=1.0,
                                  lambda_A=10.0, lambda_B=10.0,
                                  lambda_identity=0.5)}
        return {"name": "par_wbc", "model": "wbc", "scale": 1,
                "pool_size": 4, "datasets": {"train": ds},
                "network_G": {"type": "wbcunet_net", "nf": 8},
                "network_D": d, "path": {"root": "/tmp/par_wbc"},
                "train": _sgd(gan_type="lsgan", gan_weight=1.0,
                              surf_scale=0.1, struct_scale=2.0,
                              reg_scale=10.0, tv_type="tv", tv_weight=1.0,
                              surf_losses=["pix"], text_losses=["pix"],
                              struct_losses=["pix"], cont_losses=["pix"],
                              lambda_identity=0.5, sp_n_segments=20)}
    if case == "pbr":
        return {"name": "par_pbr", "model": "pbr", "scale": 4,
                "datasets": {"train": {"name": "t", "mode": "pbr",
                                       "dataroot_HR": "/x", "crop_size": 16,
                                       "batch_size": BATCH}},
                "network_G": {"type": "rrdb_net", "nf": 8, "nb": 1,
                              "gc": 4, "gaussian_noise": True},
                "path": {"root": "/tmp/par_pbr"},
                "train": _sgd(optim_G="adam", lr_G=1e-3)}
    if case in ("sofvsr", "sr3d", "edvr", "evsrgan"):
        g = {"sofvsr": {"type": "sofvsr_net", "n_frames": 3, "channels": 8,
                        "SR_net": "rrdb", "sr_nf": 8, "sr_nb": 1},
             "sr3d": {"type": "sr3d_net", "nf": 4},
             "edvr": {"type": "edvr_net", "nf": 16, "deformable_groups": 4,
                      "num_extract_block": 1, "num_reconstruct_block": 1},
             "evsrgan": {"type": "evsrgan", "nf": 8, "nb": 1,
                         "gc": 4}}[case]
        frames = 5 if case in ("sr3d", "edvr") else 3
        opt = {"name": f"par_{case}", "model": "vsr", "scale": 4,
               "datasets": {"train": {"name": "t", "mode": "video",
                                      "dataroot_HR": "/x", "crop_size": 32,
                                      "batch_size": BATCHES.get(case, BATCH),
                                      "num_frames": frames}},
               "network_G": g, "path": {"root": f"/tmp/par_{case}"},
               "train": _sgd()}
        if case == "sofvsr":
            opt["model"] = "vsrgan"
            opt["network_D"] = {"type": "patchgan", "ndf": 8,
                                "n_layers": 2}
            opt["train"].update(ofr_weight=0.1, gan_type="vanilla",
                                gan_weight=5e-2)
        return opt
    if case in ("srflow", "srflow_interop"):
        return {"name": "par_flow", "model": "srflow", "scale": 4,
                "datasets": {"train": {"name": "t", "mode": "aligned",
                                       "dataroot_HR": "/x", "crop_size": 32,
                                       "batch_size": BATCH}},
                "network_G": {"type": "srflow_net", "nf": 8, "nb": 2,
                              "gc": 4, "K": 2,
                              "flow": {"L": 3, "hidden_channels": 8,
                                       "interop": case == "srflow_interop",
                                       "stackRRDB": {"blocks": [0, 1]}}},
                "path": {"root": "/tmp/par_flow"},
                "train": {"lr_G": 1e-2, "optim_G": "sgd",
                          "lr_scheme": "MultiStepLR",
                          "lr_steps": [50], "niter": 2,
                          "train_RRDB_delay": 0.5, "grad_clip": "norm",
                          "grad_clip_value": 1.0}}
    if case == "sftgan":
        return {"name": "par_sft", "model": "sftgan", "scale": 4,
                "datasets": {"train": {"name": "t", "mode": "LRHRseg_bg",
                                       "dataroot_HR": "/x", "crop_size": px,
                                       "batch_size": BATCHES[case]}},
                "network_G": {"type": "sft_arch", "nf": 8, "cond_nf": 16,
                              "n_blocks": 1},
                "network_D": {"type": "dis_acd"},
                "path": {"root": "/tmp/par_sft"},
                "train": _sgd(gan_type="vanilla", gan_weight=5e-3)}
    if case in ("dvd", "dvd_gp"):
        gp = case == "dvd_gp"
        return {"name": f"par_{case}", "model": "dvd", "scale": 1,
                "datasets": {"train": {"name": "t", "mode": "dvd",
                                       "dataroot_HR": "/x", "crop_size": px,
                                       "batch_size": BATCH}},
                "network_G": {"type": "dvd_net", "nf": 8},
                "network_D": {"type": "patchgan", "ndf": 8, "n_layers": 2,
                              **({"norm_type": None} if gp else {})},
                "path": {"root": f"/tmp/par_{case}"},
                "train": _sgd(gan_type="wgan-gp" if gp else "lsgan",
                              gan_weight=0.1,
                              **({"gp_weight": 10.0} if gp else {}))}
    raise KeyError(case)


def _model_batch(case: str, r) -> dict:
    n = BATCHES.get(case, BATCH)

    def img(*shape):
        return r.random((n, *shape), np.float32)

    if case == "cyclegan":
        return {k: img(32, 32, 3) * 2 - 1 for k in ("A", "B")}
    if case == "wbc":
        # smooth images: a coarse field up-sampled, with a little grain
        out = {}
        for k in ("A", "B"):
            base = img(4, 4, 3).repeat(8, 1).repeat(8, 2)
            out[k] = np.clip(base + 0.05 * img(32, 32, 3), 0, 1)
        return out
    if case == "pbr":
        out = {}
        for name, nc in (("diffuse", 3), ("normal", 3), ("roughness", 1),
                         ("height", 1)):
            out[f"HR_{name}"] = img(16, 16, nc)
            out[f"LR_{name}"] = img(4, 4, nc)
        out["LR"], out["HR"] = out["LR_diffuse"], out["HR_diffuse"]
        return out
    if case in ("sofvsr", "sr3d", "edvr", "evsrgan"):
        t = 5 if case in ("sr3d", "edvr") else 3
        hr = img(t, 32, 32, 3)
        hr[:, 0] = np.roll(hr[:, 1], 2, axis=2)
        lr = hr.reshape(n, t, 8, 4, 8, 4, 3).mean((3, 5))
        return {"LR": lr.astype(np.float32), "HR": hr}
    if case in ("srflow", "srflow_interop"):
        hr = img(32, 32, 3)
        return {"LR": hr.reshape(n, 8, 4, 8, 4, 3).mean((2, 4)), "HR": hr}
    if case == "sftgan":
        return {"LR": img(24, 24, 3), "HR": img(96, 96, 3),
                "seg": img(96, 96, 8),
                "category": r.integers(0, 8, n).astype(np.int32)}
    if case in ("dvd", "dvd_gp"):
        top, bottom = img(32, 32, 3), img(32, 32, 3)
        x = top.copy()
        x[:, 1::2] = bottom[:, 1::2]
        return {"in": x, "top": top, "bottom": bottom}
    raise KeyError(case)


def batch(case: str, step: int) -> dict:
    """The global batch of a case's step, drawn from a seed with numpy."""
    r = np.random.default_rng(100 + step)
    if case in MODEL_CASES:
        return _model_batch(case, r)
    if case == "pix2pix":
        return {k: (r.random((BATCH, 32, 32, 3), np.float32) * 2 - 1)
                for k in ("A", "B")}
    lr_px, s = (8, 4) if case == "ppon" else (8, 2)
    return {"LR": r.random((BATCH, lr_px, lr_px, 3), np.float32),
            "HR": r.random((BATCH, lr_px * s, lr_px * s, 3), np.float32)}


def sd(net) -> dict:
    return {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}


def grads(net) -> dict:
    return {k: p.grad.detach().cpu().clone()
            for k, p in net.named_parameters() if p.grad is not None}


def _trainer(case: str, mesh=None):
    """The case's trainer on the CPU, eager; G's optimizer with gradient
    centralisation where ``WHOLE_WEIGHT_CASES`` asks for it."""
    trainer = create_trainer(options(case), device="cpu", graphs=False,
                             mesh=mesh)
    if WHOLE_WEIGHT_CASES.get(case, ("", False))[1]:
        build = trainer._optimizer

        def with_gc(net, which):
            opt = build(net, which)
            opt.use_gc = opt.use_gc or which == "G"
            return opt
        trainer._optimizer = with_gc
    return trainer


def run_case(case: str, steps: int, mesh=None, state_path: str = "",
             save_at: int = -1, init: str = "") -> dict:
    """``steps`` steps of a case from ``init_state(0)`` on the CPU, each
    on this rank's slice of the global batch (the whole batch without a
    mesh): the logs of each step, the gradients of the last and the nets'
    state dicts at the end, and the split leaves computed whole
    (``whole``). With ``state_path`` the state is saved there after
    ``save_at`` steps (rank 0 writes); with ``init`` G's and D's state
    dicts are loaded from that file first. A model with image pools also
    gives each query's global batch of fakes and what the Ds were given
    in its place (``pools``: the ranks' rows put together)."""
    trainer = _trainer(case, mesh)
    state = trainer.init_state(0)
    if init:
        saved = torch.load(init, weights_only=False)
        for w in ("g", "d"):
            getattr(state, w).net.load_state_dict(saved[w])
    pools = _spy_pools(trainer, mesh)
    logs = []
    for i in range(steps):
        b = batch(case, i)
        if mesh is not None:
            b = M.shard_batch(b, mesh)
        state, lg = trainer.train_step(
            state, {k: torch.from_numpy(v) for k, v in b.items()})
        logs.append({k: float(v) for k, v in lg.items()})
        if i + 1 == save_at:
            checkpoint.save_state(state, state_path, epoch=1,
                                  write=mesh is None or mesh.rank == 0)
    out = {"logs": logs, **nets(state), "whole": trainer.whole_leaves,
           "split": split_leaves(state)}
    if pools is not None:
        out["pools"] = pools
    return out


def _spy_pools(trainer, mesh):
    """Records each ``Trainer._pooled`` call of a trainer with pools: the
    pool's index in order of first use, the global fakes and the global
    pooled batch (gathered over the mesh); None for a model without."""
    if not hasattr(trainer, "fake_a_pool") and \
            not hasattr(trainer, "fake_s_pool"):
        return None
    from trainner_tpu_torch.parallel.collectives import gather_batch

    calls, ids, real = [], {}, trainer._pooled

    def gather(t):
        if mesh is None:
            return t.clone()
        with mesh.active():
            return gather_batch(t)

    def spy(pool, fakes):
        out = real(pool, fakes)
        calls.append((ids.setdefault(id(pool), len(ids)), gather(fakes),
                      gather(out)))
        return out

    trainer._pooled = spy
    return calls


def run_rife(mesh=None, swap: bool = False) -> dict:
    """RIFE (c 4) in train mode, which normalises with its batch norms'
    batch statistics, on this rank's part of a global batch of 8 frame
    pairs (32 px): one pass under the mesh, the mean of its five outputs
    as the loss, the gradients averaged; the outputs' global batch, the
    gradients and the running statistics the pass committed. In f64: its
    f32 gradients sum thousands of cancelling terms per weight, whose
    rounding differs with the batch a conv algorithm is given. ``swap``
    runs the batch with its halves swapped (the same loss, its batch
    norms' f32 statistics summed in another order)."""
    from trainner_tpu_torch.models.rife import RIFE
    from trainner_tpu_torch.ops.blocks import commit_stats
    from trainner_tpu_torch.parallel.collectives import (average_grads,
                                                         gather_batch)

    net = RIFE(c=4)
    net.init_weights(torch.Generator().manual_seed(0))
    net = net.double()
    x = np.random.default_rng(7).random((BATCH, 32, 32, 6))
    if swap:
        x = np.roll(x, BATCH // 2, axis=0)
    if mesh is not None:
        x = x[M.local_batch_slice(BATCH, mesh)]
    ctx = mesh.active() if mesh is not None else contextlib.nullcontext()
    with ctx:
        outs = net.train()(torch.from_numpy(x))
        loss = sum(o.mean() for o in outs)
        loss.backward()
        average_grads(list(net.parameters()))
        commit_stats(net)
        got = [gather_batch(o.detach()) for o in outs]
    return {"outs": got, "g": sd(net), "g_grad": grads(net)}


def split_leaves(state) -> list:
    """The leaves computed by column on the tensor axis (their weights and
    biases, ``tensor_summed``), as ``field.name``."""
    return sorted(f"{w}.{k}" for w in NET_FIELDS
                  if getattr(state, w, None) is not None
                  for k, p in getattr(state, w).net.named_parameters()
                  if getattr(p, "tensor_summed", False))


def nets(state) -> dict:
    """Each net of the state (``NET_FIELDS``) and its last gradients."""
    out = {}
    for w in NET_FIELDS:
        ns = getattr(state, w, None)
        if ns is not None:
            out[w] = sd(ns.net)
            out[f"{w}_grad"] = grads(ns.net)
    return out


def resume_case(case: str, state_path: str, start: int, steps: int,
                mesh=None) -> dict:
    """A fresh state that loads ``state_path`` and runs the case's steps
    ``start`` .. ``start + steps - 1``; its nets' state dicts."""
    trainer = _trainer(case, mesh)
    state = checkpoint.load_state(state_path, trainer.init_state(0))[0]
    for i in range(start, start + steps):
        b = batch(case, i)
        if mesh is not None:
            b = M.shard_batch(b, mesh)
        state, _ = trainer.train_step(
            state, {k: torch.from_numpy(v) for k, v in b.items()})
    return {**nets(state), "step": state.step}


def main(spec_path: str) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    rank, world = spec["rank"], spec["world"]
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{spec['store']}", rank=rank,
        world_size=world)
    results = {}
    for job in spec["jobs"]:
        if job.get("rife"):
            results[job["id"]] = run_rife(M.make_mesh(
                M.MeshConfig(data=job["data"], fsdp=job["fsdp"])))
            continue
        if job.get("cli"):
            from trainner_tpu_torch.train import main as train_main

            state = train_main(["-opt", job["cli"]], device="cpu")
            results[job["id"]] = {"step": state.step,
                                  "g": sd(state.g.net)}
            continue
        mesh = M.make_mesh(
            M.MeshConfig(data=job["data"], fsdp=job["fsdp"],
                         tensor=job.get("tensor", 1)),
            min_shard_size=job.get("min_shard", M.MIN_SHARD_SIZE))
        if job.get("state_path"):
            path = job["state_path"]
            full = run_case(job["case"], job["steps"], mesh, path,
                            job["save_at"])
            torch.distributed.barrier()
            res = resume_case(job["case"], path, job["save_at"],
                              job["steps"] - job["save_at"], mesh)
            results[job["id"]] = {"full": full, "resumed": res}
        else:
            results[job["id"]] = run_case(job["case"], job["steps"], mesh,
                                          init=job.get("init", ""))
    if rank == 0:
        torch.save(results, spec["out"])
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
