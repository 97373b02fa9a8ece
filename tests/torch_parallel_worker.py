"""The cases of tests/test_torch_parallel.py and one rank that runs them.

Imports torch and the port alone, no JAX, so that a rank starts fast:
``python tests/torch_parallel_worker.py SPEC.json`` joins a gloo group
through the spec's file store, runs each job of the spec (a case on a
``(data, fsdp)`` mesh for some steps, a checkpoint and a resume, or the
training CLI on an options file with ``parallel:``) and rank 0 writes
the results with ``torch.save``. The test runs the same
cases in one process without a group for the one-rank step.
"""

from __future__ import annotations

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

BATCH = 8  # the global batch of every case


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
      G with dropout.
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
    else:
        raise KeyError(case)
    return dict(parse_dict(copy.deepcopy(opt), is_train=True))


def batch(case: str, step: int) -> dict:
    """The global batch of a case's step, drawn from a seed with numpy."""
    r = np.random.default_rng(100 + step)
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


def run_case(case: str, steps: int, mesh=None, state_path: str = "",
             save_at: int = -1) -> dict:
    """``steps`` steps of a case from ``init_state(0)`` on the CPU, each
    on this rank's slice of the global batch (the whole batch without a
    mesh): the logs of each step, the gradients of the last and the nets'
    state dicts at the end. With ``state_path`` the state is saved there
    after ``save_at`` steps (rank 0 writes)."""
    trainer = create_trainer(options(case), device="cpu", graphs=False,
                             mesh=mesh)
    state = trainer.init_state(0)
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
    out = {"logs": logs, "g": sd(state.g.net), "g_grad": grads(state.g.net)}
    if state.d is not None:
        out["d"] = sd(state.d.net)
        out["d_grad"] = grads(state.d.net)
    return out


def resume_case(case: str, state_path: str, start: int, steps: int,
                mesh=None) -> dict:
    """A fresh state that loads ``state_path`` and runs the case's steps
    ``start`` .. ``start + steps - 1``; its nets' state dicts."""
    trainer = create_trainer(options(case), device="cpu", graphs=False,
                             mesh=mesh)
    state = checkpoint.load_state(state_path, trainer.init_state(0))[0]
    for i in range(start, start + steps):
        b = batch(case, i)
        if mesh is not None:
            b = M.shard_batch(b, mesh)
        state, _ = trainer.train_step(
            state, {k: torch.from_numpy(v) for k, v in b.items()})
    return {"g": sd(state.g.net), "d": sd(state.d.net), "step": state.step}


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
        if job.get("cli"):
            from trainner_tpu_torch.train import main as train_main

            state = train_main(["-opt", job["cli"]], device="cpu")
            results[job["id"]] = {"step": state.step,
                                  "g": sd(state.g.net)}
            continue
        mesh = M.make_mesh(
            M.MeshConfig(data=job["data"], fsdp=job["fsdp"]),
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
            results[job["id"]] = run_case(job["case"], job["steps"], mesh)
    if rank == 0:
        torch.save(results, spec["out"])
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
