"""The training command line of the port: counterpart of the JAX package's
``train.py`` (``parse_options:25``, ``dir_check:35``,
``configure_loggers:46``, ``get_resume_state:61``, ``get_dataloaders:82``,
``create_trainer:95``, ``validate:196``, ``fit:241``, ``main:395``) for
``model: sr`` (and its aliases), ``model: ppon``
(``ppon_trainer.PPONTrainer``; its validation reads the output of
``ppon_phase``), ``sftgan`` / ``sftgan_acd``, ``pix2pix``, ``cyclegan``
and the video models ``vsr``, ``vsrgan``, ``evsrgan`` and ``video``
(``vsr_trainer.VSRTrainer``; the validation scores the first frame of a
clip's HR, as the JAX CLI's does, ROADMAP C 25) and ``srflow``
(``srflow_trainer.SRFlowTrainer``; the validation samples at heat 0, as
``eval_step``'s default), ``dvd`` (``dvd_trainer.DVDTrainer``; a
validation set fails, as the JAX CLI's does, ROADMAP C 27), ``wbc``
(``wbc_trainer.WBCTrainer``; its unaligned validation set is served from
A) and ``pbr`` / ``sr_pbr`` / ``pbr_sr`` (``pbr_trainer.PBRTrainer``; the
validation serves and scores the primary map). Every
``logger.display_freq`` iterations, when the batch has ``A``, the sample
grid A | G(A) | B goes to ``experiments_root/samples/{iter:08d}.png``
(``train.py:353-369``).

The options file drives the whole run: the train loader, the on-device
degradations (``make_otf_degradation``; the bsrgan presets shuffle the
stage order per sample), ``SRTrainer.train_step`` (on the card, the
degradations, the step and ``eval_step`` replay CUDA graphs; a resume
loads the state before the first capture, and a save reads the state
between replays, after a synchronise), a log line and scalars
every ``print_freq`` iterations, checkpoints in the JAX package's format
every ``save_checkpoint_freq`` (``{iter}_G.ckpt``, ``{iter}_D.ckpt``,
``{iter}_swaG.ckpt`` with SWA, its batch norms' statistics recomputed over
the last ``swa_update_bn_batches`` LR batches (4 by default) when G has
batch norms, ``{iter}.state``), PSNR/SSIM and PNGs of the validation set every
``val_freq``, and a ``latest`` checkpoint when the run is interrupted
(Ctrl-C or SIGTERM), after which it exits with code 0. ``path.resume_state``
(a ``.state`` file, or a directory of them) resumes a run, a JAX one too.
Options read here besides: ``matmul_precision`` (``highest`` or unset keeps
TF32 off for cuDNN and matmul, any other value turns it on),
``debug_nans`` and ``profile`` (a ``torch.profiler`` trace in
``log/trace``).

``parallel: {data: D, fsdp: M}`` trains on a mesh of D x M ranks
(``parallel/mesh.py``), as ``train.py:438-469`` reads it: one process per
card under ``torchrun``, NCCL on the card (gloo on the CPU), each rank
reading its slice of every batch of the one-process loader (its
degradations drawn from a generator of its own, ROADMAP C 28), the
gradients averaged inside the step; logging, validation, sample grids
and the checkpoints' files on rank 0 (every rank takes part in a save,
which puts an fsdp-split optimizer together first). Where the JAX CLI
warns and runs on one device, the port raises: when the ranks do not
tile ``data x fsdp``, or the batch does not divide over them (N
processes each running alone would be N copies of one run; ROADMAP
C 28). Without ``torchrun`` a ``parallel:`` run is a group of one rank
in this process. Every model trains there; the one refusal left is
``tensor:`` above 1 (ROADMAP Queue A 9 e).

Usage: python -m trainner_tpu_torch.train -opt options/sr/train_sr.yml
       torchrun --nproc_per_node N -m trainner_tpu_torch.train -opt ...
``main(argv, device="cpu")`` from Python runs on the CPU; without a card
and without ``device`` it raises.
"""

from __future__ import annotations

import argparse
import collections
import json
import logging
import math
import os
import signal
from typing import Optional, Union

import numpy as np
import torch

from ..data import create_dataloader, create_dataset, device_prefetch
from ..data.common import save_img, save_img_comp, tensor2img
from ..ops.blocks import BatchNorm
from ..options import check_resume, dict2str, parse
from ..parallel import mesh as par
from ..utils import checkpoint
from ..utils.debug import check_finite, enable_nan_checks
from ..utils.device import resolve_device
from ..utils.logging_utils import (ScalarWriter, close_logger,
                                   get_root_logger, mkdir_and_rename, mkdirs)
from ..utils.metrics import MetricsDict, Timer
from .producer import make_otf_degradation
from .sr_trainer import create_trainer


def parse_options(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True,
                        help="Path to options YAML/JSON file.")
    args = parser.parse_args(argv)
    return parse(args.opt, is_train=True)


def dir_check(opt) -> None:
    """Makes the experiment's directories; a new run first moves an old
    experiment of the same name aside."""
    paths = opt["path"]
    if not paths.get("resume_state"):
        mkdir_and_rename(paths["experiments_root"])
    mkdirs([paths.get(k) for k in
            ("models", "training_state", "log", "val_images")])


def configure_loggers(opt):
    """The ``base`` logger (screen and ``train_*.log``), the ``val`` logger
    (``val_*.log``) and, unless ``logger.tensorboard`` is false, a
    ``ScalarWriter`` in ``log/tb``. A logger of an earlier run in this
    process is closed first."""
    log_dir = opt["path"]["log"]
    for name in ("base", "val"):
        close_logger(name)
    logger = get_root_logger("base", log_dir, "train")
    get_root_logger("val", log_dir, "val", screen=False)
    logger.info(dict2str(opt))
    tb = None
    if (opt.get("logger") or {}).get("tensorboard", True):
        tb = ScalarWriter(os.path.join(log_dir, "tb"))
        why = f" (no TensorBoard: {tb.tb_error})" if tb.tb_error else ""
        logger.info(f"Scalars to {os.path.join(log_dir, 'tb')}: "
                    f"{' and '.join(tb.backends)}{why}")
    return logger, tb


def get_resume_state(opt):
    """The ``.state`` file to resume from (``resume_state`` names a file,
    or a directory whose newest state is taken), with its ``{epoch,
    iter}``; None for a new run."""
    rs = opt["path"].get("resume_state")
    if not rs:
        return None
    path = rs if os.path.isfile(rs) else checkpoint.latest_state_path(rs)
    if path is None:
        return None
    meta = {"epoch": 0, "iter": 0}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    check_resume(opt, meta.get("iter", 0))
    return {"path": path, "epoch": meta.get("epoch", 0),
            "iter": meta.get("iter", 0)}


def get_dataloaders(opt, pin_memory: bool = False, mesh=None):
    """The loader of each phase; under a mesh the train loader reads this
    rank's slice of each batch, and only rank 0 builds the others."""
    loaders = {}
    for phase_key, dataset_opt in (opt.get("datasets") or {}).items():
        phase = phase_key.split("_")[0]
        part = None
        if mesh is not None:
            if phase != "train" and mesh.rank != 0:
                continue
            if phase == "train":
                part = par.local_batch_slice(
                    int(dataset_opt.get("batch_size", 16) or 16), mesh)
        loaders[phase] = create_dataloader(create_dataset(dataset_opt),
                                           dataset_opt,
                                           pin_memory=pin_memory, part=part)
    if "train" not in loaders:
        raise ValueError("no train dataset in options")
    return loaders


def validate(trainer, state, val_loader, opt, epoch: int, current_step: int,
             logger, tb):
    """PSNR, SSIM (and LPIPS, on the trainer's device) of G's output over
    the validation set, written to the logs and scalars; each output saved
    as ``{val_images}/{name}/{name}_{iter}.png``. G reads ``LR``, or ``A``
    where the batch has no ``LR`` (against ``B``), as the JAX CLI reads
    them."""
    metrics = MetricsDict((opt["train"] or {}).get("metrics") or "psnr,ssim",
                          lpips_weights=opt["path"].get("lpips_weights"),
                          device=trainer.device)
    val_dir = opt["path"].get("val_images")
    save_imgs = bool((opt.get("logger") or {}).get("save_val_imgs", True))
    scale = int(opt.get("scale") or 1)
    for i, batch in enumerate(val_loader):
        if "LR" not in batch and "A" not in batch:
            raise KeyError(
                f"a validation batch of [{opt.get('model')}] holds neither "
                f"LR nor A (its keys: {sorted(batch)}): the JAX CLI's "
                "validate fails there with a KeyError, and the port does "
                "not make up a validation (ROADMAP C 27); leave the "
                "validation set out")
        in_key = "LR" if "LR" in batch else "A"
        gt_key = "HR" if "HR" in batch or in_key == "LR" else "B"
        sr_img = tensor2img(trainer.eval_step(state, batch[in_key])[0])
        gt = batch.get(gt_key)
        name = os.path.splitext(os.path.basename(
            batch.get(f"{in_key}_path", [str(i)])[0]))[0]
        if gt is not None:
            metrics.calculate_metrics(sr_img, tensor2img(gt[0]),
                                      crop_size=scale)
        if save_imgs and val_dir:
            img_dir = os.path.join(val_dir, name)
            os.makedirs(img_dir, exist_ok=True)
            save_img(sr_img,
                     os.path.join(img_dir, f"{name}_{current_step}.png"))
    avgs = metrics.get_averages()
    msg = " ".join(f"{m['name']}: {m['average']:.6g}" for m in avgs)
    logger.info(f"# Validation # epoch {epoch} iter {current_step} | {msg}")
    logging.getLogger("val").info(
        f"epoch {epoch} iter {current_step} | {msg}")
    if tb is not None:
        for m in avgs:
            tb.add_scalar(f"val/{m['name']}", m["average"], current_step)
    return {m["name"]: m["average"] for m in avgs}


def save_sample_grid(trainer, state, batch, path: str) -> None:
    """The image-to-image sample grid A | G(A) | B of the batch's first
    pair, side by side, to ``path``. Each image goes through
    ``tensor2img`` without ``znorm``, as the JAX CLI's grid does, so a
    [-1, 1] image loses its negative half (ROADMAP C 22)."""
    fake = trainer.eval_step(state, batch["A"][:1])[0]
    save_img_comp([tensor2img(batch["A"][0]), tensor2img(fake),
                   tensor2img(batch["B"][0])], path)


def _sigterm(_signum, _frame):
    raise KeyboardInterrupt


def _save(state, opt, epoch: int, current_step: int, swa_extra=None,
          mesh=None, **kw) -> None:
    """``checkpoint.save_checkpoint`` once the card has finished the
    replays that write the state; ``swa_extra()`` gives the SWA weights'
    refreshed batch-norm statistics (or None). Under a mesh every rank
    calls it and rank 0 writes."""
    if next(state.g.net.parameters()).is_cuda:
        torch.cuda.synchronize()
    lead = mesh is None or mesh.rank == 0
    checkpoint.save_checkpoint(
        state, opt, epoch, current_step,
        swa_extra=swa_extra() if swa_extra is not None and lead else None,
        write=lead, **kw)


def fit(trainer, opt, loaders, state, start_epoch: int, current_step: int,
        logger, tb):
    """The training loop from ``current_step`` to ``niter``; returns the
    state. An interrupt (Ctrl-C, or SIGTERM, which a preempted job gets)
    saves a ``latest`` checkpoint and raises ``SystemExit(0)``."""
    try:
        previous = signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:  # not in the main thread
        previous = None
    try:
        return _fit(trainer, opt, loaders, state, start_epoch, current_step,
                    logger, tb)
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)


def _fit(trainer, opt, loaders, state, start_epoch, current_step, logger,
         tb):
    dev = trainer.device
    mesh = trainer.mesh
    lead = mesh is None or mesh.rank == 0
    train_opt = opt["train"] or {}
    logger_opt = opt.get("logger") or {}
    seed = int(train_opt.get("manual_seed") or 0)
    # each rank degrades its own samples from a generator of its own
    # (rank 0's is the one-process run's, ROADMAP C 28)
    deg_seed = seed + 7 + (RANK_SEED_STRIDE * mesh.rank if mesh else 0)
    degrade = make_otf_degradation(
        opt, device=dev,
        generator=torch.Generator(device=dev).manual_seed(deg_seed))
    niter = int(float(train_opt.get("niter") or 5e5))
    print_freq = int(logger_opt.get("print_freq") or 200)
    save_freq = int(logger_opt.get("save_checkpoint_freq") or 5e3)
    val_freq = int(float(train_opt.get("val_freq") or 5e3))
    overwrite_chkp = bool(logger_opt.get("overwrite_chkp"))
    display_freq = int(logger_opt.get("display_freq") or 0)
    debug_nans = bool(opt.get("debug_nans"))
    train_loader = loaders["train"]
    total_epochs = max(1, int(math.ceil(niter / max(len(train_loader), 1))))
    timer = Timer()
    logger.info(
        f"Start training from epoch {start_epoch}, iter {current_step}; "
        f"total epochs {total_epochs}, iters {niter}")

    # the most recent LR batches, over which a save recomputes the batch
    # norms' statistics of the SWA weights (a G with batch norms)
    bn_batches = collections.deque(
        maxlen=int(train_opt.get("swa_update_bn_batches", 4) or 4))
    keep_bn = state.swa is not None and any(
        isinstance(m, BatchNorm) for m in state.g.net.modules())

    def swa_extra():
        if not (keep_bn and bn_batches):
            return None
        return trainer.refresh_swa_bn(state, list(bn_batches))

    def tensors_only(it):
        for b in it:
            yield {k: v for k, v in b.items() if isinstance(v, torch.Tensor)}

    epoch = start_epoch
    try:
        while current_step < niter:
            for batch in device_prefetch(tensors_only(iter(train_loader)),
                                         size=2, device=dev):
                if current_step >= niter:
                    break
                current_step += 1
                timer.tic()
                if degrade is not None:
                    batch = degrade(batch)
                if keep_bn and "LR" in batch:
                    bn_batches.append(batch["LR"].clone())
                state, logs = trainer.train_step(state, batch)
                if debug_nans:
                    check_finite(logs, current_step)
                t_iter = timer.toc()

                if current_step % print_freq == 0 and lead:
                    lr_now = trainer.schedG.get_lr(int(state.step))
                    eta = (niter - current_step) * timer.get_average_time()
                    loss_str = " ".join(
                        f"{k}: {float(v):.4e}" for k, v in
                        sorted(logs.items()))
                    logger.info(
                        f"<epoch:{epoch:3d}, iter:{current_step:8,d}, "
                        f"lr:{lr_now:.3e}, t:{t_iter:.3f}s, "
                        f"eta:{eta / 3600:.2f}h> {loss_str}")
                    if tb is not None:
                        tb.add_scalar("lr", lr_now, current_step)
                        tb.add_scalar("time/iteration", t_iter, current_step)
                        for k, v in logs.items():
                            tb.add_scalar(f"train/{k}", float(v),
                                          current_step)

                if display_freq and current_step % display_freq == 0 \
                        and "A" in batch and lead:
                    save_sample_grid(trainer, state, batch, os.path.join(
                        opt["path"]["experiments_root"], "samples",
                        f"{current_step:08d}.png"))

                if current_step % save_freq == 0:
                    _save(state, opt, epoch, current_step, swa_extra, mesh,
                          latest_only=overwrite_chkp)
                    logger.info("Models and training state saved at iter "
                                f"{current_step}.")

                if "val" in loaders and current_step % val_freq == 0 \
                        and lead:
                    validate(trainer, state, loaders["val"], opt, epoch,
                             current_step, logger, tb)
            epoch += 1
    except KeyboardInterrupt:
        logger.info("Training interrupted. Saving latest models and state.")
        _save(state, opt, epoch, current_step, swa_extra, mesh,
              latest_only=True)
        raise SystemExit(0)

    _save(state, opt, epoch, current_step, swa_extra, mesh)
    logger.info("Training finished. Saved final models and state.")
    return state


def _set_precision(opt, logger) -> None:
    """``matmul_precision``: ``highest`` or unset keeps f32 matmuls and
    convolutions exact (TF32 off for cuDNN and matmul, as the parity tests
    hold them); any other value turns TF32 on. The block kernels do not
    read it."""
    prec = (opt["train"] or {}).get("matmul_precision") \
        or opt.get("matmul_precision")
    tf32 = bool(prec) and str(prec) != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    logger.info(f"matmul_precision = {prec or 'unset'}: TF32 "
                f"{'on' if tf32 else 'off'} for cuDNN and matmul")


def _train_batch_size(opt) -> int:
    for phase_key, ds in (opt.get("datasets") or {}).items():
        if phase_key.split("_")[0] == "train":
            return int(ds.get("batch_size", 16) or 16)
    return 1


def _run_mesh(opt, dev: torch.device):
    """The mesh of ``parallel:`` (``train.py:438-469``): this rank's card
    (``LOCAL_RANK`` under ``torchrun``), the process group (started here
    unless one runs: then the caller owns it), the ``data x fsdp`` layout
    with ``data: -1`` taking the ranks that remain. Raises where the axes
    do not tile the ranks or the batch does not divide over them.
    Returns (mesh, device, whether this call started the group)."""
    import torch.distributed as dist

    cfg = opt.get("parallel") or {}
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    owned = not dist.is_initialized()
    _, world = par.init_distributed(dev)
    try:
        mesh = par.make_mesh(par.MeshConfig(
            data=int(cfg.get("data", -1) or -1),
            fsdp=max(1, int(cfg.get("fsdp", 1) or 1)),
            tensor=max(1, int(cfg.get("tensor", 1) or 1))), device=dev)
        bs = _train_batch_size(opt)
        if bs % world:
            raise ValueError(
                f"batch_size {bs} does not divide over the {world} ranks of "
                f"the mesh {mesh.shape}: the JAX CLI would run on one "
                "device, the port raises (ROADMAP C 28)")
    except BaseException:
        if owned:
            dist.destroy_process_group()
        raise
    return mesh, dev, owned


# the degraders' generators of the ranks lie this far apart in seed
RANK_SEED_STRIDE = 1009


def main(argv=None, device: Union[str, torch.device, None] = None):
    """Runs the CLI and returns the final training state. ``device``
    defaults to ``cuda`` (``cuda:0``, or under ``parallel:`` the card of
    ``LOCAL_RANK``)."""
    opt = parse_options(argv)
    dev = resolve_device(device)
    mesh, owned = None, False
    if opt.get("parallel"):
        mesh, dev, owned = _run_mesh(opt, dev)
    elif dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    lead = mesh is None or mesh.rank == 0
    try:
        return _main(opt, dev, mesh, lead)
    finally:
        if owned:
            import gc

            import torch.distributed as dist

            # the trainer and its CUDA graphs (a reference cycle) go
            # first: NCCL does not destroy a communicator that a live
            # graph still holds, and would wait
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dist.destroy_process_group()


def _main(opt, dev, mesh, lead: bool):
    resume = get_resume_state(opt)
    if lead:
        dir_check(opt)
    if mesh is not None and mesh.distributed:
        import torch.distributed as dist

        dist.barrier()
    if lead:
        logger, tb = configure_loggers(opt)
    else:
        logger, tb = logging.getLogger(f"base.rank{mesh.rank}"), None
        logger.propagate = False
        logger.addHandler(logging.NullHandler())
    if mesh is not None:
        logger.info(f"Device mesh: {mesh.shape} over {mesh.world} ranks "
                    f"({mesh.backend or 'one process'}), fsdp "
                    f"{mesh.fsdp}")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    debug_nans = bool(opt.get("debug_nans"))
    prof: Optional[torch.profiler.profile] = None
    try:
        seed = int((opt["train"] or {}).get("manual_seed") or 0)
        np.random.seed(seed)
        _set_precision(opt, logger)
        if debug_nans:
            enable_nan_checks(True)
            logger.info("autograd anomaly detection on; a non-finite "
                        "training log raises")
        loaders = get_dataloaders(opt, pin_memory=dev.type == "cuda",
                                  mesh=mesh)
        trainer = create_trainer(opt, device=dev, mesh=mesh)
        logger.info(f"Training on {trainer.device} in {trainer.dtype}")
        g_path = None if resume else opt["path"].get("pretrain_model_G")
        state = trainer.init_state(seed, g_path)
        start_epoch, current_step = 0, 0
        if resume:
            state, meta = checkpoint.load_state(resume["path"], state)
            start_epoch = int(meta.get("epoch", 0))
            current_step = int(meta.get("iter", state.step))
            logger.info(f"Resuming training from epoch {start_epoch}, "
                        f"iter {current_step}.")
        elif g_path:
            logger.info(f"Loaded pretrained G from {g_path}")
        if opt.get("profile") and lead:
            trace_dir = os.path.join(opt["path"]["log"], "trace")
            os.makedirs(trace_dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            logger.info(f"torch.profiler trace -> {trace_dir}")
        return fit(trainer, opt, loaders, state, start_epoch, current_step,
                   logger, tb)
    finally:
        if prof is not None:
            prof.stop()
            prof.export_chrome_trace(os.path.join(
                opt["path"]["log"], "trace", "trace.json"))
        if debug_nans:
            enable_nan_checks(False)
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = flags
        if tb is not None:
            tb.close()
