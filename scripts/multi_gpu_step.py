"""The port's training step on a data (and fsdp) axis of several cards,
against one card: the flagship GAN step (RRDBNet nf 64, nb 23, gc 32;
D-VGG-128; pixel, VGG19 feature and relativistic GAN losses; bf16,
CUDA graphs) with every rank on its slice of a global batch of 32.

    torchrun --nproc_per_node N scripts/multi_gpu_step.py [--fsdp M]

Each rank takes the card of ``LOCAL_RANK``, joins an NCCL group and the
``(data: N / M, fsdp: M)`` mesh of ``trainner_tpu_torch.parallel``, and
runs ``--steps`` steps from ``init_state(0)`` on its slice of seeded
global batches. Checks: after the steps every rank holds the same state
bit for bit (each tensor's f64 sum and sum of squares gathered and
compared with rank 0's): what data parallelism means. Reported: the
step's ms per card (graph replays, host clock around synchronised runs),
and rank 0's step at the whole batch on its card with no group, timed in
the same call. Rank 0
prints one JSON line. ``--cpu --debug`` runs the debug widths over gloo
on the CPU, eagerly, to try it without a card.

    python scripts/multi_gpu_step.py --bands

serves instead, in one process: the flagship G (random weights from
seed 0, f32) on one ``BAND_PX`` x ``BAND_PX`` LR image through
``SRTrainer.eval_step_spatial`` in one band per visible card (N), band i
on card i, against the whole-image ``eval_step`` on card 0. Checks: the
rows beyond halo x scale from the outer edges within 1e-5 of the
output's size, before and after an in-place change of G's weights (each
card's copy of G refreshed); the first call launches 69 block kernels a
band. Reported: ms of the whole image, of the N bands on N cards and of
the same N bands on card 0 alone. ``--cpu --debug`` runs it at the debug
widths on the CPU, the bands on ``cpu:0`` (another device than the
trainer's ``cpu``).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from trainner_tpu_torch.parallel import mesh as M  # noqa: E402
from trainner_tpu_torch.train.sr_trainer import create_trainer  # noqa: E402

BATCH, LR_PX = 32, 32
BAND_PX, BAND_HALO = 512, 32


def options(debug: bool) -> dict:
    nf, nb, gcw, d_size, d_nf = (8, 1, 4, 128, 8) if debug else \
        (64, 23, 32, 128, 64)
    return {"is_train": True, "scale": 4,
            "network_G": {"type": "rrdb_net", "nf": nf, "nb": nb, "gc": gcw,
                          "upscale": 4},
            "network_D": {"type": "discriminator_vgg", "size": d_size,
                          "base_nf": d_nf},
            "train": {"lr_G": 1e-4, "lr_D": 1e-4, "pixel_criterion": "l1",
                      "pixel_weight": 1e-2, "feature_criterion": "l1",
                      "feature_weight": 1.0, "gan_type": "vanilla",
                      "gan_weight": 5e-3, "lr_scheme": "MultiStepLR",
                      "lr_steps": [50000]}}


def batch(step: int, device) -> dict:
    gen = torch.Generator().manual_seed(1000 + step)
    return {"LR": torch.rand(BATCH, LR_PX, LR_PX, 3, generator=gen
                             ).to(device),
            "HR": torch.rand(BATCH, LR_PX * 4, LR_PX * 4, 3, generator=gen
                             ).to(device)}


def state_digest(state) -> torch.Tensor:
    """Each tensor of the nets and the optimizers as (f64 sum, f64 sum of
    squares), in a fixed order."""
    out = []
    for which in ("g", "d"):
        ns = getattr(state, which)
        for t in list(ns.net.state_dict().values()):
            out.append(t.double().sum())
            out.append(t.double().square().sum())
        for key, vals in ns.opt.state_dict().items():
            if isinstance(vals, list):
                for t in vals:
                    out.append(t.double().sum())
                    out.append(t.double().square().sum())
    return torch.stack(out)


def timed(trainer, state, batches, device) -> float:
    """ms per step over the batches, after they have all run once."""
    for b in batches:
        trainer.train_step(state, b)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for b in batches:
        trainer.train_step(state, b)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / len(batches) * 1e3


def _synced_ms(fn, devices, iters: int) -> float:
    """Host ms per call of ``fn`` over ``iters`` calls, every card of
    ``devices`` synchronised before and after."""
    def sync():
        for d in set(devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters * 1e3


def bands(args) -> int:
    """``--bands``: G's bands on several cards against the whole image."""
    from trainner_tpu_torch.ops import rdb5c

    opt = options(args.debug)
    opt = {"is_train": False, "scale": 4, "network_G": opt["network_G"]}
    if args.cpu:
        torch.set_num_threads(1)
        home, n = torch.device("cpu"), 4
        devices = [torch.device("cpu", 0)] * n
        px, halo = 64, 16
    else:
        # held to 1e-5 in f32: the plain convs in f32, not TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        home, n = torch.device("cuda", 0), torch.cuda.device_count()
        devices = [torch.device("cuda", i) for i in range(n)]
        px, halo = BAND_PX, BAND_HALO
    tr = create_trainer(opt, device=home)
    st = tr.init_state(0)
    x = torch.rand(1, px, px, 3, generator=torch.Generator().manual_seed(24)
                   ).to(home)
    per_g = 3 * opt["network_G"]["nb"]
    edge = halo * 4
    out = {"cards": n, "device": torch.cuda.get_device_name(0)
           if home.type == "cuda" else "cpu", "px": px, "halo": halo}
    bad = []
    for turn in ("init", "changed"):
        if turn == "changed":
            with torch.no_grad():
                st.g.net.conv_first.weight.mul_(1.25)
        whole = tr.eval_step(st, x)
        before = rdb5c.launches
        got = tr.eval_step_spatial(st, x, devices, halo=halo)
        launched = rdb5c.launches - before
        alone = tr.eval_step_spatial(st, x, [home] * n, halo=halo)
        size = float(whole.abs().max())
        inner = float((got - whole)[:, edge:-edge].abs().max()) / size
        outer = float((got - whole).abs().max()) / size
        out[turn] = {"interior": inner, "edge_rows": outer,
                     "launches": launched, "max_abs_y": size,
                     "vs_bands_on_card0": float((got - alone).abs().max())
                     / size}
        if inner > 1e-5 or tuple(got.shape) != tuple(whole.shape) or (
                turn == "init" and home.type == "cuda"
                and launched != per_g * n):
            bad.append(turn)
    if home.type == "cuda":
        one = [home] * n
        for _ in range(tr.EVAL_CAPTURE_AT + 1):
            tr.eval_step(st, x)
            tr.eval_step_spatial(st, x, devices, halo=halo)
            tr.eval_step_spatial(st, x, one, halo=halo)
        times = {"whole": [], "bands_on_cards": [], "bands_on_card0": []}
        for _ in range(2):
            times["whole"].append(_synced_ms(
                lambda: tr.eval_step(st, x), devices, args.timed))
            times["bands_on_cards"].append(_synced_ms(
                lambda: tr.eval_step_spatial(st, x, devices, halo=halo),
                devices, args.timed))
            times["bands_on_card0"].append(_synced_ms(
                lambda: tr.eval_step_spatial(st, x, one, halo=halo),
                devices, args.timed))
        out["ms"] = {k: [round(v, 3) for v in vs] for k, vs in times.items()}
    out["twins"] = len(tr._twins)
    out["failed"] = bad
    print(json.dumps(out), flush=True)
    return 1 if bad else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--timed", type=int, default=10)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--bands", action="store_true")
    args = p.parse_args(argv)
    if args.bands:
        return bands(args)
    if args.cpu:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    else:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    rank, world = M.init_distributed(device)
    mesh = M.make_mesh(M.MeshConfig(data=world // args.fsdp,
                                    fsdp=args.fsdp), device=device)
    graphs = device.type == "cuda"
    opt = options(args.debug)
    trainer = create_trainer(opt, device=device, graphs=graphs, mesh=mesh)
    state = trainer.init_state(0)
    globals_ = [batch(i, device) for i in range(args.steps)]
    t0 = time.perf_counter()
    for b in globals_:
        state, logs = trainer.train_step(state, M.shard_batch(b, mesh))
    if graphs:
        torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    digest = state_digest(state)
    every = [torch.zeros_like(digest) for _ in range(world)]
    dist.all_gather(every, digest)
    unequal = [r for r, d in enumerate(every) if not torch.equal(d, every[0])]
    local = [M.shard_batch(batch(100 + i, device), mesh)
             for i in range(args.timed)]
    ms_group = timed(trainer, state, local, device)
    logs = {k: float(v) for k, v in logs.items()}
    out = None
    if rank == 0:
        one = create_trainer(opt, device=device, graphs=graphs)
        ones = one.init_state(0)
        ms_one = timed(one, ones, [batch(100 + i, device)
                                   for i in range(args.timed)], device)
        name = torch.cuda.get_device_name(device) if graphs else "cpu"
        out = {"ranks": world, "mesh": mesh.shape, "backend": mesh.backend,
               "device": name, "batch": BATCH,
               "per_rank": BATCH // world, "steps": args.steps,
               "replicas_unequal": unequal, "tensors": digest.numel() // 2,
               "first_steps_s": round(first_s, 3),
               "ms_per_step_group": round(ms_group, 3),
               "ms_per_step_one_card_whole_batch": round(ms_one, 3),
               "logs": logs}
        print(json.dumps(out), flush=True)
        del one, ones
    # the trainers and their CUDA graphs go before the group: NCCL does
    # not destroy a communicator that a live graph still holds
    del trainer, state
    gc.collect()
    if graphs:
        torch.cuda.synchronize(device)
    dist.barrier()
    dist.destroy_process_group()
    return 1 if unequal else 0


if __name__ == "__main__":
    sys.exit(main())
