"""The port's training step on the data, fsdp and tensor axes of several
cards, against one card: the flagship GAN step (RRDBNet nf 64, nb 23, gc
32; D-VGG-128; pixel, VGG19 feature and relativistic GAN losses; bf16,
CUDA graphs) with every slice of the batch on its part of a global batch
of 32.

    torchrun --nproc_per_node N scripts/multi_gpu_step.py [--fsdp M]
        [--tensor T] [--model sr|cyclegan|wbc|pbr|vsr|srflow]

Each rank takes the card of ``LOCAL_RANK``, joins an NCCL group and the
``(data: N / (M T), fsdp: M, tensor: T)`` mesh of
``trainner_tpu_torch.parallel``, and runs ``--steps`` steps from
``init_state(0)`` on its slice of seeded global batches (the T tensor
ranks of a slice on the same samples, each computing its columns of the
leaves the rule splits: on the flagship, conv5 of the 69 blocks by the
column-range kernels, and D-VGG's ten large leaves). Checks: after the
steps every rank holds the same state bit for bit (each tensor's f64
sum and sum of squares gathered and compared with rank 0's): what data
parallelism means. Reported: the
step's ms per card (graph replays, host clock around synchronised runs),
and rank 0's step at the whole batch on its card with no group, timed in
the same call. Rank 0
prints one JSON line. ``--cpu --debug`` runs the debug widths over gloo
on the CPU, eagerly, to try it without a card. ``--model`` takes another
model's template at its full width in place of the flagship (its
options file, ``MODEL_TEMPLATES``; the global batch ``MODEL_BATCH``):
CycleGAN (both Gs and Ds, the pools, whose stored images join the
check), WBC, PBR (four maps), the video model (SOF-VSR) or SRFlow (f32,
the encoder unfrozen half way through the steps).

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
OPTIONS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "options")
# --model: each model's template and its global batch (divisible by 4)
MODEL_TEMPLATES = {"cyclegan": "i2i/train_cyclegan.yml",
                   "wbc": "i2i/train_wbc.yml", "pbr": "sr/train_sr.yml",
                   "vsr": "video/train_video.yml",
                   "srflow": "srflow/train_srflow.yml"}
MODEL_BATCH = {"cyclegan": 4, "wbc": 16, "pbr": 8, "vsr": 8, "srflow": 16}
# and at --debug the narrow widths that try it on the CPU
DEBUG_G = {"cyclegan": {"ngf": 8, "n_blocks": 1},
           "wbc": {"nf": 8},
           "pbr": {"nf": 8, "nb": 1, "gc": 4},
           "vsr": {"channels": 8, "sr_nf": 8, "sr_nb": 1},
           "srflow": {"nf": 8, "nb": 2, "gc": 4, "K": 2,
                      "flow": {"L": 3, "hidden_channels": 8}}}
PBR_MAPS = (("diffuse", 3), ("normal", 3), ("roughness", 1), ("height", 1))


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


def model_options(model: str, debug: bool, steps: int) -> dict:
    """``--model``'s template (``MODEL_TEMPLATES``) as written, parsed by
    the port, its global batch ``MODEL_BATCH``; PBR is ``train_sr.yml``
    made a PBR run (``model: pbr``, no D, b 8, crop 128); SRFlow's
    encoder unfreezes after half of ``steps``; ``debug`` narrows G (and
    the Ds) to ``DEBUG_G``."""
    from trainner_tpu_torch.options.config import parse_dict, read_yaml

    opt = read_yaml(os.path.join(OPTIONS, MODEL_TEMPLATES[model]))
    opt["datasets"] = {"train": opt["datasets"]["train"]}
    opt["datasets"]["train"]["batch_size"] = MODEL_BATCH[model]
    if model == "pbr":
        opt["model"] = "pbr"
        opt.pop("network_D", None)
        opt["datasets"]["train"].update(mode="pbr", crop_size=128)
    if model == "srflow":
        opt["train"].update(niter=steps, train_RRDB_delay=0.5)
    opt["path"] = {"root": "/nonexistent"}
    if debug:
        opt["network_G"].update(DEBUG_G[model])
        if "network_D" in opt:
            opt["network_D"].update(ndf=8)
        opt["datasets"]["train"]["crop_size"] = 32
    return dict(parse_dict(opt, is_train=True))


def model_batch(model: str, step: int, device, debug: bool) -> dict:
    """A global batch of ``--model`` from a seed: the images at the
    template's crop (32 px at ``debug``), 4x LRs for the sr models."""
    gen = torch.Generator().manual_seed(1000 + step)
    b = MODEL_BATCH[model]
    px = 32 if debug else {"cyclegan": 256, "wbc": 256, "pbr": 128,
                           "vsr": 128, "srflow": 160}[model]

    def rand(*shape):
        return torch.rand(b, *shape, generator=gen)

    if model == "cyclegan":
        out = {k: rand(px, px, 3) * 2 - 1 for k in "AB"}
    elif model == "wbc":
        out = {k: rand(px, px, 3) for k in "AB"}
    elif model == "pbr":
        out = {}
        for name, nc in PBR_MAPS:
            out[f"HR_{name}"] = rand(px, px, nc)
            out[f"LR_{name}"] = out[f"HR_{name}"].reshape(
                b, px // 4, 4, px // 4, 4, nc).mean((2, 4))
        out["LR"], out["HR"] = out["LR_diffuse"], out["HR_diffuse"]
    elif model == "vsr":
        hr = rand(3, px, px, 3)
        out = {"HR": hr, "LR": hr.reshape(b, 3, px // 4, 4, px // 4, 4,
                                          3).mean((3, 5))}
    else:
        hr = rand(px, px, 3)
        out = {"HR": hr, "LR": hr.reshape(b, px // 4, 4, px // 4, 4,
                                          3).mean((2, 4))}
    return {k: v.to(device) for k, v in out.items()}


def batch(step: int, device) -> dict:
    gen = torch.Generator().manual_seed(1000 + step)
    return {"LR": torch.rand(BATCH, LR_PX, LR_PX, 3, generator=gen
                             ).to(device),
            "HR": torch.rand(BATCH, LR_PX * 4, LR_PX * 4, 3, generator=gen
                             ).to(device)}


def state_digest(state, trainer=None) -> torch.Tensor:
    """Each tensor of the nets and the optimizers (of every net a state
    holds: G, D, CycleGAN's and WBC's Ds) and of the trainer's image
    pools as (f64 sum, f64 sum of squares), in a fixed order."""
    out = []

    def add(t):
        out.append(t.double().sum())
        out.append(t.double().square().sum())

    for which in M.net_fields(state):
        ns = getattr(state, which, None)
        if ns is None:
            continue
        for t in list(ns.net.state_dict().values()):
            add(t)
        for key, vals in ns.opt.state_dict().items():
            if isinstance(vals, list):
                for t in vals:
                    add(t)
    for name in ("fake_a_pool", "fake_b_pool", "fake_s_pool",
                 "fake_t_pool"):
        pool = getattr(trainer, name, None)
        if pool is not None and pool.images is not None:
            add(pool.images[:pool.count])
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
    p.add_argument("--tensor", type=int, default=1)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--timed", type=int, default=10)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--bands", action="store_true")
    p.add_argument("--model", default="sr",
                   choices=["sr"] + sorted(MODEL_TEMPLATES))
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
    mesh = M.make_mesh(M.MeshConfig(
        data=world // (args.fsdp * args.tensor), fsdp=args.fsdp,
        tensor=args.tensor), device=device)
    graphs = device.type == "cuda"
    if args.model == "sr":
        opt, n_batch = options(args.debug), BATCH

        def make(i):
            return batch(i, device)
    else:
        opt = model_options(args.model, args.debug, args.steps)
        n_batch = MODEL_BATCH[args.model]

        def make(i):
            return model_batch(args.model, i, device, args.debug)
    if args.cpu and args.model != "sr":
        opt["use_amp"] = False
    trainer = create_trainer(opt, device=device, graphs=graphs, mesh=mesh)
    state = trainer.init_state(0)
    globals_ = [make(i) for i in range(args.steps)]
    t0 = time.perf_counter()
    for b in globals_:
        state, logs = trainer.train_step(state, M.shard_batch(b, mesh))
    if graphs:
        torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    digest = state_digest(state, trainer)
    every = [torch.zeros_like(digest) for _ in range(world)]
    dist.all_gather(every, digest)
    unequal = [r for r, d in enumerate(every) if not torch.equal(d, every[0])]
    local = [M.shard_batch(make(100 + i), mesh) for i in range(args.timed)]
    ms_group = timed(trainer, state, local, device)
    logs = {k: float(v) for k, v in logs.items()}
    out = None
    if rank == 0:
        one = create_trainer(opt, device=device, graphs=graphs)
        ones = one.init_state(0)
        ms_one = timed(one, ones, [make(100 + i)
                                   for i in range(args.timed)], device)
        name = torch.cuda.get_device_name(device) if graphs else "cpu"
        out = {"model": args.model, "ranks": world, "mesh": mesh.shape,
               "backend": mesh.backend,
               "device": name, "batch": n_batch,
               "per_rank": n_batch // mesh.batch_world,
               "steps": args.steps,
               "split_leaves": sum(
                   1 for w in M.net_fields(state)
                   if getattr(state, w, None) is not None
                   for p in getattr(state, w).net.parameters()
                   if getattr(p, "tensor_summed", False)),
               "whole_leaves": trainer.whole_leaves,
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
