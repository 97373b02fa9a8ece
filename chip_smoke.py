#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``trainner_tpu_torch``) on one
NVIDIA card.

Phases, each printing lines of its own; any failure ends the run with a
non-zero exit code and no result line:

1. device: the card's name and power limit, the build of every CUDA
   kernel of the main paths from the sources in ``trainner_tpu_torch/csrc``
   (registers, spills, shared memory) and, from the build's SASS, the
   instruction that multiplies in each bf16 block kernel (``HMMA`` for
   ``mma.sync``, ``HGMMA`` for ``wgmma``);
2. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, TF32 off, f32 and bf16: the block's forward at the serving shape,
   the training shape and two ragged ones (the second at b=1), its backward
   at the training shape and the ragged ones, bit-equal from run to run;
   both again with every output and scratch buffer filled with NaN before
   the launch, and in bf16 at two other widths (nf 32 and nf 128 with gc
   32); the per-sample blur at the producer's two shapes
   (the HR and the LR canvas, k 21) and at a ragged one with asymmetric
   kernels, and an identity kernel bit for bit;
3. serving slice: ``python -m trainner_tpu_torch.test`` at the full width
   of the ESRGAN generator (nf 64, nb 23, gc 32, 4x) on a synthetic test
   set, in f32 and with ``use_amp``, counting kernel launches; then the
   full G on the kernel against the same G on the plain version;
4. training slice: ``create_trainer`` -> ``init_state`` -> ``train_step`` on
   the flagship GAN configuration at full width (that G, D-VGG-128, VGG19
   conv5_4, Adam; batch 32, 32 -> 128 px, latent noise on) in bf16 and in
   f32, counting forward and backward launches, with the step's time; two
   steps at ``D_update_ratio: 2``; then one f32 G-stage gradient of the
   full G on the kernels against the same on both plain versions;
5. producer slice: a corpus of PNGs written from a seed, then the
   end-to-end training path at full width: train dataset (uint8 fast path,
   tile cache) -> loader (pinned) -> ``device_prefetch`` ->
   ``make_otf_degradation`` (the fixed-order bsrgan pipeline on the card,
   two blur launches per batch) -> ``train_step`` in bf16; its it/s beside
   the compute-only it/s of the same call, the degrader's and the loader's
   time per batch, and a traced end-to-end step;
6. times: CUDA-event times of each kernel, its plain version, its bound
   and a library call as a yardstick (the cuDNN five-conv chain; reflect
   padding and a grouped cuDNN convolution for the blur), the device-alone
   time of the bf16 block kernels from the profiler, and the G forward at
   b=8, 128->512 px;
7. trace: one f32 G forward at b=8 and one bf16 train step under
   ``torch.profiler``: device time by kernel and the device's idle share.

The second-to-last lines are a JSON summary of the kernels and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py
       python3 chip_smoke.py --kernels-only   (phases 1, 2 and the block
           kernels' part of 6: a short run while a kernel is worked on; it
           prints no result line)
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

MAIN_SHAPE = (8, 128, 128)   # b, h, w of the LR trunk at b=8, 128->512 px
TRAIN_SHAPE = (32, 32, 32)   # the trunk of a training step: b=32, 32->128 px
RAGGED_SHAPE = (3, 37, 53)
RAGGED_B1_SHAPE = (1, 21, 45)  # one image, no multiple of the 16x16 tile
BLUR_HR = (32, 128, 128, 3)  # the HR canvas of the producer's first blur
BLUR_LR = (32, 32, 32, 3)    # the LR canvas of its second blur
BLUR_K = 21
N_CORPUS, CORPUS_PX = 64, 256
NF, GC, NB = 64, 32, 23
N_IMAGES = 3
BWD_NAMES = ("dx", "dW0", "dW1", "dW2", "dW3", "dW4",
             "db1", "db2", "db3", "db4", "db5")


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _block_weights(gen, nf=NF, gc=GC):
    """Five OIHW conv weights and f32 biases of one block, std
    0.5/sqrt(fan_in), drawn from ``gen`` on the CPU."""
    import torch

    ws, bs = [], []
    for k in range(5):
        cin, cout = nf + k * gc, gc if k < 4 else nf
        ws.append(torch.randn(cout, cin, 3, 3, generator=gen)
                  * (0.5 / math.sqrt(9 * cin)))
        bs.append(torch.randn(cout, generator=gen) * 0.05)
    return ws, bs


def _bf16_ulp(t) -> float:
    return 2.0 ** (math.floor(math.log2(float(t.abs().max()))) - 7)


def _tolerance(dtype, ref) -> float:
    """f32: sums in another order over K <= 576 terms, 1e-4 on values of
    size ~5. bf16: both round c1..c4 and out once from f32 sums, but a
    rounding that differs in c_k feeds the later stages: two bf16 ulps at
    the output's largest magnitude."""
    import torch

    return 1e-4 if dtype == torch.float32 else 2 * _bf16_ulp(ref)


def _backward_tolerance(dtype, name, ref) -> float:
    """f32: dx sums up to 1,728 products (2e-6 of its largest magnitude);
    dW and db sum over every pixel in another order than cuDNN's weight
    gradient (1e-4 of theirs). bf16: a da_k that rounds the other way feeds
    the later stages: two bf16 ulps at dx's largest magnitude; dW and db
    are f32 sums over thousands of pixels of which a few differ by such a
    rounding: 2^-11 of their largest magnitude."""
    import torch

    top = float(ref.abs().max())
    if dtype == torch.float32:
        return (2e-6 if name == "dx" else 1e-4) * top
    return 2 * _bf16_ulp(ref) if name == "dx" else top * 2.0 ** -11


def _compare_block(shape, dt, x, g_out, ws, bs, label: str):
    """One block forward and, with ``g_out``, backward on the kernels
    against the plain versions; raises past the tolerances. Returns the
    two largest errors (forward, backward or None). The widths are the
    weights' own."""
    import torch

    nf, gc = ws[0].shape[1], ws[0].shape[0]

    from trainner_tpu_torch.ops.rdb5c import (pack_rdb_weights,
                                              rdb5c_backward,
                                              rdb5c_backward_plain,
                                              rdb5c_forward,
                                              rdb5c_forward_plain)

    packed = pack_rdb_weights([w.cuda() for w in ws], nf, gc, dt)
    xd = x.to(dt).contiguous()
    got = rdb5c_forward(xd, packed, bs, return_residuals=True)
    torch.cuda.synchronize()
    ref = rdb5c_forward_plain(xd, packed, bs, return_residuals=True)
    errs = []
    for name, g, r in zip(("out", "c1", "c2", "c3", "c4"), got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{name}: {g.shape} {g.dtype} vs "
                                 f"{r.shape} {r.dtype}")
        err = float((g.float() - r.float()).abs().max())
        tol = _tolerance(dt, r.float())
        print(f"kernels: {label}rdb5c {shape} {dt} {name} max_abs_err "
              f"{err:.3e} tol {tol:.3e} max|ref| "
              f"{float(r.float().abs().max()):.3f}")
        if not err <= tol:
            raise AssertionError(
                f"{label}rdb5c {shape} {dt} {name}: {err} > {tol}")
        errs.append(err)
    if g_out is None:
        return max(errs), None
    gd = g_out.to(dt).contiguous()
    got_b = rdb5c_backward(gd, xd, *got[1:], packed)
    torch.cuda.synchronize()
    ref_b = rdb5c_backward_plain(gd, xd, *got[1:], packed)
    errs_b = []
    for name, a, r in zip(BWD_NAMES, got_b, ref_b):
        if a.shape != r.shape or a.dtype != r.dtype:
            raise AssertionError(f"{name}: {a.shape} {a.dtype} vs "
                                 f"{r.shape} {r.dtype}")
        err = float((a.float() - r.float()).abs().max())
        tol = _backward_tolerance(dt, name, r.float())
        print(f"kernels: {label}rdb5c_bwd {shape} {dt} {name} max_abs_err "
              f"{err:.3e} tol {tol:.3e} max|ref| "
              f"{float(r.float().abs().max()):.3f}")
        if not err <= tol:
            raise AssertionError(
                f"{label}rdb5c_bwd {shape} {dt} {name}: {err} > {tol}")
        errs_b.append(err)
    again = rdb5c_backward(gd, xd, *got[1:], packed)
    if not all(torch.equal(a, b) for a, b in zip(got_b, again)):
        raise AssertionError("rdb5c_bwd differs from run to run")
    return max(errs), max(errs_b)


@contextlib.contextmanager
def _poisoned_buffers():
    """Every output and scratch buffer the block wrappers allocate comes
    filled with NaN, so a stale partial sum or a halo that was never
    written shows in the result."""
    import torch

    from trainner_tpu_torch.ops import rdb5c

    plain_alloc = rdb5c._alloc

    def poisoned(shape, dtype, device):
        return torch.full(shape if isinstance(shape, (tuple, torch.Size))
                          else (shape,), float("nan"), dtype=dtype,
                          device=device)

    rdb5c._alloc = poisoned
    try:
        yield
    finally:
        rdb5c._alloc = plain_alloc


def phase_kernels(smi: str):
    """Kernel against plain version on the card. Returns the max abs errors
    at the main paths' shapes: the forward's at the serving shape in f32,
    the backward's at the training shape in bf16 (each path's default
    type)."""
    import torch

    gen = torch.Generator().manual_seed(0)
    ws, bs = _block_weights(gen)
    bs = [b.cuda() for b in bs]
    main_err = bwd_err = None
    inputs = {}
    for shape in (MAIN_SHAPE, TRAIN_SHAPE, RAGGED_SHAPE, RAGGED_B1_SHAPE):
        x = (torch.randn(*shape, NF, generator=gen) * 0.5).cuda()
        g_out = torch.randn(*shape, NF, generator=gen).cuda()
        inputs[shape] = x, g_out
        for dt in (torch.float32, torch.bfloat16):
            fwd, bwd = _compare_block(
                shape, dt, x, None if shape == MAIN_SHAPE else g_out, ws, bs,
                "")
            if shape == MAIN_SHAPE and dt == torch.float32:
                main_err = fwd
            if shape == TRAIN_SHAPE and dt == torch.bfloat16:
                bwd_err = bwd
    # the same with NaN in every buffer the wrappers allocate
    with _poisoned_buffers():
        for shape in (TRAIN_SHAPE, RAGGED_B1_SHAPE):
            for dt in (torch.float32, torch.bfloat16):
                _compare_block(shape, dt, *inputs[shape], ws, bs,
                               "NaN-filled buffers: ")
    # other widths the bf16 kernels take: chunks, slices and dW slots are
    # counted from nf and gc at run time
    for nf, gc in ((32, 32), (128, 32)):
        ws2, bs2 = _block_weights(gen, nf, gc)
        x = (torch.randn(*RAGGED_B1_SHAPE, nf, generator=gen) * 0.5).cuda()
        g_out = torch.randn(*RAGGED_B1_SHAPE, nf, generator=gen).cuda()
        _compare_block(RAGGED_B1_SHAPE, torch.bfloat16, x, g_out, ws2,
                       [b.cuda() for b in bs2], f"nf {nf} gc {gc}: ")
    print(f"kernels: ok ({smi})")
    return main_err, bwd_err


def _blur_kernels(gen, b: int, k: int):
    """Asymmetric random kernels (b, k, k), each summing to 1."""
    import torch

    kern = torch.rand(b, k, k, generator=gen) ** 3
    return (kern / kern.sum(dim=(1, 2), keepdim=True)).cuda()


def phase_blur_kernel(smi: str) -> float:
    """The per-sample blur against its plain version on the card. f32:
    1e-5 absolute on inputs in [0, 1] (up to 441 products, the plain
    version multiplies and adds in two roundings where the kernel fuses
    them); bf16: one bf16 ulp of the output (both sum in f32 and round
    once). Returns the f32 error at the HR canvas."""
    import torch

    from trainner_tpu_torch.ops.blur import (blur_per_sample,
                                             blur_per_sample_plain)

    gen = torch.Generator().manual_seed(5)
    main_err = None
    for shape, k in ((BLUR_HR, BLUR_K), (BLUR_LR, BLUR_K),
                     ((5, 37, 53, 3), 7), ((5, 37, 53, 3), 21),
                     ((5, 37, 53, 1), 21)):
        x = torch.rand(*shape, generator=gen).cuda()
        kern = _blur_kernels(gen, shape[0], k)
        ident = torch.zeros(shape[0], k, k, device="cuda")
        ident[:, k // 2, k // 2] = 1.0
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            got = blur_per_sample(xd, kern)
            torch.cuda.synchronize()
            ref = blur_per_sample_plain(xd, kern)
            if got.shape != ref.shape or got.dtype != dt:
                raise AssertionError(f"blur {shape}: {got.shape} {got.dtype}")
            err = float((got.float() - ref.float()).abs().max())
            tol = 1e-5 if dt == torch.float32 else _bf16_ulp(ref.float())
            print(f"kernels: blur_per_sample {shape} k={k} {dt} max_abs_err "
                  f"{err:.3e} tol {tol:.3e}")
            if not err <= tol:
                raise AssertionError(f"blur {shape} k={k} {dt}: {err} > {tol}")
            if not torch.equal(blur_per_sample(xd, ident), xd):
                raise AssertionError(f"blur {shape} k={k} {dt}: the identity "
                                     "kernel changed the input")
            if shape == BLUR_HR and dt == torch.float32:
                main_err = err
    print(f"kernels: blur ok ({smi})")
    return main_err


@contextlib.contextmanager
def _plain_blocks():
    """Runs every residual dense block of G through the plain versions of
    both kernels, for the comparison with the kernels on the card."""
    from trainner_tpu_torch.ops import rdb5c

    kernels = rdb5c.rdb5c_forward, rdb5c.rdb5c_backward
    rdb5c.rdb5c_forward = rdb5c.rdb5c_forward_plain
    rdb5c.rdb5c_backward = rdb5c.rdb5c_backward_plain
    try:
        yield
    finally:
        rdb5c.rdb5c_forward, rdb5c.rdb5c_backward = kernels


def _options(root: str, **extra) -> str:
    opt = {"name": extra.pop("name"), "model": "sr", "scale": 4,
           "datasets": {"test_1": {"name": "synth", "mode": "synthetic",
                                   "crop_size": 512,
                                   "n_samples": N_IMAGES}},
           "network_G": {"type": "rrdb_net", "nf": NF, "nb": NB, "nr": 3,
                         "gc": GC, "upsample_mode": "upconv",
                         "gaussian_noise": True},
           "path": {"root": root}, "metrics": "psnr,ssim", **extra}
    path = os.path.join(root, opt["name"] + ".json")
    with open(path, "w") as f:
        json.dump(opt, f)
    return path


def _gain_weights(net, seed: int) -> None:
    """Kaiming weights at gain 0.7 (the init's 0.1 leaves G's output near
    1e-4, which would hide the trunk from the comparison)."""
    import torch

    from trainner_tpu_torch.ops.blocks import _Conv, kaiming_init_

    gen = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, _Conv):
            with torch.no_grad():  # drawn on the CPU, wherever net lies
                m.weight.copy_(kaiming_init_(torch.empty(m.weight.shape),
                                             0.7, gen))
                m.bias.copy_(torch.empty(m.bias.shape).normal_(
                    0.0, 0.01, generator=gen))


def phase_slice(smi: str, root: str):
    """The main path: the test CLI in f32 and bf16. Returns the kernel
    launches counted over both runs."""
    import torch

    from trainner_tpu_torch import test as test_cli
    from trainner_tpu_torch.ops import rdb5c

    per_forward = NB * 3
    paths = [_options(root, name="smoke_f32"),
             _options(root, name="smoke_bf16", use_amp=True)]
    rdb5c.launches = 0
    runs = []
    for path in paths:
        t0 = time.time()
        averages = test_cli.main(["-opt", path])
        torch.cuda.synchronize()
        runs.append((path, rdb5c.launches, time.time() - t0, averages))
    launches = rdb5c.launches
    before = 0
    for path, count, secs, averages in runs:
        vals = {m["name"]: m["average"] for m in averages["synth"]}
        print(f"slice: {os.path.basename(path)} {N_IMAGES} images in "
              f"{secs:.2f} s, launches {count - before}, metrics {vals}")
        if count - before != per_forward * N_IMAGES:
            raise AssertionError(
                f"{count - before} kernel launches, expected "
                f"{per_forward} per G forward x {N_IMAGES}")
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"metrics not finite: {vals}")
        pngs = os.listdir(os.path.join(root, "results",
                                       os.path.basename(path)[:-5], "synth"))
        if len([p for p in pngs if p.endswith(".png")]) != N_IMAGES:
            raise AssertionError(f"PNGs written: {pngs}")
        before = count
    return launches


def phase_g_compare(smi: str, root: str) -> None:
    """One image's full-G output on the kernel against the same G on the
    plain version, on the card, TF32 off."""
    import torch

    from trainner_tpu_torch.data import create_dataset
    from trainner_tpu_torch.models import define_G
    from trainner_tpu_torch.options import parse

    opt = parse(_options(root, name="smoke_compare"), is_train=False)
    lr = torch.from_numpy(create_dataset(opt["datasets"]["test_1"])[0]["LR"]
                          )[None].cuda()
    # f32 through 69 chained blocks, sums in another order: 1e-5 of the
    # output's size. bf16: a rounding that differs in one block carries
    # through the later ones: 3e-2 of the output's size.
    for dt, rel_tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        net = define_G(opt, dtype=dt)
        _gain_weights(net, seed=1)
        net = net.cuda().eval()
        with torch.inference_mode():
            got = net(lr)
            with _plain_blocks():
                ref = net(lr)
        torch.cuda.synchronize()
        want_shape = (1, lr.shape[1] * 4, lr.shape[2] * 4, 3)
        if got.shape != want_shape or not bool(got.isfinite().all()):
            raise AssertionError(f"G output {got.shape}, finite "
                                 f"{bool(got.isfinite().all())}")
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        print(f"slice: full G {dt} kernel vs plain max_abs_err {err:.3e} "
              f"on max|ref| {scale:.3e}, tol {rel_tol * scale:.3e}")
        if not err <= rel_tol * scale:
            raise AssertionError(f"full G {dt}: {err} > {rel_tol * scale}")


def _train_options(**train) -> dict:
    """The flagship GAN configuration at full width: ESRGAN G, D-VGG-128,
    pixel L1 x 1e-2 + VGG19 conv5_4 L1 x 1 + relativistic vanilla GAN x
    5e-3, Adam at 1e-4, MultiStepLR."""
    return {
        "is_train": True, "scale": 4,
        "network_G": {"type": "rrdb_net", "nf": NF, "nb": NB, "gc": GC,
                      "upscale": 4},
        "network_D": {"type": "discriminator_vgg", "size": 128,
                      "base_nf": 64},
        "train": {
            "lr_G": 1e-4, "lr_D": 1e-4,
            "pixel_criterion": "l1", "pixel_weight": 1e-2,
            "feature_criterion": "l1", "feature_weight": 1.0,
            "gan_type": "vanilla", "gan_weight": 5e-3,
            "lr_scheme": "MultiStepLR", "lr_steps": [50000], **train},
    }


def _train_batch(batch: int = TRAIN_SHAPE[0], seed: int = 0) -> dict:
    import torch

    gen = torch.Generator().manual_seed(seed)
    lr_px = TRAIN_SHAPE[1]
    return {"LR": torch.rand(batch, lr_px, lr_px, 3, generator=gen).cuda(),
            "HR": torch.rand(batch, lr_px * 4, lr_px * 4, 3,
                             generator=gen).cuda()}


def _snapshot(net) -> dict:
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def _count_moved(net, before: dict, pick) -> tuple:
    keys = [k for k in before if pick(k)]
    moved = sum(int(not bool((net.state_dict()[k] == before[k]).all()))
                for k in keys)
    return moved, len(keys)


def phase_train(smi: str) -> dict:
    """The training path: a few train steps at full width in bf16 (the
    training default) and in f32, with the launches of both kernels counted
    over each run, and the step's time. Returns the launches counted over
    the bf16 run and the step times."""
    import torch

    from trainner_tpu_torch.ops import rdb5c
    from trainner_tpu_torch.train.sr_trainer import create_trainer

    per_g = NB * 3
    batch = _train_batch()
    result = {}
    for use_amp, n_check, n_timed in ((True, 3, 10), (False, 2, 10)):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        trainer = create_trainer({**_train_options(), "use_amp": use_amp})
        name = str(trainer.dtype).replace("torch.", "")
        state = trainer.init_state(0)
        g0, d0 = _snapshot(state.g.net), _snapshot(state.d.net)
        rdb5c.launches = rdb5c.backward_launches = 0
        for _ in range(n_check):
            state, logs = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        fwd, bwd = rdb5c.launches, rdb5c.backward_launches
        vals = {k: float(v) for k, v in logs.items()}
        print(f"train: {name} b={batch['LR'].shape[0]} "
              f"{TRAIN_SHAPE[1]}->{TRAIN_SHAPE[1] * 4} px, {n_check} steps: "
              f"forward launches {fwd}, backward launches {bwd}, "
              f"logs {vals}")
        if fwd != per_g * n_check or bwd != per_g * n_check:
            raise AssertionError(
                f"{fwd} forward and {bwd} backward launches, expected "
                f"{per_g} per G forward and per G update x {n_check}")
        want = {"l_g_pix", "l_g_fea", "l_g_gan", "l_g_total", "l_d_real",
                "l_d_fake", "D_real", "D_fake", "l_d_total"}
        if set(vals) != want or not all(math.isfinite(v)
                                        for v in vals.values()):
            raise AssertionError(f"logs {vals}")
        if state.step != n_check:
            raise AssertionError(f"step counter {state.step}")
        # D's biases are left out: before a batch norm, and in the dense
        # layers under the relativistic loss, their gradient is zero but
        # for rounding, and may be exactly zero
        is_stat = lambda k: "running_" in k  # noqa: E731
        for label, net, before, pick in (
                ("G parameters", state.g.net, g0, lambda k: True),
                ("D weights", state.d.net, d0,
                 lambda k: k.endswith("weight")),
                ("D running statistics", state.d.net, d0, is_stat)):
            moved, total = _count_moved(net, before, pick)
            print(f"train: {name} {label}: {moved} of {total} tensors moved")
            if moved != total:
                raise AssertionError(f"{label}: {moved} of {total} moved")
        for p in list(state.g.net.parameters()) \
                + list(state.d.net.parameters()):
            if p.dtype != torch.float32 or not bool(p.isfinite().all()):
                raise AssertionError("a parameter is not finite f32")

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(n_timed):
            state, logs = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / n_timed * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"times: train_step {name} b={batch['LR'].shape[0]} "
              f"{TRAIN_SHAPE[1]}->{TRAIN_SHAPE[1] * 4} px over {n_timed} "
              f"steps after {n_check}: {step_ms:.3f} ms, "
              f"{1e3 / step_ms:.4f} it/s, peak memory {peak:.3f} GiB "
              f"({smi})")
        if not math.isfinite(float(logs["l_g_total"])):
            raise AssertionError("l_g_total is not finite after the timed "
                                 "steps")
        result[name] = dict(step_ms=step_ms, forward=fwd, backward=bwd)
        del trainer, state
        torch.cuda.empty_cache()

    # D_update_ratio 2: the second step updates D only
    trainer = create_trainer(_train_options(D_update_ratio=2))
    state = trainer.init_state(1)
    for step, (want_f, want_b) in enumerate(((per_g, per_g), (per_g, 0))):
        rdb5c.launches = rdb5c.backward_launches = 0
        g0 = _snapshot(state.g.net)
        state, logs = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        fwd, bwd = rdb5c.launches, rdb5c.backward_launches
        moved, _ = _count_moved(state.g.net, g0, lambda k: True)
        print(f"train: D_update_ratio 2, step {step}: forward launches "
              f"{fwd}, backward launches {bwd}, G tensors moved {moved}, "
              f"logs {sorted(logs)}")
        if (fwd, bwd) != (want_f, want_b) or bool(moved) != bool(want_b) \
                or ("l_g_total" in logs) != bool(want_b) \
                or not math.isfinite(float(logs["l_d_total"])):
            raise AssertionError(f"step {step} at D_update_ratio 2")
    del trainer, state
    torch.cuda.empty_cache()
    return result


def phase_g_gradient(smi: str) -> None:
    """One f32 G-stage gradient of the full-width G (pixel, feature and GAN
    losses, b=2, noise off, weights at gain 0.7) on the two kernels against
    the same on both plain versions, TF32 off."""
    import torch

    from trainner_tpu_torch.ops import rdb5c
    from trainner_tpu_torch.train.sr_trainer import create_trainer

    opt = {**_train_options(), "use_amp": False}
    opt["network_G"]["gaussian_noise"] = False
    trainer = create_trainer(opt)
    state = trainer.init_state(2)
    _gain_weights(state.g.net, seed=3)
    batch = _train_batch(batch=2, seed=4)

    def grads():
        # a G update at learning rate 0: the gradients stay on .grad
        trainer._train_step(state, batch, 0.0, 0.0, update_d=False,
                            update_g=True)
        torch.cuda.synchronize()
        return {k: p.grad.clone()
                for k, p in state.g.net.named_parameters()}

    before = rdb5c.backward_launches
    got = grads()
    if rdb5c.backward_launches - before != NB * 3:
        raise AssertionError("the G stage did not run the backward kernel")
    with _plain_blocks():
        ref = grads()
    if rdb5c.backward_launches - before != NB * 3:
        raise AssertionError("the plain pass launched a kernel")
    # f32 through 69 chained blocks forward and back, sums in another
    # order, and a c_k within rounding of zero may take the other slope,
    # which changes that pixel's gradient by a finite step: each tensor
    # within 3e-3 of its own largest gradient
    worst, worst_name, top = 0.0, "", 0.0
    for k, r in ref.items():
        scale = float(r.abs().max())
        top = max(top, scale)
        ratio = float((got[k] - r).abs().max()) / max(scale, 1e-30)
        if ratio > worst:
            worst, worst_name = ratio, k
    print(f"train: full G f32 gradient, kernels vs plain: worst relative "
          f"error {worst:.3e} ({worst_name}), tol 3.000e-03, largest "
          f"gradient {top:.3e} over {len(ref)} tensors")
    if not (worst <= 3e-3 and top > 0 and math.isfinite(top)):
        raise AssertionError(f"full G gradient: {worst} at {worst_name}")
    del trainer, state
    torch.cuda.empty_cache()


def _write_corpus(root: str, n: int = N_CORPUS, px: int = CORPUS_PX,
                  seed: int = 0) -> None:
    """``n`` PNGs of ``px`` x ``px``: random fields with a 1/f^1.2
    spectrum from a seed (smooth, not white noise, so that blur and JPEG
    act on something), channels correlated, written by the port's own PNG
    writer."""
    import torch

    from trainner_tpu_torch.data import save_img

    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = torch.fft.fftfreq(px, device="cuda")
    radius = torch.hypot(f[:, None], f[None, :])
    radius[0, 0] = 1.0
    white = torch.randn(n, 3, px, px, generator=gen, device="cuda")
    img = torch.fft.ifft2(torch.fft.fft2(white) / radius ** 1.2).real
    img = img + 0.6 * img.mean(dim=1, keepdim=True)
    img = (img - img.mean(dim=(1, 2, 3), keepdim=True)) \
        / img.std(dim=(1, 2, 3), keepdim=True) * 0.18 + 0.5
    u8 = (img.clamp(0, 1) * 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    for i, arr in enumerate(u8.cpu().numpy()):
        save_img(arr, os.path.join(root, f"{i:04d}.png"))


def _e2e_options(root: str) -> dict:
    """The end-to-end training configuration: the flagship GAN step fed
    by the aligned train dataset under the bsrgan blind-SR degradations in
    their fixed order, uint8 on the wire."""
    return {**_train_options(), "model": "sr", "datasets": {"train": {
        "name": "smoke", "mode": "aligned", "dataroot_HR": root,
        "crop_size": TRAIN_SHAPE[1] * 4, "batch_size": TRAIN_SHAPE[0],
        "use_flip": True, "use_rot": True, "augs_strategy": "bsrgan",
        "resize_strat": "in", "n_workers": 4, "wire_dtype": "uint8",
        "shuffle_degradations": False}}}


def phase_producer(smi: str, root: str) -> dict:
    """The end-to-end path at full width, bf16: 3 warm-up and 10 timed
    steps of loader -> prefetch -> degradations -> train_step, with the
    three kernels' launches counted over the timed steps. Returns the
    counts."""
    import torch

    from trainner_tpu_torch.data import create_dataloader, create_dataset
    from trainner_tpu_torch.ops import blur, rdb5c
    from trainner_tpu_torch.options import parse_dict
    from trainner_tpu_torch.train import (batches, create_trainer,
                                          make_otf_degradation)

    corpus = os.path.join(root, "corpus")
    os.makedirs(corpus)
    t0 = time.perf_counter()
    _write_corpus(corpus)
    print(f"producer: {N_CORPUS} PNGs of {CORPUS_PX}x{CORPUS_PX} written in "
          f"{time.perf_counter() - t0:.2f} s")
    opt = parse_dict(_e2e_options(corpus), is_train=True)
    ds_opt = opt["datasets"]["train"]
    dataset = create_dataset(ds_opt)
    if not (dataset._fast_u8 and dataset.skip_host_lr):
        raise AssertionError("the dataset is not on its uint8 fast path")
    loader = create_dataloader(dataset, ds_opt, pin_memory=True)
    t0 = time.perf_counter()
    n_first = sum(1 for _ in loader)  # the first epoch decodes every file
    print(f"producer: first epoch ({n_first} batches, every PNG decoded "
          f"into the tile cache) {time.perf_counter() - t0:.2f} s")
    if len(dataset._cache) != N_CORPUS:
        raise AssertionError(f"{len(dataset._cache)} images in the cache")
    gen = torch.Generator(device="cuda").manual_seed(7)
    degrade = make_otf_degradation(opt, generator=gen)
    trainer = create_trainer(opt)
    state = trainer.init_state(0)
    stream = batches(loader)
    b, lr_px = TRAIN_SHAPE[0], TRAIN_SHAPE[1]
    per_g = NB * 3

    def e2e_step():
        nonlocal state
        batch = degrade(next(stream))
        state, logs = trainer.train_step(state, batch)
        return batch, logs

    for _ in range(3):
        batch, logs = e2e_step()
    torch.cuda.synchronize()
    hr, lr = batch["HR"], batch["LR"]
    if hr.dtype != torch.uint8 or tuple(hr.shape) != (b, lr_px * 4,
                                                      lr_px * 4, 3):
        raise AssertionError(f"HR {hr.dtype} {tuple(hr.shape)}")
    if lr.dtype != torch.float32 or not lr.is_cuda \
            or tuple(lr.shape) != (b, lr_px, lr_px, 3):
        raise AssertionError(f"LR {lr.dtype} {lr.device} {tuple(lr.shape)}")
    lo, hi = float(lr.min()), float(lr.max())
    off = float((lr * 255 - (lr * 255).round()).abs().max())
    moved = float((lr - hr[:, ::4, ::4].float() / 255).abs().mean())
    print(f"producer: LR {tuple(lr.shape)} {lr.dtype} on {lr.device}, in "
          f"[{lo:.4f}, {hi:.4f}], off the 1/255 lattice by {off:.2e}, mean "
          f"distance from the strided placeholder {moved:.4f}")
    if not (0.0 <= lo and hi <= 1.0 and off <= 1e-4 and moved > 1e-3):
        raise AssertionError("the degraded LR batch is not as expected")

    n_timed = 10
    blur.launches = rdb5c.launches = rdb5c.backward_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        batch, logs = e2e_step()
    torch.cuda.synchronize()
    e2e_ms = (time.perf_counter() - t0) / n_timed * 1e3
    counts = dict(blur=blur.launches, forward=rdb5c.launches,
                  backward=rdb5c.backward_launches)
    vals = {k: float(v) for k, v in logs.items()}
    print(f"producer: {n_timed} end-to-end steps: blur launches "
          f"{counts['blur']}, forward launches {counts['forward']}, backward "
          f"launches {counts['backward']}, logs {vals}")
    if counts != dict(blur=2 * n_timed, forward=per_g * n_timed,
                      backward=per_g * n_timed):
        raise AssertionError(
            f"launches {counts}: expected 2 blur launches per batch and "
            f"{per_g} + {per_g} block launches per G update x {n_timed}")
    if not all(math.isfinite(v) for v in vals.values()):
        raise AssertionError(f"logs {vals}")

    # the same call's compute-only steps, on the last degraded batch
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, logs = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_timed * 1e3
    # and the degrader in front of the step without the loader's threads
    raw = next(stream)
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, logs = trainer.train_step(state, degrade(raw))
    torch.cuda.synchronize()
    fed_ms = (time.perf_counter() - t0) / n_timed * 1e3
    print(f"times: train_e2e bfloat16 b={b} {lr_px}->{lr_px * 4} px over "
          f"{n_timed} steps after 3: {e2e_ms:.3f} ms, {1e3 / e2e_ms:.4f} "
          f"it/s; compute-only in the same call {step_ms:.3f} ms, "
          f"{1e3 / step_ms:.4f} it/s; degrade + step on one resident batch "
          f"(no loader) {fed_ms:.3f} ms, {1e3 / fed_ms:.4f} it/s ({smi})")

    # the producer's parts alone
    deg_ms = _time_ms(lambda: degrade(raw), iters=10, warmup=2)
    t0 = time.perf_counter()
    for _ in range(10):
        degrade(raw)
    torch.cuda.synchronize()
    deg_host_ms = (time.perf_counter() - t0) / 10 * 1e3
    t0 = time.perf_counter()
    n_loaded = sum(1 for _ in range(5) for _ in loader)
    load_ms = (time.perf_counter() - t0) / n_loaded * 1e3
    print(f"times: producer alone, per batch of {b}: degrade {deg_ms:.3f} ms "
          f"(CUDA events), {deg_host_ms:.3f} ms (host clock, synchronised "
          f"after 10); loader {load_ms:.3f} ms (host clock, {n_loaded} "
          f"batches, cache warm, pinned) ({smi})")
    _traced(lambda: degrade(raw), f"degrade b={b} {lr_px * 4}->{lr_px} px",
            smi, deg_host_ms)
    _traced(e2e_step, f"bf16 end-to-end step b={b} {lr_px}->{lr_px * 4} px",
            smi, e2e_ms)
    del trainer, state, stream
    torch.cuda.empty_cache()
    return counts


BF16_BLOCK_KERNELS = {"rdb5c.cu": ("rdb_stage_mma",),
                      "rdb5c_bwd.cu": ("rdb_dx_stage_mma", "dw_mma_kernel")}


def _instruction_forms(smi: str) -> dict:
    """Reads the SASS of the two block libraries (``cuobjdump -sass``) and
    returns {kernel: "HGMMA" or "HMMA"} for the bf16 block kernels. Fails
    if one of them multiplies on neither, or if a bf16 instantiation of the
    f32-FMA kernels is still in the build."""
    import collections

    from trainner_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    forms = {}
    for source, kernels in BF16_BLOCK_KERNELS.items():
        sass = subprocess.run(
            [cuobjdump, "-sass", str(_build.library_path(source))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        counts, name = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                counts[name] = collections.Counter()
            elif name is not None:
                for op in ("HGMMA", "HMMA", "FFMA", "LDSM", "LDGSTS"):
                    if op + "." in line or op + " " in line:
                        counts[name][op] += 1
        for fn in counts:
            if "bfloat16" in fn and any(k in fn for k in (
                    "rdb_stageI", "rdb_dx_stageI", "dw_kernelI",
                    "vtab_kernelI")):
                raise AssertionError(f"{source} still builds {fn}")
        for kernel in kernels:
            found = [c for fn, c in counts.items() if kernel in fn]
            if len(found) != 1:
                raise AssertionError(f"{source}: {len(found)} functions "
                                     f"named {kernel}")
            c = found[0]
            form = "HGMMA" if c["HGMMA"] else "HMMA" if c["HMMA"] else None
            print(f"device: {source}: {kernel}: " + ", ".join(
                f"{n} {op}" for op, n in sorted(c.items())) + f" -> {form}")
            if form is None:
                raise AssertionError(f"{kernel} has no tensor-core "
                                     "instruction")
            forms[kernel] = form
    return forms


def _bound(name: str, flops: float, nbytes: float) -> tuple:
    """The least time in ms the card could take: the larger of operations
    over the type's peak and bytes over the memory rate, and which."""
    t_ops = flops / PEAK_FLOPS[name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_times(smi: str, root: str, kernels_only: bool = False):
    """CUDA-event times of both block kernels at the main paths' shapes in
    both types, beside the plain version, the bound and the cuDNN five-conv
    chain (its forward, and autograd's backward through it), and the bf16
    kernels' time on the device alone; then (unless ``kernels_only``) the G
    forward at b=8. Returns {(kernel, shape, dtype name): row}."""
    import torch

    from trainner_tpu_torch.models import define_G
    from trainner_tpu_torch.models.rrdb import ResidualDenseBlock5C
    from trainner_tpu_torch.ops.rdb5c import (rdb5c_backward,
                                              rdb5c_backward_plain,
                                              rdb5c_forward,
                                              rdb5c_forward_plain)
    from trainner_tpu_torch.options import parse

    n_q = (NF * (4 * GC + NF) + GC * (3 * GC + NF) + GC * (2 * GC + NF)
           + GC * (GC + NF) + GC * NF)
    gen = torch.Generator().manual_seed(2)
    rows = {}
    for shape in (MAIN_SHAPE, TRAIN_SHAPE):
        b, h, w = shape
        npix = b * h * w
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).replace("torch.", "")
            blk = ResidualDenseBlock5C(NF, GC)
            ws, bs = _block_weights(gen)
            with torch.no_grad():
                for conv, wt, bt in zip(blk.convs(), ws, bs):
                    conv.weight.copy_(wt)
                    conv.bias.copy_(bt)
            blk = blk.cuda()
            packed, biases = blk.packed(dt)
            x = (torch.randn(b, h, w, NF, generator=gen) * 0.5).cuda().to(dt)
            x_nchw = x.permute(0, 3, 1, 2)
            conv_blk = blk.to(dt)
            with torch.inference_mode():
                ms = _time_ms(lambda: rdb5c_forward(x, packed, biases))
                plain_ms = _time_ms(
                    lambda: rdb5c_forward_plain(x, packed, biases), iters=5)
                library_ms = _time_ms(
                    lambda: conv_blk._unfused_forward(x_nchw))
            w_bytes = sum(p.numel() * p.element_size() for p in packed)
            nbytes = (x.numel() * 2 * x.element_size() + w_bytes
                      + sum(t.numel() * 4 for t in biases))
            work = 2 * 9 * n_q * npix
            bound_ms, bound_by = _bound(name, work, nbytes)
            rows["rdb5c_forward", shape, name] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)
            print(f"times: rdb5c {name} b={b} {h}x{w}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, cuDNN 5-conv chain "
                  f"{library_ms:.4f} ms ({library_ms / ms:.2f}x the kernel), "
                  f"bound {bound_ms:.4f} ms ({bound_by}, "
                  f"{bound_ms / ms:.1%} of it reached), "
                  f"{work / ms / 1e9:.2f} TFLOP/s ({smi})")

            # the backward, from the forward's residuals; the yardstick is
            # autograd's backward through the cuDNN chain on a kept graph
            g = torch.randn(b, h, w, NF, generator=gen).cuda().to(dt)
            with torch.no_grad():
                _, *cs = rdb5c_forward(x, packed, biases,
                                       return_residuals=True)
                ms = _time_ms(lambda: rdb5c_backward(g, x, *cs, packed))
                plain_ms = _time_ms(
                    lambda: rdb5c_backward_plain(g, x, *cs, packed), iters=3)
            xin = x_nchw.detach().requires_grad_(True)
            out = conv_blk._unfused_forward(xin)
            inputs = [xin, *conv_blk.parameters()]
            g_nchw = g.permute(0, 3, 1, 2)
            library_ms = _time_ms(lambda: torch.autograd.grad(
                out, inputs, g_nchw, retain_graph=True))
            nbytes = ((3 * NF + 4 * GC) * npix * x.element_size() + w_bytes
                      + sum(p.numel() for p in packed) * 4
                      + (4 * GC + NF) * 4)
            work = 4 * 9 * n_q * npix
            bound_ms, bound_by = _bound(name, work, nbytes)
            rows["rdb5c_backward", shape, name] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)
            print(f"times: rdb5c_bwd {name} b={b} {h}x{w}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, autograd through "
                  f"the cuDNN 5-conv chain {library_ms:.4f} ms "
                  f"({library_ms / ms:.2f}x the kernel), bound "
                  f"{bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.1%} of "
                  f"it reached), {work / ms / 1e9:.2f} TFLOP/s ({smi})")
            if dt == torch.bfloat16:
                # the three hot kernels on the device alone, all their
                # launches in one block added up
                with torch.no_grad():
                    dev = {k: _device_ms(fn, k) for k, fn in (
                        ("rdb_stage_mma",
                         lambda: rdb5c_forward(x, packed, biases)),
                        ("rdb_dx_stage_mma",
                         lambda: rdb5c_backward(g, x, *cs, packed)),
                        ("dw_mma_kernel",
                         lambda: rdb5c_backward(g, x, *cs, packed)))}
                rows["rdb5c_forward", shape, name]["device_ms"] = \
                    dev["rdb_stage_mma"]
                rows["rdb5c_backward", shape, name]["device_ms"] = dev
                print(f"times: bf16 block kernels b={b} {h}x{w} on the "
                      f"device alone (profiler, per block): "
                      + ", ".join(f"{k} {v:.4f} ms" for k, v in dev.items())
                      + f" ({smi})")
            del blk, conv_blk, out, inputs, xin
    if kernels_only:
        return rows

    b, h, w = MAIN_SHAPE
    opt = parse(_options(root, name="smoke_times"), is_train=False)
    lr = torch.rand(b, h, w, 3, generator=gen).cuda()
    for dt in (torch.float32, torch.bfloat16):
        net = define_G(opt, dtype=dt)
        net.init_weights(torch.Generator().manual_seed(0))
        net = net.cuda().eval()
        with torch.inference_mode():
            g_ms = _time_ms(lambda: net(lr), iters=5, warmup=2)
        mpx = b * (h * 4) * (w * 4) / 1e6 / (g_ms / 1e3)
        print(f"times: G forward {dt} b={b} {h}->{h * 4} px: {g_ms:.3f} ms, "
              f"{mpx:.3f} Mpx/s ({smi})")
        del net
        torch.cuda.empty_cache()
    return rows


def _device_ms(fn, match: str, calls: int = 10) -> float:
    """Device time per call of ``fn``, under torch.profiler, of the kernels
    whose name holds ``match`` (all their launches in one call added up),
    over ``calls`` calls; 0.0 when the profiler recorded none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and match in e.name]
    return sum(spans) / calls / 1e3


def phase_blur_times(smi: str) -> dict:
    """CUDA-event times of the blur kernel in f32 at the producer's two
    shapes, beside its bound, its plain version and the library call
    (reflect ``F.pad`` and one grouped cuDNN convolution over b*c groups).
    Returns {shape: row}."""
    import torch
    import torch.nn.functional as F

    from trainner_tpu_torch.ops.blur import (blur_per_sample,
                                             blur_per_sample_plain)

    def library(x, kern):
        b, h, w, c = x.shape
        k = kern.shape[-1]
        xg = F.pad(x.permute(0, 3, 1, 2).reshape(1, b * c, h, w),
                   (k // 2,) * 4, mode="reflect")
        y = F.conv2d(xg, kern.repeat_interleave(c, 0)[:, None], groups=b * c)
        return y.reshape(b, c, h, w).permute(0, 2, 3, 1).contiguous()

    gen = torch.Generator().manual_seed(6)
    rows = {}
    for shape in (BLUR_HR, BLUR_LR):
        b, h, w, c = shape
        x = torch.rand(*shape, generator=gen).cuda()
        kern = _blur_kernels(gen, b, BLUR_K)
        lib_err = float((library(x, kern) - blur_per_sample(x, kern)
                         ).abs().max())
        if not lib_err <= 1e-5:
            raise AssertionError(f"the library call disagrees: {lib_err}")
        ms = _time_ms(lambda: blur_per_sample(x, kern), iters=50)
        plain_ms = _time_ms(lambda: blur_per_sample_plain(x, kern), iters=3,
                            warmup=1)
        library_ms = _time_ms(lambda: library(x, kern))
        device_ms = _device_ms(lambda: blur_per_sample(x, kern),
                               "blur_kernel")
        work = 2 * BLUR_K * BLUR_K * x.numel()
        nbytes = 2 * x.numel() * 4 + kern.numel() * 4
        bound_ms, bound_by = _bound("float32", work, nbytes)
        rows[shape] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           device_ms=device_ms)
        print(f"times: blur_per_sample float32 {shape} k={BLUR_K}: kernel "
              f"{ms:.4f} ms per call of the wrapper (CUDA events over 50 "
              f"calls), {device_ms:.4f} ms on the device alone (profiler), "
              f"plain {plain_ms:.4f} ms, reflect pad + grouped cuDNN conv "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{work / ms / 1e9:.2f} TFLOP/s ({smi})")
    return rows


def _kernel_rows(rows, serving_launches, train, main_err, bwd_err,
                 blur_rows, producer, blur_err, forms):
    """The JSON summary: each kernel at its main path's shape and type (the
    forward at the serving shape in f32, the backward at the training shape
    in bf16, the blur at the HR canvas in f32, with its times at the LR
    canvas beside), with the launches counted over the main paths' runs."""
    fwd = rows["rdb5c_forward", MAIN_SHAPE, "float32"]
    bwd = rows["rdb5c_backward", TRAIN_SHAPE, "bfloat16"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def bf16_at(kernel):
        return {f"b={sh[0]} {sh[1]}x{sh[2]}": {
            k: rows[kernel, sh, "bfloat16"][k] for k in keys + ("device_ms",)}
            for sh in (MAIN_SHAPE, TRAIN_SHAPE)}

    return [
        {"name": "rdb5c_forward", "route": "cuda",
         "source": "trainner_tpu_torch/csrc/rdb5c.cu",
         "replaces": "trainner_tpu/ops/pallas_kernels.py:180",
         "launches": serving_launches + producer["forward"] + sum(
             r["forward"] for r in train.values()),
         "max_abs_err": main_err, **{k: fwd[k] for k in keys},
         "shape": list(MAIN_SHAPE), "dtype": "float32",
         "bfloat16": bf16_at("rdb5c_forward"),
         "bfloat16_form": {k: forms[k]
                           for k in BF16_BLOCK_KERNELS["rdb5c.cu"]}},
        {"name": "rdb5c_backward", "route": "cuda",
         "source": "trainner_tpu_torch/csrc/rdb5c_bwd.cu",
         "replaces": "trainner_tpu/ops/pallas_kernels.py:355",
         "launches": producer["backward"] + sum(
             r["backward"] for r in train.values()),
         "max_abs_err": bwd_err, **{k: bwd[k] for k in keys},
         "shape": list(TRAIN_SHAPE), "dtype": "bfloat16",
         "bfloat16": bf16_at("rdb5c_backward"),
         "bfloat16_form": {k: forms[k]
                           for k in BF16_BLOCK_KERNELS["rdb5c_bwd.cu"]}},
        {"name": "blur_per_sample", "route": "cuda",
         "source": "trainner_tpu_torch/csrc/blur_per_sample.cu",
         "replaces": "trainner_tpu/ops/pallas_kernels.py:466",
         "launches": producer["blur"], "max_abs_err": blur_err,
         **{k: blur_rows[BLUR_HR][k] for k in keys + ("device_ms",)},
         "shape": list(BLUR_HR), "k": BLUR_K, "dtype": "float32",
         "at_lr_canvas": {"shape": list(BLUR_LR),
                          **{k: blur_rows[BLUR_LR][k]
                             for k in keys + ("device_ms",)}}},
    ]


def _traced(fn, label: str, smi: str, untraced_ms: float = 0.0) -> None:
    """Runs ``fn`` once under torch.profiler and prints the device time by
    kernel and the device's idle share of the wall time; with
    ``untraced_ms``, the time of the same work without the profiler, also
    the idle share against that (the profiler slows the host)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = collections.Counter()
    calls = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.removeprefix("void ").replace(
                "(anonymous namespace)::", "").split("(")[0][:70]
            by_name[name] += e.time_range.elapsed_us()
            calls[name] += 1
    busy_us = sum(by_name.values())
    if not busy_us:
        print(f"trace: the profiler recorded no device time; the breakdown "
              f"of {label} is not measured ({smi})")
        return
    print(f"trace: {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms in {sum(calls.values())} kernels and "
          f"copies, idle share {1 - busy_us / wall_us:.4f} ({smi})")
    if untraced_ms:
        print(f"trace: {label}: untraced {untraced_ms:.3f} ms, idle share "
              f"against it {1 - busy_us / 1e3 / untraced_ms:.4f} ({smi})")
    for name, us in by_name.most_common(12):
        print(f"trace:   {us / 1e3:9.3f} ms {us / max(busy_us, 1):7.2%} "
              f"{calls[name]:4d} x {name}")


def phase_trace(smi: str, root: str, step_ms: float) -> None:
    """Where the time goes, from profiler traces: one f32 G forward at b=8,
    128->512 px, and one bf16 train step at b=32, 32->128 px (``step_ms``:
    its time without the profiler, from the training phase)."""
    import torch

    from trainner_tpu_torch.models import define_G
    from trainner_tpu_torch.options import parse
    from trainner_tpu_torch.train.sr_trainer import create_trainer

    b, h, w = MAIN_SHAPE
    opt = parse(_options(root, name="smoke_trace"), is_train=False)
    net = define_G(opt, dtype=torch.float32)
    net.init_weights(torch.Generator().manual_seed(0))
    net = net.cuda().eval()
    lr = torch.rand(b, h, w, 3, generator=torch.Generator().manual_seed(3)
                    ).cuda()
    with torch.inference_mode():
        _traced(lambda: net(lr), f"f32 G forward b={b} {h}->{h * 4} px", smi)
    del net
    torch.cuda.empty_cache()

    trainer = create_trainer(_train_options())
    state = trainer.init_state(0)
    batch = _train_batch()
    trainer.train_step(state, batch)
    _traced(lambda: trainer.train_step(state, batch),
            f"bf16 train_step b={TRAIN_SHAPE[0]} "
            f"{TRAIN_SHAPE[1]}->{TRAIN_SHAPE[1] * 4} px", smi, step_ms)


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels-only", action="store_true")
    flags = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from trainner_tpu_torch.ops import _build, rdb5c

    smi = _smi()
    print(f"device: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    t0 = time.time()
    logs = _build.build_all()
    print(f"device: kernels built in {time.time() - t0:.2f} s")
    for source, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"device: {source}: {line.strip()}")
    smem = {f"rdb_stage_mma / rdb_dx_stage_mma over {c} channels":
            rdb5c._library().rdb5c_stage_smem_bytes(c)
            for c in range(NF, NF + 4 * GC + 1, GC)}
    smem["dw_mma_kernel"] = rdb5c._bwd_library().rdb5c_backward_dw_smem_bytes()
    print("device: dynamic shared memory of the bf16 block kernels, bytes "
          f"per block: {smem}")
    forms = _instruction_forms(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    main_err, bwd_err = phase_kernels(smi)
    if flags.kernels_only:
        phase_times(smi, "", kernels_only=True)
        print(smi)
        return 0
    blur_err = phase_blur_kernel(smi)
    with tempfile.TemporaryDirectory() as root:
        launches = phase_slice(smi, root)
        phase_g_compare(smi, root)
        train = phase_train(smi)
        phase_g_gradient(smi)
        producer = phase_producer(smi, root)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        rows = phase_times(smi, root)
        blur_rows = phase_blur_times(smi)
        phase_trace(smi, root, train["bfloat16"]["step_ms"])
    kernels = _kernel_rows(rows, launches, train, main_err, bwd_err,
                           blur_rows, producer, blur_err, forms)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
