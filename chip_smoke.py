#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``trainner_tpu_torch``) on one
NVIDIA card.

Phases, each printing lines of its own; any failure ends the run with a
non-zero exit code and no result line:

1. device: the card's name and power limit, the build of every CUDA
   kernel of the main paths from the sources in ``trainner_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once: registers, spills, shared memory)
   and, from the build's SASS, the instruction that multiplies in each
   block kernel (``HMMA`` for ``mma.sync``, ``HGMMA`` for ``wgmma``; tf32
   ``HMMA`` in f32), with no f32-FMA block kernel left in the build, and
   the blur kernel's FFMA against shared-memory reads at k 21;
2. tf32 mma: how one tf32 ``mma.sync`` adds its products on the card
   (``csrc/tf32_mma_probe.cu`` on inputs that tell the ways apart), held to
   ``TF32_MMA``, which the CPU emulation of 3xTF32 follows;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, TF32 off, f32 and bf16: the block's forward at the serving shape,
   the training shape and two ragged ones (the second at b=1), its backward
   at the training shape and the ragged ones, bit-equal from run to run;
   both again with every output and scratch buffer filled with NaN before
   the launch, and at other widths (``OTHER_WIDTHS``: nf 16 / gc 8 and nf
   48 / gc 16, which the wrappers pad to multiples of 32 and which are held
   to the unpadded plain versions; nf 64 and 128 with gc 64, whose widest
   bf16 stages stream their weights); the per-sample blur at the producer's
   two shapes (the HR and the LR canvas, k 21) and at the shuffled
   program's two q-slices, at k 3 and 7 on the HR
   canvas, at ragged shapes with asymmetric kernels, k/2 close to h and a k
   past the instantiated ones, and an identity kernel bit for bit;
4. serving slice: ``python -m trainner_tpu_torch.test`` at the full width
   of the ESRGAN generator (nf 64, nb 23, gc 32, 4x) on a synthetic test
   set, in f32 and with ``use_amp``, counting kernel launches; then the
   full G on the kernel against the same G on the plain version;
5. debug configs: ``options/sr/test_sr_debug.yml``'s G (nf 16, nb 2, gc 8)
   served through the CLI with random weights, and two train steps of
   ``options/sr/train_sr_debug.yml``'s G and D, in f32 and bf16;
6. training slice: ``create_trainer`` -> ``init_state`` -> ``train_step`` on
   the flagship GAN configuration at full width (that G, D-VGG-128, VGG19
   conv5_4, Adam; batch 32, 32 -> 128 px, latent noise on) in bf16 and in
   f32, counting forward and backward launches, with the step's time; two
   steps at ``D_update_ratio: 2``; then one f32 G-stage gradient of the
   full G on the kernels against the same on both plain versions;
7. producer slice: a corpus of PNGs written from a seed, then the
   end-to-end training path at full width: train dataset (uint8 fast path,
   tile cache) -> loader (pinned) -> ``device_prefetch`` ->
   ``make_otf_degradation`` (the fixed-order bsrgan pipeline on the card,
   two blur launches per batch) -> ``train_step`` in bf16; its it/s beside
   the compute-only it/s of the same call, the degrader's and the loader's
   time per batch, and a traced end-to-end step; then the same path with
   the per-sample shuffle of the stages (24 blur launches per batch);
8. shuffle: the routed and the candidate-select programs of the
   per-sample shuffle on stand-in stages, the card's output against the
   CPU's bit for bit on one plan; then the bsrgan stages at b=32, 128 px in
   the fixed order and shuffled: ms per batch, device busy and launches
   (profiler), and the blur kernel's launches and shapes per batch (the
   q-slices (6, 128, 128, 3) and (6, 32, 32, 3), at which phase 3 holds the
   kernel against its plain version too);
9. cli: ``options/sr/train_sr.yml`` at its full width through
   ``trainner_tpu_torch.train.main`` (the corpus as its train set, a
   validation set of 4 corpus images and their x4 LR, 12 iterations,
   checkpoints and validation at 6 and 12): launches per step and per
   batch, the artifacts, the JSONL scalars, the steady it/s, the save and
   validation times; then a second ``main`` that resumes from
   ``training_state/`` to 16, whose loaded state equals the saved one bit
   for bit;
10. times: CUDA-event times of each kernel, its plain version, its bound
   and a library call as a yardstick (the cuDNN five-conv chain; reflect
   padding and a grouped cuDNN convolution for the blur), the device-alone
   time of the block kernels and the blur from the profiler, the block at
   the padded and the streamed widths at the training shape, and the G
   forward at b=8, 128->512 px. The f32 block kernels run 3xTF32: their
   bound is three tf32 products per f32 product at the tensor cores' tf32
   rate, printed beside the bound of the same work on the CUDA cores. With
   ``--parent DIR``, the blur kernel of the tree in DIR is timed beside
   this one's in turns; the blur also at the shuffled program's q-slices;
11. trace: one f32 G forward at b=8 and one train step in bf16 and in f32
   under ``torch.profiler``: device time by kernel and the device's idle
   share.

The second-to-last lines are a JSON summary of the kernels and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py [--parent DIR]
       python3 chip_smoke.py --kernels-only [--parent DIR]   (phases 1-3
           and the kernels' part of 10: a short run while a kernel is
           worked on; it prints no result line)
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

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W): f32 on the
# CUDA cores, tf32 and bf16 on the tensor cores.
PEAK_FLOPS = {"float32": 67e12, "tfloat32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

MAIN_SHAPE = (8, 128, 128)   # b, h, w of the LR trunk at b=8, 128->512 px
TRAIN_SHAPE = (32, 32, 32)   # the trunk of a training step: b=32, 32->128 px
RAGGED_SHAPE = (3, 37, 53)
RAGGED_B1_SHAPE = (1, 21, 45)  # one image, no multiple of the 16x16 tile
BLUR_HR = (32, 128, 128, 3)  # the HR canvas of the producer's first blur
BLUR_LR = (32, 32, 32, 3)    # the LR canvas of its second blur
BLUR_K = 21
# the q-slices of the shuffled program at b = 32: k = 6 symbols (bsrgan's
# five shuffled stages and the resize), npad 36, q 6
BLUR_Q_HR = (6, 128, 128, 3)
BLUR_Q_LR = (6, 32, 32, 3)
SHUFFLE_K = 6
# the widths the block runs at besides (64, 32): narrow ones the wrappers
# pad to multiples of 32, and bf16 stages over 256 channels, which stream
# their weights
OTHER_WIDTHS = ((16, 8), (48, 16), (32, 32), (128, 32), (64, 64), (128, 64))
OPTIONS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "options", "sr")
DEBUG_TEST_YML = os.path.join(OPTIONS_DIR, "test_sr_debug.yml")
DEBUG_TRAIN_YML = os.path.join(OPTIONS_DIR, "train_sr_debug.yml")
TRAIN_YML = os.path.join(OPTIONS_DIR, "train_sr.yml")
N_VAL = 4
CLI_NITER, CLI_FREQ, CLI_RESUME_NITER = 12, 6, 16
# How one tf32 mma.sync.m16n8k8 adds on the card, as phase_tf32_mma reads
# it (mma_tf32_sum): the eight products, exact, and the running sum are
# aligned to the largest exponent among them, a product's exponent being
# the sum of its operands' (its significand not renormalised); every term
# is cut towards zero below 2^(E - 25), the cut terms are added exactly and
# the sum is cut towards zero to f32. The CPU emulation of 3xTF32 in
# tests/test_torch_rdb5c_tf32.py adds the same way.
TF32_MMA = dict(frac_bits=25, product_exponent="operands", acc_in_group=True,
                group=8, cut="trunc", rounding="rz")
N_CORPUS, CORPUS_PX = 64, 256
PROBE_SOURCE = "tf32_mma_probe.cu"
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
    """f32: sums in another order over K <= 576 terms, each product taken
    as 3xTF32 on the card (about 2^-21 of it), 1e-4 on values of size ~5.
    bf16: both round c1..c4 and out once from f32 sums, but a
    rounding that differs in c_k feeds the later stages: two bf16 ulps at
    the output's largest magnitude."""
    import torch

    return 1e-4 if dtype == torch.float32 else 2 * _bf16_ulp(ref)


def _backward_tolerance(dtype, name, ref) -> float:
    """f32: dx sums up to 1,728 products (2e-6 of its largest magnitude;
    3xTF32 on the card, whose mma cuts its sums towards zero (TF32_MMA),
    reads about 0.3 of that, as the CPU emulation of
    tests/test_torch_rdb5c_tf32.py predicts); dW and db
    sum over every pixel in another order than cuDNN's weight gradient
    (1e-4 of theirs). bf16: a da_k that rounds the other way feeds
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
    weights' own; where they are not multiples of 32 the wrappers pad the
    block and the plain versions run it unpadded: the padded residuals'
    extra channels must be exactly zero and the rest agree."""
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
    for i, c in enumerate(got[1:]):
        if c.shape[-1] > gc and bool(c[..., gc:].any()):
            raise AssertionError(f"{label}rdb5c {shape} {dt}: c{i + 1}'s "
                                 "padded channels are not zero")
    cut = [got[0]] + [c[..., :gc] for c in got[1:]]
    ref = rdb5c_forward_plain(xd, packed, bs, return_residuals=True)
    errs = []
    for name, g, r in zip(("out", "c1", "c2", "c3", "c4"), cut, ref):
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
    ref_b = rdb5c_backward_plain(gd, xd, *cut[1:], packed)
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


def _exponent(v):
    """floor(log2 |v|) of each value; far below any other for 0."""
    import torch

    _, e = torch.frexp(v)
    return torch.where(v == 0, torch.full_like(e, -100000), e - 1)


def _round_f32(s, rounding: str):
    """f64 -> the f32 value nearest (rn) or next towards zero (rz), as
    f64."""
    import torch

    r = s.float()
    if rounding == "rz":
        over = r.double().abs() > s.abs()
        r = torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)
    return r.double()


def mma_tf32_sum(acc, a, b, frac_bits: int, product_exponent: str,
                 acc_in_group: bool, group: int, cut: str, rounding: str):
    """One tf32 mma.sync's sums as a model of the unit: ``acc`` (...,) and
    the tf32 operands ``a``, ``b`` (..., 8), which may broadcast against
    each other, all f64; returns the f32 sums as f64. Group by group of ``group`` products (and the running sum, with
    ``acc_in_group``), every term is cut (``trunc``: towards zero,
    ``floor``: down) to a multiple of 2^(E - frac_bits), E the largest
    term's exponent, a product's taken as the sum of its operands'
    exponents (``operands``: its significand, in [1, 4), not renormalised)
    or its own (``product``); the cut terms are added exactly and the sum
    rounded to f32 (``rn``: to nearest, ``rz``: towards zero)."""
    import torch

    prods = a * b  # a and b may broadcast against each other
    if product_exponent == "operands":
        pe = _exponent(a) + _exponent(b)
        pe = torch.where(prods == 0, -100000, pe)
    else:
        pe = _exponent(prods)
    for lo in range(0, prods.shape[-1], group):
        terms, exps = prods[..., lo:lo + group], pe[..., lo:lo + group]
        if acc_in_group:
            terms = torch.cat([acc[..., None], terms], -1)
            exps = torch.cat([_exponent(acc)[..., None], exps], -1)
        # a group of zeros cuts nothing: its quantum stays far from 0
        top = exps.amax(-1, keepdim=True).clamp(min=-900)
        quantum = torch.ldexp(torch.ones_like(terms[..., :1]),
                              top - frac_bits)
        units = terms / quantum
        units = units.trunc() if cut == "trunc" else units.floor()
        s = (units * quantum).sum(-1)
        acc = _round_f32(s if acc_in_group else s + acc, rounding)
    return acc


def tf32_mma_cases():
    """Inputs of the probe, each one dot product of eight tf32 products
    and an accumulator: (acc, a (8,), b (8,)). They tell apart where a
    small term is cut (with how many extra bits, towards zero or down),
    whether the accumulator joins the products' alignment, whether the
    eight products are one group or two, and how the sum is rounded."""
    import torch

    cases = []

    def case(acc, pairs):
        a = torch.zeros(8, dtype=torch.float64)
        b = torch.zeros(8, dtype=torch.float64)
        for k, (x, y) in pairs.items():
            a[k], b[k] = x, y
        cases.append((float(acc), a, b))

    for j in range(18, 50):
        small = 2.0 ** -j
        case(0.0, {0: (1.0, 1.0), 1: (-1.0, 1.0), 2: (small, 1.0)})
        case(0.0, {0: (1.0, 1.0), 1: (-1.0, 1.0), 6: (small, 1.0)})
        case(0.0, {4: (1.0, 1.0), 5: (-1.0, 1.0), 2: (small, 1.0)})
        case(0.0, {0: (1.0, 1.0), 1: (-1.0, 1.0), 2: (1.5 * small, 1.0)})
        case(0.0, {0: (1.0, 1.0), 1: (-1.0, 1.0), 2: (-1.5 * small, 1.0)})
        case(small, {0: (1.0, 1.0), 1: (-1.0, 1.0)})
        case(1.0, {0: (-1.0, 1.0), 3: (small, 1.0)})
        case(2.0 ** 8, {0: (-2.0 ** 8, 1.0), 3: (small, 1.0)})
    for frac in (0.25, 0.5, 0.75, 1.25, 1.5):
        for sign in (1.0, -1.0):
            case(sign, {0: (sign * frac, 2.0 ** -23)})
            case(sign, {0: (sign * frac, 2.0 ** -24), 5: (sign * frac,
                                                          2.0 ** -24)})
    # random dot products, eleven significant bits an operand, exponents
    # over a narrow and over a wide range
    gen = torch.Generator().manual_seed(11)
    for lo, hi, n in ((-12, 4, 64), (-24, 8, 200)):
        for _ in range(n):
            mant = torch.randint(1024, 2048, (17,), generator=gen).double()
            expo = torch.randint(lo, hi, (17,), generator=gen).double()
            sign = torch.randint(0, 2, (17,), generator=gen).double() * 2 - 1
            v = sign * mant * 2.0 ** (expo - 10)
            case(float(v[16]), {k: (float(v[k]), float(v[8 + k]))
                                for k in range(8)})
    return cases


def tf32_mma_models():
    """The models ``mma_tf32_sum`` can be: every combination of its
    options."""
    return [dict(frac_bits=f, product_exponent=p, acc_in_group=a, group=g,
                 cut=c, rounding=r)
            for f in range(20, 32) for p in ("operands", "product")
            for a in (True, False) for g in (8, 4)
            for c in ("trunc", "floor") for r in ("rz", "rn")]


def phase_tf32_mma(smi: str) -> list:
    """One tf32 mma.sync.m16n8k8 per case of ``tf32_mma_cases`` on the
    card (``csrc/tf32_mma_probe.cu``); prints which models of
    ``tf32_mma_models`` give every case's sum bit for bit, and fails
    unless TF32_MMA, which the CPU emulation uses, is one. Returns the
    models that fit."""
    import ctypes

    import torch

    from trainner_tpu_torch.ops import _build

    lib = _build.load(PROBE_SOURCE)
    p = ctypes.c_void_p
    lib.tf32_mma_probe.argtypes = [p, p, p, p, ctypes.c_int, p]
    lib.tf32_mma_probe.restype = ctypes.c_int
    cases = tf32_mma_cases()
    n = len(cases)
    a = torch.zeros(n, 16, 8)
    b = torch.zeros(n, 8, 8)
    c = torch.zeros(n, 16, 8)
    for i, (acc, av, bv) in enumerate(cases):
        a[i, 0], b[i, :, 0], c[i, 0, 0] = av.float(), bv.float(), acc
    a, b, c = a.cuda(), b.cuda(), c.cuda()
    d = torch.zeros_like(c)
    err = lib.tf32_mma_probe(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                             d.data_ptr(), n,
                             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"tf32 mma probe launch failed: {err}")
    got = d[:, 0, 0].double().cpu()
    accs = torch.tensor([cs[0] for cs in cases], dtype=torch.float64)
    av = torch.stack([cs[1] for cs in cases])
    bv = torch.stack([cs[2] for cs in cases])
    fits = [model for model in tf32_mma_models()
            if torch.equal(mma_tf32_sum(accs, av, bv, **model), got)]
    exact = _round_f32(accs + (av * bv).sum(-1), "rn")
    print(f"tf32 mma: {n} cases, {int((got != exact).sum())} differ from "
          f"the sum rounded once to nearest; models that give every case: "
          f"{fits or 'none'} ({smi})")
    short = [j for j, g in zip(range(18, 50), got[0:8 * 32:8].tolist())
             if g != 2.0 ** -j]
    print(f"tf32 mma: 1 - 1 + 2^-j in one mma comes out short of 2^-j "
          f"from j = {short[0] if short else 'none'} on")
    if TF32_MMA not in fits:
        raise AssertionError(f"the card does not add as TF32_MMA = "
                             f"{TF32_MMA} says")
    return fits


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
    # other widths: chunks, segments, slices and dW slots are counted from
    # nf and gc at run time; narrow blocks run padded, and bf16 stages over
    # 256 channels stream their weights
    for nf, gc in OTHER_WIDTHS:
        ws2, bs2 = _block_weights(gen, nf, gc)
        x = (torch.randn(*RAGGED_B1_SHAPE, nf, generator=gen) * 0.5).cuda()
        g_out = torch.randn(*RAGGED_B1_SHAPE, nf, generator=gen).cuda()
        for dt in (torch.float32, torch.bfloat16):
            _compare_block(RAGGED_B1_SHAPE, dt, x, g_out, ws2,
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
                     (BLUR_Q_HR, BLUR_K), (BLUR_Q_LR, BLUR_K), (BLUR_HR, 3),
                     (BLUR_HR, 7), ((5, 37, 53, 3), 7), ((5, 37, 53, 3), 21),
                     ((5, 37, 53, 1), 21), ((2, 11, 70, 3), 21),
                     ((3, 40, 9, 3), 17), ((2, 30, 30, 3), 25)):
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


def read_options_yml(path: str) -> dict:
    """An options YAML, read by the port's own reader
    (``options/config.py::read_yaml``), which needs no PyYAML (the card's
    machine has none)."""
    from trainner_tpu_torch.options.config import read_yaml

    return read_yaml(path)


def phase_debug_configs(smi: str, root: str) -> None:
    """The repo's debug configs on the card, at their narrow widths (nf 16,
    gc 8), which the kernels run padded to 32: test_sr_debug.yml's G
    through the CLI in f32 and bf16 with random weights (its
    pretrain_model_G dropped), and two train steps of train_sr_debug.yml's
    G and D in f32 and bf16, counting the block kernels' launches."""
    import torch

    from trainner_tpu_torch import test as test_cli
    from trainner_tpu_torch.ops import rdb5c
    from trainner_tpu_torch.train.sr_trainer import create_trainer

    opt = read_options_yml(DEBUG_TEST_YML)
    opt["path"] = {"root": root}
    g_opt = opt["network_G"]
    per_g = g_opt["nb"] * 3
    n_img = opt["datasets"]["test_1"]["n_samples"]
    for use_amp in (False, True):
        opt["name"] = f"debug_serve_{'bf16' if use_amp else 'f32'}"
        opt["use_amp"] = use_amp
        path = os.path.join(root, opt["name"] + ".json")
        with open(path, "w") as f:
            json.dump(opt, f)
        rdb5c.launches = 0
        averages = test_cli.main(["-opt", path])
        torch.cuda.synchronize()
        vals = {m["name"]: m["average"] for v in averages.values()
                for m in v}
        print(f"debug: {os.path.basename(DEBUG_TEST_YML)} G (nf "
              f"{g_opt['nf']}, nb {g_opt['nb']}, gc {g_opt['gc']}) served, "
              f"use_amp {use_amp}: {n_img} images, launches "
              f"{rdb5c.launches}, metrics {vals}")
        if rdb5c.launches != per_g * n_img or not vals or not all(
                math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"debug serving: {rdb5c.launches} launches,"
                                 f" metrics {vals}")

    opt = read_options_yml(DEBUG_TRAIN_YML)
    train = {"is_train": True, "scale": opt["scale"],
             "network_G": opt["network_G"], "network_D": opt["network_D"],
             "train": opt["train"]}
    hr_px = opt["datasets"]["train"]["crop_size"]
    b = opt["datasets"]["train"]["batch_size"]
    gen = torch.Generator().manual_seed(8)
    batch = {"LR": torch.rand(b, hr_px // 4, hr_px // 4, 3,
                              generator=gen).cuda(),
             "HR": torch.rand(b, hr_px, hr_px, 3, generator=gen).cuda()}
    for use_amp in (False, True):
        trainer = create_trainer({**train, "use_amp": use_amp})
        state = trainer.init_state(0)
        g0 = _snapshot(state.g.net)
        rdb5c.launches = rdb5c.backward_launches = 0
        for _ in range(2):
            state, logs = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        vals = {k: float(v) for k, v in logs.items()}
        moved, total = _count_moved(state.g.net, g0, lambda k: True)
        print(f"debug: {os.path.basename(DEBUG_TRAIN_YML)} G and D, "
              f"{trainer.dtype}, b={b} {hr_px // 4}->{hr_px} px, 2 steps: "
              f"forward launches {rdb5c.launches}, backward launches "
              f"{rdb5c.backward_launches}, G tensors moved {moved} of "
              f"{total}, logs {vals}")
        if (rdb5c.launches, rdb5c.backward_launches) != (2 * per_g,
                                                          2 * per_g) \
                or moved != total or not all(math.isfinite(v)
                                             for v in vals.values()):
            raise AssertionError("debug training did not run as expected")
        del trainer, state
    print(f"debug: ok ({smi})")


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


def _e2e_options(root: str, shuffle: bool = False) -> dict:
    """The end-to-end training configuration: the flagship GAN step fed
    by the aligned train dataset under the bsrgan blind-SR degradations in
    their fixed order (``shuffle``: in an order drawn per sample), uint8 on
    the wire."""
    return {**_train_options(), "model": "sr", "datasets": {"train": {
        "name": "smoke", "mode": "aligned", "dataroot_HR": root,
        "crop_size": TRAIN_SHAPE[1] * 4, "batch_size": TRAIN_SHAPE[0],
        "use_flip": True, "use_rot": True, "augs_strategy": "bsrgan",
        "resize_strat": "in", "n_workers": 4, "wire_dtype": "uint8",
        "shuffle_degradations": shuffle}}}


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

    # the same path with the stage order drawn per sample (the routed
    # program: blur and blur2 once per slot and pass, on q-slices)
    degrade_fixed = degrade
    degrade = make_otf_degradation(
        parse_dict(_e2e_options(corpus, shuffle=True), is_train=True),
        generator=gen)
    for _ in range(2):
        e2e_step()
    blur.launches = rdb5c.launches = rdb5c.backward_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        batch, logs = e2e_step()
    torch.cuda.synchronize()
    e2e_sh_ms = (time.perf_counter() - t0) / n_timed * 1e3
    counts["shuffled"] = dict(blur=blur.launches, forward=rdb5c.launches,
                              backward=rdb5c.backward_launches)
    per_batch = 2 * 2 * SHUFFLE_K
    print(f"producer: {n_timed} shuffled end-to-end steps: launches "
          f"{counts['shuffled']}")
    if counts["shuffled"] != dict(blur=per_batch * n_timed,
                                  forward=per_g * n_timed,
                                  backward=per_g * n_timed):
        raise AssertionError(
            f"shuffled launches {counts['shuffled']}: expected {per_batch} "
            f"blur launches per batch and {per_g} + {per_g} block launches "
            f"per G update x {n_timed}")
    lr = batch["LR"]
    if tuple(lr.shape) != (b, lr_px, lr_px, 3) or not all(
            math.isfinite(float(v)) for v in logs.values()):
        raise AssertionError(f"shuffled e2e: LR {tuple(lr.shape)}, logs "
                             f"{logs}")
    print(f"times: train_e2e bfloat16 b={b} {lr_px}->{lr_px * 4} px, "
          f"per-sample shuffle {e2e_sh_ms:.3f} ms, {1e3 / e2e_sh_ms:.4f} "
          f"it/s; fixed order {e2e_ms:.3f} ms, {1e3 / e2e_ms:.4f} it/s in "
          f"the same call ({smi})")
    degrade = degrade_fixed

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


def _stand_in_degrader(ds_opt: dict):
    """A shuffling degrader whose stages are deterministic stand-ins that
    do not commute (exact on the 1/255 lattice on any device), with a
    resize (stride 4) among them and no finals: k = 6 symbols, as bsrgan."""
    from trainner_tpu_torch.data.pipeline import BatchDegrader

    deg = BatchDegrader(ds_opt, "lr")
    deg.stages = [("a", lambda g, x: x * 0.5), ("b", lambda g, x: x + 0.25),
                  ("resize", lambda g, x: x[:, ::4, ::4]),
                  ("c", lambda g, x: 1.0 - x), ("d", lambda g, x: x * x),
                  ("e", lambda g, x: x.flip(2))]
    deg._resize_finals, deg._comp_finals, deg._programs = [], [], {}
    return deg


def phase_shuffle(smi: str, root: str) -> dict:
    """The per-sample shuffle of the bsrgan stages on the card. First the
    routed and the candidate-select programs on stand-in stages, on one
    plan: the card's output equals the CPU's bit for bit, and the samples
    of one image repeated take both orders. Then the real bsrgan stages at
    b = 32, 128 px: the fixed order against the routed shuffle (ms per
    batch, device busy and launches from the profiler), and the blur
    kernel's launches and shapes per batch. Returns the shuffled program's
    degrade ms."""
    import numpy as np
    import torch

    from trainner_tpu_torch.data.common import decode_image
    from trainner_tpu_torch.data.pipeline import (BatchDegrader, _full_f32,
                                                  plan_to_device)
    from trainner_tpu_torch.ops import blur
    from trainner_tpu_torch.ops import degradations as D
    from trainner_tpu_torch.options import parse_dict

    corpus = os.path.join(root, "corpus")
    b, hr = BLUR_HR[0], BLUR_HR[1]
    ds = parse_dict(_e2e_options(corpus, shuffle=True),
                    is_train=True)["datasets"]["train"]
    ds_fixed = parse_dict(_e2e_options(corpus),
                          is_train=True)["datasets"]["train"]

    # 1. stand-ins: the card against the CPU on the same plan and scores
    gen_cpu = torch.Generator().manual_seed(3)
    x = (torch.randint(0, 256, (b, hr, hr, 3), generator=gen_cpu)
         / 255.0).float()
    x[b // 2:] = x[0]  # half the batch one image: its samples take orders
    plan = _stand_in_degrader(ds)._routing_plan(np.random.default_rng(0), b)
    scores = torch.rand(b, SHUFFLE_K, generator=gen_cpu)
    outs = {}
    for dev in ("cuda", "cpu"):
        deg = _stand_in_degrader(ds)
        gen = torch.Generator(device=dev).manual_seed(0)
        with _full_f32():
            outs["routed", dev] = deg._build_routing()(
                gen, x.to(dev), *plan_to_device(plan[:4], torch.device(dev)))
            outs["select", dev] = deg._build_persample()(
                gen, x.to(dev), scores=scores.to(dev))
    torch.cuda.synchronize()
    for prog in ("routed", "select"):
        got, want = outs[prog, "cuda"].cpu(), outs[prog, "cpu"]
        same = x[b // 2:].shape[0]
        orders = len({tuple(t.flatten()[:64].tolist())
                      for t in got[b // 2:]})
        print(f"shuffle: stand-ins, {prog} program, b={b} {hr} px: card "
              f"equals CPU bit for bit: {torch.equal(got, want)}; "
              f"{orders} distinct outputs among {same} samples of one image")
        if not torch.equal(got, want) or orders < 2 \
                or tuple(got.shape) != (b, hr // 4, hr // 4, 3):
            raise AssertionError(f"shuffle: {prog} stand-ins differ")

    # 2. the bsrgan stages, fixed order against the routed shuffle
    names = sorted(os.listdir(corpus))[:b]
    x_u8 = torch.from_numpy(np.stack(
        [decode_image(os.path.join(corpus, n))[:hr, :hr, :3] for n in names]
    )).cuda()
    fixed, shuffled = BatchDegrader(ds_fixed, "lr"), BatchDegrader(ds, "lr")
    if not (shuffled.shuffle and not fixed.shuffle):
        raise AssertionError("shuffle_degradations did not reach the degrader")
    gen = torch.Generator(device="cuda").manual_seed(11)
    result = {}
    for label, deg, per_batch, shapes_want in (
            ("fixed order", fixed, 2, {BLUR_HR: 1, BLUR_LR: 1}),
            ("per-sample shuffle", shuffled, 4 * SHUFFLE_K,
             {BLUR_Q_HR: 2 * SHUFFLE_K, BLUR_Q_LR: 2 * SHUFFLE_K})):
        deg(gen, x_u8)
        torch.cuda.synchronize()
        shapes = {}
        orig = D.apply_kernels

        def spy(xx, kern):
            key = tuple(xx.shape)
            shapes[key] = shapes.get(key, 0) + 1
            return orig(xx, kern)

        blur.launches = 0
        D.apply_kernels = spy
        try:
            y = deg(gen, x_u8)
            torch.cuda.synchronize()
        finally:
            D.apply_kernels = orig
        launches = blur.launches
        off = float((y * 255 - (y * 255).round()).abs().max())
        print(f"shuffle: bsrgan {label}, b={b} {hr}->{hr // 4} px: blur "
              f"launches per batch {launches}, shapes {shapes}; output "
              f"{tuple(y.shape)} off the 1/255 lattice by {off:.1e}")
        if launches != per_batch or shapes != shapes_want \
                or tuple(y.shape) != (b, hr // 4, hr // 4, 3) \
                or off > 1e-4 or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"shuffle: bsrgan {label} ran otherwise")
        ms = _time_ms(lambda: deg(gen, x_u8), iters=10, warmup=2)
        print(f"times: degrade bsrgan {label} b={b} {hr}->{hr // 4} px "
              f"{ms:.3f} ms per batch (CUDA events over 10) ({smi})")
        _traced(lambda: deg(gen, x_u8), f"degrade, {label}, b={b}", smi, ms)
        result[label] = dict(ms=ms, blur_launches=launches)
    print(f"shuffle: ok ({smi})")
    return result


def _cli_options(root: str, corpus: str) -> str:
    """``options/sr/train_sr.yml`` as written, read by the port's reader,
    but for its data roots (the corpus; a validation set of ``N_VAL``
    corpus images and their x4 bicubic LR written here), ``niter``, the
    frequencies and ``path.root``. Returns the path of the options file."""
    import numpy as np

    from trainner_tpu_torch.data.common import decode_image, save_img
    from trainner_tpu_torch.ops.imresize import imresize_np

    val_hr, val_lr = os.path.join(root, "val_HR"), os.path.join(root,
                                                                 "val_LR")
    os.makedirs(val_hr)
    os.makedirs(val_lr)
    for name in sorted(os.listdir(corpus))[:N_VAL]:
        hr = decode_image(os.path.join(corpus, name))
        save_img(hr, os.path.join(val_hr, name))
        lr = imresize_np(hr.astype(np.float32) / 255.0, 0.25, kernel="cubic")
        save_img((lr * 255.0).round().astype(np.uint8),
                 os.path.join(val_lr, name))
    opt = read_options_yml(TRAIN_YML)
    opt["datasets"]["train"]["dataroot_HR"] = corpus
    opt["datasets"]["val"].update(dataroot_HR=val_hr, dataroot_LR=val_lr)
    opt["train"].update(niter=CLI_NITER, val_freq=CLI_FREQ)
    opt["logger"].update(print_freq=2, save_checkpoint_freq=CLI_FREQ)
    opt["path"] = {"root": os.path.join(root, "cli")}
    path = os.path.join(root, "cli_train_sr.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    return path


def _state_tensors(state) -> dict:
    """Every tensor a checkpoint carries, on the host: both nets'
    state_dicts (D's running statistics included), the moments and the
    step counts."""
    out = {"step": state.step}
    for which in ("g", "d"):
        ns = getattr(state, which)
        for k, v in ns.net.state_dict().items():
            out[f"{which}.{k}"] = v.detach().cpu().clone()
        out[f"{which}.count"] = ns.opt.count
        for key in ("mu", "nu"):
            for i, t in enumerate(getattr(ns.opt, key)):
                out[f"{which}.{key}.{i}"] = t.detach().cpu().clone()
    return out


def _save_breakdown(state, path: str) -> dict:
    """Where a ``.state`` save spends its time: the state to numpy trees
    (device to host) and the encoding written to ``path``."""
    import torch

    from trainner_tpu_torch.utils import checkpoint
    from trainner_tpu_torch.utils.torch_interop import train_state_to_jax

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_state_to_jax(state)
    t1 = time.perf_counter()
    checkpoint.save_state(state, path, backup=False)
    t2 = time.perf_counter()
    out = dict(host_ms=(t1 - t0) * 1e3,
               write_ms=(t2 - t1 - (t1 - t0)) * 1e3,
               mb=os.path.getsize(path) / 1e6)
    os.remove(path)
    os.remove(path + ".json")
    return out


def phase_cli(smi: str, root: str) -> dict:
    """The training CLI at the full width of ``options/sr/train_sr.yml``
    (G nf 64, nb 23, gc 32, D-VGG-128, batch 32, crop 128, bsrgan with the
    per-sample shuffle, bf16), ``trainner_tpu_torch.train.main`` on the
    card for 12 iterations with checkpoints and validation at 6 and 12;
    then a second ``main`` that resumes from ``training_state/`` to 16,
    whose loaded state must equal the saved one bit for bit. Counts the
    three kernels' launches over each run, per step and per batch. Returns
    the first run's counts."""
    import torch

    from trainner_tpu_torch.ops import blur, rdb5c
    from trainner_tpu_torch.train import cli
    from trainner_tpu_torch.train.sr_trainer import SRTrainer
    from trainner_tpu_torch.utils import checkpoint

    corpus = os.path.join(root, "corpus")
    opt_path = _cli_options(root, corpus)
    per_g = NB * 3
    per_batch = 2 * 2 * SHUFFLE_K
    exp = os.path.join(root, "cli", "experiments", "001_sr_template")
    rec = {"steps": [], "save": [], "val": [], "loaded": None}
    orig = (SRTrainer.train_step, checkpoint.save_checkpoint, cli.validate,
            checkpoint.load_state)

    def train_step(self, state, batch):
        step = state.step
        start = (time.perf_counter(), rdb5c.launches,
                 rdb5c.backward_launches, blur.launches)
        out = orig[0](self, state, batch)
        if step + 1 == CLI_NITER:
            torch.cuda.synchronize()
            rec["end"] = time.perf_counter()
        rec["steps"].append((step + 1, start, rdb5c.launches,
                             rdb5c.backward_launches))
        return out

    def timed(fn, key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec[key].append(time.perf_counter() - t0)
            return out
        return run

    def load_state(path, state):
        state, meta = orig[3](path, state)
        rec["loaded"] = (path, meta, _state_tensors(state))
        return state, meta

    def run(argv):
        rec["steps"].clear()
        blur.launches = rdb5c.launches = rdb5c.backward_launches = 0
        t0 = time.perf_counter()
        state = cli.main(argv)
        torch.cuda.synchronize()
        counts = dict(blur=blur.launches, forward=rdb5c.launches,
                      backward=rdb5c.backward_launches)
        return state, counts, time.perf_counter() - t0

    SRTrainer.train_step = train_step
    checkpoint.save_checkpoint = timed(orig[1], "save")
    cli.validate = timed(orig[2], "val")
    checkpoint.load_state = load_state
    try:
        state, counts, wall = run(["-opt", opt_path])
        steps = list(rec["steps"])
        saved = _state_tensors(state)
        save_parts = _save_breakdown(state, os.path.join(root, "t.state"))
        del state
        torch.cuda.empty_cache()
        with open(opt_path) as f:
            opt2 = json.load(f)
        opt2["train"]["niter"] = CLI_RESUME_NITER
        opt2["path"]["resume_state"] = os.path.join(exp, "training_state")
        opt2_path = os.path.join(root, "cli_resume.json")
        with open(opt2_path, "w") as f:
            json.dump(opt2, f)
        state2, counts2, wall2 = run(["-opt", opt2_path])
        steps2 = list(rec["steps"])
    finally:
        (SRTrainer.train_step, checkpoint.save_checkpoint, cli.validate,
         checkpoint.load_state) = orig

    # the first run: launches per step and per batch, and in all
    n_val = 2 * N_VAL  # validation at 6 and 12
    want = dict(blur=per_batch * CLI_NITER,
                forward=per_g * (CLI_NITER + n_val),
                backward=per_g * CLI_NITER)
    print(f"cli: main() on {CLI_NITER} iterations, {wall:.2f} s: launches "
          f"{counts} (expected {want})")
    blur_seen = 0
    for i, (step, (_, fwd0, bwd0, blur0), fwd1, bwd1) in enumerate(steps):
        if step != i + 1 or (fwd1 - fwd0, bwd1 - bwd0) != (per_g, per_g) \
                or blur0 - blur_seen != per_batch:
            raise AssertionError(
                f"cli step {i + 1}: state step {step}, launches forward "
                f"{fwd1 - fwd0}, backward {bwd1 - bwd0}, blur for its batch "
                f"{blur0 - blur_seen}")
        blur_seen = blur0
    if counts != want or len(steps) != CLI_NITER:
        raise AssertionError(f"cli launches {counts}, {len(steps)} steps")
    print(f"cli: every step {per_g} + {per_g} block launches and its batch "
          f"{per_batch} blur launches ({CLI_NITER} steps)")

    # the artifacts
    files = {os.path.relpath(os.path.join(d, f), exp)
             for d, _, fs in os.walk(exp) for f in fs}
    need = {f"models/{t}_{n}.ckpt" for t in (CLI_FREQ, CLI_NITER)
            for n in "GD"} | {f"training_state/{t}.state{e}"
                              for t in (CLI_FREQ, CLI_NITER)
                              for e in ("", ".json")} \
        | {"tb/scalars.jsonl"}
    names = [os.path.splitext(n)[0] for n in
             sorted(os.listdir(os.path.join(root, "val_HR")))]
    need |= {f"val_images/{n}/{n}_{t}.png" for n in names
             for t in (CLI_FREQ, CLI_NITER)}
    if need - files:
        raise AssertionError(f"cli: missing {sorted(need - files)}")
    sizes = {f: os.path.getsize(os.path.join(exp, f)) for f in sorted(files)
             if f.startswith(("models/12", "training_state/12"))}
    print(f"cli: artifacts present ({len(files)} files); sizes {sizes}")
    rows = [json.loads(line) for line in
            open(os.path.join(exp, "tb", "scalars.jsonl"))]
    tags = {(r["tag"], r["step"]) for r in rows}
    if not ({("train/l_g_total", s) for s in range(2, CLI_NITER + 1, 2)}
            | {("val/psnr", CLI_FREQ), ("val/psnr", CLI_NITER)}) <= tags \
            or not all(math.isfinite(r["value"]) for r in rows):
        raise AssertionError("cli: the JSONL scalars are incomplete")
    psnr = [r["value"] for r in rows if r["tag"] == "val/psnr"]
    print(f"cli: {len(rows)} JSONL scalars, all finite; val psnr {psnr}")

    # times: from the start of step 3 to the end of step 12 (synchronised
    # there), with and without the save and validation at 6 inside it
    span = rec["end"] - steps[2][1][0]
    steady = span - rec["save"][0] - rec["val"][0]
    n = CLI_NITER - 2
    save_ms = [t * 1e3 for t in rec["save"]]
    val_ms = [t * 1e3 for t in rec["val"]]
    print(f"times: cli main() steps 3-{CLI_NITER} on the host clock: "
          f"{steady * 1e3 / n:.3f} ms per iteration, {n / steady:.4f} it/s "
          f"steady; {span * 1e3 / n:.3f} ms, {n / span:.4f} it/s with the "
          f"save and validation at {CLI_FREQ} ({smi})")
    print(f"times: cli save_checkpoint (G, D, state; synchronised) "
          f"{', '.join(f'{t:.1f}' for t in save_ms)} ms; of a state file "
          f"({save_parts['mb']:.1f} MB): to host trees "
          f"{save_parts['host_ms']:.1f} ms, encoded and written "
          f"{save_parts['write_ms']:.1f} ms; validation "
          f"{', '.join(f'{t / N_VAL:.1f}' for t in val_ms)} ms per image "
          f"({N_VAL} images of {CORPUS_PX // 4} -> {CORPUS_PX} px) ({smi})")

    # the resumed run
    path, meta, loaded = rec["loaded"]
    diff = [k for k in saved if not (
        torch.equal(saved[k], loaded[k]) if isinstance(saved[k],
                                                       torch.Tensor)
        else saved[k] == loaded[k])]
    want2 = dict(blur=per_batch * (CLI_RESUME_NITER - CLI_NITER),
                 forward=per_g * (CLI_RESUME_NITER - CLI_NITER),
                 backward=per_g * (CLI_RESUME_NITER - CLI_NITER))
    print(f"cli: resumed from {os.path.relpath(path, exp)} (iter "
          f"{meta['iter']}, epoch {meta['epoch']}) to {state2.step} in "
          f"{wall2:.2f} s: {len(saved)} tensors and counts of the saved "
          f"state, {len(diff)} differ after loading; launches {counts2}")
    if diff or meta["iter"] != CLI_NITER or state2.step != CLI_RESUME_NITER \
            or steps2[0][0] != CLI_NITER + 1 or counts2 != want2 \
            or not os.path.exists(os.path.join(
                exp, "models", f"{CLI_RESUME_NITER}_G.ckpt")):
        raise AssertionError(f"cli resume: differs {diff[:5]}, meta {meta},"
                             f" step {state2.step}, launches {counts2}")
    del state2
    torch.cuda.empty_cache()
    print(f"cli: ok ({smi})")
    return dict(counts, resumed=counts2)


BF16_BLOCK_KERNELS = {"rdb5c.cu": ("rdb_stage_mma",),
                      "rdb5c_bwd.cu": ("rdb_dx_stage_mma", "dw_mma_kernel")}
# bf16 stages over more than 256 channels, which stream their weights
BF16_STREAMED_KERNELS = {"rdb5c.cu": ("rdb_streamed_stage_mma",),
                         "rdb5c_bwd.cu": ("rdb_dx_streamed_stage_mma",)}
F32_BLOCK_KERNELS = {"rdb5c.cu": ("rdb_stage_tf32",),
                     "rdb5c_bwd.cu": ("rdb_dx_stage_tf32", "dw_tf32_kernel")}
# the f32-FMA block kernels of earlier versions (mangled name parts)
GONE_KERNELS = ("rdb_stageI", "rdb_dx_stageI", "dw_kernelI", "vtab_kernel")


def _instruction_forms(smi: str) -> dict:
    """Reads the SASS of the two block libraries (``cuobjdump -sass``) and
    returns {kernel: "HGMMA" or "HMMA"} for the block kernels of both
    types. Fails if one of them multiplies on neither, if an f32 kernel's
    ``HMMA`` is not tf32, or if an f32-FMA block kernel of an earlier
    version is still in the build."""
    import collections

    from trainner_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    forms = {}
    for source in BF16_BLOCK_KERNELS:
        sass = subprocess.run(
            [cuobjdump, "-sass", str(_build.library_path(source))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        counts, name = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                counts[name] = collections.Counter()
            elif name is not None:
                for op in ("HGMMA", "HMMA", "FFMA", "LDSM", "LDS", "LDGSTS"):
                    if op + "." in line or op + " " in line:
                        counts[name][op] += 1
                if "HMMA" in line and "TF32" in line:
                    counts[name]["HMMA.TF32"] += 1
        for fn in counts:
            if any(k in fn for k in GONE_KERNELS):
                raise AssertionError(f"{source} still builds {fn}")
        for kernel in (BF16_BLOCK_KERNELS[source]
                       + BF16_STREAMED_KERNELS[source]
                       + F32_BLOCK_KERNELS[source]):
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
            if kernel in F32_BLOCK_KERNELS[source] and \
                    c["HMMA.TF32"] != c["HMMA"]:
                raise AssertionError(f"{kernel}: {c['HMMA']} HMMA, of which "
                                     f"{c['HMMA.TF32']} tf32")
            forms[kernel] = form
    return forms


def _blur_sass_mix(smi: str) -> None:
    """The static instruction mix of the blur kernel at k = 21 in f32, one
    line per tile (``cuobjdump -sass``): FFMA against shared-memory reads
    (LDS, of which LDS.128 the taps') in its main loop's body."""
    import collections

    from trainner_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", str(_build.library_path("blur_per_sample.cu"))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = collections.Counter()
        elif name is not None:
            for op in ("FFMA", "LDS.128", "LDS", "STS", "LDG"):
                if op + " " in line or op + "." in line:
                    counts[name][op] += 1
                    break
    for fn, c in counts.items():
        if "blur_kernelIfLi21E" in fn:
            print(f"device: blur_per_sample.cu: {fn}: " + ", ".join(
                f"{n} {op}" for op, n in sorted(c.items()))
                + f"; FFMA per shared-memory read "
                f"{c['FFMA'] / max(c['LDS'] + c['LDS.128'], 1):.2f}")


def _bound(name: str, flops: float, nbytes: float) -> tuple:
    """The least time in ms the card could take: the larger of operations
    over the type's peak and bytes over the memory rate, and which. ``name``
    is a key of PEAK_FLOPS; for "tfloat32" ``flops`` counts the tf32
    products (three per f32 product in 3xTF32)."""
    t_ops = flops / PEAK_FLOPS[name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _bounds(name: str, work: float, nbytes: float) -> dict:
    """A block kernel's bound. bf16: the tensor cores' bf16 rate. f32: the
    kernels run 3xTF32, so three tf32 products per f32 product at the tf32
    rate; the same work on the CUDA cores rides along."""
    if name == "bfloat16":
        bound_ms, bound_by = _bound(name, work, nbytes)
        return dict(bound_ms=bound_ms, bound_by=bound_by)
    bound_ms, bound_by = _bound("tfloat32", 3 * work, nbytes)
    cores_ms, _ = _bound("float32", work, nbytes)
    return dict(bound_ms=bound_ms, bound_by=bound_by,
                bound_ms_cuda_cores=cores_ms)


def _bound_text(row: dict) -> str:
    text = (f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
            f"{row['bound_ms'] / row['ms']:.1%} of it reached)")
    if "bound_ms_cuda_cores" in row:
        cores = row["bound_ms_cuda_cores"]
        text += (f", 3xTF32; on the CUDA cores {cores:.4f} ms "
                 f"({cores / row['ms']:.1%})")
    return text


def phase_times(smi: str, root: str, kernels_only: bool = False):
    """CUDA-event times of both block kernels at the main paths' shapes in
    both types, beside the plain version, the bound and the cuDNN five-conv
    chain (its forward, and autograd's backward through it), and the
    kernels' time on the device alone; then (unless ``kernels_only``) the G
    forward at b=8. f32 rows carry two bounds: 3xTF32 on the tensor cores
    (``bound_ms``, what the kernels run) and the same work on the CUDA cores
    (``bound_ms_cuda_cores``). Returns {(kernel, shape, dtype name): row}."""
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
            row = _bounds(name, work, nbytes)
            row.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms)
            rows["rdb5c_forward", shape, name] = row
            print(f"times: rdb5c {name} b={b} {h}x{w}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, cuDNN 5-conv chain "
                  f"{library_ms:.4f} ms ({library_ms / ms:.2f}x the kernel), "
                  f"{_bound_text(row)}, {work / ms / 1e9:.2f} TFLOP/s "
                  f"({smi})")

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
            row = _bounds(name, work, nbytes)
            row.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms)
            rows["rdb5c_backward", shape, name] = row
            print(f"times: rdb5c_bwd {name} b={b} {h}x{w}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, autograd through "
                  f"the cuDNN 5-conv chain {library_ms:.4f} ms "
                  f"({library_ms / ms:.2f}x the kernel), {_bound_text(row)}, "
                  f"{work / ms / 1e9:.2f} TFLOP/s ({smi})")
            # the three hot kernels on the device alone, all their launches
            # in one block added up
            kernels = (BF16_BLOCK_KERNELS if dt == torch.bfloat16
                       else F32_BLOCK_KERNELS)
            (fwd_k,), (dx_k, dw_k) = (kernels["rdb5c.cu"],
                                      kernels["rdb5c_bwd.cu"])
            with torch.no_grad():
                dev = {k: _device_ms(fn, k) for k, fn in (
                    (fwd_k, lambda: rdb5c_forward(x, packed, biases)),
                    (dx_k, lambda: rdb5c_backward(g, x, *cs, packed)),
                    (dw_k, lambda: rdb5c_backward(g, x, *cs, packed)))}
            rows["rdb5c_forward", shape, name]["device_ms"] = dev[fwd_k]
            rows["rdb5c_backward", shape, name]["device_ms"] = {
                k: dev[k] for k in (dx_k, dw_k)}
            print(f"times: {name} block kernels b={b} {h}x{w} on the "
                  f"device alone (profiler, per block): "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in dev.items())
                  + f" ({smi})")
            del blk, conv_blk, out, inputs, xin
    _width_times(smi, gen)
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


def _width_times(smi: str, gen) -> None:
    """The block at the other widths of OTHER_WIDTHS that the main paths do
    not run (narrow ones padded, bf16 stages over 256 channels streamed), at
    the training shape in both types: CUDA-event times of the wrappers
    (padding included) and the stage, dx and dW kernels' device time, beside
    the bound of the block's own (unpadded) work."""
    import torch

    from trainner_tpu_torch.models.rrdb import ResidualDenseBlock5C
    from trainner_tpu_torch.ops.rdb5c import (padded_width, rdb5c_backward,
                                              rdb5c_forward)

    b, h, w = TRAIN_SHAPE
    for nf, gc in OTHER_WIDTHS:
        if (nf, gc) in ((32, 32), (128, 32)):
            continue
        n_q = (nf * (4 * gc + nf) + gc * (3 * gc + nf) + gc * (2 * gc + nf)
               + gc * (gc + nf) + gc * nf)
        ws, bs = _block_weights(gen, nf, gc)
        blk = ResidualDenseBlock5C(nf, gc)
        with torch.no_grad():
            for conv, wt, bt in zip(blk.convs(), ws, bs):
                conv.weight.copy_(wt)
                conv.bias.copy_(bt)
        blk = blk.cuda()
        x32 = (torch.randn(b, h, w, nf, generator=gen) * 0.5).cuda()
        g32 = torch.randn(b, h, w, nf, generator=gen).cuda()
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).replace("torch.", "")
            packed, biases = blk.packed(dt)
            x, g = x32.to(dt), g32.to(dt)
            with torch.no_grad():
                _, *cs = rdb5c_forward(x, packed, biases,
                                       return_residuals=True)
                fwd = lambda: rdb5c_forward(x, packed, biases)  # noqa: E731
                bwd = lambda: rdb5c_backward(  # noqa: E731
                    g, x, *cs, packed)
                ms, bwd_ms = _time_ms(fwd), _time_ms(bwd)
                dev = (_device_ms(fwd, "stage"), _device_ms(bwd, "dx_"),
                       _device_ms(bwd, "dw_"))
            npix, size = b * h * w, x.element_size()
            n_w = sum(wt.numel() for wt in ws)
            fwd_bound = _bounds(name, 2 * 9 * n_q * npix,
                                (2 * nf + 4 * gc) * npix * size + n_w * size
                                + (nf + 4 * gc) * 4)
            bwd_bound = _bounds(name, 4 * 9 * n_q * npix,
                                (3 * nf + 4 * gc) * npix * size
                                + n_w * (size + 4) + (nf + 4 * gc) * 4)
            print(f"times: widths {name} b={b} {h}x{w} nf {nf} gc {gc} "
                  f"(kernels at nf {padded_width(nf)}, gc "
                  f"{padded_width(gc)}): forward {ms:.4f} ms (stages on "
                  f"the device {dev[0]:.4f}), backward {bwd_ms:.4f} ms (dx "
                  f"{dev[1]:.4f} + dW {dev[2]:.4f}); bound of the block's "
                  f"own work: forward {fwd_bound['bound_ms']:.4f} ms, "
                  f"backward {bwd_bound['bound_ms']:.4f} ms ({smi})")
        del blk


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


def _parent_blur(parent: str):
    """The blur kernel of another tree (``parent``, e.g. the parent commit
    unpacked with ``git archive``), built from its source into the build
    directory and loaded; its C interface is this tree's."""
    import ctypes

    from trainner_tpu_torch.ops import _build

    src = os.path.join(parent, "trainner_tpu_torch", "csrc",
                       "blur_per_sample.cu")
    out = _build.BUILD_DIR / "parent-blur_per_sample.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
                    src], capture_output=True, text=True, timeout=600,
                   check=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.blur_per_sample.argtypes = [i, p, p, p, i, i, i, i, i, p]
    lib.blur_per_sample.restype = i
    return lib


def phase_blur_times(smi: str, parent: str = "") -> dict:
    """CUDA-event times of the blur kernel in f32 at the producer's two
    shapes, its time on the device alone (profiler) and its share of the
    bound, beside its plain version and the library call (reflect
    ``F.pad`` and one grouped cuDNN convolution over b*c groups). With
    ``parent``, the same of that tree's blur kernel in the same call, in
    turns (parent, this, this, parent). Returns {shape: row}."""
    import torch
    import torch.nn.functional as F

    from trainner_tpu_torch.ops import blur as port_blur
    from trainner_tpu_torch.ops.blur import (blur_per_sample,
                                             blur_per_sample_plain)

    def library(x, kern):
        b, h, w, c = x.shape
        k = kern.shape[-1]
        xg = F.pad(x.permute(0, 3, 1, 2).reshape(1, b * c, h, w),
                   (k // 2,) * 4, mode="reflect")
        y = F.conv2d(xg, kern.repeat_interleave(c, 0)[:, None], groups=b * c)
        return y.reshape(b, c, h, w).permute(0, 2, 3, 1).contiguous()

    old = _parent_blur(parent) if parent else None
    gen = torch.Generator().manual_seed(6)
    rows = {}
    for shape in (BLUR_HR, BLUR_LR, BLUR_Q_HR, BLUR_Q_LR):
        b, h, w, c = shape
        x = torch.rand(*shape, generator=gen).cuda()
        kern = _blur_kernels(gen, b, BLUR_K)
        lib_err = float((library(x, kern) - blur_per_sample(x, kern)
                         ).abs().max())
        if not lib_err <= 1e-5:
            raise AssertionError(f"the library call disagrees: {lib_err}")
        work = 2 * BLUR_K * BLUR_K * x.numel()
        nbytes = 2 * x.numel() * 4 + kern.numel() * 4
        bound_ms, bound_by = _bound("float32", work, nbytes)
        fn = lambda: blur_per_sample(x, kern)  # noqa: E731
        if old is not None and shape in (BLUR_HR, BLUR_LR):
            # both libraries called alike, straight through their C
            # interface, into one output buffer
            out = torch.empty_like(x)
            stream = torch.cuda.current_stream().cuda_stream

            def direct(lib):
                return lambda: lib.blur_per_sample(
                    0, x.data_ptr(), kern.data_ptr(), out.data_ptr(), b, h,
                    w, c, BLUR_K, stream)

            old_fn, new_fn = direct(old), direct(port_blur._library())
            old_fn()
            torch.cuda.synchronize()
            if not torch.equal(out, fn()):
                raise AssertionError("the parent's blur gives other sums")
            turns = []
            for f, who in ((old_fn, "parent"), (new_fn, "this"),
                           (new_fn, "this"), (old_fn, "parent")):
                turns.append((who, _time_ms(f, iters=50),
                              _device_ms(f, "blur_kernel")))
            print(f"times: blur_per_sample float32 {shape} k={BLUR_K}, its C "
                  f"interface called in turns (CUDA events ms per call, "
                  f"device ms): " + ", ".join(
                      f"{who} {ms:.4f} / {dev:.4f}" for who, ms, dev in turns)
                  + f"; bound {bound_ms:.4f} ms ({smi})")
        ms = _time_ms(fn, iters=50)
        plain_ms = _time_ms(lambda: blur_per_sample_plain(x, kern), iters=3,
                            warmup=1)
        library_ms = _time_ms(lambda: library(x, kern))
        device_ms = _device_ms(fn, "blur_kernel")
        rows[shape] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           device_ms=device_ms)
        share = f"{bound_ms / device_ms:.1%}" if device_ms else "not measured"
        print(f"times: blur_per_sample float32 {shape} k={BLUR_K}: kernel "
              f"{ms:.4f} ms per call of the wrapper (CUDA events over 50 "
              f"calls), {device_ms:.4f} ms on the device alone (profiler), "
              f"{share} of the bound {bound_ms:.4f} ms ({bound_by}), plain "
              f"{plain_ms:.4f} ms, reflect pad + grouped cuDNN conv "
              f"{library_ms:.4f} ms, {work / ms / 1e9:.2f} TFLOP/s ({smi})")
    return rows


def _kernel_rows(rows, serving_launches, train, main_err, bwd_err,
                 blur_rows, producer, blur_err, forms, cli):
    """The JSON summary: each kernel at its main path's shape and type (the
    forward at the serving shape in f32, the backward at the training shape
    in bf16, the blur at the HR canvas in f32, with its times at the LR
    canvas and at the shuffled program's q-slices beside), with the
    launches counted over the main paths' runs (serving, training, the
    producer in both orders, the training CLI and its resume), and both
    types' times at both block shapes beside."""
    paths = (producer, producer["shuffled"], cli, cli["resumed"])
    fwd = rows["rdb5c_forward", MAIN_SHAPE, "float32"]
    bwd = rows["rdb5c_backward", TRAIN_SHAPE, "bfloat16"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def at(kernel, dtype):
        return {f"b={sh[0]} {sh[1]}x{sh[2]}": {
            k: v for k, v in rows[kernel, sh, dtype].items()}
            for sh in (MAIN_SHAPE, TRAIN_SHAPE)}

    def forms_of(source):
        return {k: forms[k] for k in BF16_BLOCK_KERNELS[source]
                + BF16_STREAMED_KERNELS[source] + F32_BLOCK_KERNELS[source]}

    return [
        {"name": "rdb5c_forward", "route": "cuda",
         "source": "trainner_tpu_torch/csrc/rdb5c.cu",
         "replaces": "trainner_tpu/ops/pallas_kernels.py:180",
         "launches": serving_launches + sum(p["forward"] for p in paths)
         + sum(r["forward"] for r in train.values()),
         "max_abs_err": main_err, **{k: fwd[k] for k in keys},
         "bound_ms_cuda_cores": fwd["bound_ms_cuda_cores"],
         "shape": list(MAIN_SHAPE), "dtype": "float32",
         "float32": at("rdb5c_forward", "float32"),
         "bfloat16": at("rdb5c_forward", "bfloat16"),
         "forms": forms_of("rdb5c.cu")},
        {"name": "rdb5c_backward", "route": "cuda",
         "source": "trainner_tpu_torch/csrc/rdb5c_bwd.cu",
         "replaces": "trainner_tpu/ops/pallas_kernels.py:355",
         "launches": sum(p["backward"] for p in paths) + sum(
             r["backward"] for r in train.values()),
         "max_abs_err": bwd_err, **{k: bwd[k] for k in keys},
         "shape": list(TRAIN_SHAPE), "dtype": "bfloat16",
         "float32": at("rdb5c_backward", "float32"),
         "bfloat16": at("rdb5c_backward", "bfloat16"),
         "forms": forms_of("rdb5c_bwd.cu")},
        {"name": "blur_per_sample", "route": "cuda",
         "source": "trainner_tpu_torch/csrc/blur_per_sample.cu",
         "replaces": "trainner_tpu/ops/pallas_kernels.py:466",
         "launches": sum(p["blur"] for p in paths),
         "max_abs_err": blur_err,
         **{k: blur_rows[BLUR_HR][k] for k in keys + ("device_ms",)},
         "shape": list(BLUR_HR), "k": BLUR_K, "dtype": "float32",
         **{name: {"shape": list(shape),
                   **{k: blur_rows[shape][k] for k in keys + ("device_ms",)}}
            for name, shape in (("at_lr_canvas", BLUR_LR),
                                ("at_q_slice_hr", BLUR_Q_HR),
                                ("at_q_slice_lr", BLUR_Q_LR))}},
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


def phase_trace(smi: str, root: str, step_ms: dict) -> None:
    """Where the time goes, from profiler traces: one f32 G forward at b=8,
    128->512 px, and one train step at b=32, 32->128 px in bf16 and in f32
    (``step_ms``: their times without the profiler by type name, from the
    training phase)."""
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

    batch = _train_batch()
    for use_amp, name in ((True, "bfloat16"), (False, "float32")):
        trainer = create_trainer({**_train_options(), "use_amp": use_amp})
        state = trainer.init_state(0)
        trainer.train_step(state, batch)
        _traced(lambda: trainer.train_step(state, batch),
                f"{'bf16' if use_amp else 'f32'} train_step b={TRAIN_SHAPE[0]} "
                f"{TRAIN_SHAPE[1]}->{TRAIN_SHAPE[1] * 4} px", smi,
                step_ms[name])
        del trainer, state
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels-only", action="store_true")
    parser.add_argument("--parent", default="",
                        help="another tree (e.g. the parent commit from "
                        "git archive) whose blur kernel is timed beside "
                        "this one's")
    flags = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from trainner_tpu_torch.ops import _build, rdb5c

    t_start = time.time()
    smi = _smi()
    print(f"device: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    t0 = time.time()
    logs = _build.build_all(_build.SOURCES + (PROBE_SOURCE,))
    print(f"device: kernels built in {time.time() - t0:.2f} s")
    for source, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"device: {source}: {line.strip()}")
    smem = {f"rdb_stage_mma / rdb_dx_stage_mma over {c} channels":
            rdb5c._library().rdb5c_stage_smem_bytes(1, c)
            for c in range(NF, NF + 4 * GC + 1, GC)}
    smem["rdb_streamed_stage_mma / rdb_dx_streamed_stage_mma, over 256 "
         "channels"] = rdb5c._library().rdb5c_stage_smem_bytes(1, 288)
    smem["rdb_stage_tf32 / rdb_dx_stage_tf32, any width"] = \
        rdb5c._library().rdb5c_stage_smem_bytes(0, NF)
    for dt, kernel in ((1, "dw_mma_kernel"), (0, "dw_tf32_kernel")):
        smem[kernel] = rdb5c._bwd_library().rdb5c_backward_dw_smem_bytes(dt)
    print("device: dynamic shared memory of the block kernels, bytes per "
          f"block: {smem}")
    forms = _instruction_forms(smi)
    _blur_sass_mix(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase_tf32_mma(smi)
    main_err, bwd_err = phase_kernels(smi)
    blur_err = phase_blur_kernel(smi)
    if flags.kernels_only:
        phase_times(smi, "", kernels_only=True)
        phase_blur_times(smi, flags.parent)
        print(smi)
        return 0
    with tempfile.TemporaryDirectory() as root:
        launches = phase_slice(smi, root)
        phase_g_compare(smi, root)
        phase_debug_configs(smi, root)
        train = phase_train(smi)
        phase_g_gradient(smi)
        producer = phase_producer(smi, root)
        phase_shuffle(smi, root)
        cli_counts = phase_cli(smi, root)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        rows = phase_times(smi, root)
        blur_rows = phase_blur_times(smi, flags.parent)
        phase_trace(smi, root, {k: r["step_ms"] for k, r in train.items()})
    kernels = _kernel_rows(rows, launches, train, main_err, bwd_err,
                           blur_rows, producer, blur_err, forms, cli_counts)
    print(f"chip_smoke: {time.time() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
