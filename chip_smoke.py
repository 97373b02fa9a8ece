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
   and the forward at phase 14's serving shape (b=8, 64x64: the trunk of
   128 px LRs unshuffled by 2);
   both again with every output and scratch buffer filled with NaN before
   the launch, and at other widths (``OTHER_WIDTHS``: nf 16 / gc 8 and nf
   48 / gc 16, which the wrappers pad to multiples of 32 and which are held
   to the unpadded plain versions; nf 64 and 128 with gc 64, whose widest
   bf16 stages stream their weights); the per-sample blur at the producer's
   two shapes (the HR and the LR canvas, k 21), at the LR canvas of the
   2x producer (32, 64, 64, 3) and at the shuffled
   program's two q-slices, at k 3 and 7 on the HR
   canvas, at ragged shapes with asymmetric kernels, k/2 close to h and a k
   past the instantiated ones, and an identity kernel bit for bit;
4. serving slice: ``python -m trainner_tpu_torch.test`` at the full width
   of the ESRGAN generator (nf 64, nb 23, gc 32, 4x) on a synthetic test
   set, in f32 and with ``use_amp``, then in f32 with ``x8`` and with
   ``chop``, each under a launch trace (``eval_step`` replays a CUDA graph
   of a shape after its ninth call); then the full G on the kernel against
   the same G on the plain version;
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
   time of the block kernels and the blur from the profiler (the forward
   also at phase 14's serving shape, the blur at its LR canvas), the block at
   the padded and the streamed widths at the training shape, and the G
   forward at b=8, 128->512 px. The f32 block kernels run 3xTF32: their
   bound is three tf32 products per f32 product at the tensor cores' tf32
   rate, printed beside the bound of the same work on the CUDA cores. With
   ``--parent DIR``, the blur kernel of the tree in DIR is timed beside
   this one's in turns; the blur also at the shuffled program's q-slices;
11. trace: one f32 G forward at b=8 and one train step (a graph replay)
   in bf16 and in f32 under ``torch.profiler``: device time by kernel and
   the device's idle share;
12. graphs (run before the times): the step, ``train_steps``, the
   degrader and ``eval_step`` as CUDA graphs (the default on the card)
   against the same programs run eagerly (``graphs=False``), in one
   process: 3 graphed against 3 eager steps in bf16 and f32 within the
   step tolerances of ``tests/test_torch_train_step.py`` (and how much of
   them is equal bit for bit, printed); the launches each graph recorded
   (69 + 69 block launches per step, 2 and 24 blur launches per degrader
   replay) against a profiler trace of one replay; fresh latent noise per
   replay (the statistical gate of ``tests/test_torch_trainer.py``); a
   resume into a captured state, bit for bit; ``train_steps`` k = 10 with
   a MultiStep boundary inside the window; the degrader from one
   generator state and plan stream; ``eval_step`` at b = 8 in f32 and
   bf16, x8 and chop on a 300 x 200 image (replaying their graphs)
   against the CPU's eager composition; and eager against graphed times
   of each with the device-busy ms and idle share, the captures' seconds
   and pool memory, the test CLI's seconds per image on a test set of one
   size per image and on one of one size, the end-to-end rate and the
   CLI's steady rate;
13. realesrgan (after the graphs): ``options/sr/train_realesrgan.yml`` at
   its full width (G nf 64, nb 23, gc 32; the U-Net D nf 64 with spectral
   norm; EMA; bf16; b=32, 32 -> 128 px): the ops it adds on the card
   against the CPU (sinc kernels, Poisson noise, the blur kernel against
   its plain version with sinc banks at the HR and LR canvases, the
   cv2-style resize codes 0-6, the EMA update bit for bit, the U-Net D in
   f32 with its spectral norms' state and gradients, also with cuDNN off,
   and where its conv3 weight gradient takes its error against f64: each
   conv's output and input gradient, conv3's weight gradient by each
   cuDNN setting and a plain product, with the kernels each ran); the
   resrgan degrader
   on stand-in stages, card against CPU bit for bit, and the real one's 4
   blur launches per batch (HR once, LR three times) from a trace; the
   degrader as a graph against eager; 3 graphed bf16 steps against 3
   eager ones (69 + 69 block launches per replay, from a trace), their
   times; the end-to-end rate; then the training CLI on a copy of the
   options (the corpus, 12 iterations, checkpoints with ``_emaG`` and
   validation at 6 and 12, a resume to 16 whose EMA and spectral-norm
   state load bit for bit), each step's launches read between markers;
14. zoo (after realesrgan): the SR generator options at full width.
   Real-ESRGAN's x2 generator (``scale: 2``, ``use_unshuffle``,
   ``mrrdb_net`` at its own 4x: nf 64, nb 23, gc 32, in_nc 12) served by
   the test CLI on 128 px LRs in f32, with ``use_amp``, with CEM (box and
   cubic, ``out_orig`` and ``out_keepY``), x8 and chop, each under a
   launch trace (69 block launches per G forward); the full G on the
   kernels against the plain versions; ``eval_step`` at b=8 graphed; its
   training step with ``network_D_preset: disc_esrgan`` (bf16, b=32, 64 ->
   128 px) as a graph against eager within the step tolerances, 69 + 69
   block launches per replay from a trace, its times; ``train_sr.yml``
   with the x2 layout and the D preset through the training CLI (12
   iterations, a resume to 16 that loads bit for bit); full-width
   ``sr_resnet`` card against CPU (f32 and bf16 forwards, 3 f32 steps
   with D-VGG-128 at b=4) and ESRGAN+ (``plus``: no block kernel) card
   against CPU;
15. degradations (after the zoo): the realsr and combo strategies and
   every on-device degradation op. A seeded KernelGAN-style kernel pool
   (``.npy`` 21 x 21, one 25 x 25, one ``.mat``) and noise PNGs; each op
   of the slice card against CPU (1e-5 or 1e-6 for the linear ones, bit
   for bit for median, quantize, dither, maxrgb, s&p and fringes, the
   share of differing pixels for k-means, SOM, SLIC and CLAHE); a
   degrader with every op no preset reaches, combo's (shuffled, with its
   pool and patches) and realsr's, each as a CUDA graph against its eager
   program, with its blur launches by shape and its times; the training
   CLI on ``train_sr.yml`` with combo (12 iterations and a resume to 16,
   31 blur launches per batch from the trace) and with realsr (6, no
   blur); the blur kernel's times for this slice's callers (the pool and
   motion banks, combo's routing slices, unsharp's k 11);
16. losses (after the degradations): the rest of the loss stack of
   ``train_sr.yml`` (its commented loss block switched on, with
   ``cx_type`` and ``hfen_criterion``: contextual, HFEN, tv, MS-SSIM,
   LPIPS on a seeded VGG19 file, wgan-gp with its gradient penalty on
   ``discriminator_vgg_128_sn``; validation with ``psnr,ssim,lpips`` on a
   seeded squeeze file). Each loss of the stack, the penalty and the LPIPS
   metric, card against the port's CPU result in f32 with TF32 off (the
   contextual loss also against an f64 run of the port's code, each side's
   distance from it read); the ResNet-101 and MINC feature losses card
   against CPU at b=4; the refusal of wgan-gp with a batch-norm D; the
   step at b=32, 32 -> 128 px, bf16, as a graph against eager (69 + 69
   block launches per replay from a trace), its times beside the flagship
   step's in turns, its peak memory and the device time of each added loss
   and of the penalty's pass; the training CLI on the yml (12 iterations
   and a resume to 16, 69 + 69 block and 24 blur launches per step from
   the trace, LPIPS in the validation) and its rate eager and graphed in
   turns;
17. trainer options (after the losses): every option of the JAX
   ``SRTrainer`` the port added in PR 13. Each at small widths (G nf 32,
   nb 1, gc 32; D-VGG 16 at 32 px; pixel and GAN losses; f32, TF32 off),
   steps on the card
   (graphed), the CPU and an f64 witness on the CPU's random draws
   (``_SharedDraws``): every optimizer, the auto clip, a virtual batch of
   2, FreezeD, fs, each DiffAugment policy, each batch augmentation,
   AdaTarget and SWA across their starts; then ``train_sr.yml`` at full
   width with its commented trainer options on (AdaTarget from 4, SWA from
   6, FreezeD, mixup, DiffAugment, fs, norm clip, a virtual batch of 2;
   bf16, b=32, crop 112: AdaTarget with D-VGG needs a multiple of 7 x
   scale), graphed against eager bit for bit over 8 steps across both
   starts, a replay of each program traced (69 x 2 + 69 x 2 block
   launches under the virtual batch, 69 + 69 under AdaTarget); the
   training CLI on it at crop 224 (the bsrgan jpeg needs an LR of a
   multiple of 8; 12 iterations and a resume to 16 that restores SWA, the
   LocNet, the clip history and every optimizer state, the launches per
   step from the trace), its ``16_swaG`` file served by the test CLI with
   ``which: swa``; and the graphed step with each optimizer, the auto
   clip, the virtual batch and the options cell against the flagship's, in
   turns.

18. the rest of the producer (after the options): the corpus written
   into an LMDB by the port's ``create_lmdb`` (every value decodes to its
   PNG bit for bit, a Paeth-filtered one too; the host's decode ms per
   sample of a PNG file, an LMDB value and a Paeth-filtered value); the
   training CLI on ``train_sr.yml`` with the LMDB as its train set (12
   iterations and a resume to 16, launches from the trace); the CLI with
   ``aug_downscale: 0.5`` and a ``subset_file`` of half the corpus (every
   sample from the subset); the graphed step fed by the folder and the
   LMDB in turns (it/s); a ``WeightedMultiLoader`` over [folder, LMDB]
   with weights [3, 1] through the graphed step, the batches from each;
   ``otf_mode: host`` with gaussian ``lr_noise``: the host ms per sample,
   the device degrader still after it (its LR made anew from HR, so the
   host's LR is thrown away, bit for bit: ROADMAP C 20), its steps under
   a trace, and without OpenCV each OpenCV op's named error;
19. models (after phase 18): PPON (nf 64, nb 24), PAN (nf 40, unf 24, nb
   16, with self-attention) and A2N at full width, each forward card
   against CPU in f32 and bf16 (every PPON output); the training CLI on
   ``train_sr.yml`` with ``model: ppon``, ``ppon_stages`` [4, 8] and the
   losses its phases select (contextual and the GAN on D-VGG-128 in phase
   3), 12 iterations through the three phases and a resume to 16, its G
   served by the test CLI at ``ppon_phase`` 3 and 1; six PPON steps
   graphed against eager bit for bit, the frozen branches bit-equal across
   each; one f32 step per phase at cut depth (nb 1) on the card, the CPU
   and an f64 witness; PAN through the ``sr`` training CLI (12 and a
   resume to 16); the three models' serving Mpx/s at b=8, 128 -> 512 px.

Launches: the kernel wrappers count where they put a kernel on a stream,
eagerly or into a graph being captured (a replay runs no Python). What the
card ran is read from a profiler trace of each main-path run
(``_launch_trace``: the wrappers' counts set to 0 just before it, the
kernels counted by name in the trace, replays included, with markers on
the stream between a CLI's steps); the phases check those launches, and
that every wrapper of the path counted too. The JSON summary gives the
traced launches over the main paths' runs, the wrappers' counts beside.
``_device_ms`` gives "not measured" rather than a sum with fewer
launches than the calls made.

The second-to-last lines are a JSON summary of the kernels and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py [--parent DIR]
       python3 chip_smoke.py --only 18,19   (phase 18 and/or 19 alone,
           after the build and the corpus; no result line)
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
# phase 14 (zoo): the unshuffled mrrdb_net's trunk when serving b=8 128 px
# LRs (64x64 after the unshuffle by 2), and the LR canvas of the bsrgan
# producer at scale 2 (HR 128 -> LR 64)
ZOO_SERVE_SHAPE = (8, 64, 64)
ZOO_LR_CANVAS = (32, 64, 64, 3)
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
N_IMAGES = 10  # eval_step captures at the 9th image of one size
BWD_NAMES = ("dx", "dW0", "dW1", "dW2", "dW3", "dW4",
             "db1", "db2", "db3", "db4", "db5")


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _reset_launches() -> None:
    """Every kernel wrapper's launch count to 0."""
    from trainner_tpu_torch.ops import blur, rdb5c

    rdb5c.launches = rdb5c.backward_launches = blur.launches = 0


def _counted() -> dict:
    """The kernel wrappers' own counts since ``_reset_launches``: each
    adds one where it puts its kernel on a stream, eagerly or into a graph
    being captured, and nowhere else. A replay runs no Python, so under
    graphs these are not the launches the card ran: ``_launch_trace``
    reads those."""
    from trainner_tpu_torch.utils import graphs

    return graphs.kernel_launches()


def _short_name(name: str) -> str:
    return name.removeprefix("void ").replace(
        "(anonymous namespace)::", "").split("(")[0].split("<")[0]


def _device_events(prof) -> list:
    """The device's records in a finished ``_profiled`` session: (start
    ns, duration ns, name) in the order the host launched them (each
    kernel of a graph's replay at the replay's launch, found by the
    CUDA call's correlation id), without the markers that open the
    session; read from the profiler's raw results (parsing them into
    ``prof.events()`` takes about 60 us per record). The device's own
    start times do not keep that order: the kernels of a replay are
    recorded on streams of the graph's own, and one run had a replay's
    blur kernels start before the marker launched ahead of it."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    launched = {e.correlation_id(): e.start_ns() for e in raw
                if e.device_type() != DeviceType.CUDA
                and e.name().startswith("cu")}
    events = [(e.start_ns(), e.duration_ns(), e.name()) for e, _ in sorted(
        ((e, launched.get(e.correlation_id(), e.start_ns())) for e in raw
         if e.device_type() == DeviceType.CUDA),
        key=lambda pair: (pair[1], pair[0].start_ns()))]
    first = 0
    while first < len(events) and MARKER in events[first][2]:
        first += 1
    return events[first:]


@contextlib.contextmanager
def _profiled(cpu: bool = False):
    """torch.profiler over the body: the device's activity (and the
    host's, with ``cpu``), the body starting 0.3 s after
    ``OPENING_MARKERS`` markers. The profiler drops the first records of
    a session (on the H100, now and then every launch of a short timing
    session that launched at once; with a pause of 0.1 s, once the eager
    first step of a debug-width training session; with three markers and
    0.3 s, late in a whole run of this script, the first 21-23 records of
    a step's replay, two of them block stages, while a fresh process lost
    none); the markers take their place, and the body runs after the
    pause."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for _ in range(OPENING_MARKERS):
            _mark()
        torch.cuda.synchronize()
        time.sleep(0.3)
        yield prof
        torch.cuda.synchronize()


def _calls_per_wrapper(names) -> dict:
    """Kernel names in a trace -> calls of the kernel wrappers: five stage
    kernels per block forward (``rdb_*`` but ``rdb_dx_*``), one dW kernel
    per block backward, one blur kernel per blur."""
    stages = dw = blur = 0
    for name in names:
        short = _short_name(name)
        if short.startswith("rdb_") and "_dx_" not in short:
            stages += 1
        elif short.startswith("dw_"):
            dw += 1
        elif short == "blur_kernel":
            blur += 1
    return {"rdb5c": stages // 5 if stages % 5 == 0 else stages / 5,
            "rdb5c_bwd": dw, "blur": blur}


MARKER = "spin_kernel"
OPENING_MARKERS = 128  # per profiler session, ahead of the body


def _mark() -> None:
    """A marker on the current stream that a trace shows between the work
    before it and the work after it (``torch.cuda._sleep``'s one-block
    ``spin_kernel``, a few cycles long)."""
    import torch

    torch.cuda._sleep(1)


@contextlib.contextmanager
def _launch_trace(want: dict = None, fresh: bool = True, label: str = ""):
    """Runs the body under torch.profiler, the device's activity only (the
    kernels of graph replays included), with every wrapper's count set to
    0 just before it. Yields a dict that, after the body, holds ``ran``,
    the launches of each kernel in the trace by wrapper (what the card
    ran), ``counted``, the wrappers' own counts over the body, and
    ``segments``, ``ran`` between the ``_mark`` markers. With ``want``
    ({wrapper: launches}), ``ran`` must equal it and, when ``fresh`` (the
    body captured its graphs), every wrapper with launches must have
    counted some too."""
    out = {}
    with _profiled() as prof:
        _reset_launches()
        yield out
    out["counted"] = _counted()
    names = [name for _, _, name in _device_events(prof)]
    out["ran"] = _calls_per_wrapper(names)
    cuts = [i for i, n in enumerate(names) if MARKER in n]
    out["segments"] = [_calls_per_wrapper(names[a + 1:b]) for a, b in
                       zip([-1] + cuts, cuts + [len(names)])]
    if want is not None:
        want = {k: want.get(k, 0) for k in out["ran"]}
        idle = [k for k, n in want.items() if n and fresh
                and not out["counted"][k]]
        if out["ran"] != want or idle:
            raise AssertionError(
                f"{label}: the card ran {out['ran']}, expected {want}; the "
                f"wrappers counted {out['counted']}")


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
    the later stages: two bf16 ulps at dx's largest magnitude; dW is an
    f32 sum over thousands of pixels of which a few differ by such a
    rounding: 2^-11 of its largest magnitude. db_k sums da_k alone, so one
    da_k that rounds the other way on either side moves it by a whole ulp
    of that da_k, up to 2^-7 of max|da_k|; over one 21 x 45 image max|db_k|
    is only 10-15 times max|da_k|, and one such rounding at the top on
    each side reads 1.06-1.17 ulps of max|da_1| (2^-11.2 to 2^-10.8 of
    max|db_1|; H100, scripts/rdb5c_bwd_repeat.py): 2^-10 of its largest
    magnitude."""
    import torch

    top = float(ref.abs().max())
    if dtype == torch.float32:
        return (2e-6 if name == "dx" else 1e-4) * top
    if name == "dx":
        return 2 * _bf16_ulp(ref)
    return top * 2.0 ** (-10 if name.startswith("db") else -11)


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
    # cuDNN's default transposed and weight-gradient convs differ from run
    # to run (scripts/rdb5c_bwd_repeat.py); its deterministic ones repeat
    cudnn = torch.backends.cudnn
    saved, cudnn.deterministic = cudnn.deterministic, True
    try:
        ref_b = rdb5c_backward_plain(gd, xd, *cut[1:], packed)
    finally:
        cudnn.deterministic = saved
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
    # phase 14's serving shape, from a generator of its own: the draws
    # above and below stay those the earlier slices were held on
    x = (torch.randn(*ZOO_SERVE_SHAPE, NF,
                     generator=torch.Generator().manual_seed(14)) * 0.5)
    for dt in (torch.float32, torch.bfloat16):
        _compare_block(ZOO_SERVE_SHAPE, dt, x.cuda(), None, ws, bs, "")
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


def _sinc_banks(gen, b: int, k: int = BLUR_K):
    """resrgan's sinc kernels (b, k, k) on the card: random odd supports
    7 to k and cutoffs as its blur stages draw them, from a CPU
    generator."""
    from trainner_tpu_torch.ops import degradations as D

    return D.sinc_kernels(D.draw_sinc_kernels(gen, b, k, None, 7), k).cuda()


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
                     ((3, 40, 9, 3), 17), ((2, 30, 30, 3), 25),
                     (ZOO_LR_CANVAS, BLUR_K)):
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
    1e-4, which would hide the trunk from the comparison), dense layers'
    too, and a self-attention's ``gamma`` at 0.5 (0 at init, which would
    hide the attention)."""
    import torch

    from trainner_tpu_torch.ops.blocks import (Dense, SelfAttentionBlock,
                                               _Conv, kaiming_init_)

    gen = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, SelfAttentionBlock):
            with torch.no_grad():
                m.gamma.fill_(0.5)
        if isinstance(m, Dense):
            with torch.no_grad():
                m.weight.copy_(kaiming_init_(torch.empty(m.weight.shape),
                                             0.7, gen))
        if isinstance(m, _Conv):
            with torch.no_grad():  # drawn on the CPU, wherever net lies
                m.weight.copy_(kaiming_init_(torch.empty(m.weight.shape),
                                             0.7, gen))
                if m.bias is not None:
                    m.bias.copy_(torch.empty(m.bias.shape).normal_(
                        0.0, 0.01, generator=gen))


def phase_slice(smi: str, root: str) -> dict:
    """The main path: the test CLI in f32 and bf16, then in f32 with
    ``x8: true`` (eight forwards per image) and with ``chop: true`` (one
    128 x 128 tile per image), each run under a launch trace. Returns the
    launches the card ran and the wrappers counted, over all runs."""
    import torch

    from trainner_tpu_torch import test as test_cli

    per_forward = NB * 3
    runs = [(_options(root, name="smoke_f32"), 1),
            (_options(root, name="smoke_bf16", use_amp=True), 1),
            (_options(root, name="smoke_x8", x8=True), 8),
            (_options(root, name="smoke_chop", chop=True), 1)]
    total = {"ran": 0, "counted": 0}
    for path, forwards in runs:
        t0 = time.time()
        want = {"rdb5c": per_forward * forwards * N_IMAGES}
        with _launch_trace(want, label=os.path.basename(path)) as t:
            averages = test_cli.main(["-opt", path])
        secs = time.time() - t0
        vals = {m["name"]: m["average"] for m in averages["synth"]}
        print(f"slice: {os.path.basename(path)} {N_IMAGES} images in "
              f"{secs:.2f} s (traced), launches the card ran "
              f"{t['ran']['rdb5c']} ({per_forward} per G forward x "
              f"{forwards} x {N_IMAGES}), the wrapper counted "
              f"{t['counted']['rdb5c']}, metrics {vals}")
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"metrics not finite: {vals}")
        pngs = os.listdir(os.path.join(root, "results",
                                       os.path.basename(path)[:-5], "synth"))
        if len([p for p in pngs if p.endswith(".png")]) != N_IMAGES:
            raise AssertionError(f"PNGs written: {pngs}")
        total["ran"] += t["ran"]["rdb5c"]
        total["counted"] += t["counted"]["rdb5c"]
    return total


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
        with _launch_trace({"rdb5c": per_g * n_img},
                           label="debug serving") as t:
            averages = test_cli.main(["-opt", path])
        vals = {m["name"]: m["average"] for v in averages.values()
                for m in v}
        print(f"debug: {os.path.basename(DEBUG_TEST_YML)} G (nf "
              f"{g_opt['nf']}, nb {g_opt['nb']}, gc {g_opt['gc']}) served, "
              f"use_amp {use_amp}: {n_img} images, launches the card ran "
              f"{t['ran']['rdb5c']}, metrics {vals}")
        if not vals or not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"debug serving: metrics {vals}")

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
        with _launch_trace({"rdb5c": 2 * per_g, "rdb5c_bwd": 2 * per_g},
                           label="debug training") as t:
            for _ in range(2):
                state, logs = trainer.train_step(state, batch)
        vals = {k: float(v) for k, v in logs.items()}
        moved, total = _count_moved(state.g.net, g0, lambda k: True)
        print(f"debug: {os.path.basename(DEBUG_TRAIN_YML)} G and D, "
              f"{trainer.dtype}, b={b} {hr_px // 4}->{hr_px} px, 2 steps: "
              f"launches the card ran {t['ran']}, G tensors moved {moved} "
              f"of {total}, logs {vals}")
        if moved != total or not all(math.isfinite(v)
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
    training default) and in f32, the first steps of each under a launch
    trace, and the step's time. Returns by type name the step's ms and the
    traced steps' launches (``ran``, ``counted``)."""
    import torch

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
        with _launch_trace({"rdb5c": per_g * n_check,
                            "rdb5c_bwd": per_g * n_check},
                           label=f"train {name}") as t:
            for _ in range(n_check):
                state, logs = trainer.train_step(state, batch)
        vals = {k: float(v) for k, v in logs.items()}
        print(f"train: {name} b={batch['LR'].shape[0]} "
              f"{TRAIN_SHAPE[1]}->{TRAIN_SHAPE[1] * 4} px, {n_check} steps: "
              f"launches the card ran {t['ran']} ({per_g} per G forward "
              f"and per G update x {n_check}), the wrappers counted "
              f"{t['counted']}, logs {vals}")
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
        result[name] = dict(step_ms=step_ms, ran=t["ran"],
                            counted=t["counted"])
        del trainer, state
        torch.cuda.empty_cache()

    # D_update_ratio 2: the second step updates D only
    trainer = create_trainer(_train_options(D_update_ratio=2))
    state = trainer.init_state(1)
    for step, (want_f, want_b) in enumerate(((per_g, per_g), (per_g, 0))):
        g0 = _snapshot(state.g.net)
        with _launch_trace({"rdb5c": want_f, "rdb5c_bwd": want_b},
                           label=f"D_update_ratio 2, step {step}") as t:
            state, logs = trainer.train_step(state, batch)
        moved, _ = _count_moved(state.g.net, g0, lambda k: True)
        print(f"train: D_update_ratio 2, step {step}: launches the card "
              f"ran {t['ran']}, G tensors moved {moved}, logs "
              f"{sorted(logs)}")
        if bool(moved) != bool(want_b) \
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

    # eager calls: the wrapper's count is what the card ran
    before = _counted()["rdb5c_bwd"]
    got = grads()
    if _counted()["rdb5c_bwd"] - before != NB * 3:
        raise AssertionError("the G stage did not run the backward kernel")
    with _plain_blocks():
        ref = grads()
    if _counted()["rdb5c_bwd"] - before != NB * 3:
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
    """The end-to-end path at full width, bf16: loader -> prefetch ->
    degradations -> train_step, its first 3 steps under a launch trace,
    then 10 timed steps; the same with the shuffled degrader. Returns the
    launch traces of both orders."""
    import torch

    from trainner_tpu_torch.data import create_dataloader, create_dataset
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

    # the first steps (the degrader's and the step's captures, then
    # replays) under a launch trace, then timed steps without it
    n_traced = 3
    with _launch_trace({"blur": 2 * n_traced, "rdb5c": per_g * n_traced,
                        "rdb5c_bwd": per_g * n_traced},
                       label="producer, fixed order") as traced:
        for _ in range(n_traced):
            batch, logs = e2e_step()
    print(f"producer: {n_traced} end-to-end steps from the start: launches "
          f"the card ran {traced['ran']} (2 blur launches per batch, "
          f"{per_g} + {per_g} block launches per step), the wrappers "
          f"counted {traced['counted']}")
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        batch, logs = e2e_step()
    torch.cuda.synchronize()
    e2e_ms = (time.perf_counter() - t0) / n_timed * 1e3
    vals = {k: float(v) for k, v in logs.items()}
    print(f"producer: {n_timed} timed end-to-end steps, logs {vals}")
    if not all(math.isfinite(v) for v in vals.values()):
        raise AssertionError(f"logs {vals}")

    # the same path with the stage order drawn per sample (the routed
    # program: blur and blur2 once per slot and pass, on q-slices); its
    # degrader captures in the trace, the step's graph replays
    degrade_fixed = degrade
    degrade = make_otf_degradation(
        parse_dict(_e2e_options(corpus, shuffle=True), is_train=True),
        generator=gen)
    per_batch = 2 * 2 * SHUFFLE_K
    with _launch_trace({"blur": per_batch * n_traced,
                        "rdb5c": per_g * n_traced,
                        "rdb5c_bwd": per_g * n_traced}, fresh=False,
                       label="producer, shuffled") as traced_sh:
        for _ in range(n_traced):
            batch, logs = e2e_step()
    print(f"producer: {n_traced} shuffled end-to-end steps from the "
          f"degrader's start: launches the card ran {traced_sh['ran']} "
          f"({per_batch} blur launches per batch), the wrappers counted "
          f"{traced_sh['counted']}")
    if not traced_sh["counted"]["blur"]:
        raise AssertionError("the shuffled degrader's wrapper counted no "
                             "blur launch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        batch, logs = e2e_step()
    torch.cuda.synchronize()
    e2e_sh_ms = (time.perf_counter() - t0) / n_timed * 1e3
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
    return {"fixed order": traced, "shuffled": traced_sh}


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

        D.apply_kernels = spy
        try:
            with _launch_trace({"blur": per_batch},
                               label=f"bsrgan {label}") as t:
                y = deg(gen, x_u8)
        finally:
            D.apply_kernels = orig
        launches = t["ran"]["blur"]
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


def _cli_options(root: str, corpus: str, yml: str = None,
                 name: str = "cli", edit=None, niter: int = CLI_NITER) -> str:
    """An options file of the repo (``options/sr/train_sr.yml`` unless
    ``yml``) as written, read by the port's reader, but for ``edit``
    (applied to the options dict), its data roots (the corpus; a
    validation set of ``N_VAL`` corpus images and their bicubic LR at the
    options' scale, written here), ``niter``, the frequencies and
    ``path.root`` (``root/name``; the other ``path`` keys as the file and
    ``edit`` left them). ``corpus`` may be another form of the corpus (its
    LMDB); the validation set comes from the PNGs of ``root/corpus``.
    Returns the path of the options file."""
    import numpy as np

    from trainner_tpu_torch.data.common import decode_image, save_img
    from trainner_tpu_torch.ops.imresize import imresize_np

    opt = read_options_yml(yml or TRAIN_YML)
    if edit is not None:
        edit(opt)
    scale = int(opt.get("scale") or 4)
    val_hr = os.path.join(root, "val_HR")
    val_lr = os.path.join(root, "val_LR" if scale == 4
                          else f"val_LR_x{scale}")
    os.makedirs(val_hr, exist_ok=True)
    if not os.path.isdir(val_lr):
        os.makedirs(val_lr)
        pngs = os.path.join(root, "corpus")  # the PNGs, whatever the train set
        for img in sorted(os.listdir(pngs))[:N_VAL]:
            hr = decode_image(os.path.join(pngs, img))
            save_img(hr, os.path.join(val_hr, img))
            lr = imresize_np(hr.astype(np.float32) / 255.0, 1.0 / scale,
                             kernel="cubic")
            save_img((lr * 255.0).round().astype(np.uint8),
                     os.path.join(val_lr, img))
    opt["datasets"]["train"]["dataroot_HR"] = corpus
    opt["datasets"]["val"].update(dataroot_HR=val_hr, dataroot_LR=val_lr)
    opt["train"].update(niter=niter, val_freq=CLI_FREQ)
    opt["logger"].update(print_freq=2, save_checkpoint_freq=CLI_FREQ)
    opt["path"] = {**(opt.get("path") or {}),
                   "root": os.path.join(root, name)}
    path = os.path.join(root, f"{name}_options.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    return path


def _state_tensors(state) -> dict:
    """Every tensor a checkpoint carries, on the host: both nets'
    state_dicts (D's running statistics or spectral norms' state
    included), every optimizer's state lists and counts, the EMA and SWA
    weights, the LocNet and the clip history."""
    out = {"step": state.step}
    for which in ("g", "d", "loc"):
        ns = getattr(state, which)
        if ns is None:
            continue
        for k, v in ns.net.state_dict().items():
            out[f"{which}.{k}"] = v.detach().cpu().clone()
        opt = ns.opt.state_dict()
        for key, v in opt.items():
            if isinstance(v, int):
                out[f"{which}.{key}"] = v
            else:
                for i, t in enumerate(v):
                    out[f"{which}.{key}.{i}"] = t.detach().cpu().clone()
    for k, v in (state.ema_params or {}).items():
        out[f"ema.{k}"] = v.detach().cpu().clone()
    if state.swa is not None:
        for k, v in state.swa.named_parameters():
            out[f"swa.{k}"] = v.detach().cpu().clone()
        out["swa_n"] = int(state.swa_n)
    for k, v in (state.grad_hist or {}).items():
        out[f"grad_hist.{k}"] = v.detach().cpu().clone()
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


def phase_cli(smi: str, root: str, yml: str = None, label: str = "cli",
              per_batch: int = 2 * 2 * SHUFFLE_K,
              nets: tuple = ("G", "D"), edit=None, niter: int = CLI_NITER,
              resume: bool = True, g_launches=None, corpus: str = None,
              trainer_cls=None, val_launches: int = None) -> dict:
    """The training CLI at the full width of an options file of the repo
    (``yml``; by default ``options/sr/train_sr.yml``: G nf 64, nb 23, gc
    32, D-VGG-128, batch 32, crop 128, bsrgan with the per-sample shuffle,
    bf16), ``trainner_tpu_torch.train.main`` on the card for 12 iterations
    with checkpoints (one file per net of ``nets``) and validation at 6
    and 12; then a second ``main`` that resumes from ``training_state/`` to
    16, whose loaded state must equal the saved one bit for bit. Each run
    under a launch trace: the three kernels' launches per step, per batch
    (``per_batch`` blur launches) and in all. ``niter`` (a multiple of 6)
    and ``resume`` shorten it. ``g_launches(n)``: the forward (and
    backward) block launches of step n where they are not 69 (a virtual
    batch runs G once per microbatch). ``corpus`` replaces the train set
    (``root/corpus``); ``trainer_cls`` is the trainer whose ``train_step``
    the markers wrap (``SRTrainer``); ``val_launches`` the block launches
    of one validation forward (69). Returns the runs' traces."""
    import torch

    from trainner_tpu_torch.train import cli
    from trainner_tpu_torch.train.sr_trainer import SRTrainer
    from trainner_tpu_torch.utils import checkpoint

    corpus = corpus or os.path.join(root, "corpus")
    opt_path = _cli_options(root, corpus, yml, label, edit, niter)
    per_g = NB * 3
    per_val = per_g if val_launches is None else val_launches
    cls = trainer_cls or SRTrainer
    with open(opt_path) as f:
        exp = os.path.join(root, label, "experiments", json.load(f)["name"])
    rec = {"steps": [], "save": [], "val": [], "loaded": None}
    orig = (cls.train_step, checkpoint.save_checkpoint, cli.validate,
            checkpoint.load_state)

    def train_step(self, state, batch):
        # a marker on the stream before and after each step: the trace's
        # launches between them are the step's own
        step = state.step
        start = time.perf_counter()
        _mark()
        out = orig[0](self, state, batch)
        _mark()
        if step + 1 == niter:
            torch.cuda.synchronize()
            rec["end"] = time.perf_counter()
        rec["steps"].append((step + 1, start))
        return out

    def timed(fn, key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec[key].append((t0, time.perf_counter() - t0))
            return out
        return run

    def load_state(path, state):
        state, meta = orig[3](path, state)
        rec["loaded"] = (path, meta, _state_tensors(state))
        return state, meta

    def run(argv):
        rec["steps"].clear()
        t0 = time.perf_counter()
        with _launch_trace() as t:
            state = cli.main(argv)
        return state, t, time.perf_counter() - t0

    cls.train_step = train_step
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
        if resume:
            with open(opt_path) as f:
                opt2 = json.load(f)
            opt2["train"]["niter"] = CLI_RESUME_NITER
            opt2["path"]["resume_state"] = os.path.join(exp,
                                                        "training_state")
            opt2_path = os.path.join(root, f"{label}_resume.json")
            with open(opt2_path, "w") as f:
                json.dump(opt2, f)
            state2, counts2, wall2 = run(["-opt", opt2_path])
            steps2 = list(rec["steps"])
    finally:
        (cls.train_step, checkpoint.save_checkpoint, cli.validate,
         checkpoint.load_state) = orig

    # the first run: launches per step and per batch, and in all, from
    # its trace; between the markers: before step 1 its batch's degrader,
    # then each step, then the next batch's degrader (after a validation
    # at 6, its forwards too), and after step 12 the validation at 12
    n_val = niter // CLI_FREQ * N_VAL  # validation every CLI_FREQ
    per_step = g_launches or (lambda n: per_g)
    g_run = sum(per_step(n) for n in range(1, niter + 1))
    want = dict(blur=per_batch * niter,
                rdb5c=g_run + per_val * n_val,
                rdb5c_bwd=g_run)
    _check_cli_trace(label, counts, want, steps, range(1, niter + 1),
                     per_val, per_batch, per_step)
    print(f"{label}: main() on {niter} iterations, {wall:.2f} s (traced): "
          f"launches the card ran {counts['ran']} (expected {want}); the "
          f"wrappers counted {counts['counted']}")
    print(f"{label}: every step's block launches (forward, backward) "
          f"{sorted({(per_step(n), per_step(n)) for n in range(1, niter + 1)})}"
          f" and its batch's {per_batch} blur launches before it ({niter} "
          f"steps, from the trace)")

    # the artifacts
    files = {os.path.relpath(os.path.join(d, f), exp)
             for d, _, fs in os.walk(exp) for f in fs}
    need = {f"models/{t}_{n}.ckpt" for t in (CLI_FREQ, niter)
            for n in nets} | {f"training_state/{t}.state{e}"
                              for t in (CLI_FREQ, niter)
                              for e in ("", ".json")} \
        | {"tb/scalars.jsonl"}
    names = [os.path.splitext(n)[0] for n in
             sorted(os.listdir(os.path.join(root, "val_HR")))]
    need |= {f"val_images/{n}/{n}_{t}.png" for n in names
             for t in (CLI_FREQ, niter)}
    if need - files:
        raise AssertionError(f"{label}: missing {sorted(need - files)}")
    sizes = {f: os.path.getsize(os.path.join(exp, f)) for f in sorted(files)
             if f.startswith((f"models/{niter}_",
                              f"training_state/{niter}."))}
    print(f"{label}: artifacts present ({len(files)} files); sizes {sizes}")
    rows = [json.loads(line) for line in
            open(os.path.join(exp, "tb", "scalars.jsonl"))]
    tags = {(r["tag"], r["step"]) for r in rows}
    if not ({("train/l_g_total", s) for s in range(2, niter + 1, 2)}
            | {("val/psnr", CLI_FREQ), ("val/psnr", niter)}) <= tags \
            or not all(math.isfinite(r["value"]) for r in rows):
        raise AssertionError(f"{label}: the JSONL scalars are incomplete")
    psnr = [r["value"] for r in rows if r["tag"] == "val/psnr"]
    print(f"{label}: {len(rows)} JSONL scalars, all finite; val psnr {psnr}")

    # times: from the start of step 3 to the end of the last step
    # (synchronised there), with and without the saves and validations
    # inside that span
    span = rec["end"] - steps[2][1]
    steady = span - sum(d for t0, d in rec["save"] + rec["val"]
                        if steps[2][1] <= t0 < rec["end"])
    n = niter - 2
    save_ms = [d * 1e3 for _, d in rec["save"]]
    val_ms = [d * 1e3 for _, d in rec["val"]]
    print(f"times: {label} main() steps 3-{niter} on the host clock, "
          f"under the launch trace: "
          f"{steady * 1e3 / n:.3f} ms per iteration, {n / steady:.4f} it/s "
          f"steady; {span * 1e3 / n:.3f} ms, {n / span:.4f} it/s with the "
          f"save and validation at {CLI_FREQ} ({smi})")
    print(f"times: {label} save_checkpoint ({', '.join(nets)}, state; "
          f"synchronised) "
          f"{', '.join(f'{t:.1f}' for t in save_ms)} ms; of a state file "
          f"({save_parts['mb']:.1f} MB): to host trees "
          f"{save_parts['host_ms']:.1f} ms, encoded and written "
          f"{save_parts['write_ms']:.1f} ms; validation "
          f"{', '.join(f'{t / N_VAL:.1f}' for t in val_ms)} ms per image "
          f"({N_VAL} images to {CORPUS_PX} px) ({smi})")

    if not resume:
        print(f"{label}: ok ({smi})")
        return {"run": counts}

    # the resumed run
    path, meta, loaded = rec["loaded"]
    diff = [k for k in saved if not (
        torch.equal(saved[k], loaded[k]) if isinstance(saved[k],
                                                       torch.Tensor)
        else saved[k] == loaded[k])]
    n2 = CLI_RESUME_NITER - niter
    g_run2 = sum(per_step(n) for n in range(niter + 1,
                                            CLI_RESUME_NITER + 1))
    want2 = dict(blur=per_batch * n2, rdb5c=g_run2, rdb5c_bwd=g_run2)
    _check_cli_trace(f"{label} resume", counts2, want2, steps2,
                     range(niter + 1, CLI_RESUME_NITER + 1), per_val,
                     per_batch, per_step)
    print(f"{label}: resumed from {os.path.relpath(path, exp)} (iter "
          f"{meta['iter']}, epoch {meta['epoch']}) to {state2.step} in "
          f"{wall2:.2f} s (traced): {len(saved)} tensors and counts of the "
          f"saved state, {len(diff)} differ after loading; launches the "
          f"card ran {counts2['ran']}, the wrappers counted "
          f"{counts2['counted']}")
    if diff or meta["iter"] != niter or state2.step != CLI_RESUME_NITER \
            or not os.path.exists(os.path.join(
                exp, "models", f"{CLI_RESUME_NITER}_G.ckpt")):
        raise AssertionError(f"{label} resume: differs {diff[:5]}, meta {meta},"
                             f" step {state2.step}")
    del state2
    torch.cuda.empty_cache()
    print(f"{label}: ok ({smi})")
    return {"run": counts, "resumed": counts2}


def _check_cli_trace(label: str, trace: dict, want: dict, steps: list,
                     numbers, per_g: int, per_batch: int,
                     per_step=None) -> None:
    """A training CLI run's launch trace: what the card ran in all equals
    ``want``, every wrapper counted, and between the markers around the
    steps (numbered ``numbers``) each step ran ``per_g`` forward and
    backward block launches and no blur, and before it its batch's
    ``per_batch`` blur launches (with a validation's forwards where one
    ran there); ``per_step(n)`` gives step n's block launches where they
    are not ``per_g``."""
    ran, segments = trace["ran"], trace["segments"]
    numbers = list(numbers)
    per_step = per_step or (lambda n: per_g)
    idle = [k for k, n in want.items() if n and not trace["counted"][k]]
    if ran != want or idle or [s for s, _ in steps] != numbers \
            or len(segments) != 2 * len(numbers) + 1:
        raise AssertionError(
            f"{label}: the card ran {ran}, expected {want}; the wrappers "
            f"counted {trace['counted']}; steps {[s for s, _ in steps]}; "
            f"{len(segments)} segments between markers")
    for i, number in enumerate(numbers):
        before, step = segments[2 * i], segments[2 * i + 1]
        g = per_step(number)
        if step != {"rdb5c": g, "rdb5c_bwd": g, "blur": 0} \
                or before["blur"] != per_batch or before["rdb5c_bwd"] \
                or (before["rdb5c"] % per_g if per_g else before["rdb5c"]):
            raise AssertionError(
                f"{label} step {number}: {step} in the step, {before} "
                f"before it")


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
    # phase 14's serving shape draws from a generator of its own
    zoo_gen = torch.Generator().manual_seed(14)
    rows = {}
    for shape in (MAIN_SHAPE, TRAIN_SHAPE, ZOO_SERVE_SHAPE):
        b, h, w = shape
        npix = b * h * w
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).replace("torch.", "")
            g_draw = zoo_gen if shape == ZOO_SERVE_SHAPE else gen
            blk = ResidualDenseBlock5C(NF, GC)
            ws, bs = _block_weights(g_draw)
            with torch.no_grad():
                for conv, wt, bt in zip(blk.convs(), ws, bs):
                    conv.weight.copy_(wt)
                    conv.bias.copy_(bt)
            blk = blk.cuda()
            packed, biases = blk.packed(dt)
            x = (torch.randn(b, h, w, NF, generator=g_draw) * 0.5
                 ).cuda().to(dt)
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
            if shape == ZOO_SERVE_SHAPE:
                # a serving shape: the forward alone, on the device too
                fwd_k = (BF16_BLOCK_KERNELS if dt == torch.bfloat16
                         else F32_BLOCK_KERNELS)["rdb5c.cu"][0]
                with torch.no_grad():
                    row["device_ms"] = _device_ms(
                        lambda: rdb5c_forward(x, packed, biases), fwd_k)
                print(f"times: {name} forward kernel b={b} {h}x{w} on the "
                      f"device alone (profiler, per block): {fwd_k} "
                      f"{_ms_text(row['device_ms'])} ms ({smi})")
                del blk, conv_blk
                continue

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
                  + ", ".join(f"{k} {_ms_text(v)} ms" for k, v in dev.items())
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
                  f"the device {_ms_text(dev[0])}), backward {bwd_ms:.4f} ms "
                  f"(dx "
                  f"{_ms_text(dev[1])} + dW {_ms_text(dev[2])}); bound of the "
                  f"block's "
                  f"own work: forward {fwd_bound['bound_ms']:.4f} ms, "
                  f"backward {bwd_bound['bound_ms']:.4f} ms ({smi})")
        del blk


def _session_events(fn, calls: int) -> list:
    """The device's records of ``calls`` calls of ``fn`` in one
    ``_profiled`` session."""
    with _profiled() as prof:
        for _ in range(calls):
            fn()
    return _device_events(prof)


def _matched(events, match: str) -> tuple:
    """(records, summed ns) of the records whose name holds ``match``."""
    spans = [d for _, d, name in events if match in name]
    return len(spans), sum(spans)


def _device_ms(fn, match: str, calls: int = 10, session=None):
    """Device time per call of ``fn``, under torch.profiler, of the kernels
    whose name holds ``match`` (all their launches in one call added up),
    over ``calls`` calls. The launches of one call are read from a first
    traced call; a session of ``calls`` calls must hold ``calls`` times as
    many records, or it lost some and another session runs. A session that
    holds more (the first traced call lost records) sets the count per
    call, which the next session must meet. After three sessions short of
    the count, None (not measured), never a short sum. ``session(fn, n)``
    gives the records of n calls (``_session_events`` unless a test hands
    in a stub)."""
    if session is None:
        import torch

        fn()
        torch.cuda.synchronize()
        session = _session_events
    per_call = 0
    for _ in range(3):
        per_call = _matched(session(fn, 1), match)[0]
        if per_call:
            break
    if not per_call:
        return None
    for _ in range(3):
        n, ns = _matched(session(fn, calls), match)
        if n == calls * per_call:
            return ns / calls / 1e6
        if n > calls * per_call and n % calls == 0:
            per_call = n // calls
    return None


def _ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


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


def _library_blur(x, kern):
    """The library call that computes the blur: reflect ``F.pad`` and one
    grouped cuDNN convolution over b*c groups."""
    import torch.nn.functional as F

    b, h, w, c = x.shape
    k = kern.shape[-1]
    xg = F.pad(x.permute(0, 3, 1, 2).reshape(1, b * c, h, w),
               (k // 2,) * 4, mode="reflect")
    y = F.conv2d(xg, kern.repeat_interleave(c, 0)[:, None], groups=b * c)
    return y.reshape(b, c, h, w).permute(0, 2, 3, 1).contiguous()


def _blur_time_row(smi: str, x, kern, label: str = "") -> dict:
    """One row of the blur kernel's times in f32 on ``x`` (b, h, w, c) and
    ``kern`` (b, k, k), both on the card: CUDA-event ms per call of the
    wrapper (50 calls), the device-alone ms (``_device_ms``), the bound,
    the plain version's and the library call's ms, printed."""
    from trainner_tpu_torch.ops.blur import (blur_per_sample,
                                             blur_per_sample_plain)

    k = kern.shape[-1]
    shape = tuple(x.shape)
    lib_err = float((_library_blur(x, kern) - blur_per_sample(x, kern)
                     ).abs().max())
    if not lib_err <= 1e-5:
        raise AssertionError(f"the library call disagrees: {lib_err}")
    work = 2 * k * k * x.numel()
    nbytes = 2 * x.numel() * 4 + kern.numel() * 4
    bound_ms, bound_by = _bound("float32", work, nbytes)
    fn = lambda: blur_per_sample(x, kern)  # noqa: E731
    ms = _time_ms(fn, iters=50)
    plain_ms = _time_ms(lambda: blur_per_sample_plain(x, kern), iters=3,
                        warmup=1)
    library_ms = _time_ms(lambda: _library_blur(x, kern))
    device_ms = _device_ms(fn, "blur_kernel")
    share = (f"{bound_ms / device_ms:.1%}" if device_ms is not None
             else "share not measured")
    print(f"times: blur_per_sample float32 {shape} k={k}{label}: kernel "
          f"{ms:.4f} ms per call of the wrapper (CUDA events over 50 "
          f"calls), {_ms_text(device_ms)} ms on the device alone "
          f"(profiler), "
          f"{share} of the bound {bound_ms:.4f} ms ({bound_by}), plain "
          f"{plain_ms:.4f} ms, reflect pad + grouped cuDNN conv "
          f"{library_ms:.4f} ms, {work / ms / 1e9:.2f} TFLOP/s ({smi})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, device_ms=device_ms,
                shape=list(shape), k=k)


def phase_blur_times(smi: str, parent: str = "") -> dict:
    """CUDA-event times of the blur kernel in f32 at the producer's two
    shapes, at the shuffled program's q-slices, and with resrgan's sinc
    banks at its two canvases (``_blur_time_row``). With ``parent``, the
    same of that tree's blur kernel in the same call, in turns (parent,
    this, this, parent). Returns {shape: row}, the sinc rows under
    ("sinc", shape)."""
    import torch

    from trainner_tpu_torch.ops import blur as port_blur
    from trainner_tpu_torch.ops.blur import blur_per_sample

    old = _parent_blur(parent) if parent else None
    gen = torch.Generator().manual_seed(6)
    rows = {}
    for key in (BLUR_HR, BLUR_LR, BLUR_Q_HR, BLUR_Q_LR, ("sinc", BLUR_HR),
                ("sinc", BLUR_LR), ZOO_LR_CANVAS):
        sinc = key[0] == "sinc"
        shape = key[1] if sinc else key
        b, h, w, c = shape
        x = torch.rand(*shape, generator=gen).cuda()
        kern = _sinc_banks(gen, b) if sinc else _blur_kernels(gen, b, BLUR_K)
        if old is not None and key in (BLUR_HR, BLUR_LR):
            bound_ms = _bound("float32", 2 * BLUR_K * BLUR_K * x.numel(),
                              2 * x.numel() * 4 + kern.numel() * 4)[0]
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
            if not torch.equal(out, blur_per_sample(x, kern)):
                raise AssertionError("the parent's blur gives other sums")
            turns = []
            for f, who in ((old_fn, "parent"), (new_fn, "this"),
                           (new_fn, "this"), (old_fn, "parent")):
                turns.append((who, _time_ms(f, iters=50),
                              _device_ms(f, "blur_kernel")))
            print(f"times: blur_per_sample float32 {shape} k={BLUR_K}, its C "
                  f"interface called in turns (CUDA events ms per call, "
                  f"device ms): " + ", ".join(
                      f"{who} {ms:.4f} / {_ms_text(dev)}"
                      for who, ms, dev in turns)
                  + f"; bound {bound_ms:.4f} ms ({smi})")
        rows[key] = _blur_time_row(smi, x, kern,
                                   ", sinc banks" if sinc else "")
    return rows


def _kernel_rows(rows, serving, train, main_err, bwd_err,
                 blur_rows, producer, blur_err, forms, cli, caller_rows):
    """The JSON summary: each kernel at its main path's shape and type (the
    forward at the serving shape in f32, the backward at the training shape
    in bf16, the blur at the HR canvas in f32, with its times at the LR
    canvas, at the shuffled program's q-slices and with resrgan's sinc
    banks beside), with the launches the card ran in the launch traces of
    the main paths' runs (serving, training in both types, the producer in
    both orders, the training CLI on train_sr.yml and on
    train_realesrgan.yml and their resumes, phase 15's combo and realsr
    runs), the wrappers' own counts over the same runs beside them, both
    types' times at both block shapes, and the blur's rows for phase 15's
    callers (``caller_rows``)."""
    traces = [*train.values(), *producer.values(), *cli.values()]

    def summed(key, wrapper):
        return sum(t[key][wrapper] for t in traces) + (
            serving[key] if wrapper == "rdb5c" else 0)

    fwd = rows["rdb5c_forward", MAIN_SHAPE, "float32"]
    bwd = rows["rdb5c_backward", TRAIN_SHAPE, "bfloat16"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def at(kernel, dtype):
        shapes = (MAIN_SHAPE, TRAIN_SHAPE) + (
            (ZOO_SERVE_SHAPE,) if kernel == "rdb5c_forward" else ())
        return {f"b={sh[0]} {sh[1]}x{sh[2]}": {
            k: v for k, v in rows[kernel, sh, dtype].items()}
            for sh in shapes}

    def forms_of(source):
        return {k: forms[k] for k in BF16_BLOCK_KERNELS[source]
                + BF16_STREAMED_KERNELS[source] + F32_BLOCK_KERNELS[source]}

    return [
        {"name": "rdb5c_forward", "route": "cuda",
         "source": "trainner_tpu_torch/csrc/rdb5c.cu",
         "replaces": "trainner_tpu/ops/pallas_kernels.py:180",
         "launches": summed("ran", "rdb5c"),
         "wrapper_counts": summed("counted", "rdb5c"),
         "max_abs_err": main_err, **{k: fwd[k] for k in keys},
         "bound_ms_cuda_cores": fwd["bound_ms_cuda_cores"],
         "shape": list(MAIN_SHAPE), "dtype": "float32",
         "float32": at("rdb5c_forward", "float32"),
         "bfloat16": at("rdb5c_forward", "bfloat16"),
         "forms": forms_of("rdb5c.cu")},
        {"name": "rdb5c_backward", "route": "cuda",
         "source": "trainner_tpu_torch/csrc/rdb5c_bwd.cu",
         "replaces": "trainner_tpu/ops/pallas_kernels.py:355",
         "launches": summed("ran", "rdb5c_bwd"),
         "wrapper_counts": summed("counted", "rdb5c_bwd"),
         "max_abs_err": bwd_err, **{k: bwd[k] for k in keys},
         "shape": list(TRAIN_SHAPE), "dtype": "bfloat16",
         "float32": at("rdb5c_backward", "float32"),
         "bfloat16": at("rdb5c_backward", "bfloat16"),
         "forms": forms_of("rdb5c_bwd.cu")},
        {"name": "blur_per_sample", "route": "cuda",
         "source": "trainner_tpu_torch/csrc/blur_per_sample.cu",
         "replaces": "trainner_tpu/ops/pallas_kernels.py:466",
         "launches": summed("ran", "blur"),
         "wrapper_counts": summed("counted", "blur"),
         "max_abs_err": blur_err,
         **{k: blur_rows[BLUR_HR][k] for k in keys + ("device_ms",)},
         "shape": list(BLUR_HR), "k": BLUR_K, "dtype": "float32",
         **{name: {"shape": list(key[1] if key[0] == "sinc" else key),
                   **{k: blur_rows[key][k] for k in keys + ("device_ms",)}}
            for name, key in (("at_lr_canvas", BLUR_LR),
                              ("at_zoo_lr_canvas", ZOO_LR_CANVAS),
                              ("at_q_slice_hr", BLUR_Q_HR),
                              ("at_q_slice_lr", BLUR_Q_LR),
                              ("resrgan_sinc_at_hr_canvas",
                               ("sinc", BLUR_HR)),
                              ("resrgan_sinc_at_lr_canvas",
                               ("sinc", BLUR_LR)))},
         "callers": {f"{label} {tuple(shape)}": {
             k: row[k] for k in keys + ("device_ms",)}
             for (label, shape), row in caller_rows.items()}},
    ]


def _traced(fn, label: str, smi: str, untraced_ms: float = 0.0) -> None:
    """Runs ``fn`` once under torch.profiler and prints the device time by
    kernel and the device's idle share of the wall time; with
    ``untraced_ms``, the time of the same work without the profiler, also
    the idle share against that (the profiler slows the host)."""
    import collections

    import torch

    fn()
    torch.cuda.synchronize()
    with _profiled(cpu=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = collections.Counter()
    calls = collections.Counter()
    for _, ns, name in _device_events(prof):
        name = name.removeprefix("void ").replace(
            "(anonymous namespace)::", "").split("(")[0][:70]
        by_name[name] += ns / 1e3
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


# ---------------------------------------------------------------------------
# graphs: the step, train_steps, the degrader and eval_step as CUDA graphs
# ---------------------------------------------------------------------------

GRAPH_STEPS = 3     # graphed against eager steps, per type
WINDOW_K = 10       # train_steps' window, as bench.py times it
WINDOW_BOUNDARY = 5  # a MultiStep boundary inside the window
EMA_MOVE_TOL = 1e-2  # bf16 graph against eager: the EMA weights' moves
X8_CHOP_LR = (1, 300, 200, 3)


def _net_tensors(state) -> dict:
    """G's and D's state_dicts (``g.``, ``d.``) and the EMA weights
    (``e.``), cloned."""
    out = {f"{w}.{k}": v.detach().clone()
           for w in ("g", "d") for k, v in
           getattr(state, w).net.state_dict().items()}
    out.update({f"e.{k}": v.detach().clone()
                for k, v in (state.ema_params or {}).items()})
    return out


def _bit_equality(logs_a, logs_b, state_a, state_b) -> str:
    """How much of two runs of the same steps is equal bit for bit (read,
    not required: the library calls may differ between a graph and an
    eager run): the logs, G's and D's parameters and buffers, and their
    optimizers' moments."""
    import torch

    logs = all(torch.equal(a[k], b[k]) for a, b in zip(logs_a, logs_b)
               for k in b)
    nets_a, nets_b = _net_tensors(state_a), _net_tensors(state_b)
    nets = sum(torch.equal(nets_a[k], nets_b[k]) for k in nets_b)
    moments = [torch.equal(x, y) for w in ("g", "d")
               for key, ts in getattr(state_a, w).opt.state_dict().items()
               if key != "count"
               for x, y in zip(ts, getattr(state_b, w).opt.state_dict()[key])]
    return (f"bit for bit: logs {logs}, parameters and buffers {nets} of "
            f"{len(nets_b)} tensors, moments {sum(moments)} of "
            f"{len(moments)}")


def _check_steps(label: str, logs_a, logs_b, got: dict, want: dict,
                 lr: float, n_g: int, n_d: int, start: dict = None) -> str:
    """The step-parity tolerances of ``tests/test_torch_train_step.py``
    between two runs of the same steps
    (adam): logs 1e-4 relative at the first step and 2e-3 after it (floor
    0.3 for D's mean logits, 1e-3 for the losses); every parameter element
    within 2 lr per update, all but 0.1 % of each tensor within 0.02 lr
    per update (D's biases that only rounding moves excepted: those before
    a batch norm, the head's, the U-Net's output bias); D's running
    statistics and spectral norms' u and sigma within 1e-3 of their size;
    the EMA weights' moves from ``start`` (the weights before the steps)
    within ``EMA_MOVE_TOL`` of their norm, per tensor: they move by 1 -
    decay of G's moves, below G's bounds, and a skipped or misordered
    update misses by half or more. Returns the worst log error."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(logs_a, logs_b)):
        if set(a) != set(b):
            raise AssertionError(f"{label}: step {i} logs {sorted(a)} vs "
                                 f"{sorted(b)}")
        rel = 1e-4 if i == 0 else 2e-3
        for k in b:
            x, y = float(a[k]), float(b[k])
            floor = 0.3 if k in ("D_real", "D_fake") else 1e-3
            worst = max(worst, abs(x - y) / max(abs(y), floor))
            if not (math.isfinite(x) and abs(x - y) <= rel * max(abs(y),
                                                                 floor)):
                raise AssertionError(f"{label}: step {i} {k} {x} vs {y}")
    worst_e = None
    for k, w in want.items():
        if k.startswith("e."):
            moved = w.float() - start[k].float()
            off = float((got[k].float() - w.float()).norm())
            norm = float(moved.norm())
            rel = off / norm if norm else (float("inf") if off else 0.0)
            worst_e = max(worst_e or 0.0, rel)
            if not rel <= EMA_MOVE_TOL:
                raise AssertionError(f"{label}: {k} moved {rel} off")
            continue
        err = (got[k].float() - w.float()).abs()
        if "running_" in k or ".sn." in k:
            if float(err.max()) > 1e-3 * float(w.abs().max()):
                raise AssertionError(f"{label}: {k} {float(err.max())}")
            continue
        n = n_d if k.startswith("d.") else n_g
        name = k[2:]
        noise_only = k.startswith("d.") and name.endswith("bias") and (
            name.startswith("linear") or name == "conv9.bias"
            or "d." + name.replace("bias", "norm.weight") in want)
        if float(err.max()) > 2 * lr * max(n, 1):
            raise AssertionError(f"{label}: {k} {float(err.max())}")
        far = float((err > 0.02 * lr * max(n, 1)).float().mean())
        if not noise_only and far > 1e-3:
            raise AssertionError(f"{label}: {k} {far} of it past 0.02 lr")
    if worst_e is not None:
        print(f"{label}: EMA weights' moves from the start, worst relative "
              f"difference {worst_e:.3e} (tol {EMA_MOVE_TOL:.0e})")
    return worst


def _kernel_calls(fn) -> tuple:
    """One call of ``fn`` under torch.profiler (the device's activity):
    (kernel launches by short name, device-busy ms, wall ms)."""
    import collections

    import torch

    with _profiled() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    calls = collections.Counter(_short_name(n) for _, _, n in events)
    return calls, sum(d for _, d, _ in events) / 1e6, wall


def _graph_step(smi: str, options=None, types=(True, False),
                label: str = "", noise: bool = True,
                batch_fn=None) -> dict:
    """The step of ``options()`` (the flagship configuration by default) as
    a graph against the eager step, in bf16 and f32 (``types``: the values
    of ``use_amp``): three steps each from one seed on the same batches,
    within the step tolerances of ``_check_steps``; the recorded launches
    of one replay against a profiler trace of it; with ``noise``, fresh
    latent noise per replay. Returns the graphs' capture seconds, pool
    bytes and step times by type."""
    import torch

    from trainner_tpu_torch.ops.blocks import GaussianNoise
    from trainner_tpu_torch.train.sr_trainer import create_trainer
    from trainner_tpu_torch.utils.graphs import Captured

    options = options or _train_options
    per_g = NB * 3
    batches = [(batch_fn or _train_batch)(seed=s)
               for s in range(GRAPH_STEPS)]
    lr = options()["train"]["lr_G"]
    out = {}
    for use_amp in types:
        runs = {}
        # cuDNN's deterministic algorithms for the comparison: some of its
        # f32 weight-gradient algorithms add with atomics, so two eager
        # runs differ by themselves; so the one difference left is graph
        # against eager
        torch.backends.cudnn.deterministic = True
        try:
            for graphs in (True, False):
                trainer = create_trainer({**options(), "use_amp": use_amp},
                                         graphs=graphs)
                state = trainer.init_state(0)
                start = _net_tensors(state)
                logs = [trainer.train_step(state, b)[1] for b in batches]
                torch.cuda.synchronize()
                runs[graphs] = (trainer, state, logs, _net_tensors(state))
        finally:
            torch.backends.cudnn.deterministic = False
        name = label + str(runs[True][0].dtype).replace("torch.", "")
        worst = _check_steps(f"graphs: {name} step", runs[True][2],
                             runs[False][2], runs[True][3], runs[False][3],
                             lr, GRAPH_STEPS, GRAPH_STEPS, start)
        equal = _bit_equality(runs[True][2], runs[False][2], runs[True][1],
                              runs[False][1])
        trainer, state = runs[True][:2]
        caps = trainer.step_graphs()
        if len(caps) != 1:
            raise AssertionError(f"graphs: {len(caps)} step graphs")
        cap = next(iter(caps.values()))
        want = {"rdb5c": per_g, "rdb5c_bwd": per_g, "blur": 0}
        calls, busy, wall = _kernel_calls(
            lambda: trainer.train_step(state, batches[0]))
        traced = _calls_per_wrapper(calls.elements())
        print(f"graphs: {name} step, {GRAPH_STEPS} graphed steps against "
              f"{GRAPH_STEPS} eager ones within the step tolerances "
              f"(worst log error {worst:.3e} relative; {equal}); "
              f"recorded launches "
              f"per replay {cap.launches}, in a profiler trace of one "
              f"replay {traced} ({sum(calls.values())} kernels, busy "
              f"{busy:.3f} ms of {wall:.3f} ms); replays {cap.replays}; "
              f"capture {cap.capture_s:.3f} s, pool "
              f"{cap.pool_bytes / 2 ** 20:.1f} MiB ({smi})")
        if cap.launches != want or traced != want:
            raise AssertionError(f"graphs: {name} step launches "
                                 f"{cap.launches}, traced {traced}")
        # times: 10 steps each, in turns (eager, graphed, graphed, eager)
        ms = {}
        for graphs in (False, True, True, False):
            tr, st = runs[graphs][:2]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                tr.train_step(st, batches[1])
            torch.cuda.synchronize()
            ms.setdefault(graphs, []).append(
                (time.perf_counter() - t0) * 1e2)
        lr_px, hr_px = batches[1]["LR"].shape[1], batches[1]["HR"].shape[1]
        print(f"times: train_step {name} b={batches[1]['LR'].shape[0]} "
              f"{lr_px}->{hr_px} px, ms per step over "
              f"10 (eager, graphed, graphed, eager): eager {ms[False]}, "
              f"graphed {ms[True]}; it/s eager {1e3 / min(ms[False]):.4f}, "
              f"graphed {1e3 / min(ms[True]):.4f} ({smi})")
        for graphs in (True, False):
            tr, st = runs[graphs][:2]
            _traced(lambda: tr.train_step(st, batches[1]),
                    f"{'graphed' if graphs else 'eager'} train_step {name}",
                    smi, min(ms[graphs]))
        out[name] = dict(capture_s=cap.capture_s, pool=cap.pool_bytes,
                         eager_ms=min(ms[False]), graphed_ms=min(ms[True]))
        del runs, trainer, state, cap, caps, tr, st
        torch.cuda.empty_cache()
    if not noise:
        return out

    # latent noise in a graph: the state's generator registered with it
    gen = torch.Generator(device="cuda").manual_seed(5)
    layer = GaussianNoise(0.1).train()
    layer.generator = gen
    x = torch.full((64, 8, 16, 16), 3.0, device="cuda")
    start = gen.get_state()
    eager_rel = ((layer(x) - x) / x).clone()
    cap = Captured(lambda: layer(x), generators=[gen])
    gen.set_state(start)
    first = ((cap.replay() - x) / x).clone()
    second = ((cap.replay() - x) / x).clone()
    torch.cuda.synchronize()
    stats = [(float(r.mean()), float(r.std()))
             for r in (eager_rel, first, second)]
    print(f"graphs: latent noise, 131,072 draws a call: eager and two "
          f"replays (mean, std of the relative noise) {stats}; the first "
          f"replay from the eager draw's generator state equals it: "
          f"{torch.equal(first, eager_rel)}; the two replays differ: "
          f"{not torch.equal(first, second)}")
    # the gate of tests/test_torch_trainer.py: |mean| < 1e-3 and
    # |std - sigma| < 1e-3
    if not (all(abs(m) < 1e-3 and abs(sd - 0.1) < 1e-3 for m, sd in stats)
            and torch.equal(first, eager_rel)
            and not torch.equal(first, second)):
        raise AssertionError("graphs: latent noise in a graph")
    return out


def _graph_resume(smi: str, root: str) -> None:
    """A resume after capture: two graphed steps, a checkpoint, two more;
    then the checkpoint loaded into the same (captured) state, whose
    tensors equal the saved ones bit for bit, and a replay from it within
    the step tolerances of an eager trainer's step from the same file."""
    import torch

    from trainner_tpu_torch.train.sr_trainer import create_trainer
    from trainner_tpu_torch.utils import checkpoint

    opt = {"path": {"models": os.path.join(root, "graph_models"),
                    "training_state": os.path.join(root, "graph_state")}}
    batches = [_train_batch(seed=10 + s) for s in range(5)]
    trainer = create_trainer(_train_options())
    state = trainer.init_state(3)
    for b in batches[:2]:
        state, _ = trainer.train_step(state, b)
    torch.cuda.synchronize()
    checkpoint.save_checkpoint(state, opt, epoch=0, niter=2)
    saved = _state_tensors(state)
    for b in batches[2:4]:
        state, _ = trainer.train_step(state, b)
    path = os.path.join(root, "graph_state", "2.state")
    state, _ = checkpoint.load_state(path, state)
    loaded = _state_tensors(state)
    diff = [k for k in saved if not (
        torch.equal(saved[k], loaded[k]) if isinstance(saved[k],
                                                       torch.Tensor)
        else saved[k] == loaded[k])]
    replays = trainer.step_graphs()
    state, logs = trainer.train_step(state, batches[4])
    eager = create_trainer(_train_options(), graphs=False)
    estate = eager.init_state(7)
    estate, _ = checkpoint.load_state(path, estate)
    estate, elogs = eager.train_step(estate, batches[4])
    torch.cuda.synchronize()
    n_replays = sum(c.replays for c in trainer.step_graphs().values())
    print(f"graphs: resume after capture: {len(saved)} tensors and counts "
          f"of the saved state, {len(diff)} differ after loading into the "
          f"captured state; the next step (a replay, {len(replays)} "
          f"graph(s), {n_replays} replays in all) against an eager "
          f"trainer's step from the same file")
    if diff or not n_replays:
        raise AssertionError(f"graphs: resume after capture {diff[:5]}")
    _check_steps("graphs: step after the resume", [logs], [elogs],
                 _net_tensors(state), _net_tensors(estate),
                 _train_options()["train"]["lr_G"], 1, 1)
    del trainer, state, eager, estate
    torch.cuda.empty_cache()


def _graph_window(smi: str) -> dict:
    """``train_steps`` with k = 10 at b = 32, 32 -> 128 px, bf16, a
    MultiStep boundary at step 5: the window (the first step of a fresh
    trainer runs eagerly and captures, nine replays) against ten eager
    ``train_step`` calls, the learning rates the window handed the step,
    and both times over a second window."""
    import torch

    from trainner_tpu_torch.train.sr_trainer import create_trainer

    b, px = TRAIN_SHAPE[0], TRAIN_SHAPE[1]
    gen = torch.Generator().manual_seed(21)
    batches = {"LR": torch.rand(WINDOW_K, b, px, px, 3, generator=gen),
               "HR": torch.rand(WINDOW_K, b, px * 4, px * 4, 3,
                                generator=gen)}
    batches = {k: v.cuda() for k, v in batches.items()}
    opt = _train_options(lr_steps=[WINDOW_BOUNDARY])
    lr = opt["train"]["lr_G"]
    trainer = create_trainer(opt)
    state = trainer.init_state(0)
    fn = trainer._get_step_fn(True, True)
    seen = []

    def recording(st, batch, lr_g, lr_d):
        seen.append((lr_g, lr_d))
        return fn(st, batch, lr_g, lr_d)

    trainer._step_fns[(True, True, False)] = recording
    state, logs = trainer.train_steps(state, batches)
    torch.cuda.synchronize()
    trainer._step_fns[(True, True, False)] = fn
    eager = create_trainer(opt, graphs=False)
    estate = eager.init_state(0)
    elogs = []
    for i in range(WINDOW_K):
        estate, lg = eager.train_step(estate, {k: v[i] for k, v in
                                               batches.items()})
        elogs.append(lg)
    want_lrs = [(trainer.schedG.get_lr(i), trainer.schedD.get_lr(i))
                for i in range(WINDOW_K)]
    per_step = [{k: v[i] for k, v in logs.items()} for i in range(WINDOW_K)]
    shapes = {k: tuple(v.shape) for k, v in logs.items()}
    worst = _check_steps("graphs: train_steps", per_step, elogs,
                         _net_tensors(state), _net_tensors(estate), lr,
                         WINDOW_K, WINDOW_K)
    cap = next(iter(trainer.step_graphs().values()))
    print(f"graphs: train_steps k={WINDOW_K} b={b} {px}->{px * 4} px bf16, "
          f"MultiStep boundary at {WINDOW_BOUNDARY}: learning rates "
          f"{[g for g, _ in seen]}, the schedule's {seen == want_lrs}; "
          f"logs {shapes}, within the step tolerances of {WINDOW_K} eager "
          f"steps (worst log error {worst:.3e}; "
          f"{_bit_equality(per_step, elogs, state, estate)}); replays "
          f"{cap.replays}; "
          f"capture {cap.capture_s:.3f} s, pool "
          f"{cap.pool_bytes / 2 ** 20:.1f} MiB; state step {state.step}")
    if seen != want_lrs or state.step != WINDOW_K or cap.replays != \
            WINDOW_K - 1 or any(s != (WINDOW_K,) for s in shapes.values()):
        raise AssertionError("graphs: train_steps")

    # times: a second window each, in turns
    times = {}
    for label, tr, st in (("eager", eager, estate), ("graphed", trainer,
                                                      state),
                          ("graphed", trainer, state),
                          ("eager", eager, estate)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, lg = tr.train_steps(st, batches)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / WINDOW_K
        times.setdefault(label, []).append(ms)
    print(f"times: train_steps k={WINDOW_K} b={b} {px}->{px * 4} px bf16, "
          f"ms per step over a window (eager, graphed, graphed, eager): "
          f"eager {times['eager']}, graphed {times['graphed']}; it/s "
          f"eager {1e3 / min(times['eager']):.4f}, graphed "
          f"{1e3 / min(times['graphed']):.4f} ({smi})")
    _traced(lambda: trainer.train_steps(state, batches),
            f"graphed train_steps k={WINDOW_K}", smi,
            min(times["graphed"]) * WINDOW_K)
    _traced(lambda: eager.train_steps(estate, batches),
            f"eager train_steps k={WINDOW_K}", smi,
            min(times["eager"]) * WINDOW_K)
    del trainer, state, eager, estate
    torch.cuda.empty_cache()
    return {k: min(v) for k, v in times.items()}


def _degrader_pair(corpus: str, shuffle: bool, options=None):
    """The degradation step of ``options(corpus, shuffle)`` (the bsrgan
    end-to-end configuration by default), graphed and eager, from one
    generator seed."""
    import torch

    from trainner_tpu_torch.options import parse_dict
    from trainner_tpu_torch.train import make_otf_degradation

    opt = parse_dict((options or _e2e_options)(corpus, shuffle=shuffle),
                     is_train=True)
    return (make_otf_degradation(
                opt, generator=torch.Generator(device="cuda").manual_seed(9)),
            make_otf_degradation(
                opt, generator=torch.Generator(device="cuda").manual_seed(9),
                graphs=False))


def _graph_degrader(smi: str, root: str, programs=None,
                    preset: str = "bsrgan") -> dict:
    """The degrader as a graph against the eager program, for each of
    ``programs`` ((label, shuffle, blur launches per batch, options); by
    default bsrgan's fixed order and its shuffle): from one generator
    state and plan stream, batch after batch (the first runs eagerly and
    captures, then replays), bit for bit, or one 1/255 level on at most
    0.1 % of the values where a library call (cuBLAS, cuDNN) took another
    algorithm under capture; the blur launches each graph recorded and
    the kernels of a replay; both times in turns."""
    import numpy as np
    import torch

    from trainner_tpu_torch.data.common import decode_image

    corpus = os.path.join(root, "corpus")
    b, hr = BLUR_HR[0], BLUR_HR[1]
    names = sorted(os.listdir(corpus))
    raws = []
    for i in range(4):
        pick = [names[(i * b + j) % len(names)] for j in range(b)]
        raws.append({"HR": torch.from_numpy(np.stack(
            [decode_image(os.path.join(corpus, n))[:hr, :hr, :3]
             for n in pick])).cuda()})
    result = {}
    for label, shuffle, per_batch, options in programs or (
            ("fixed order", False, 2, None),
            ("per-sample shuffle", True, 4 * SHUFFLE_K, None)):
        graphed, eager = _degrader_pair(corpus, shuffle, options)
        if not eager.lr_from_hr:  # the LR degrader works on the batch's LR
            for raw in raws:
                raw.setdefault("LR", raw["HR"][:, ::4, ::4].contiguous())
        worst, n_off = 0.0, 0
        for raw in raws:
            got, want = graphed(raw)["LR"], eager(raw)["LR"]
            d = (got - want).abs()
            worst = max(worst, float(d.max()))
            n_off += int((d > 0).sum())
        torch.cuda.synchronize()
        caps = list(graphed.graphs.values())
        cap = caps[0]
        total = len(raws) * got.numel()
        same = worst == 0.0
        why = "" if same else (
            f"; not bit for bit: {n_off} of {total} values differ, at most "
            f"{worst * 255:.3f} of a 1/255 level (a library call, cuBLAS or "
            f"cuDNN, takes another algorithm under capture)")
        calls, busy, wall = _kernel_calls(lambda: graphed(raws[0]))
        traced = _calls_per_wrapper(calls.elements())["blur"]
        print(f"graphs: degrader, {preset} {label}, b={b} {hr}->{hr // 4} "
              f"px: {len(raws)} batches graphed against eager from one "
              f"generator state and plan stream: equal bit for bit {same}"
              f"{why}; recorded launches per replay {cap.launches}, blur "
              f"kernels in a trace of one replay {traced} of "
              f"{sum(calls.values())} kernels, busy {busy:.3f} ms; replays "
              f"{cap.replays}; capture {cap.capture_s:.3f} s, pool "
              f"{cap.pool_bytes / 2 ** 20:.1f} MiB")
        if len(caps) != 1 or cap.launches["blur"] != per_batch \
                or traced != per_batch or not (
                    same or (worst <= 1 / 255 + 1e-6
                             and n_off <= 1e-3 * total)):
            raise AssertionError(f"graphs: degrader {preset} {label}")
        ms = {}
        for which, fn in (("eager", eager), ("graphed", graphed),
                          ("graphed", graphed), ("eager", eager)):
            ms.setdefault(which, []).append(
                _time_ms(lambda: fn(raws[1]), iters=10, warmup=2))
        print(f"times: degrade {preset} {label} b={b} {hr}->{hr // 4} px, "
              f"ms per batch (CUDA events over 10; eager, graphed, graphed, "
              f"eager): eager {ms['eager']}, graphed {ms['graphed']} "
              f"({smi})")
        for which, fn in (("graphed", graphed), ("eager", eager)):
            _traced(lambda: fn(raws[1]),
                    f"{which} degrade, {preset} {label}, b={b}", smi,
                    min(ms[which]))
        result[label] = dict(eager_ms=min(ms["eager"]),
                             graphed_ms=min(ms["graphed"]),
                             capture_s=cap.capture_s, pool=cap.pool_bytes)
        del graphed, eager
        torch.cuda.empty_cache()
    return result


def _graph_e2e(smi: str, root: str, programs=None) -> dict:
    """The end-to-end rate, loader -> degrader -> step at full width in
    bf16, eager (``graphs=False`` for both) against graphed, in turns, for
    each of ``programs`` ((label, options of the corpus); by default the
    bsrgan configuration in the fixed order and shuffled)."""
    import torch

    from trainner_tpu_torch.data import create_dataloader, create_dataset
    from trainner_tpu_torch.options import parse_dict
    from trainner_tpu_torch.train import (batches, create_trainer,
                                          make_otf_degradation)

    corpus = os.path.join(root, "corpus")
    rates = {}
    for label, options in programs or (
            ("fixed order", lambda c: _e2e_options(c)),
            ("per-sample shuffle", lambda c: _e2e_options(c, True))):
        opt = parse_dict(options(corpus), is_train=True)
        ds_opt = opt["datasets"]["train"]
        pair = {}
        for graphs in (False, True):
            loader = create_dataloader(create_dataset(ds_opt), ds_opt,
                                       pin_memory=True)
            pair[graphs] = dict(
                degrade=make_otf_degradation(
                    opt, generator=torch.Generator(
                        device="cuda").manual_seed(7), graphs=graphs),
                trainer=create_trainer(opt, graphs=graphs),
                stream=batches(loader))
            pair[graphs]["state"] = pair[graphs]["trainer"].init_state(0)

        def run(p, n):
            for _ in range(n):
                batch = p["degrade"](next(p["stream"]))
                p["state"], logs = p["trainer"].train_step(p["state"], batch)
            torch.cuda.synchronize()
            return logs

        ms = {}
        for graphs in (False, True):
            run(pair[graphs], 3)
        for graphs in (False, True, True, False):
            t0 = time.perf_counter()
            logs = run(pair[graphs], 10)
            ms.setdefault(graphs, []).append(
                (time.perf_counter() - t0) * 1e2)
            if not all(math.isfinite(float(v)) for v in logs.values()):
                raise AssertionError(f"graphs: e2e {label} logs")
        print(f"times: train_e2e bfloat16 b={TRAIN_SHAPE[0]} "
              f"{TRAIN_SHAPE[1]}->{TRAIN_SHAPE[1] * 4} px, {label}, ms per "
              f"step over 10 (eager, graphed, graphed, eager): eager "
              f"{ms[False]}, graphed {ms[True]}; it/s eager "
              f"{1e3 / min(ms[False]):.4f}, graphed "
              f"{1e3 / min(ms[True]):.4f} ({smi})")
        for graphs in (True, False):
            _traced(lambda: run(pair[graphs], 1),
                    f"{'graphed' if graphs else 'eager'} end-to-end step, "
                    f"{label}", smi, min(ms[graphs]))
        rates[label] = {"eager": min(ms[False]), "graphed": min(ms[True])}
        del pair
        torch.cuda.empty_cache()
    return rates


def _graph_serving(smi: str) -> None:
    """``eval_step`` as a graph against the eager one at b = 8, 128 -> 512
    px (f32 within 1e-5 and bf16 within 3e-2 of the output's size, the
    full-G tolerances; times in turns); then x8 and chop on one 300 x 200
    LR image in f32 on the card against the eager ``eval_step`` over the
    same rotations and tiles on the CPU with the same weights (the plain
    versions), within the full-G f32 tolerance."""
    import torch

    from trainner_tpu_torch.train.sr_trainer import create_trainer

    opt = {"is_train": False, "scale": 4,
           "network_G": {"type": "rrdb_net", "nf": NF, "nb": NB, "gc": GC,
                         "upscale": 4}}
    b, h, w = MAIN_SHAPE
    lr = torch.rand(b, h, w, 3, generator=torch.Generator().manual_seed(31)
                    ).cuda()
    for use_amp, rel_tol in ((False, 1e-5), (True, 3e-2)):
        pair = {}
        for graphs in (True, False):
            tr = create_trainer({**opt, "use_amp": use_amp}, graphs=graphs)
            st = tr.init_state(0)
            _gain_weights(st.g.net, seed=1)
            pair[graphs] = (tr, st)
        name = str(pair[True][0].dtype).replace("torch.", "")
        # eager calls, then one that captures, then two replays
        n_eager = pair[True][0].EVAL_CAPTURE_AT - 1
        outs = [pair[True][0].eval_step(pair[True][1], lr)
                for _ in range(n_eager + 3)]
        want = pair[False][0].eval_step(pair[False][1], lr)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = max(float((o - want).abs().max()) for o in outs)
        cap = next(iter(pair[True][0].eval_graphs().values()))
        print(f"graphs: eval_step {name} b={b} {h}->{h * 4} px, graphed "
              f"({n_eager} eager calls, one that captures, 2 replays) "
              f"against eager: "
              f"max_abs_err "
              f"{err:.3e} on max|ref| {scale:.3e}, tol "
              f"{rel_tol * scale:.3e}; recorded launches per replay "
              f"{cap.launches}; capture {cap.capture_s:.3f} s, pool "
              f"{cap.pool_bytes / 2 ** 20:.1f} MiB")
        if not err <= rel_tol * scale or cap.launches["rdb5c"] != NB * 3 \
                or cap.replays != 2:
            raise AssertionError(f"graphs: eval_step {name}")
        ms = {}
        for graphs in (False, True, True, False):
            tr, st = pair[graphs]
            ms.setdefault(graphs, []).append(
                _time_ms(lambda: tr.eval_step(st, lr), iters=10, warmup=2))
        print(f"times: G forward {name} b={b} {h}->{h * 4} px through "
              f"eval_step (eager, graphed, graphed, eager): eager "
              f"{ms[False]} ms, graphed {ms[True]} ms; "
              f"{b * h * w * 16 / min(ms[True]) / 1e3:.3f} Mpx/s graphed "
              f"({smi})")
        for graphs in (True, False):
            tr, st = pair[graphs]
            _traced(lambda: tr.eval_step(st, lr),
                    f"{'graphed' if graphs else 'eager'} eval_step {name} "
                    f"b={b}", smi, min(ms[graphs]))
        del pair
        torch.cuda.empty_cache()

    # x8 and chop on one image, against the CPU's eager composition
    tr = create_trainer(dict(opt))
    st = tr.init_state(0)
    _gain_weights(st.g.net, seed=2)
    cpu = create_trainer(dict(opt), device="cpu")
    cst = cpu.init_state(0)
    cst.g.net.load_state_dict({k: v.cpu() for k, v in
                               st.g.net.state_dict().items()})
    x = torch.rand(*X8_CHOP_LR, generator=torch.Generator().manual_seed(32))
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 8)
    try:
        # x8 meets each of its two shapes four times a call, chop its one
        # chunk of six tiles once: the last call replays graphs of them
        for label, run, calls in (
                ("x8", lambda t, s, v: t.eval_step_x8(s, v),
                 tr.EVAL_CAPTURE_AT // 4 + 1),
                ("chop", lambda t, s, v: t.eval_step_chop(s, v),
                 tr.EVAL_CAPTURE_AT + 1)):
            before = {k: c.replays for k, c in tr.eval_graphs().items()}
            for _ in range(calls):
                got = run(tr, st, x.cuda())
            torch.cuda.synchronize()
            replayed = sorted(k[0] for k, c in tr.eval_graphs().items()
                              if c.replays > before.get(k, 0))
            t0 = time.perf_counter()
            want = run(cpu, cst, x)
            cpu_s = time.perf_counter() - t0
            scale = float(want.abs().max())
            err = float((got.cpu() - want).abs().max())
            print(f"graphs: {label} on a {X8_CHOP_LR[1]}x{X8_CHOP_LR[2]} "
                  f"LR image, f32 on the card, call {calls} (graph replays "
                  f"of the shapes {replayed}) against the CPU's eager "
                  f"composition ({cpu_s:.1f} s there): max_abs_err "
                  f"{err:.3e} on max|ref| {scale:.3e}, tol "
                  f"{1e-5 * scale:.3e}")
            want_shapes = ([(1, 200, 300, 3), (1, 300, 200, 3)] if label
                           == "x8" else [(6, 128, 128, 3)])
            if tuple(got.shape) != (1, X8_CHOP_LR[1] * 4, X8_CHOP_LR[2] * 4,
                                    3) or not err <= 1e-5 * scale \
                    or replayed != want_shapes:
                raise AssertionError(f"graphs: {label}")
    finally:
        torch.set_num_threads(threads)
    del tr, st, cpu, cst
    torch.cuda.empty_cache()


MIXED_LR = ((128, 128), (96, 128), (128, 96), (120, 80), (100, 140),
            (88, 112), (140, 100), (112, 88))  # h, w: one size per image


def _graph_mixed_sizes(smi: str, root: str) -> None:
    """The test CLI, f32 at full width, plain and with x8, eager
    (``graphs=False``) against graphed (the default) in turns, on a test
    set of one size per image (``MIXED_LR``, LR crops of the corpus,
    ``mode: single``) and on one of one size (the synthetic set of
    ``N_IMAGES``): seconds per image through ``main()`` (set-up included)
    and in the inference call alone (synchronised), and the eval_step
    graphs the run kept."""
    import numpy as np
    import torch

    from trainner_tpu_torch import test as test_cli
    from trainner_tpu_torch.data import save_img
    from trainner_tpu_torch.data.common import decode_image
    from trainner_tpu_torch.train import sr_trainer

    corpus = os.path.join(root, "corpus")
    lr_dir = os.path.join(root, "mixed_lr")
    os.makedirs(lr_dir)
    names = sorted(os.listdir(corpus))
    for i, (h, w) in enumerate(MIXED_LR):
        img = decode_image(os.path.join(corpus, names[i]))[:h, :w, :3]
        save_img(np.ascontiguousarray(img), os.path.join(lr_dir,
                                                         f"{i:02d}.png"))
    sets = (("one size per image", len(MIXED_LR),
             {"name": "mixed", "mode": "single", "dataroot_LR": lr_dir}),
            ("one size", N_IMAGES,
             {"name": "synth", "mode": "synthetic", "crop_size": 512,
              "n_samples": N_IMAGES}))
    orig = (sr_trainer.create_trainer, sr_trainer.SRTrainer.eval_step,
            sr_trainer.SRTrainer.eval_step_x8)
    for (kind, n_img, ds), x8 in ((d, x8) for d in sets
                                  for x8 in (False, True)):
        label = "x8" if x8 else "plain"
        runs = {}
        for n, graphs in enumerate((False, True, True, False)):
            name = f"sizes_{ds['name']}_{label}_{n}"
            path = _options(root, name=name, x8=x8,
                            datasets={"test_1": ds})
            made, spent = [], []

            def create(o, device=None, graphs=graphs):
                made.append(orig[0](o, device=device, graphs=graphs))
                return made[-1]

            def timed(fn):
                def call(self, state, x, *which):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = fn(self, state, x, *which)
                    torch.cuda.synchronize()
                    spent.append(time.perf_counter() - t0)
                    return out
                return call

            sr_trainer.create_trainer = create
            if x8:
                sr_trainer.SRTrainer.eval_step_x8 = timed(orig[2])
            else:
                sr_trainer.SRTrainer.eval_step = timed(orig[1])
            try:
                t0 = time.perf_counter()
                test_cli.main(["-opt", path])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                (sr_trainer.create_trainer, sr_trainer.SRTrainer.eval_step,
                 sr_trainer.SRTrainer.eval_step_x8) = orig
            pngs = os.listdir(os.path.join(root, "results", name,
                                           ds["name"]))
            if len(spent) != n_img or len(pngs) != n_img:
                raise AssertionError(f"{kind} {label}: {len(spent)} calls, "
                                     f"{len(pngs)} PNGs")
            runs.setdefault(graphs, []).append(
                (wall / n_img, sum(spent) / n_img,
                 len(made[0].eval_graphs())))
            del made
            torch.cuda.empty_cache()
        sizes = (f"{MIXED_LR[0]} .. {MIXED_LR[-1]}"
                 if ds["mode"] == "single" else "(128, 128)")
        print(f"times: test CLI {label}, f32, {n_img} images of {kind} "
              f"(LR h, w {sizes}), in turns (eager, graphed, graphed, "
              f"eager): s per image "
              f"through main() (set-up included) eager "
              f"{[r[0] for r in runs[False]]}, graphed "
              f"{[r[0] for r in runs[True]]}; in the inference "
              f"call eager {[r[1] for r in runs[False]]}, "
              f"graphed {[r[1] for r in runs[True]]}; eval_step "
              f"graphs kept {runs[True][0][2]} ({smi})")


def _graph_cli(smi: str, root: str, options: str = "cli_options.json",
               label: str = "train_sr.yml") -> None:
    """The training CLI's steady rate, eager (the trainer and the degrader
    made with ``graphs=False``) against graphed (the default), on the
    options ``phase_cli`` wrote (``train_sr.yml`` at full width by
    default), 8 iterations each, one run of each (four in turns, eager,
    graphed, graphed, eager, until phases 18 and 19 needed the time)."""
    import torch

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from trainner_tpu_torch.train import cli
    from trainner_tpu_torch.train.sr_trainer import SRTrainer

    corpus = os.path.join(root, "corpus")
    orig = (cli.create_sr_trainer, cli.make_otf_degradation)
    rates = {}
    for n, graphs in enumerate((False, True)):
        with open(os.path.join(root, options)) as f:
            opt = json.load(f)
        opt["train"].update(niter=8, val_freq=10 ** 6)
        opt["logger"].update(print_freq=10 ** 6,
                             save_checkpoint_freq=10 ** 6)
        stem = options.removesuffix(".json").removesuffix("_options")
        opt["path"]["root"] = os.path.join(root, f"{stem}_rate_{n}")
        opt["datasets"]["train"]["dataroot_HR"] = corpus
        opt["datasets"].pop("val", None)
        path = os.path.join(root, f"{stem}_rate_{n}.json")
        with open(path, "w") as f:
            json.dump(opt, f)
        starts, ends, traced = [], [], []
        # the device's activity only: the host side would trace the
        # loader's threads too, and slow them
        prof = profile(activities=[ProfilerActivity.CUDA])
        cli.create_sr_trainer = lambda o, device=None: orig[0](
            o, device=device, graphs=graphs)
        cli.make_otf_degradation = lambda o, device=None, generator=None: \
            orig[1](o, device=device, generator=generator, graphs=graphs)
        step = SRTrainer.train_step

        def timed(self, state, batch):
            # one whole iteration (loader, degrader, step) under the
            # profiler: from the start of step 6 to the start of step 7,
            # the profiler's own start and stop outside the span
            if len(starts) == 6:
                torch.cuda.synchronize()
                traced.append(time.perf_counter() - traced.pop())
                prof.__exit__(None, None, None)
            if len(starts) == 5:
                prof.__enter__()
                torch.cuda.synchronize()
                traced.append(time.perf_counter())
            starts.append(time.perf_counter())
            out = step(self, state, batch)
            if len(starts) == 8:
                torch.cuda.synchronize()
                ends.append(time.perf_counter())
            return out

        SRTrainer.train_step = timed
        try:
            cli.main(["-opt", path])
        finally:
            SRTrainer.train_step = step
            cli.create_sr_trainer, cli.make_otf_degradation = orig
        # from the start of step 3 to the end of step 8 (synchronised)
        rates.setdefault(graphs, []).append(6 / (ends[0] - starts[2]))
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / 1e3
        print(f"trace: cli main() on {label} "
              f"{'graphed' if graphs else 'eager'}, one "
              f"iteration (step 6: loader, degrader, step): wall "
              f"{traced[0] * 1e3:.3f} ms (traced), device busy {busy:.3f} "
              f"ms, idle share {1 - busy / (traced[0] * 1e3):.4f} ({smi})")
    print(f"times: cli main() on {label}, steps 3-8 (synchronised "
          f"at the end of step 8), it/s (eager, then graphed): eager "
          f"{rates[False]}, graphed {rates[True]} ({smi})")


# ---------------------------------------------------------------------------
# realesrgan: options/sr/train_realesrgan.yml on the card
# ---------------------------------------------------------------------------

RESRGAN_YML = os.path.join(OPTIONS_DIR, "train_realesrgan.yml")
# blur launches per resrgan degrader replay: blur on the HR canvas, blur2
# on the LR canvas (the port resizes straight to it), and final_blur on the
# LR canvas once in each order of the finals
RESRGAN_BLUR = 4
RESRGAN_BLUR_SHAPES = {BLUR_HR: 1, BLUR_LR: 3}


def _resrgan_options(**train) -> dict:
    """``options/sr/train_realesrgan.yml`` as written, read by the port's
    reader: G nf 64, nb 23, gc 32, upconv, latent noise; the U-Net D nf 64
    with spectral norm; VGG19 conv5_4 L1 x 1, pixel L1 x 1, vanilla GAN x
    0.1; Adam 1e-4 for both, MultiStepLR; EMA 0.999; bf16; batch 32, crop
    128, the resrgan degradations; with ``train`` edits."""
    opt = read_options_yml(RESRGAN_YML)
    opt["is_train"] = True
    opt["train"].update(train)
    return opt


def _resrgan_e2e_options(corpus: str, shuffle: bool = False) -> dict:
    """The same, its train set the corpus, uint8 on the wire, no
    validation set."""
    opt = _resrgan_options()
    opt["datasets"].pop("val", None)
    opt["datasets"]["train"].update(dataroot_HR=corpus, wire_dtype="uint8",
                                    shuffle_degradations=shuffle)
    return opt


def _resrgan_ops(smi: str) -> None:
    """The ops this configuration adds, on the card against the CPU on the
    same inputs and draws: sinc kernels (random supports, and a fixed
    cutoff) and Poisson noise within 1e-6; the blur kernel against its
    plain version with sinc banks at resrgan's canvases (HR for blur; the
    LR canvas for blur2, which the port runs on the LR canvas, and for
    final_blur), f32 within 1e-5 as phase 3 holds it; the cv2-style resize
    codes 0-6 down (HR -> LR canvas) and up within 1e-5; the EMA update
    bit for bit (one fused multiply-add, as the CPU's); the U-Net D with
    spectral norm at nf 64, b=4, 128 px, f32: output within 1e-4 of its
    size, the committed u and sigma within 1e-5 of theirs, each
    parameter's gradient within 1e-3 of its largest."""
    import copy

    import torch

    from trainner_tpu_torch.data.pipeline import _full_f32
    from trainner_tpu_torch.models.discriminators import UNetDiscriminator
    from trainner_tpu_torch.ops import degradations as D
    from trainner_tpu_torch.ops.blur import (blur_per_sample,
                                             blur_per_sample_plain)
    from trainner_tpu_torch.ops.imresize import jax_resize
    from trainner_tpu_torch.train.state import (NetState, SRTrainState,
                                                ema_update, init_ema)

    def cuda(params):
        return {k: None if v is None else v.cuda() for k, v in
                params.items()}

    def check(what, got, want, tol):
        err = float((got.cpu().float() - want.float()).abs().max())
        print(f"realesrgan: {what} card vs CPU max_abs_err {err:.3e} tol "
              f"{tol:.1e}")
        if not err <= tol:
            raise AssertionError(f"realesrgan: {what}: {err} > {tol}")

    gen = torch.Generator().manual_seed(21)
    b = BLUR_HR[0]
    with _full_f32():
        for cut in (None, (1.3, 1.3)):
            params = D.draw_sinc_kernels(gen, b, BLUR_K, cut, 7)
            check(f"sinc kernels, cutoff {cut or 'drawn'}",
                  D.sinc_kernels(cuda(params), BLUR_K),
                  D.sinc_kernels(params, BLUR_K), 1e-6)
        for shape in (BLUR_HR, BLUR_LR):
            xb = torch.rand(*shape, generator=gen).cuda()
            kern = _sinc_banks(gen, shape[0])
            check(f"blur kernel vs plain, sinc banks, {shape}",
                  blur_per_sample(xb, kern),
                  blur_per_sample_plain(xb, kern).cpu(), 1e-5)
        x = torch.rand(*BLUR_LR, generator=gen)
        params = D.draw_poisson_noise(gen, x.shape, (0.05, 3.0))
        check("poisson noise", D.poisson_noise(x.cuda(), cuda(params)),
              D.poisson_noise(x, params), 1e-6)
        hr = torch.rand(*BLUR_HR, generator=gen)
        for code in range(7):
            for src, out in ((hr, BLUR_LR[1:3]), (x, (48, 40))):
                check(f"resize code {code} {tuple(src.shape[1:3])}->{out}",
                      D.resize_batch(src.cuda(), out, code),
                      D.resize_batch(src, out, code), 1e-5)
        if not torch.equal(jax_resize(hr.cuda(), BLUR_LR[1:3], "linear",
                                      True).cpu(),
                           D.resize_batch(hr.cuda(), BLUR_LR[1:3], 3).cpu()):
            raise AssertionError("realesrgan: area is not antialiased "
                                 "linear")

        # the EMA update: one rounding of decay e + (1 - decay) p
        states = []
        conv = torch.nn.Conv2d(64, 64, 3)
        for dev in ("cpu", "cuda"):
            net = copy.deepcopy(conv).to(dev)
            st = SRTrainState(step=0, g=NetState(net))
            init_ema(st)
            with torch.no_grad():
                for p in net.parameters():
                    p.add_(torch.randn(p.shape, generator=torch.Generator(
                        ).manual_seed(p.numel())).to(dev))
            ema_update(st, 0.999)
            states.append(st)
        same = all(torch.equal(a.cpu(), bb) for a, bb in zip(
            states[1].ema.parameters(), states[0].ema.parameters()))
        print(f"realesrgan: ema_update card vs CPU bit for bit: {same}")
        if not same:
            raise AssertionError("realesrgan: ema_update rounds otherwise "
                                 "on the card")

        # the U-Net D with spectral norm, f32, under cuDNN's deterministic
        # algorithms and its heuristics (benchmark off), as the step
        # comparisons run: its choice of algorithm moves the gradients'
        # error against the CPU; an f64 pass on the CPU says whose error
        # it is
        net = UNetDiscriminator(nf=NF, dtype=torch.float32)
        net.init_weights(torch.Generator().manual_seed(4))
        nets = {"cpu": net, "cuda": copy.deepcopy(net).cuda(),
                "f64": copy.deepcopy(net).double(),
                "cuda, cuDNN off": copy.deepcopy(net).cuda()}
        x = torch.rand(4, 128, 128, 3, generator=gen)
        outs = {}
        caps = {dev: _capture_convs(d) for dev, d in nets.items()}
        cudnn = torch.backends.cudnn
        saved = cudnn.deterministic, cudnn.benchmark
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            for dev, d in nets.items():
                def run(d=d, dev=dev):
                    out = d(x.double() if dev == "f64" else
                            x.to(dev.split(",")[0]), train=True)
                    (out.square().mean()).backward()
                    d.commit_stats()
                    outs[dev] = out.detach()

                cudnn.enabled = dev != "cuda, cuDNN off"
                if dev == "cuda":
                    kernels = _kernel_calls(run)[0]
                else:
                    run()
        finally:
            cudnn.deterministic, cudnn.benchmark = saved
            cudnn.enabled = True
        scale = float(outs["cpu"].abs().max())
        check("U-Net D (spectral norm) forward, nf 64, b=4 128 px",
              outs["cuda"], outs["cpu"], 1e-4 * scale)
        cpu_sd, card_sd = nets["cpu"].state_dict(), nets["cuda"].state_dict()
        worst_sn = max(float((card_sd[k].cpu() - v).abs().max()
                             / v.abs().max()) for k, v in cpu_sd.items()
                       if ".sn." in k)

        def worst(dev, ref):
            want = dict(nets[ref].named_parameters())
            return max((float((p.grad.cpu().double() - want[k].grad.double()
                               ).abs().max() / want[k].grad.abs().max()), k)
                       for k, p in nets[dev].named_parameters())

        worst_g, name = worst("cuda", "cpu")
        card64, cpu64 = worst("cuda", "f64"), worst("cpu", "f64")
        native64 = worst("cuda, cuDNN off", "f64")
        convs = sorted(k for k in kernels if any(
            s in k.lower() for s in ("fft", "winograd", "gemm", "grad",
                                     "conv")))
        print(f"realesrgan: U-Net D u and sigma after a pass, card vs CPU, "
              f"worst relative error {worst_sn:.3e} (tol 1e-5); gradients "
              f"{worst_g:.3e} of each tensor's largest ({name}; tol 1e-3); "
              f"against an f64 pass on the CPU: card {card64[0]:.3e} "
              f"({card64[1]}), CPU f32 {cpu64[0]:.3e} ({cpu64[1]}), the card "
              f"with cuDNN off (PyTorch's own convolutions) {native64[0]:.3e} "
              f"({native64[1]}); cuDNN ran {convs}")
        if not (worst_sn <= 1e-5 and worst_g <= 1e-3):
            raise AssertionError("realesrgan: the U-Net D on the card")
        _conv3_wgrad_algorithms(smi, caps, nets)
    print(f"realesrgan: ops ok ({smi})")


CONV3_W = (512, 256, 4, 4)  # the U-Net D's conv3 at nf 64: 4x4, stride 2


def _capture_convs(net) -> dict:
    """Wraps each conv of the U-Net D ``net`` so that a pass leaves, by
    conv number, its input (``x``) and the gradient of its output (``g``)
    in the returned dict."""
    caps = {}
    for i in range(10):
        conv = getattr(net, f"conv{i}")
        cap = caps[i] = {}

        def spy(xx, weight=None, bias=None, cap=cap, orig=conv._conv):
            out = orig(xx, weight, bias)
            cap["x"] = xx.detach()
            out.register_hook(lambda grad: cap.__setitem__("g",
                                                           grad.detach()))
            return out

        conv._conv = spy
    return caps


def _conv_weight(conv) -> "torch.Tensor":
    """The weight a conv of the U-Net D ran with: divided by the sigma its
    spectral norm committed after the pass."""
    w = conv.weight.detach()
    return w / conv.sn.sigma if conv.sn is not None else w


def _conv3_wgrad_algorithms(smi: str, caps: dict, nets: dict) -> dict:
    """Where the U-Net D's ``conv3`` weight gradient takes its error on the
    card (ROADMAP Queue C 15), from the check's passes (``caps``: each
    conv's input and output gradient on the card, the CPU and in f64;
    ``nets``: the nets after them). First each conv's output gradient, card
    and CPU, against the f64 pass's, and each conv's input gradient (its
    dgrad) by the check's cuDNN algorithm from the card's own inputs
    against the same in f64, with the kernels it ran; then the weight
    gradient of
    the card's own inputs (4x4, stride 2, padding 1, 256 -> 512 channels
    at 32 -> 16 px, b=4) by cuDNN under the check's flags (deterministic,
    benchmark off), by its default and its benchmarked algorithms, in
    NCHW, by PyTorch's own CUDA convolution (cuDNN off) and as a plain
    product (im2col and one f32 matmul, TF32 off), each against the same
    gradient of the same inputs in f64, with the kernels each ran; beside
    it the CPU's f32 gradient of its own inputs. Returns {way: relative
    error}."""
    import torch
    import torch.nn.functional as F

    def wgrad(xx, gg):
        return torch.ops.aten.convolution_backward(
            gg, xx, torch.empty(CONV3_W, dtype=xx.dtype, device=xx.device),
            None, (2, 2), (1, 1), (1, 1), False, (0, 0), 1,
            (False, True, False))[1]

    def plain(xx, gg):
        cols = F.unfold(xx, 4, padding=1, stride=2)  # (b, 256*16, 256)
        gm = gg.reshape(gg.shape[0], gg.shape[1], -1)  # (b, 512, 256)
        return torch.einsum("bop,bkp->ok", gm, cols).reshape(CONV3_W)

    def rel(a, b):
        a, b = a.cpu().double(), b.cpu().double()
        return float((a - b).abs().max() / b.abs().max())

    print("realesrgan: C 15 each conv's output gradient against the f64 "
          "pass, card / CPU: " + ", ".join(
              f"conv{i} {rel(caps['cuda'][i]['g'], caps['f64'][i]['g']):.2e}"
              f" / {rel(caps['cpu'][i]['g'], caps['f64'][i]['g']):.2e}"
              for i in range(9, -1, -1)))
    cudnn = torch.backends.cudnn
    saved = (cudnn.enabled, cudnn.deterministic, cudnn.benchmark,
             cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        cudnn.deterministic, cudnn.benchmark = True, False
        for i in range(9, 0, -1):
            conv = getattr(nets["cuda"], f"conv{i}")
            w, cap = _conv_weight(conv), caps["cuda"][i]
            args = ((conv.stride,) * 2, ((w.shape[-1] - 1) // 2,) * 2,
                    (1, 1), False, (0, 0), 1, (True, False, False))

            def dgrad(gg, ww, xx=cap["x"], args=args):
                return torch.ops.aten.convolution_backward(
                    gg, torch.empty_like(xx), ww, None, *args)[0]

            res = {}
            calls = _kernel_calls(lambda: res.setdefault(
                "d", dgrad(cap["g"], w)))[0]
            ref = dgrad(cap["g"].cpu().double(), w.cpu().double(),
                        cap["x"].cpu().double())
            print(f"realesrgan: C 15 conv{i} input gradient from the card's "
                  f"inputs, the check's cuDNN algorithm: "
                  f"{rel(res['d'], ref):.3e} of its largest against f64; "
                  f"kernels {dict(calls)}")
    finally:
        (cudnn.enabled, cudnn.deterministic, cudnn.benchmark,
         cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = saved
    caps = {dev: c[3] for dev, c in caps.items()}
    f64 = caps["f64"]
    xc, gc = caps["cuda"]["x"], caps["cuda"]["g"]
    ref_pass = wgrad(f64["x"], f64["g"])
    ref_card = wgrad(xc.cpu().double(), gc.cpu().double())
    out = {"cpu f32, own inputs": rel(wgrad(caps["cpu"]["x"],
                                            caps["cpu"]["g"]),
                                      wgrad(caps["cpu"]["x"].double(),
                                            caps["cpu"]["g"].double()))}
    print(f"realesrgan: C 15 conv3's inputs against the f64 pass: card x "
          f"{rel(xc, f64['x']):.3e}, g {rel(gc, f64['g']):.3e}; CPU x "
          f"{rel(caps['cpu']['x'], f64['x']):.3e}, g "
          f"{rel(caps['cpu']['g'], f64['g']):.3e}; the weight gradient of "
          f"the card's inputs in f64 against the f64 pass's "
          f"{rel(ref_card, ref_pass):.3e} (layout {tuple(xc.stride())})")
    cudnn = torch.backends.cudnn
    saved = (cudnn.enabled, cudnn.deterministic, cudnn.benchmark,
             cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    ways = (("cuDNN deterministic, benchmark off (the check's)", True, True,
             False, True),
            ("cuDNN default, benchmark off", True, False, False, True),
            ("cuDNN benchmark on", True, False, True, True),
            ("cuDNN deterministic, NCHW", True, True, False, False),
            ("PyTorch's CUDA convolution (cuDNN off)", False, False, False,
             True))
    try:
        cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        for way, enabled, det, bench, keep in ways:
            cudnn.enabled, cudnn.deterministic, cudnn.benchmark = \
                enabled, det, bench
            xi, gi = (xc, gc) if keep else (xc.contiguous(), gc.contiguous())
            wgrad(xi, gi)
            res = {}
            calls = _kernel_calls(lambda: res.setdefault("w",
                                                         wgrad(xi, gi)))[0]
            out[way] = rel(res["w"], ref_card)
            print(f"realesrgan: C 15 conv3 weight gradient of the card's "
                  f"inputs, {way}: {out[way]:.3e} of its largest against "
                  f"f64, against the f64 pass {rel(res['w'], ref_pass):.3e};"
                  f" kernels {dict(calls)}")
        cudnn.enabled = True
        res = {}
        calls = _kernel_calls(lambda: res.setdefault(
            "w", plain(xc.contiguous(), gc.contiguous())))[0]
        out["plain product"] = rel(res["w"], ref_card)
        print(f"realesrgan: C 15 conv3 weight gradient of the card's inputs, "
              f"plain product (im2col + one f32 matmul, TF32 off): "
              f"{out['plain product']:.3e}; kernels {dict(calls)}")
    finally:
        (cudnn.enabled, cudnn.deterministic, cudnn.benchmark,
         cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = saved
    best = min((v, k) for k, v in out.items() if "cpu" not in k)
    print(f"realesrgan: C 15 conv3 weight gradient: the check's cuDNN "
          f"algorithm {out[ways[0][0]]:.3e}, the best way on the card "
          f"{best[0]:.3e} ({best[1]}), the CPU's f32 on its inputs "
          f"{out['cpu f32, own inputs']:.3e}; TF32 flags at the check cuDNN "
          f"{saved[3]}, matmul {saved[4]} ({smi})")
    return out


def _resrgan_degrader(smi: str, root: str) -> None:
    """The resrgan degrader on the card: its program on stand-in stages and
    finals (deterministic, exact on the 1/255 lattice) equals the CPU's bit
    for bit; the real program at b=32, 128 -> 32 px: its stages and finals
    as JAX names them, the blur launches and shapes per batch from a trace
    (``RESRGAN_BLUR``: the HR canvas once, the LR canvas three times), the
    output's shape, lattice and range."""
    import numpy as np
    import torch

    from trainner_tpu_torch.data.common import decode_image
    from trainner_tpu_torch.data.pipeline import BatchDegrader
    from trainner_tpu_torch.ops import degradations as D
    from trainner_tpu_torch.options import parse_dict

    corpus = os.path.join(root, "corpus")
    b, hr = BLUR_HR[0], BLUR_HR[1]
    ds = parse_dict(_resrgan_e2e_options(corpus),
                    is_train=True)["datasets"]["train"]
    stand = {"blur": lambda g, x: x * 0.5, "resize": lambda g, x:
             x[:, ::4, ::4], "noise": lambda g, x: x + 0.25,
             "compression": lambda g, x: 1.0 - x, "blur2": lambda g, x:
             x * x, "resize2": lambda g, x: x.flip(2), "noise2":
             lambda g, x: x * 0.75, "final_scale": lambda g, x: x.flip(1),
             "final_blur": lambda g, x: x * 0.5 + 0.125}
    x = (torch.randint(0, 256, (b, hr, hr, 3), generator=torch.Generator(
        ).manual_seed(2)) / 255.0).float()
    outs = {}
    for dev in ("cuda", "cpu"):
        deg = BatchDegrader(ds, "lr")
        deg.stages = [(n, stand[n]) for n, _ in deg.stages]
        deg._resize_finals = [(n, stand[n]) for n, _ in deg._resize_finals]
        deg._comp_finals = []
        outs[dev] = deg(torch.Generator(device=dev).manual_seed(0),
                        x.to(dev))
    same = torch.equal(outs["cuda"].cpu(), outs["cpu"])
    print(f"realesrgan: degrader on stand-ins, b={b} {hr} px: card equals "
          f"CPU bit for bit: {same}")
    if not same:
        raise AssertionError("realesrgan: the degrader's program differs")

    deg = BatchDegrader(ds, "lr")
    names = ([n for n, _ in deg.stages], [n for n, _ in deg.finals])
    if names != (["blur", "resize", "noise", "compression", "blur2",
                  "resize2", "noise2"],
                 ["final_scale", "final_blur", "final_compression"]):
        raise AssertionError(f"realesrgan: stages {names}")
    paths = sorted(os.listdir(corpus))[:b]
    x_u8 = torch.from_numpy(np.stack(
        [decode_image(os.path.join(corpus, n))[:hr, :hr, :3]
         for n in paths])).cuda()
    gen = torch.Generator(device="cuda").manual_seed(11)
    deg(gen, x_u8)
    shapes = {}
    orig = D.apply_kernels

    def spy(xx, kern):
        shapes[tuple(xx.shape)] = shapes.get(tuple(xx.shape), 0) + 1
        return orig(xx, kern)

    D.apply_kernels = spy
    try:
        with _launch_trace({"blur": RESRGAN_BLUR},
                           label="resrgan degrader") as t:
            y = deg(gen, x_u8)
    finally:
        D.apply_kernels = orig
    off = float((y * 255 - (y * 255).round()).abs().max())
    print(f"realesrgan: degrader b={b} {hr}->{hr // 4} px, stages "
          f"{names[0]}, finals {names[1]}: blur launches per batch "
          f"{t['ran']['blur']}, shapes {shapes}; output {tuple(y.shape)} "
          f"off the 1/255 lattice by {off:.1e}, in [{float(y.min()):.3f}, "
          f"{float(y.max()):.3f}]")
    if shapes != RESRGAN_BLUR_SHAPES or off > 1e-4 \
            or tuple(y.shape) != (b, hr // 4, hr // 4, 3) \
            or not (0.0 <= float(y.min()) and float(y.max()) <= 1.0):
        raise AssertionError("realesrgan: the degrader ran otherwise")


def phase_realesrgan(smi: str, root: str) -> dict:
    """``options/sr/train_realesrgan.yml`` on the card at its full width:
    the new ops against the CPU; the degrader on stand-ins against the CPU
    and the real one's blur launches; the degrader as a graph against
    eager; three graphed bf16 steps against eager within the step
    tolerances, 69 + 69 block launches per step from a trace, the step's
    times; the end-to-end rate; then ``main`` on a copy of the options for
    12 iterations and a resume to 16 whose EMA and spectral-norm state
    load bit for bit. Returns the CLI runs' launch traces."""
    t0 = time.perf_counter()
    _resrgan_ops(smi)
    _resrgan_degrader(smi, root)
    _graph_degrader(smi, root, programs=(
        ("fixed order", False, RESRGAN_BLUR, _resrgan_e2e_options),),
        preset="resrgan")
    _graph_step(smi, _resrgan_options, types=(True,), label="resrgan ",
                noise=False)
    _graph_e2e(smi, root, programs=(("resrgan fixed order",
                                     _resrgan_e2e_options),))
    traces = phase_cli(smi, root, RESRGAN_YML, "cli_realesrgan",
                       RESRGAN_BLUR, ("G", "D", "emaG"))
    print(f"realesrgan: ok in {time.perf_counter() - t0:.1f} s ({smi})")
    return {f"realesrgan {k}": v for k, v in traces.items()}


N_ZOO_IMAGES = 4  # serving runs of phase 14 (x8: 32 calls of one shape)
# full-width sr_resnet's steps with train_sr.yml's D-VGG (batch norms):
# each tensor's error as a share of its move, card against CPU, by net (G,
# D), set from the H100's readings (G 1.07e-2, D 1.14e-1); and each
# tensor's distance of the card to the f64 witness at most this many times
# the CPU f32's largest distance to it in the same net (read: G 0.40, D
# 0.78)
SRRESNET_STEP_TOL = {"g": 3e-2, "d": 3e-1}
SRRESNET_F64_TOL = 2.0
ZOO_CPU_LR = (1, 32, 32, 3)  # card against CPU, full width


def _zoo_g() -> dict:
    """Real-ESRGAN's x2 generator: ``mrrdb_net`` at its own 4x behind a
    pixel-unshuffle by 2 of the 2x task (in_nc 12), nf 64 / nb 23 /
    gc 32."""
    return {"scale": 2, "use_unshuffle": True,
            "network_G": {"type": "mrrdb_net", "scale": 4, "nf": NF,
                          "nb": NB, "gc": GC}}


def _zoo_serve_options(root: str, name: str, hr_px: int = 256,
                       **extra) -> str:
    opt = {"name": name, "model": "sr", **_zoo_g(),
           "datasets": {"test_1": {"name": "synth", "mode": "synthetic",
                                   "crop_size": hr_px,
                                   "n_samples": N_ZOO_IMAGES}},
           "path": {"root": root}, "metrics": "psnr,ssim", **extra}
    path = os.path.join(root, name + ".json")
    with open(path, "w") as f:
        json.dump(opt, f)
    return path


def _zoo_serving(smi: str, root: str) -> dict:
    """The test CLI on the x2 layout (128 px LRs, random weights): f32,
    ``use_amp``, CEM (box and cubic, with ``out_orig`` and ``out_keepY``:
    two G forwards per image), x8, and chop on 249 px LRs (3 x 3 tiles of
    128 at rows and columns 0, 112 and 121, unshuffled tile by tile, in
    one forward per image), each under a launch trace with 69 block
    launches per G forward; then the full G on the kernels
    against the same G on the plain versions, and ``eval_step``'s ms per
    forward at b=8 (graphed) in f32 and bf16. Returns the traces."""
    import torch

    from trainner_tpu_torch import test as test_cli
    from trainner_tpu_torch.models import define_G
    from trainner_tpu_torch.ops.blocks import space_to_depth
    from trainner_tpu_torch.options import parse
    from trainner_tpu_torch.train.sr_trainer import SRTrainer, create_trainer

    per_forward = NB * 3
    cem = {"out_orig": True, "out_keepY": True}
    runs = [("zoo_f32", {}, 1), ("zoo_bf16", {"use_amp": True}, 1),
            ("zoo_cem_box", {"use_cem": True, "cem_config": cem}, 2),
            ("zoo_cem_cubic", {"use_cem": True, "cem": {"kernel": "cubic"},
                               "cem_config": cem}, 2),
            ("zoo_x8", {"x8": True}, 8),
            ("zoo_chop", {"chop": True, "hr_px": 498}, 1)]
    traces = {}
    eval_step = SRTrainer.eval_step
    for name, extra, forwards in runs:
        path = _zoo_serve_options(root, name, **extra)
        hr_px = extra.get("hr_px", 256)
        want = {"rdb5c": per_forward * forwards * N_ZOO_IMAGES}
        seen = []

        def spy(self, state, lr, *args, **kw):
            seen.append(tuple(lr.shape))
            return eval_step(self, state, lr, *args, **kw)

        t0 = time.time()
        SRTrainer.eval_step = spy
        try:
            with _launch_trace(want, label=name) as t:
                averages = test_cli.main(["-opt", path])
        finally:
            SRTrainer.eval_step = eval_step
        vals = {m["name"]: m["average"] for m in averages["synth"]}
        pngs = [p for p in os.listdir(os.path.join(root, "results", name,
                                                   "synth"))
                if p.endswith(".png")]
        print(f"zoo: serving {name}: {N_ZOO_IMAGES} images of {hr_px // 2} "
              f"-> {hr_px} px in {time.time() - t0:.2f} s (traced), G's "
              f"inputs {sorted(set(seen))}, launches the card "
              f"ran {t['ran']['rdb5c']} ({per_forward} per G forward x "
              f"{forwards} x {N_ZOO_IMAGES}), the wrapper counted "
              f"{t['counted']['rdb5c']}, metrics {vals}")
        if len(pngs) != N_ZOO_IMAGES or not all(
                math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"zoo {name}: {pngs}, {vals}")
        if name == "zoo_chop" and seen != [(9, 128, 128, 3)] * N_ZOO_IMAGES:
            raise AssertionError(f"zoo chop: G's inputs {seen}, not 3 x 3 "
                                 "tiles of 128 per image")
        traces[f"zoo {name}"] = t

    opt = parse(_zoo_serve_options(root, "zoo_compare"), is_train=False)
    lr = torch.rand(1, 128, 128, 3,
                    generator=torch.Generator().manual_seed(3)).cuda()
    x = space_to_depth(lr, 2)
    for dt, rel_tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        net = define_G(opt, dtype=dt)
        _gain_weights(net, seed=1)
        net = net.cuda().eval()
        with torch.inference_mode():
            got = net(x)
            with _plain_blocks():
                ref = net(x)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        print(f"zoo: full x2 G {dt} kernel vs plain max_abs_err {err:.3e} "
              f"on max|ref| {scale:.3e}, tol {rel_tol * scale:.3e}")
        if got.shape != (1, 256, 256, 3) or not err <= rel_tol * scale:
            raise AssertionError(f"zoo G {dt}: {got.shape}, {err}")
        del net

    lr8 = torch.rand(ZOO_SERVE_SHAPE[0], 128, 128, 3,
                     generator=torch.Generator().manual_seed(4)).cuda()
    for use_amp in (False, True):
        trainer = create_trainer({**opt, "use_amp": use_amp})
        state = trainer.init_state(0)
        for _ in range(trainer.EVAL_CAPTURE_AT + 1):
            trainer.eval_step(state, lr8)
        ms = _time_ms(lambda: trainer.eval_step(state, lr8), iters=10,
                      warmup=1)
        calls, busy, wall = _kernel_calls(
            lambda: trainer.eval_step(state, lr8))
        mpx = lr8.shape[0] * 256 * 256 / 1e6 / (ms / 1e3)
        print(f"times: zoo eval_step {trainer.dtype} b={lr8.shape[0]} 128 "
              f"-> 256 px (graphed): {ms:.3f} ms per forward, {mpx:.3f} "
              f"Mpx/s; device busy {busy:.3f} ms of {wall:.3f} ms in "
              f"{sum(calls.values())} kernels ({smi})")
        if len(trainer.eval_graphs()) != 1:
            raise AssertionError("zoo: eval_step did not replay a graph")
        del trainer, state
        torch.cuda.empty_cache()
    return traces


def _zoo_train_options() -> dict:
    """The x2 layout trained with ``network_D_preset: disc_esrgan`` (D-VGG
    at the crop size, 128) and the flagship losses, parsed by the port."""
    from trainner_tpu_torch.options.config import parse_dict

    opt = {"name": "zoo_step", "model": "sr", **_zoo_g(),
           "network_D_preset": "disc_esrgan",
           "datasets": {"train": {"name": "t", "mode": "aligned",
                                  "dataroot_HR": "/nonexistent",
                                  "crop_size": 128,
                                  "batch_size": TRAIN_SHAPE[0]}},
           "path": {"root": "/nonexistent"},
           "train": _train_options()["train"]}
    return dict(parse_dict(opt, is_train=True))


def _zoo_batch(seed: int = 0) -> dict:
    """b=32, LR 64 -> HR 128 (2x)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return {"LR": torch.rand(TRAIN_SHAPE[0], 64, 64, 3, generator=gen).cuda(),
            "HR": torch.rand(TRAIN_SHAPE[0], 128, 128, 3,
                             generator=gen).cuda()}


def _zoo_cli_edit(opt: dict) -> None:
    """``train_sr.yml`` -> the x2 layout with the D preset."""
    opt.update(_zoo_g())
    opt.pop("network_D", None)
    opt["network_D_preset"] = "disc_esrgan"


def _card_vs_cpu_forward(label: str, opt: dict, lr_shape, dtypes,
                         tag: str = "zoo") -> dict:
    """A G of ``opt`` at full width with gain-0.7 weights, its forward on
    the card against the CPU's on one LR: f32 within 1e-5 of the output's
    size (TF32 off), bf16 within 3e-2; a G of several outputs (PPON) is
    held on all of them. No block kernel may run. Returns the error and
    the output's size by type."""
    import torch

    from trainner_tpu_torch.models import define_G

    def joined(y):
        return torch.cat([t.flatten() for t in y]) if isinstance(
            y, tuple) else y

    lr = torch.rand(*lr_shape, generator=torch.Generator().manual_seed(5))
    readings = {}
    for dt in dtypes:
        rel_tol = 1e-5 if dt == torch.float32 else 3e-2
        net = define_G(opt, dtype=dt)
        _gain_weights(net, seed=2)
        net = net.eval()
        with torch.inference_mode():
            out = net(lr)
            ref = joined(out)
            net = net.cuda()
            with _launch_trace({"rdb5c": 0}, label=label):
                got = joined(net(lr.cuda())).cpu()
        if isinstance(out, tuple):
            out = out[-1]
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        readings[str(dt)] = (err, scale)
        print(f"{tag}: {label} {dt} forward, card vs CPU: max_abs_err "
              f"{err:.3e} on max|ref| {scale:.3e}, tol {rel_tol * scale:.3e}"
              f", output {tuple(out.shape)}, no block kernel launched")
        if not (err <= rel_tol * scale and bool(got.isfinite().all())):
            raise AssertionError(f"{tag} {label} {dt}: {err}")
        del net
    return readings


@contextlib.contextmanager
def _in_f64():
    """Runs the port's code in f64 for a witness: ``.float()`` keeps an
    f64 tensor f64 (the models cast their outputs, the batch norms and the
    losses their inputs, to f32), new tensors default to f64, and the name
    of every op that still yields an f32 tensor is collected in the list
    this yields; 0-d ones are left out (the optimizers' learning rate, the
    same f32 value on every side)."""
    import torch
    from torch.overrides import TorchFunctionMode

    plain_float = torch.Tensor.float
    f32 = []

    def keep(self, *args, **kwargs):
        if self.dtype == torch.float64:
            return self
        return plain_float(self, *args, **kwargs)

    class Watch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and \
                        t.dtype == torch.float32 and t.dim():
                    f32.append(getattr(func, "__name__", str(func)))
            return out

    default = torch.get_default_dtype()
    torch.Tensor.float = keep
    torch.set_default_dtype(torch.float64)
    try:
        with Watch():
            yield f32
    finally:
        torch.Tensor.float = plain_float
        torch.set_default_dtype(default)


def _f64_trainer(opt: dict):
    """The eager CPU trainer of ``opt`` with its nets, the feature net and
    the optimizers' moments in f64 (the witness of ``_in_f64``)."""
    import torch

    from trainner_tpu_torch.train.sr_trainer import create_trainer

    trainer = create_trainer({**opt, "use_amp": False}, device="cpu")
    state = trainer.init_state(0)
    trainer.dtype = torch.float64
    loc = state.loc.net if state.loc is not None else None
    for net in (state.g.net, state.d.net, trainer.generator_loss, loc,
                state.swa):
        if net is None:
            continue
        net.double()
        for m in net.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64
    state.g.opt = trainer._optimizer(state.g.net, "G")
    state.d.opt = trainer._optimizer(state.d.net, "D")
    if loc is not None:
        state.loc.opt = trainer._optimizer(loc, "G")
    if state.grad_hist is not None:
        state.grad_hist["vals"] = state.grad_hist["vals"].double()
    return trainer, state


def _map_tree(fn, tree):
    """``fn`` on every tensor of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


class _SharedDraws:
    """The step's random draws made on the CPU trainer (its own generator,
    recorded by wrapping its ``_draws``; ``choices`` overrides the batch
    augmentation's choice step by step) and handed to the card's trainer
    and the f64 witness as their ``draw_hook``. On the card the hook
    returns clones of staging buffers that ``stage`` fills before each
    step: a graph captures the clones, and each replay reads what was
    staged for it."""

    def __init__(self, cpu_trainer, choices=None):
        self.choices = list(choices) if choices else None
        self.pending = None
        self.buffers = None
        orig = cpu_trainer._draws

        def recording(state, shapes):
            import torch

            d = orig(state, shapes)
            if self.choices:
                d["aug"]["choice"]["idx"] = torch.tensor(
                    self.choices.pop(0))
            self.pending = d
            return d
        cpu_trainer._draws = recording

    def stage(self) -> None:
        if self.buffers is not None:
            flat_b, flat_p = [], []
            _map_tree(flat_b.append, self.buffers)
            _map_tree(flat_p.append, self.pending)
            for b, p in zip(flat_b, flat_p):
                b.copy_(p)

    def card(self, shapes):
        if self.buffers is None:
            self.buffers = _map_tree(
                lambda t: t.to("cuda").clone(), self.pending)
        return _map_tree(lambda t: t.clone(), self.buffers)

    def f64(self, shapes):
        return _map_tree(lambda t: t.double() if t.is_floating_point()
                         else t.clone(), self.pending)


def _load_from(dst, src) -> None:
    """Copies every training tensor of state ``src`` into ``dst`` in place
    (nets, optimizer states, the LocNet, SWA, the clip history): a graph
    captured on ``dst`` stays valid."""
    import torch

    for w in ("g", "d", "loc"):
        a, b = getattr(dst, w), getattr(src, w)
        if a is None:
            continue
        a.net.load_state_dict(b.net.state_dict())
        a.opt.load_state_dict(b.opt.state_dict())
    with torch.no_grad():
        if dst.swa is not None:
            for x, y in zip(dst.swa.parameters(), src.swa.parameters()):
                x.copy_(y)
            dst.swa_n.copy_(src.swa_n)
        if dst.grad_hist is not None:
            for k in ("vals", "n"):
                dst.grad_hist[k].copy_(src.grad_hist[k])


def _train_tensors(state) -> dict:
    """``_net_tensors`` and the LocNet's (``l.``) and SWA weights
    (``s.``)."""
    out = _net_tensors(state)
    if state.loc is not None:
        out.update({f"l.{k}": v.detach().clone()
                    for k, v in state.loc.net.state_dict().items()})
    if state.swa is not None:
        out.update({f"s.{k}": v.detach().clone()
                    for k, v in state.swa.named_parameters()})
    return out


def _d_branches(net, replay=None):
    """``_Branches`` over the forward passes of D (``net``) alone, entered
    by a forward pre-hook and left by a forward hook: D runs the same
    Python on every side, where G's blocks take their LeakyReLU inside
    the kernels on the card. Returns the ``_Branches`` and a function that
    removes the hooks."""
    branches = _Branches(replay)

    def enter(module, args):
        branches.__enter__()

    def leave(module, args, out):
        branches.__exit__(None, None, None)

    hooks = [net.register_forward_pre_hook(enter),
             net.register_forward_hook(leave)]
    return branches, lambda: [h.remove() for h in hooks]


def _steps_card_cpu_f64(label: str, opt: dict, batches, graphs: int = 1,
                        share_draws: bool = False, choices=None,
                        lr: float = None, branches: bool = False) -> dict:
    """Steps of ``opt`` (f32) on the card (graphed: exactly ``graphs``
    programs captured), on the CPU and, as the witness, on the CPU in f64,
    each step from the CPU's state (every training tensor: nets, optimizer
    states, LocNet, SWA, clip history), under deterministic cuDNN with
    TF32 off; with ``share_draws`` the card and the witness take the CPU's
    random draws (``_SharedDraws``). With ``branches``, an eager run on
    the card (equal to the graphed one bit for bit, or this fails) and the
    CPU run record D's branches (``_d_branches``), and each side has its
    own witness, which replays them: the card's distance from it is
    rounding alone, where a LeakyReLU that rounding flips on one side would
    move D's gradients by that element's whole share. Returns per tensor
    (``g.``/``d.``/``l.``/``s.``) the largest, over the steps, of each
    side's distance from its witness rounded to f32 (card against CPU:
    their own distance) as a share of the tensor's move in its witness's
    step (moves under 1e-6 are skipped): ``card_cpu``, ``card_f64``,
    ``cpu_f64``; ``logs``, the logs' largest relative error, card against
    CPU, per step (``logs_by_step``) and overall; with ``branches``,
    ``flips`` per step (D's branches that differ, card against CPU) and
    ``records``. With ``lr`` (an adaptive rule's, whose elements of a
    rounding-level gradient move by about lr either way), also
    ``far_card`` and ``far_cpu``: per tensor the largest share of its
    elements further than 0.02 lr from its side's witness, and
    ``abs_card``, ``abs_cpu``, the largest distances."""
    import torch

    from trainner_tpu_torch.train.sr_trainer import create_trainer

    f32 = {**opt, "use_amp": False}
    trainers = {"cpu": create_trainer(f32, device="cpu"),
                "cuda": create_trainer(f32, device="cuda")}
    witnesses = {"cuda": "f64", "cpu": "f64 cpu" if branches else "f64"}
    if branches:
        trainers["eager"] = create_trainer(f32, device="cuda", graphs=False)
    states = {side: tr.init_state(0) for side, tr in trainers.items()}
    for w in set(witnesses.values()):
        trainers[w], states[w] = _f64_trainer(opt)
    cpu = states["cpu"]
    if share_draws:
        shared = _SharedDraws(trainers["cpu"], choices)
        for side in trainers:
            if side != "cpu":
                trainers[side].draw_hook = shared.f64 if \
                    side.startswith("f64") else shared.card
    order = ["cpu", "cuda"] + (["eager"] if branches else []) + sorted(
        set(witnesses.values()))
    replays = {"f64": "eager", "f64 cpu": "cpu"} if branches else {}
    out = {"card_cpu": {}, "card_f64": {}, "cpu_f64": {}, "logs": 0.0,
           "logs_by_step": [], "far_card": {}, "far_cpu": {},
           "abs_card": {}, "abs_cpu": {}, "flips": [], "records": 0}
    unequal = []
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
             matmul.allow_tf32)
    cudnn.deterministic, cudnn.benchmark = True, False
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        for i, batch in enumerate(batches):
            for side in order[1:]:
                # the card's graphed trainer starts from its own init,
                # which is the CPU's
                if i or side != "cuda":
                    _load_from(states[side], cpu)
            start = {k: v.double() for k, v in _train_tensors(cpu).items()}
            logs, records = {}, {}
            for side in order:
                d_net = states[side].d.net if states[side].d else None
                rec = None
                if branches and d_net is not None and side != "cuda":
                    rec, remove = _d_branches(d_net, records.get(
                        replays.get(side)))
                try:
                    if side.startswith("f64"):
                        with _in_f64() as f32_ops:
                            logs[side] = trainers[side].train_step(
                                states[side], {k: v.double() for k, v in
                                               batch.items()})[1]
                        if f32_ops:
                            raise AssertionError(
                                f"{label}: the f64 witness ran f32 ops "
                                f"{sorted(set(f32_ops))}")
                    else:
                        dev = "cpu" if side == "cpu" else "cuda"
                        if side != "cpu" and share_draws:
                            shared.stage()
                        logs[side] = trainers[side].train_step(
                            states[side], {k: v.to(dev) for k, v in
                                           batch.items()})[1]
                finally:
                    if rec is not None:
                        remove()
                if rec is None:
                    continue
                if side in replays:
                    if rec.replay:
                        raise AssertionError(
                            f"{label}: {len(rec.replay)} of D's branch "
                            f"records left over in the {side} witness")
                else:
                    records[side] = rec.records
            if branches and records:
                if len(records["eager"]) != len(records["cpu"]):
                    raise AssertionError(f"{label}: D recorded "
                                         f"{len(records['eager'])} branch "
                                         f"ops on the card, "
                                         f"{len(records['cpu'])} on the CPU")
                out["records"] = len(records["cpu"])
                out["flips"].append(_Branches.flips(records["eager"],
                                                    records["cpu"]))
            step_worst = 0.0
            for k, want in logs["cpu"].items():
                got = float(logs["cuda"][k])
                step_worst = max(step_worst, abs(got - float(want))
                                 / max(abs(float(want)), 1e-3))
            out["logs_by_step"].append(step_worst)
            out["logs"] = max(out["logs"], step_worst)
            t = {side: {k: v.cpu().double() for k, v in
                        _train_tensors(states[side]).items()}
                 for side in order}
            if branches:
                unequal += [(i, k) for k, v in t["cuda"].items()
                            if not torch.equal(v, t["eager"][k])]
                unequal += [(i, k) for k, v in logs["cuda"].items()
                            if not torch.equal(v, logs["eager"][k])]
            for k in t["cpu"]:
                for side in ("cuda", "cpu"):
                    exact = t[witnesses[side]][k]
                    if exact.dtype != torch.float64:
                        raise AssertionError(f"{label}: witness tensor {k} "
                                             f"is {exact.dtype}")
                    # against the witness rounded once to f32, the type
                    # the sides hold: a small move of a weight near 1 (a
                    # batch norm's scale under a clipped step) is else
                    # read against its own storage's rounding
                    err = (t[side][k] - exact.float().double()).abs()
                    name = "card" if side == "cuda" else "cpu"
                    if lr is not None and not k.endswith(("running_mean",
                                                          "running_var")):
                        far = float((err > 0.02 * lr).double().mean())
                        out[f"far_{name}"][k] = max(
                            out[f"far_{name}"].get(k, 0.0), far)
                        out[f"abs_{name}"][k] = max(
                            out[f"abs_{name}"].get(k, 0.0),
                            float(err.max()))
                    moved = float((exact - start[k]).abs().max())
                    if moved <= 1e-6:
                        continue
                    pairs = [("cpu_f64", err)] if side == "cpu" else [
                        ("card_f64", err),
                        ("card_cpu", (t["cuda"][k] - t["cpu"][k]).abs())]
                    for key, e in pairs:
                        out[key][k] = max(out[key].get(k, 0.0),
                                          float(e.max()) / moved)
    finally:
        (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
         matmul.allow_tf32) = saved
    if unequal:
        raise AssertionError(f"{label}: the graphed card's steps differ "
                             f"from the eager card's: {unequal[:8]}")
    captured = len(trainers["cuda"].step_graphs())
    if captured != graphs:
        raise AssertionError(f"{label}: the card's steps captured "
                             f"{captured} graphs, want {graphs}")
    return out


def _worst(readings: dict, prefix: str) -> tuple:
    """The largest reading of the tensors under ``prefix``, and its
    name."""
    return max(((v, k) for k, v in readings.items()
                if k.startswith(prefix)), default=(0.0, "none"))


def _zoo_srresnet_and_plus(smi: str) -> None:
    """Full-width ``sr_resnet`` (nf 64, nb 16, relu, pixel shuffle, 4x):
    its forward card against CPU in f32 and bf16, and 3 steps with
    ``train_sr.yml``'s D-VGG-128 (batch norms) in f32 (b=4, 32 -> 128 px,
    SGD at lr 1e-2, whose updates are linear in the gradients), each from
    the CPU's state on the card (graphed), the CPU and an f64 witness on
    the CPU (``_steps_card_cpu_f64``): logs within 1e-4 relative; every
    tensor of G and D within ``SRRESNET_STEP_TOL`` of its move, card
    against CPU; and no tensor of the card further from the witness than
    ``SRRESNET_F64_TOL`` times the CPU f32's largest distance in the same
    net. f32 rounding moves D's weight gradients by up to 11 % of a move
    on the CPU as on the card (sums over every pixel of a real and a fake
    batch that nearly cancel, through batch statistics of 4 x 8 x 8
    samples), G's by up to 2 %; a fault of the card's program would move
    them further from the witness than the CPU's own rounding does. Then
    ESRGAN+ (``rrdb_net`` with ``plus``, nf 64, nb 23, gc
    32), whose blocks run the composite chain on cuDNN: its f32 forward
    card against CPU."""
    import torch

    from trainner_tpu_torch.options.config import parse_dict

    # the CLI runs before this one may have turned TF32 on
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def options(network_G, **train):
        return dict(parse_dict({
            "name": "zoo_srresnet", "model": "sr", "scale": 4,
            "network_G": network_G,
            "network_D": {"type": "discriminator_vgg", "size": 128,
                          "base_nf": 64},
            "path": {"root": "/nonexistent"},
            "train": {**_train_options()["train"], **train}},
            is_train=True))

    srresnet = options({"type": "sr_resnet"}, optim_G="sgd", optim_D="sgd",
                       lr_G=1e-2, lr_D=1e-2)
    g = srresnet["network_G"]
    if (g["nf"], g["nb"], g["act_type"], g["upsample_mode"]) != (
            64, 16, "relu", "pixelshuffle") or \
            srresnet["network_D"]["norm_type"] != "batch":
        raise AssertionError(f"zoo: sr_resnet config {g}, "
                             f"{srresnet['network_D']}")
    _card_vs_cpu_forward("sr_resnet", srresnet, ZOO_CPU_LR,
                         (torch.float32, torch.bfloat16))

    gen = torch.Generator().manual_seed(6)
    batches = [{"LR": torch.rand(4, 32, 32, 3, generator=gen),
                "HR": torch.rand(4, 128, 128, 3, generator=gen)}
               for _ in range(3)]
    r = _steps_card_cpu_f64("zoo: sr_resnet", srresnet, batches)
    bad = []
    for net in ("g", "d"):
        cc, f64, cpu = (_worst(r[key], net + ".") for key in
                        ("card_cpu", "card_f64", "cpu_f64"))
        step_tol, f64_tol = SRRESNET_STEP_TOL[net], SRRESNET_F64_TOL * cpu[0]
        print(f"zoo: sr_resnet with D-VGG-128 (batch norms), 3 f32 SGD "
              f"steps (lr 1e-2) b=4 32 -> 128 px, {net.upper()}'s tensors "
              f"as a share of their move: card vs CPU up to {cc[0]:.3e} "
              f"({cc[1]}; tol {step_tol}); against the f64 witness: card "
              f"{f64[0]:.3e} ({f64[1]}; tol {f64_tol:.3e}), CPU f32 "
              f"{cpu[0]:.3e} ({cpu[1]}) ({smi})")
        bad += [(k, v, step_tol) for k, v in r["card_cpu"].items()
                if k.startswith(net + ".") and not v <= step_tol]
        bad += [(k, v, f64_tol) for k, v in r["card_f64"].items()
                if k.startswith(net + ".") and not v <= f64_tol]
    print(f"zoo: sr_resnet logs card vs CPU within {r['logs']:.3e} "
          f"relative (tol 1e-4)")
    if bad or not r["logs"] <= 1e-4:
        raise AssertionError(f"zoo: sr_resnet step: {bad}, logs "
                             f"{r['logs']}")
    torch.cuda.empty_cache()

    plus = options({"type": "rrdb_net", "nf": NF, "nb": NB, "gc": GC,
                    "plus": True})
    _card_vs_cpu_forward("ESRGAN+ rrdb_net plus", plus, ZOO_CPU_LR,
                         (torch.float32,))


def phase_zoo(smi: str, root: str) -> dict:
    """Phase 14: the SR generator options at full width. Serving the x2
    layout (``_zoo_serving``); its step with ``disc_esrgan`` as a graph
    against eager (bf16, b=32, 64 -> 128 px; 69 + 69 block launches per
    replay, from a trace; step ms and device busy); ``train_sr.yml`` with
    the x2 layout through the CLI for 12 iterations and a resume to 16
    that loads bit for bit; then ``sr_resnet`` and ESRGAN+ card against
    CPU. Returns the main paths' launch traces."""
    t0 = time.perf_counter()
    traces = _zoo_serving(smi, root)
    _graph_step(smi, _zoo_train_options, types=(True,), label="zoo x2 ",
                noise=False, batch_fn=_zoo_batch)
    cli_traces = phase_cli(smi, root, TRAIN_YML, "cli_zoo",
                           edit=_zoo_cli_edit)
    traces.update({f"zoo cli {k}": v for k, v in cli_traces.items()})
    _zoo_srresnet_and_plus(smi)
    print(f"zoo: ok in {time.perf_counter() - t0:.1f} s ({smi})")
    return traces


# ---------------------------------------------------------------------------
# 15. degradations: the realsr and combo strategies and every on-device op
# ---------------------------------------------------------------------------

N_POOL = 16          # seeded KernelGAN-style kernels of 21 x 21 (.npy)
N_NOISE_IMAGES = 8   # seeded 1/f noise PNGs for the patches
NOISE_PX = 96
COMBO_Q = (5, 128, 128, 3), (5, 32, 32, 3)  # combo's routing q-slices
# combo's blur launches per batch (shuffled, with its pool): 2 passes x 7
# slots x (blur, blur2) on q-slices, the pool on the HR canvas of the batch
# padded to 7 q = 35, and final_blur in both orders of the finals
COMBO_BLUR = {COMBO_Q[0]: 14, COMBO_Q[1]: 14, (35, 128, 128, 3): 1,
              BLUR_LR: 2}
# the degrader with every op of the slice: its blur stage at the HR canvas
# and unsharp_mask at the LR one
ALL_OPS_BLUR = {BLUR_HR: 1, BLUR_LR: 1}
REALSR_NITER = 6
CPU_SHAPE = (8, 64, 64, 3)  # card against CPU of each op
SHARE_TOL = 1e-2  # k-means, SOM, SLIC, CLAHE: pixels that may differ


def _write_assets(root: str) -> tuple:
    """The user directories of the two strategies, from seeds: a
    KernelGAN-style pool (``N_POOL`` anisotropic gaussians of 21 x 21 as
    ``.npy``, one of 25 x 25 that the loader crops, one ``.mat`` written
    with ``scipy.io.savemat``) and ``N_NOISE_IMAGES`` 1/f noise PNGs by
    the corpus writer. Returns (kernels dir, noise dir)."""
    import numpy as np
    from scipy.io import savemat

    kdir, ndir = os.path.join(root, "kernels"), os.path.join(root, "noise")
    os.makedirs(kdir)
    rng = np.random.default_rng(2024)

    def kernel(size):
        ax = np.arange(size) - (size - 1) / 2
        xx, yy = np.meshgrid(ax, ax)
        t = rng.uniform(0, np.pi)
        sx, sy = rng.uniform(0.5, 3.5, 2)
        xr = np.cos(t) * xx + np.sin(t) * yy
        yr = -np.sin(t) * xx + np.cos(t) * yy
        return np.exp(-0.5 * ((xr / sx) ** 2 + (yr / sy) ** 2)) \
            * rng.uniform(0.5, 2.0)

    for i in range(N_POOL):
        np.save(os.path.join(kdir, f"kernel_{i:02d}.npy"),
                kernel(21).astype(np.float32))
    np.save(os.path.join(kdir, "kernel_25x25.npy"), kernel(25))
    savemat(os.path.join(kdir, "kernel_mat.mat"), {"Kernel": kernel(21)})
    _write_corpus(ndir, n=N_NOISE_IMAGES, px=NOISE_PX, seed=77)
    return kdir, ndir


def _strategy_edit(strategy: str, assets: tuple):
    """``train_sr.yml`` -> ``augs_strategy`` with its assets; the inline
    resize types are dropped so that the strategy's own (combo's list with
    ``realistic``, code 999) apply."""
    def edit(opt: dict) -> None:
        ds = opt["datasets"]["train"]
        for key in ("lr_downscale", "lr_downscale_types"):
            ds.pop(key, None)
        ds.update(augs_strategy=strategy, dataroot_kernels=assets[0],
                  noise_data=assets[1])
    return edit


def _strategy_options(strategy: str, assets: tuple):
    """The end-to-end configuration with ``strategy``'s own presets and its
    assets, for ``_graph_degrader``."""
    def options(corpus: str, shuffle: bool = False) -> dict:
        opt = _e2e_options(corpus)
        ds = opt["datasets"]["train"]
        del ds["shuffle_degradations"], ds["resize_strat"]
        ds.update(augs_strategy=strategy, dataroot_kernels=assets[0],
                  noise_data=assets[1])
        return opt
    return options


def _all_ops_options(corpus: str, shuffle: bool = False) -> dict:
    """Every op of the slice that no preset reaches, in one fixed-order
    degrader: box, motion, median and bilateral blur at the HR canvas; the
    cubic resize; speckle, s&p, every quantize and dither kind, CLAHE,
    superpixels and maxrgb as noise candidates; webp by the DCT
    approximation; auto levels, unsharp and fringes."""
    opt = _e2e_options(corpus)
    ds = opt["datasets"]["train"]
    del ds["augs_strategy"]
    noise = ["speckle", "s&p", "quantize", "km_quantize", "simple_quantize",
             "dither", "bayer_dither", "avg_dither", "bin_dither",
             "rnd_dither", "fs_dither", "bw_dither", "clahe", "superpixels",
             "maxrgb"]
    ds.update(lr_blur=True, lr_blur_types=["box", "motion", "median",
                                           "bilateral"],
              lr_downscale=True, lr_downscale_types=["cubic"],
              lr_noise=True, lr_noise_types=noise, compression=["webp"],
              lr_auto_levels=True, lr_rand_auto_levels=0.5,
              lr_unsharp_mask=True, lr_rand_unsharp=0.7, lr_fringes=True,
              lr_fringes_chance=0.6,
              aug_configs={t: {"p": 1.0} for t in noise + [
                  "box", "motion", "median", "bilateral", "webp"]})
    return opt


def _crops(root: str, shape) -> "torch.Tensor":
    """Corpus crops (b, h, w, 3) in [0, 1] on the 1/255 lattice, CPU."""
    import numpy as np
    import torch

    from trainner_tpu_torch.data.common import decode_image

    corpus = os.path.join(root, "corpus")
    b, h, w, _ = shape
    names = sorted(os.listdir(corpus))[:b]
    return torch.from_numpy(np.stack(
        [decode_image(os.path.join(corpus, n))[:h, :w, :3] for n in names]
    )).float() / 255.0


def _ops_card_vs_cpu(smi: str, root: str, assets: tuple) -> dict:
    """Each op of the slice on the card against the CPU, on the same inputs
    (corpus crops, ``CPU_SHAPE``) and the same draws (made on the CPU):
    the linear and smooth ones within 1e-5 (filters, colours, kernel
    banks, speckle, unsharp, auto levels, bilateral, the pool, the
    patches), the exact ones bit for bit (median, quantize, every dither
    kind, maxrgb, s&p, fringes); k-means, SOM, SLIC and CLAHE by the share
    of pixels whose colour differs by more than 1e-5 (argmin ties and bin
    edges over sums added in another order), printed and held to
    ``SHARE_TOL``. Returns {op: error or share}."""
    import torch

    from trainner_tpu_torch.data import kernels as K
    from trainner_tpu_torch.data.pipeline import _full_f32
    from trainner_tpu_torch.ops import colors as C
    from trainner_tpu_torch.ops import degradations as D
    from trainner_tpu_torch.ops import filters as F
    from trainner_tpu_torch.ops import superpixel as S

    gen = torch.Generator().manual_seed(15)
    x = _crops(root, CPU_SHAPE)
    b, h, w, _ = x.shape
    xc = x.cuda()
    out = {}

    def on_card(v):
        if isinstance(v, dict):
            return {k: on_card(t) for k, t in v.items()}
        return v.cuda() if isinstance(v, torch.Tensor) else v

    def check(name, fn, args, tol=None, share=False):
        got = fn(*on_card(args)).cpu()
        want = fn(*args)
        if share:
            diff = (got - want).abs().reshape(-1, got.shape[-1]).amax(-1)
            val = float((diff > 1e-5).float().mean())
            ok = val <= SHARE_TOL
            what = f"share of pixels off by more than 1e-5 {val:.4%} " \
                   f"(tol {SHARE_TOL:.0%})"
        elif tol is None:
            val = float((got - want).abs().max())
            ok = torch.equal(got, want)
            what = f"bit for bit {ok}"
        else:
            val = float((got - want).abs().max())
            ok = val <= tol
            what = f"max_abs_err {val:.3e} (tol {tol:.0e})"
        out[name] = val
        print(f"degradations: {name} card vs CPU: {what}")
        if not ok:
            raise AssertionError(f"degradations: {name} on the card")

    with _full_f32():
        k21 = D.draw_motion_kernels(gen, b)
        check("motion_kernels k 21", D.motion_kernels, (k21, 21), 1e-6)
        check("box_kernels k 21", D.box_kernels,
              (D.draw_box_kernels(gen, b), 21), 1e-6)
        check("speckle_noise", D.speckle_noise,
              (x, D.draw_speckle_noise(gen, x.shape)), 1e-6)
        check("salt_pepper_noise", D.salt_pepper_noise,
              (x, D.draw_salt_pepper_noise(gen, x.shape, (0.01, 0.1))))
        check("unsharp_mask (blur kernel, k 11)", D.unsharp_mask,
              (x, D.draw_unsharp_mask(gen, b)), 1e-5)
        check("auto_levels", D.auto_levels, (x, 1.0), 1e-5)
        check("fringes", D.fringes, (x, D.draw_fringes(gen, b)))
        check("max_rgb", D.max_rgb, (x,))
        check("quantize_colors", D.quantize_colors, (x, 32))
        check("ordered_dither", D.ordered_dither, (x, 1))
        for kind in ("bayer", "fs", "rnd", "avg", "bin"):
            for bw in (False, True):
                check(f"dither_batch {kind}{' bw' if bw else ''}",
                      D.dither_batch, (x, kind, 1, bw,
                                       D.draw_dither(gen, x.shape, kind)))
        check("median_blur k 3", D.median_blur, (x, 3))
        check("median_blur k 11", D.median_blur, (x, 11))
        check("bilateral_blur k 9", D.bilateral_blur, (x, 9, 75.0, 75.0),
              1e-5)
        check("kmeans_quantize 32", D.kmeans_quantize,
              (x, D.draw_kmeans_quantize(gen, x.shape), 32), share=True)
        check("som_quantize 32", D.som_quantize,
              (x, D.draw_som_quantize(gen, x.shape, 32), 32), share=True)
        check("clahe_batch", D.clahe_batch,
              (x, D.draw_clahe(gen, 4.0)), share=True)
        check("superpixel_structure 200", S.superpixel_structure,
              (x, S.draw_superpixel_structure(gen, b), 200), share=True)
        pool = torch.from_numpy(K.load_kernel_pool(assets[0]))
        patches = torch.from_numpy(K.load_noise_patches(assets[1], 16))
        check("apply_kernel_pool (blur kernel, k 21)", K.apply_kernel_pool,
              (x, pool, K.draw_kernel_pool(gen, b, pool.shape[0]), 4), 1e-5)
        check("apply_noise_patches", K.apply_noise_patches,
              (x, patches, K.draw_noise_patches(gen, b, patches.shape[0])),
              1e-6)
        check("filter2d_per_sample", F.filter2d_per_sample,
              (x, D.motion_kernels(k21, 21)[:, 5:16, 5:16]), 1e-5)
        check("filter_low / filter_high", lambda v: torch.cat(
            [F.filter_low(v, 9), F.filter_high(v, 9, filter_type="average"),
             F.filter2d(v, F.log_kernel(5, 0.8))], -1), (x,), 1e-5)
        check("colours", lambda v: torch.cat(
            [C.rgb_to_yuv(v), C.yuv_to_rgb(v, "ycbcr"), C.srgb_to_linear(v),
             C.linear_to_srgb(v), C.rgb_to_grayscale(v)], -1), (x,), 1e-6)
    n_pool = pool.shape[0]
    print(f"degradations: pool of {n_pool} kernels (the 25 x 25 cropped, "
          f"the .mat read), {patches.shape[0]} noise patches; every op "
          f"holds card against CPU ({smi})")
    if n_pool != N_POOL + 2:
        raise AssertionError(f"degradations: a pool of {n_pool} kernels")
    return out


def _blur_shapes(deg, gen, x) -> dict:
    """The shapes of the blur kernel's launches in one call of the
    degrader ``deg`` (an eager program), by shape."""
    from trainner_tpu_torch.ops import degradations as D

    shapes = {}
    orig = D.apply_kernels

    def spy(xx, kern):
        key = tuple(xx.shape)
        shapes[key] = shapes.get(key, 0) + 1
        return orig(xx, kern)

    D.apply_kernels = spy
    try:
        deg(gen, x)
    finally:
        D.apply_kernels = orig
    return shapes


def _caller_blur_rows(smi: str, assets: tuple) -> dict:
    """The blur kernel as this slice's callers give it work: the pool's
    kernels and the motion banks (k 21) at the HR and LR canvases, combo's
    routing q-slices (k 21), and unsharp_mask's gaussians (k 11) at both
    canvases; each row's kernel ms, device ms (through the record-counting
    ``_device_ms``), bound, plain ms and the library call's ms."""
    import torch

    from trainner_tpu_torch.data import kernels as K
    from trainner_tpu_torch.ops import degradations as D

    gen = torch.Generator().manual_seed(16)
    pool = K.load_kernel_pool(assets[0])
    rows = {}
    for label, shape in (("pool", BLUR_HR), ("pool", BLUR_LR),
                         ("motion", BLUR_HR), ("motion", BLUR_LR),
                         ("combo q-slice", COMBO_Q[0]),
                         ("combo q-slice", COMBO_Q[1]),
                         ("unsharp k 11", BLUR_HR),
                         ("unsharp k 11", BLUR_LR)):
        b = shape[0]
        if label == "pool":
            kern = torch.from_numpy(pool)[torch.randint(
                0, pool.shape[0], (b,), generator=gen)]
        elif label == "unsharp k 11":
            kern = D.gaussian_kernels(D.draw_unsharp_mask(gen, b)["kernel"],
                                      D.UNSHARP_K)
        else:
            kern = D.motion_kernels(D.draw_motion_kernels(gen, b), BLUR_K)
        x = torch.rand(*shape, generator=gen).cuda()
        rows[label, shape] = _blur_time_row(smi, x, kern.cuda(),
                                            f", {label}")
    return rows


def phase_degradations(smi: str, root: str) -> tuple:
    """Phase 15: the realsr and combo strategies and every on-device
    degradation op. Writes the assets (``_write_assets``); holds each op
    card against CPU (``_ops_card_vs_cpu``); the degrader with every op of
    the slice, combo's (shuffled, with its pool and patches) and realsr's
    (the patches on the dataset's LR) as CUDA graphs against their eager
    programs from one generator state, at b=32, crop 128, with their blur
    launches per batch by shape and their times graphed and eager (device
    busy, idle share); then ``train_sr.yml`` through the training CLI with
    ``augs_strategy: combo`` and its assets at full width (12 iterations
    and a resume to 16, ``COMBO_BLUR`` blur launches per batch and 69 + 69
    block launches per step from the trace) and with ``realsr`` (6
    iterations, no blur); last the blur kernel's rows for this slice's
    callers. Returns (the CLI runs' traces, the blur rows)."""
    import torch

    from trainner_tpu_torch.data.pipeline import BatchDegrader
    from trainner_tpu_torch.options import parse_dict

    t0 = time.perf_counter()
    assets = _write_assets(os.path.join(root, "assets"))
    _ops_card_vs_cpu(smi, root, assets)
    corpus = os.path.join(root, "corpus")
    cases = (("every op of the slice", ALL_OPS_BLUR, _all_ops_options),
             ("combo, shuffled, with its assets", COMBO_BLUR,
              _strategy_options("combo", assets)),
             ("realsr, with its patches", {},
              _strategy_options("realsr", assets)))
    os.environ["TRAINNER_DEVICE_WEBP"] = "approx"
    try:
        for label, want, options in cases:
            ds = parse_dict(options(corpus), is_train=True)["datasets"][
                "train"]
            deg = BatchDegrader(ds, "lr")
            x = _crops(root, BLUR_HR if deg.stages[0][0] != "noise"
                       else BLUR_LR).cuda()
            shapes = _blur_shapes(deg, torch.Generator(
                device="cuda").manual_seed(1), x)
            print(f"degradations: {label}: stages "
                  f"{[n for n, _ in deg.stages]}, finals "
                  f"{[n for n, _ in deg.finals]}, program "
                  f"{deg.program()[0]}; blur launches per batch by shape "
                  f"{shapes} (expected {want})")
            if shapes != want:
                raise AssertionError(f"degradations: {label} blur shapes")
        _graph_degrader(smi, root, [
            (label, None, sum(want.values()), options)
            for label, want, options in cases], preset="phase 15")
    finally:
        del os.environ["TRAINNER_DEVICE_WEBP"]
    traces = {}
    runs = phase_cli(smi, root, TRAIN_YML, "cli_combo",
                     per_batch=sum(COMBO_BLUR.values()),
                     edit=_strategy_edit("combo", assets))
    traces.update({f"combo cli {k}": v for k, v in runs.items()})
    runs = phase_cli(smi, root, TRAIN_YML, "cli_realsr", per_batch=0,
                     edit=_strategy_edit("realsr", assets),
                     niter=REALSR_NITER, resume=False)
    traces.update({f"realsr cli {k}": v for k, v in runs.items()})
    rows = _caller_blur_rows(smi, assets)
    print(f"degradations: ok in {time.perf_counter() - t0:.1f} s ({smi})")
    return traces, rows


# ---------------------------------------------------------------------------
# losses: the rest of the loss stack on train_sr.yml
# ---------------------------------------------------------------------------

# train_sr.yml's commented loss block (lines 82-88) switched on, with the
# type and the criterion that cx and hfen need to make an entry, and
# wgan-gp with its penalty in place of the vanilla GAN
LOSS_STACK = {"cx_weight": 0.5, "cx_type": "contextual",
              "hfen_weight": 1e-6, "hfen_criterion": "l1",
              "tv_type": "tv", "tv_weight": 1e-5,
              "ssim_type": "ms-ssim", "ssim_weight": 0.2,
              "lpips_weight": 0.5, "gan_type": "wgan-gp", "gp_weight": 10}
LOSS_NAMES = ["l_g_pix", "l_g_fea", "l_g_cx", "l_g_lpips", "l_g_HFEN",
              "l_g_tv", "l_g_ssim"]
LOSS_D = {"type": "discriminator_vgg_128_sn", "base_nf": 64}
LOSS_CPU = (2, 128, 128, 3)   # each loss and the penalty, card against CPU
FEATNET_CPU = (4, 64, 64, 3)  # the ResNet-101 and MINC feature losses
# card against CPU, f32, TF32 off: a value within LOSS_VALUE_TOL of the
# CPU's. A gradient through ReLUs (VGG), LeakyReLUs (D), an L1 or a max
# jumps where an input lies within rounding of a kink, and the card and the
# CPU round differently (ROADMAP C 15): so each side's gradient is held to
# an f64 run of the port's code that takes the branches that side took
# (``_Branches``), within LOSS_GRAD_TOL of the largest element
LOSS_VALUE_TOL = 1e-4
LOSS_GRAD_TOL = 1e-3
CARD = "cuda"  # the card's side of those comparisons


def _write_loss_assets(root: str) -> tuple:
    """A converted-VGG19 file (``path.vgg_weights``) and an LPIPS squeeze
    file holding the backbone only (``path.lpips_weights``; the bundled
    lin vectors complete it), drawn from a numpy seed: He-scaled kernels,
    small biases. Returns their paths."""
    import numpy as np

    from trainner_tpu_torch.losses.lpips import SqueezeFeatures
    from trainner_tpu_torch.models.perceptual import VGG_CFGS

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(16)

    def conv(k, cin, cout):
        return ((rng.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin))
                 ).astype(np.float32),
                (rng.randn(cout) * 0.01).astype(np.float32))

    vgg, cin = {}, 3
    for b, n in enumerate(VGG_CFGS["vgg19"], start=1):
        cout = 64 * min(2 ** (b - 1), 8)
        for c in range(1, n + 1):
            vgg[f"conv{b}_{c}/kernel"], vgg[f"conv{b}_{c}/bias"] = conv(
                3, cin, cout)
            cin = cout
    squeeze = {}
    for name, m in SqueezeFeatures().named_children():
        squeeze[f"net/{name}/kernel"], squeeze[f"net/{name}/bias"] = conv(
            m.kernel_size[0], m.in_channels, m.out_channels)
    paths = (os.path.join(root, "vgg19.npz"),
             os.path.join(root, "lpips_squeeze.npz"))
    np.savez(paths[0], **vgg)
    np.savez(paths[1], **squeeze)
    return paths


def _loss_stack_options(vgg: str):
    """The step's options: the flagship at full width with the loss stack,
    D-VGG-128 with spectral norm, ``path.vgg_weights`` the seeded file."""
    def options(**train) -> dict:
        opt = _train_options(**{**LOSS_STACK, **train})
        opt["network_D"] = dict(LOSS_D)
        opt["path"] = {"vgg_weights": vgg}
        return opt
    return options


def _loss_stack_edit(vgg: str, squeeze: str):
    """``train_sr.yml`` with the loss stack, its D and the seeded files;
    validation with ``psnr,ssim,lpips``."""
    def edit(opt: dict) -> None:
        opt["network_D"] = dict(LOSS_D)
        opt["train"].update(LOSS_STACK, metrics="psnr,ssim,lpips")
        opt["path"] = {**(opt.get("path") or {}), "vgg_weights": vgg,
                       "lpips_weights": squeeze}
    return edit


def _f64_copy(module):
    """A copy of ``module`` in f64, its ``dtype`` attributes too (the
    witness of ``_in_f64``)."""
    import copy

    import torch

    m = copy.deepcopy(module).double()
    for sub in m.modules():
        if isinstance(getattr(sub, "dtype", None), torch.dtype):
            sub.dtype = torch.float64
    return m


def _rel(a, b) -> float:
    """|a - b| over |b| for floats; for tensors, or dicts of them, the
    largest element's distance over b's largest, the worst tensor's."""
    if isinstance(b, dict):
        return max(_rel(a[k], v) for k, v in b.items())
    if isinstance(b, float):
        return abs(a - b) / max(abs(b), 1e-12)
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


class _Branches:
    """Records the branch every piecewise op of a run takes (the masks of
    ``relu`` and ``leaky_relu``, the signs of ``abs``, the picks of
    ``max_pool2d``, ``amax`` and ``amin``), on the host, in call order;
    given the records of another run, makes each op take that run's
    branch instead (a mask, a sign or a gather, so gradients follow it
    too). An f64 run that replays the card's branches differs from the
    card's by rounding alone, where a branch that rounding flips would
    move a gradient by its whole share."""

    OPS = ("relu", "leaky_relu", "abs", "max_pool2d", "amax", "amin")

    def __init__(self, replay=None):
        self.replay = None if replay is None else list(replay)
        self.records = []

    def __enter__(self):
        from torch.overrides import TorchFunctionMode

        branches = self

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = getattr(func, "__name__", "")
                if name not in _Branches.OPS:
                    return func(*args, **kwargs)
                return branches._op(name, func, args, kwargs)

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)

    def _op(self, name, func, args, kwargs):
        import torch
        import torch.nn.functional as F

        x = args[0]
        if self.replay is None:
            out = func(*args, **kwargs)
            if name == "relu":
                rec = x > 0
            elif name == "leaky_relu":
                rec = x > 0
            elif name == "abs":
                rec = x.sign().to(torch.int8)
            elif name == "max_pool2d":
                rec = F.max_pool2d(*args, **{**kwargs,
                                             "return_indices": True})[1]
            else:
                dim = args[1] if len(args) > 1 else kwargs["dim"]
                pick = x.argmax if name == "amax" else x.argmin
                rec = pick(dim, keepdim=True)
            self.records.append(rec.cpu())
            return out
        rec = self.replay.pop(0).to(x.device)
        if name == "relu":
            return torch.where(rec, x, torch.zeros_like(x))
        if name == "leaky_relu":
            slope = kwargs.get("negative_slope",
                               args[1] if len(args) > 1 else 0.01)
            return torch.where(rec, x, x * slope)
        if name == "abs":
            return x * rec.to(x.dtype)
        if name == "max_pool2d":
            return x.flatten(2).gather(2, rec.flatten(2)).view(rec.shape)
        dim = args[1] if len(args) > 1 else kwargs["dim"]
        keep = kwargs.get("keepdim", args[2] if len(args) > 2 else False)
        out = x.gather(dim, rec)
        return out if keep else out.squeeze(dim)

    @staticmethod
    def flips(a, b) -> int:
        """How many elements' branches differ between two records."""
        return sum(int((x != y).sum()) for x, y in zip(a, b))


def _three_ways(label: str, run, smi: str) -> dict:
    """``run(side)`` for side 'cpu', 'cuda' and 'f64' -> (value, gradient:
    a tensor or a dict of them). Runs the CPU and the card, recording
    their branches (``_Branches``), then the port's code in f64 on the
    CPU (``_in_f64``) three times: free, with the card's branches and with
    the CPU's. Prints and returns the readings; fails unless the card's
    value is within ``LOSS_VALUE_TOL`` of the CPU's and its gradient within
    ``LOSS_GRAD_TOL`` of the f64 gradient on its own branches."""
    def host(g):
        return {k: v.detach().double().cpu().clone() for k, v in g.items()} \
            if isinstance(g, dict) else g.detach().double().cpu().clone()

    got, records = {}, {}
    for side, replay in (("cpu", None), ("cuda", None), ("f64", None),
                         ("f64 card", "cuda"), ("f64 cpu", "cpu")):
        with _Branches(records.get(replay)) as branches:
            if side.startswith("f64"):
                with _in_f64() as f32:
                    value, grad = run("f64")
                if f32:
                    raise AssertionError(f"losses: the f64 run of {label} "
                                         f"ran f32 ops {sorted(set(f32))}")
            else:
                value, grad = run(side)
        if replay is None:
            records[side] = branches.records
        elif branches.replay:
            raise AssertionError(f"losses: {label}: {len(branches.replay)}"
                                 f" branch records left over")
        got[side] = (float(value), host(grad))
    r = {"value": _rel(got["cuda"][0], got["cpu"][0]),
         "grad": _rel(got["cuda"][1], got["cpu"][1]),
         "card_f64": _rel(got["cuda"][1], got["f64"][1]),
         "cpu_f64": _rel(got["cpu"][1], got["f64"][1]),
         "card_own_f64": _rel(got["cuda"][1], got["f64 card"][1]),
         "cpu_own_f64": _rel(got["cpu"][1], got["f64 cpu"][1])}
    flips = {side: _Branches.flips(records[side], records["f64"])
             for side in ("cuda", "cpu")}
    print(f"losses: {label}, card against CPU (f32, TF32 off) and each "
          f"against f64: value {got['cuda'][0]:.6g} (CPU "
          f"{got['cpu'][0]:.6g}, f64 {got['f64'][0]:.6g}); "
          + ", ".join(f"{k} {v:.3e}" for k, v in r.items())
          + f"; branches off f64's: card {flips['cuda']}, CPU "
          f"{flips['cpu']} of {sum(t.numel() for t in records['f64'])} "
          f"({smi})")
    if not (math.isfinite(got["cuda"][0]) and r["value"] <= LOSS_VALUE_TOL
            and r["card_own_f64"] <= LOSS_GRAD_TOL):
        raise AssertionError(f"losses: {label}: {r}")
    return r


def _losses_card_vs_cpu(smi: str, vgg: str, squeeze: str) -> None:
    """Each loss of the stack, the penalty and the ResNet-101 and MINC
    feature losses, card against CPU in f32 with TF32 off and each against
    an f64 run (``_three_ways``); the LPIPS metric card against CPU; the
    refusal of wgan-gp with a batch-norm D."""
    import copy

    import numpy as np
    import torch

    from trainner_tpu_torch.losses.gan import AdversarialLoss
    from trainner_tpu_torch.losses.generator_loss import GeneratorLoss
    from trainner_tpu_torch.losses.lpips import LPIPSMetric
    from trainner_tpu_torch.losses.perceptual import PerceptualLoss
    from trainner_tpu_torch.models.networks import define_D
    from trainner_tpu_torch.train.sr_trainer import create_trainer

    opt = {"train": {**_train_options()["train"], **LOSS_STACK},
           "path": {"vgg_weights": vgg}}
    cpu = GeneratorLoss(opt, device_dtype=torch.float32)
    names = [e.name for e in cpu.entries]
    if names != LOSS_NAMES:
        raise AssertionError(f"losses: the stack's entries {names}")
    fns = {"cpu": cpu, "cuda": copy.deepcopy(cpu).to(CARD),
           "f64": _f64_copy(cpu)}
    gen = torch.Generator().manual_seed(16)
    hr = torch.rand(LOSS_CPU, generator=gen)
    sr = (hr + 0.1 * torch.randn(LOSS_CPU, generator=gen)).clamp(0, 1)

    def tensors(side, *ts):
        """Fresh leaves of ``ts`` for one side."""
        return [t.double().detach().clone() if side == "f64"
                else t.detach().to(side).clone() for t in ts]

    for i, name in enumerate(names):
        def run(side, i=i):
            e = fns[side].entries[i]
            x, y = tensors(CARD if side == "cuda" else side, sr, hr)
            x.requires_grad_(True)
            val = e.fn(x, y) if e.needs_target else e.fn(x)
            val.backward()
            return val.detach(), x.grad
        _three_ways(f"{name} at {LOSS_CPU}", run, smi)

    # the penalty: wgan-gp's D stage on D-VGG-128 with spectral norm
    d_cpu = define_D({"network_D": dict(LOSS_D)}, dtype=torch.float32)
    d_cpu.init_weights(torch.Generator().manual_seed(1))
    nets = {"cpu": d_cpu, "cuda": copy.deepcopy(d_cpu).to(CARD),
            "f64": _f64_copy(d_cpu)}
    fake, real = torch.rand(LOSS_CPU, generator=gen), \
        torch.rand(LOSS_CPU, generator=gen)
    alpha = torch.rand((LOSS_CPU[0], 1, 1, 1), generator=gen)
    adv = AdversarialLoss(gan_type="wgan-gp", gp_weight=10.0)
    gps = {}

    def d_stage(side):
        d = nets[side]
        d.zero_grad(set_to_none=True)
        f, r, a = tensors(CARD if side == "cuda" else side, fake, real,
                          alpha)
        total, logs = adv.discriminator_loss(
            lambda x: d(x, train=True), f, r, alpha=a)
        total.backward()
        gps[side] = float(logs["l_d_gp"].detach())
        return total.detach(), {k: p.grad for k, p in d.named_parameters()}
    _three_ways(f"wgan-gp D stage at {LOSS_CPU} (gp_weight 10, D-VGG-128 "
                f"with spectral norm; the gradient is D's, through the "
                f"penalty's double backward)", d_stage, smi)
    print(f"losses: l_d_gp card {gps['cuda']:.6g}, CPU {gps['cpu']:.6g}, "
          f"f64 {gps['f64']:.6g}")
    if _rel(gps["cuda"], gps["cpu"]) > LOSS_VALUE_TOL:
        raise AssertionError("losses: l_d_gp card against CPU")

    # the LPIPS metric on the seeded squeeze file
    rng = np.random.RandomState(17)
    a = (rng.rand(128, 128, 3) * 255).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.randint(-30, 30, a.shape), 0,
                255).astype(np.uint8)
    vals = {side: LPIPSMetric(net="squeeze", weights_path=squeeze,
                              device=dev)(a, b)
            for side, dev in (("cpu", "cpu"), ("cuda", CARD))}
    print(f"losses: LPIPS metric (squeeze, seeded backbone, bundled lin) "
          f"on a 128 px pair: card {vals['cuda']:.6g}, CPU "
          f"{vals['cpu']:.6g}, {_rel(vals['cuda'], vals['cpu']):.3e} "
          f"({smi})")
    if _rel(vals["cuda"], vals["cpu"]) > LOSS_VALUE_TOL:
        raise AssertionError("losses: the LPIPS metric card against CPU")

    # the single-tap feature losses
    x = torch.rand(FEATNET_CPU, generator=gen)
    y = torch.rand(FEATNET_CPU, generator=gen)
    for arch in ("resnet101", "minc"):
        ploss = PerceptualLoss(arch=arch, dtype=torch.float32)
        feats = {"cpu": ploss, "cuda": copy.deepcopy(ploss).to(CARD),
                 "f64": _f64_copy(ploss)}

        def run(side):
            xs, ys = tensors(CARD if side == "cuda" else side, x, y)
            xs.requires_grad_(True)
            val = feats[side](xs, ys)
            val.backward()
            return val.detach(), xs.grad
        _three_ways(f"{arch} feature loss at {FEATNET_CPU}", run, smi)

    # wgan-gp with a batch-norm D is refused, as the JAX step fails there
    bad = _loss_stack_options(vgg)()
    bad["network_D"] = {"type": "discriminator_vgg", "size": 128,
                        "base_nf": 64}
    try:
        create_trainer(bad, device=CARD).init_state(0)
    except NotImplementedError as e:
        if "ROADMAP C 18" not in str(e):
            raise
        print(f"losses: wgan-gp with a batch-norm D refused: {e}")
    else:
        raise AssertionError("losses: wgan-gp with a batch-norm D ran")
    del fns, nets, feats
    torch.cuda.empty_cache()


def _loss_stack_step_times(smi: str, vgg: str) -> None:
    """The graphed bf16 step at b=32, 32 -> 128 px, with the loss stack
    beside the flagship's, 10 steps each in turns (flagship, stack, stack,
    flagship); each one's replay traced (device busy, kernels), its peak
    memory over the warm-up and capture, its graph pool; then the device
    time of each added loss (forward and backward, eager, at the step's
    shapes and dtypes) and of the penalty (the D stage with it less
    without it)."""
    import dataclasses

    import torch

    from trainner_tpu_torch.train.sr_trainer import create_trainer

    batch = _train_batch(seed=1)
    runs = {}
    for name, options in (("loss stack", _loss_stack_options(vgg)),
                          ("flagship", _train_options)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr = create_trainer(options())
        st = tr.init_state(0)
        for _ in range(3):
            tr.train_step(st, batch)
        torch.cuda.synchronize()
        runs[name] = (tr, st, torch.cuda.max_memory_allocated() - base,
                      next(iter(tr.step_graphs().values())))
    ms = {}
    for name in ("flagship", "loss stack", "loss stack", "flagship"):
        tr, st = runs[name][:2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            tr.train_step(st, batch)
        torch.cuda.synchronize()
        ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e2)
    busy = {}
    for name, (tr, st, peak, cap) in runs.items():
        calls, busy[name], wall = _kernel_calls(
            lambda: tr.train_step(st, batch))
        print(f"times: {name} step graphed, bf16, b=32 32->128 px: ms per "
              f"step over 10 in turns (flagship, stack, stack, flagship) "
              f"{ms[name]}, it/s {1e3 / min(ms[name]):.4f}; one replay "
              f"traced: device busy {busy[name]:.3f} ms in "
              f"{sum(calls.values())} kernels, wall {wall:.3f} ms; peak "
              f"memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated over "
              f"its warm-up and capture); graph pool "
              f"{cap.pool_bytes / 2 ** 20:.1f} MiB ({smi})")
    tr, st = runs["loss stack"][:2]
    gen = torch.Generator(device="cuda").manual_seed(2)
    fake = torch.rand(batch["HR"].shape, device="cuda", generator=gen)
    hr = batch["HR"]
    parts = {}
    for e in tr.generator_loss.entries:
        if e.name in ("l_g_cx", "l_g_lpips", "l_g_ssim", "l_g_HFEN",
                      "l_g_tv"):
            def loss(e=e):
                x = fake.clone().requires_grad_(True)
                (e.fn(x, hr) if e.needs_target else e.fn(x)).backward()
            loss()
            parts[e.name] = _kernel_calls(loss)[1]
    net_d = st.d.net
    for gp in (tr.adversarial.gp_weight, None):
        adv = dataclasses.replace(tr.adversarial, gp_weight=gp)

        def d_stage(adv=adv):
            l_d, _ = adv.discriminator_loss(
                lambda x: net_d(x, train=True), fake, hr,
                generator=st.noise_generator)
            l_d.backward()
        d_stage()
        parts["D stage" if gp is None else "D stage with the penalty"] = \
            _kernel_calls(d_stage)[1]
    parts["the penalty's pass"] = parts.pop("D stage with the penalty") \
        - parts["D stage"]
    print(f"times: device ms of each added part (eager, one call under "
          f"the profiler, forward and backward, b=32 at 128 px): "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f"; the replays' busy times differ by "
          f"{busy['loss stack'] - busy['flagship']:.3f} ms (the stack's D "
          f"has spectral norm, the flagship's batch norm) ({smi})")
    del runs, tr, st
    torch.cuda.empty_cache()


def phase_losses(smi: str, root: str) -> dict:
    """Phase 16: the rest of the loss stack. Writes the seeded weight
    files (``_write_loss_assets``); holds each loss, the penalty, the
    LPIPS metric and the ResNet-101 and MINC losses card against CPU
    (``_losses_card_vs_cpu``); the step with the stack as a graph against
    eager (``_graph_step``: within the step tolerances, 69 + 69 block
    launches per replay from a trace, times in turns); its time beside the
    flagship's, its memory and the device time of each added part
    (``_loss_stack_step_times``); then ``train_sr.yml`` with the stack
    through the training CLI (12 iterations and a resume to 16, 69 + 69
    block and 24 blur launches per step from the trace, LPIPS in each
    validation) and its rate eager and graphed in turns. Returns the CLI
    runs' traces."""
    t0 = time.perf_counter()
    vgg, squeeze = _write_loss_assets(os.path.join(root, "loss_assets"))
    _losses_card_vs_cpu(smi, vgg, squeeze)
    _graph_step(smi, _loss_stack_options(vgg), types=(True,),
                label="loss stack ", noise=False)
    _loss_stack_step_times(smi, vgg)
    runs = phase_cli(smi, root, TRAIN_YML, "cli_losses",
                     edit=_loss_stack_edit(vgg, squeeze))
    with open(os.path.join(root, "cli_losses_options.json")) as f:
        name = json.load(f)["name"]
    rows = [json.loads(line) for line in open(os.path.join(
        root, "cli_losses", "experiments", name, "tb", "scalars.jsonl"))]
    lpips = {r["step"]: r["value"] for r in rows if r["tag"] == "val/lpips"}
    losses = {r["tag"] for r in rows if r["tag"].startswith("train/l_")}
    want = {f"train/{k}" for k in LOSS_NAMES + ["l_d_gp"]}
    print(f"losses: cli_losses validation LPIPS {lpips}; losses logged "
          f"{sorted(losses)}")
    if sorted(lpips) != [CLI_FREQ, CLI_NITER] or not all(
            math.isfinite(v) and v >= 0 for v in lpips.values()) \
            or not want <= losses:
        raise AssertionError(f"losses: the CLI's scalars: lpips {lpips}, "
                             f"missing {sorted(want - losses)}")
    _graph_cli(smi, root, "cli_losses_options.json",
               "train_sr.yml with the loss stack")
    print(f"losses: ok in {time.perf_counter() - t0:.1f} s ({smi})")
    return {f"loss stack cli {k}": v for k, v in runs.items()}


OPT_CROP = 112  # AdaTarget with D-VGG: a crop of a multiple of 7 x scale
# the CLI's crop: its bsrgan pipeline compresses the LR in 8 x 8 blocks
# (jpeg), so the LR must be a multiple of 8 too: 224 = lcm(28, 32)
OPT_CLI_CROP = 224
OPT_ATG_START, OPT_SWA_START = 4, 6
OPT_GRAPH_STEPS = 8   # graphed against eager, across both starts
OPT_TIME_STEPS = 5    # steps per turn in the option times
OPT_F64_TOL = 4.0     # card's distance from its witness over the CPU's
# ... or this share of a tensor's move: each side's witness takes that
# side's branches of D, so what is left between them is rounding
OPT_MOVE_FLOOR = 1e-3
OPT_FAR_FLOOR = 1e-3  # adaptive rules: share of elements past 0.02 lr
OPT_FLIP = 2.05       # ... and every element within a whole step taken
#                       the other way: twice its tensor's largest move
ADAPTIVE = ("rmsprop", "adamp", "ranger", "madgrad")
# cutout first, so that mixalpha can give it a drop rate alone (an alpha
# for rgb or cutmixup raises a TypeError in both packages)
OPT_AUGS = ["cutout", "blend", "rgb", "mixup", "cutmix", "cutmixup",
            "cutblur"]
OPT_POLICIES = ("color,translation,cutout", "flip,rotate",
                "zoom_in,zoom_out", "offset,offset_h,offset_v")


def _options_cell(crop: int = OPT_CROP, **train) -> dict:
    """``train_sr.yml``'s flagship at full width with its commented
    trainer options on (AdaTarget from 4, SWA from 6 at 5e-5, FreezeD 4,
    the yml's mixup, DiffAugment color,translation,cutout, fs, norm clip
    at 1.0, a virtual batch of 2), at ``crop``."""
    opt = _train_options(**{
        "atg_start_iter": OPT_ATG_START, "swa_start_iter": OPT_SWA_START,
        "swa_lr": 5e-5, "freeze_loc": 4, "mixup": True,
        "mixopts": ["blend", "rgb", "mixup", "cutmix", "cutmixup"],
        "diffaug": True, "dapolicy": "color,translation,cutout", "fs": True,
        "grad_clip": "norm", "grad_clip_value": 1.0,
        "virtual_batch_size": 2, **train})
    opt["network_D"]["size"] = crop
    opt["use_atg"] = opt["use_swa"] = True
    return opt


def _options_batch(seed: int, crop: int = OPT_CROP,
                   batch: int = TRAIN_SHAPE[0]) -> dict:
    import torch

    gen = torch.Generator().manual_seed(seed)
    return {"LR": torch.rand(batch, crop // 4, crop // 4, 3,
                             generator=gen).cuda(),
            "HR": torch.rand(batch, crop, crop, 3, generator=gen).cuda()}


def _small_options(**train) -> dict:
    """The small configuration of the card-against-CPU runs: G nf 32, nb
    1, gc 32 (the block kernels at their narrowest unpadded width) without
    the latent noise (whose draws the sides cannot share), D-VGG base_nf
    16 at 32 px with batch norms, pixel and GAN losses (no VGG19, whose
    three copies per option would take most of the time), SGD at 1e-2
    unless ``train`` says otherwise."""
    opt = _train_options(**{"optim_G": "sgd", "optim_D": "sgd",
                            "lr_G": 1e-2, "lr_D": 1e-2, **train})
    opt["network_G"].update(nf=32, nb=1, gc=32, gaussian_noise=False)
    opt["network_D"].update(size=32, base_nf=16)
    for key in ("feature_criterion", "feature_weight"):
        opt["train"].pop(key)
    return opt


def _noise_only(key: str, keys) -> bool:
    """D's tensors whose gradient is rounding alone: a conv's bias before a
    batch norm, which takes the batch's mean out, and the head's bias,
    which the relativistic loss takes out."""
    return key == "d.linear1.bias" or (key.startswith("d.") and key.endswith(
        ".bias") and key[:-len("bias")] + "norm.weight" in keys)


def _options_card_cpu(smi: str) -> None:
    """(a) Each option at small widths: steps on the card (graphed, f32,
    TF32 off), on the CPU and on f64 witnesses of the port's code, the
    card and the witnesses taking the CPU's random draws, each side's
    witness on that side's branches of D (``_steps_card_cpu_f64`` with
    ``share_draws`` and ``branches``; the card's eager run equal to its
    graphed one bit for bit). Every optimizer, ``grad_clip: auto``, a
    virtual batch of 2, FreezeD, fs, each DiffAugment policy (four
    configurations), each batch augmentation (one configuration of seven
    steps, one choice each), AdaTarget (across its start, at a 28-px crop)
    and SWA (across its start). Passes where the first step's logs agree
    within 1e-4 and no tensor of the card is further from its witness
    than ``OPT_F64_TOL`` times the CPU f32's largest distance from its own
    in the same net, or ``OPT_MOVE_FLOOR`` of its move. Under an adaptive
    rule (lr 1e-4), where an element whose gradient is below rounding
    moves by about lr either way, each tensor's share of elements further
    than 0.02 lr from the witness is held to ``OPT_F64_TOL`` times the
    CPU's (or ``OPT_FAR_FLOOR``) and every element to ``OPT_FLIP`` of its
    tensor's largest move; D's tensors whose whole gradient is rounding
    (``_noise_only``) are held together: their largest distance from the
    witness to ``OPT_F64_TOL`` times the CPU's."""
    import torch

    gen = torch.Generator().manual_seed(17)

    def batches(n, px=32):
        return [{"LR": torch.rand(4, px // 4, px // 4, 3, generator=gen),
                 "HR": torch.rand(4, px, px, 3, generator=gen)}
                for _ in range(n)]

    atg = _small_options(atg_start_iter=1)
    atg["use_atg"] = True
    atg["network_D"]["size"] = 28
    swa = _small_options(swa_start_iter=1, swa_lr=2e-3)
    swa["use_swa"] = True
    # (label, options, steps, crop, batch augmentation choices, graphs)
    configs = [(f"optimizer {o}", _small_options(
        optim_G=o, optim_D=o, lr_G=1e-4 if o in ADAPTIVE else 1e-2,
        lr_D=1e-4 if o in ADAPTIVE else 1e-2), 3, 32, None, 1)
        for o in ("rmsprop", "adamp", "sgdp", "ranger", "madgrad")]
    configs += [
        # steps 0 and 2 update G, step 1 does not: two programs
        ("grad_clip auto", _small_options(grad_clip="auto",
                                          D_update_ratio=2), 3, 32, None, 2),
        ("virtual_batch_size 2", _small_options(virtual_batch_size=2), 3,
         32, None, 1),
        ("freeze_loc 4", _small_options(freeze_loc=4), 3, 32, None, 1),
        ("fs", _small_options(fs=True), 3, 32, None, 1)]
    configs += [(f"diffaug {p}", _small_options(diffaug=True, dapolicy=p),
                 3, 32, None, 1) for p in OPT_POLICIES]
    configs += [
        ("batch augmentations", _small_options(
            mixup=True, mixopts=OPT_AUGS, mixalpha=[0.2]),
         len(OPT_AUGS), 32, list(range(len(OPT_AUGS))), 1),
        # AdaTarget's program from step 1 on: two programs
        ("AdaTarget", atg, 3, 28, None, 2), ("SWA", swa, 3, 32, None, 1)]
    t0 = time.perf_counter()
    bad = []
    for label, opt, n, px, choices, graphs in configs:
        adaptive = opt["train"]["optim_G"] in ADAPTIVE
        lr = opt["train"]["lr_G"]
        r = _steps_card_cpu_f64(f"options: {label}", opt, batches(n, px),
                                graphs=graphs, share_draws=True,
                                choices=choices, branches=True,
                                lr=lr if adaptive else None)
        parts = [f"D's {r['records']} branch ops per step, flipped card vs "
                 f"CPU by step {r['flips']}"]
        if adaptive:
            noise = [k for k in r["far_card"]
                     if _noise_only(k, r["far_card"])]
            for k, share in r["far_card"].items():
                if k in noise:
                    continue
                tol = max(OPT_F64_TOL * r["far_cpu"][k], OPT_FAR_FLOOR)
                flip = r["card_f64"].get(k, 0.0)
                if not (share <= tol and flip <= OPT_FLIP):
                    bad.append((label, k, share, tol, flip))
            worst = max((v, k) for k, v in r["far_card"].items()
                        if k not in noise)
            flip = max((v, k) for k, v in r["card_f64"].items()
                       if k not in noise)
            card_n, cpu_n = (max(r[key][k] for k in noise) / lr
                             for key in ("abs_card", "abs_cpu"))
            if not card_n <= OPT_F64_TOL * cpu_n:
                bad.append((label, "noise-only", card_n, cpu_n))
            parts.append(f"elements past 0.02 lr of the witness: card up "
                         f"to {worst[0]:.2e} of {worst[1]} (CPU "
                         f"{r['far_cpu'][worst[1]]:.2e}); largest distance "
                         f"{flip[0]:.3f} of its tensor's move ({flip[1]}; "
                         f"tol {OPT_FLIP}); D's {len(noise)} tensors of a "
                         f"rounding gradient: card up to {card_n:.3f} lr "
                         f"from the witness, CPU {cpu_n:.3f} lr")
        for net in ("g", "d", "l", "s") if not adaptive else ():
            if not any(k.startswith(net + ".") for k in r["cpu_f64"]):
                continue
            f64, cpu = (_worst(r[key], net + ".")
                        for key in ("card_f64", "cpu_f64"))
            tol = max(OPT_F64_TOL * cpu[0], OPT_MOVE_FLOOR)
            parts.append(f"{net}: card {f64[0]:.2e} ({f64[1]}), CPU "
                         f"{cpu[0]:.2e} ({cpu[1]}), tol {tol:.2e}")
            bad += [(label, k, v, tol) for k, v in r["card_f64"].items()
                    if k.startswith(net + ".") and not v <= tol]
        if not r["logs_by_step"][0] <= 1e-4:
            bad.append((label, "logs", r["logs_by_step"], 1e-4))
        print(f"options: {label}, {n} f32 steps card (graphed; its eager "
              f"run equal bit for bit) / CPU / f64 on shared draws, each "
              f"side's witness on its own branches of D; each tensor's "
              f"distance from the witness as a share of its move: "
              f"{'; '.join(parts)}; logs card vs CPU by step "
              f"{[f'{v:.1e}' for v in r['logs_by_step']]} ({smi})")
        torch.cuda.empty_cache()
    print(f"options: card against CPU and f64, {len(configs)} "
          f"configurations in {time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError(f"options: card against the f64 witness: "
                             f"{bad}")


def _options_graphed_vs_eager(smi: str) -> None:
    """(b) The full-width options cell (bf16, b=32, 28 -> 112 px), the
    graphed trainer against the eager one from one seed over
    ``OPT_GRAPH_STEPS`` steps across AdaTarget's start and SWA's, under
    deterministic cuDNN: every log, parameter, buffer, optimizer state,
    LocNet and SWA weight equal bit for bit; the programs captured ((True,
    True, False) and (True, True, True)); a replay of each traced: 69 x 2
    + 69 x 2 block launches before AdaTarget (two microbatches), 69 + 69
    with it."""
    import torch

    from trainner_tpu_torch.train.sr_trainer import create_trainer

    batches = [_options_batch(seed=20 + i) for i in range(OPT_GRAPH_STEPS)]
    runs = {}
    cudnn = torch.backends.cudnn
    cudnn.deterministic = True
    try:
        for graphs in (True, False):
            tr = create_trainer(_options_cell(), graphs=graphs)
            st = tr.init_state(0)
            logs = [tr.train_step(st, b)[1] for b in batches]
            torch.cuda.synchronize()
            runs[graphs] = (tr, st, logs)
    finally:
        cudnn.deterministic = False
    (tg, sg, lg), (te, se, le) = runs[True], runs[False]
    differ = [f"step {i} {k}" for i, (a, b) in enumerate(zip(lg, le))
              for k in b if not torch.equal(a[k], b[k])]
    ta, tb = _state_tensors(sg), _state_tensors(se)
    differ += [k for k in tb if not (
        torch.equal(ta[k], tb[k]) if isinstance(tb[k], torch.Tensor)
        else ta[k] == tb[k])]
    keys = sorted(tg.step_graphs())
    print(f"options: full-width cell (bf16, b=32, {OPT_CROP // 4} -> "
          f"{OPT_CROP} px; AdaTarget from {OPT_ATG_START}, SWA from "
          f"{OPT_SWA_START}), {OPT_GRAPH_STEPS} graphed steps against "
          f"{OPT_GRAPH_STEPS} eager ones: {len(ta)} state tensors and "
          f"counts and {sum(len(x) for x in le)} logs, {len(differ)} not "
          f"equal bit for bit {differ[:8]}; swa_n {int(sg.swa_n)}; step "
          f"graphs {[k[:3] for k in keys]} ({smi})")
    if differ or int(sg.swa_n) != OPT_GRAPH_STEPS - OPT_SWA_START or \
            sorted(k[:3] for k in keys) != [(True, True, False),
                                            (True, True, True)]:
        raise AssertionError(f"options: graphed against eager: {differ}")
    per_g = NB * 3
    for label, step, want_g in (("virtual batch", 1, 2 * per_g),
                                ("AdaTarget", OPT_ATG_START, per_g)):
        sg.step = step
        _reset_launches()
        calls, busy, wall = _kernel_calls(
            lambda: tg.train_step(sg, batches[0]))
        traced = _calls_per_wrapper(calls.elements())
        want = {"rdb5c": want_g, "rdb5c_bwd": want_g, "blur": 0}
        print(f"options: one replay of the {label} program traced: "
              f"{traced} block launches (want {want}), "
              f"{sum(calls.values())} kernels, device busy {busy:.3f} ms "
              f"of {wall:.3f} ms ({smi})")
        if traced != want:
            raise AssertionError(f"options: {label} replay {traced}")
    del runs, tg, sg, te, se
    torch.cuda.empty_cache()


def _options_cli_edit(opt: dict) -> None:
    """``train_sr.yml`` with the options cell's trainer options (the clip
    ``auto``, so that the checkpoint carries its history) at
    ``OPT_CLI_CROP``."""
    cell = _options_cell(grad_clip="auto")
    opt["use_atg"] = opt["use_swa"] = True
    opt["datasets"]["train"]["crop_size"] = OPT_CLI_CROP
    opt["network_D"]["size"] = OPT_CLI_CROP
    keys = ("atg_start_iter", "swa_start_iter", "swa_lr", "freeze_loc",
            "mixup", "mixopts", "diffaug", "dapolicy", "fs", "grad_clip",
            "virtual_batch_size")
    opt["train"].update({k: cell["train"][k] for k in keys})


def _options_cli(smi: str, root: str) -> dict:
    """(c) The training CLI on the cell at ``OPT_CLI_CROP`` (b=32, 56 ->
    224 px; 12 iterations and a resume to 16
    that restores SWA, the LocNet, the clip history and every optimizer
    state bit for bit; 69 x 2 + 69 x 2 block launches per step before
    AdaTarget, 69 + 69 after, 24 blur launches per shuffled batch, from
    the trace); the ``16_swaG`` file equal to the state's SWA weights and
    served by the port's test CLI with ``which: swa``."""
    import numpy as np

    from trainner_tpu_torch import test as test_cli
    from trainner_tpu_torch.utils import checkpoint

    per_g = NB * 3
    runs = phase_cli(smi, root, TRAIN_YML, "cli_options",
                     edit=_options_cli_edit,
                     g_launches=lambda n: per_g * (
                         1 if n > OPT_ATG_START else 2))
    with open(os.path.join(root, "cli_options_options.json")) as f:
        opt = json.load(f)
    exp = os.path.join(root, "cli_options", "experiments", opt["name"])
    swa_file = os.path.join(exp, "models", f"{CLI_RESUME_NITER}_swaG.ckpt")
    with open(os.path.join(exp, "training_state",
                           f"{CLI_RESUME_NITER}.state"), "rb") as f:
        tree = checkpoint.msgpack_restore(f.read())
    with open(swa_file, "rb") as f:
        swa = checkpoint.msgpack_restore(f.read())
    flat_a, flat_b = [], []
    _map_tree(flat_a.append, tree["swa_params"])
    _map_tree(flat_b.append, swa)
    same = len(flat_a) == len(flat_b) and all(
        np.array_equal(a, b) for a, b in zip(flat_a, flat_b))
    serve = {"name": "serve_swa", "model": "sr", "scale": 4,
             "which": "swa",
             "datasets": {"test_1": {
                 "name": "val", "mode": "aligned",
                 "dataroot_HR": opt["datasets"]["val"]["dataroot_HR"],
                 "dataroot_LR": opt["datasets"]["val"]["dataroot_LR"]}},
             "network_G": opt["network_G"],
             "path": {"root": os.path.join(root, "serve_swa"),
                      "pretrain_model_G": swa_file},
             "metrics": "psnr,ssim"}
    path = os.path.join(root, "serve_swa.json")
    with open(path, "w") as f:
        json.dump(serve, f)
    averages = test_cli.main(["-opt", path])
    psnr = [m["average"] for m in averages["val"] if m["name"] == "psnr"]
    print(f"options: {CLI_RESUME_NITER}_swaG.ckpt equals the state's SWA "
          f"weights bit for bit: {same} (swa_n {int(tree['swa_n'])}); "
          f"served by the test CLI with which: swa, PSNR {psnr} ({smi})")
    if not same or not psnr or not all(math.isfinite(v) for v in psnr) \
            or int(tree["swa_n"]) != CLI_RESUME_NITER - OPT_SWA_START:
        raise AssertionError("options: the SWA checkpoint or its serving")
    return {f"options cli {k}": v for k, v in runs.items()}


def _options_times(smi: str) -> None:
    """(d) The graphed bf16 step at full width (b=32, 32 -> 128 px) with
    each optimizer (G and D), ``grad_clip: auto`` and a virtual batch of 2
    against the flagship (Adam), and the options cell (at its 112 px
    crop, in AdaTarget's program with SWA's update) against it:
    ``OPT_TIME_STEPS`` steps each in turns (flagship, other, other,
    flagship) after three warm-up steps, by CUDA events on the card's
    clock."""
    import torch

    from trainner_tpu_torch.train.sr_trainer import create_trainer

    def warm(options, batch):
        tr = create_trainer(options)
        st = tr.init_state(0)
        for _ in range(3):
            tr.train_step(st, batch)
        torch.cuda.synchronize()
        return tr, st

    def timed(tr, st, batch):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(OPT_TIME_STEPS):
            tr.train_step(st, batch)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / OPT_TIME_STEPS

    batch = _train_batch(seed=1)
    flag = warm(_train_options(), batch)
    others = [(f"optimizer {o}", _train_options(optim_G=o, optim_D=o),
               batch) for o in ("rmsprop", "adamp", "sgdp", "ranger",
                                "madgrad")]
    others += [("grad_clip auto", _train_options(grad_clip="auto"), batch),
               ("virtual_batch_size 2",
                _train_options(virtual_batch_size=2), batch),
               (f"options cell at {OPT_CROP} px",
                _options_cell(atg_start_iter=0, swa_start_iter=0),
                _options_batch(seed=2))]
    for label, options, b in others:
        other = warm(options, b)
        ms = {"flagship": [], label: []}
        for which in ("flagship", label, label, "flagship"):
            tr, st = flag if which == "flagship" else other
            ms[which].append(timed(tr, st, batch if which == "flagship"
                                   else b))
        print(f"times: graphed bf16 step, {label} against the flagship "
              f"(Adam, b=32 32->128 px), ms per step (CUDA events) over "
              f"{OPT_TIME_STEPS} in turns: flagship {ms['flagship']}, "
              f"{label} {ms[label]}; ratio "
              f"{min(ms[label]) / min(ms['flagship']):.3f} ({smi})")
        del other, tr, st
        torch.cuda.empty_cache()
    del flag
    torch.cuda.empty_cache()


def phase_trainer_options(smi: str, root: str) -> dict:
    """Phase 17: the rest of the sr trainer's options. (a) each option card
    against CPU and an f64 witness at small widths; (b) the full-width
    options cell graphed against eager bit for bit across AdaTarget's and
    SWA's starts, each program's replay traced; (c) the training CLI on
    the cell with a resume and the SWA file served; (d) each optimizer's,
    the auto clip's, the virtual batch's and the cell's step times against
    the flagship's. Returns the launch traces of its main-path runs."""
    import torch

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _options_card_cpu(smi)
    _options_graphed_vs_eager(smi)
    traces = _options_cli(smi, root)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _options_times(smi)
    print(f"options: ok in {time.perf_counter() - t0:.1f} s ({smi})")
    return traces


# ---------------------------------------------------------------------------
# 18. the rest of the producer: LMDB, the dataset options, host-side OTF
# ---------------------------------------------------------------------------
DECODE_SAMPLES = 16  # host decode ms per sample, folder and LMDB
PAETH_SAMPLES = 2    # ... and of a value filtered with Paeth on every row
RATE_TURNS = 2       # the folder's and the LMDB's graphed rates, in turns
RATE_STEPS = 4       # timed steps per turn, after the streams' first step
MIXED_WEIGHTS = (3, 1)  # the weighted loader over [folder, LMDB]
MIXED_BATCHES = 8
HOST_SAMPLES = 8     # otf_mode: host, host ms per sample
HOST_STEPS = 3
DATAOPTS_NITER = 6


def _lmdb_corpus(smi: str, root: str) -> str:
    """The corpus written into an LMDB by the port's ``create_lmdb``; every
    key's value decodes to its PNG's pixels bit for bit, and so does a
    value filtered with Paeth on every row; the host's decode ms per
    sample of each (``read_img``). Returns the LMDB's path."""
    import numpy as np

    from trainner_tpu_torch.data import common, lmdb_io
    from trainner_tpu_torch.scripts.create_lmdb import create_lmdb

    corpus = os.path.join(root, "corpus")
    t0 = time.perf_counter()
    db = create_lmdb(corpus, os.path.join(root, "corpus.lmdb"), 1)
    t_make = time.perf_counter() - t0
    names = sorted(os.listdir(corpus))
    paths = common.scan_images(db)
    keys = [p.split("::", 1)[1] for p in paths]
    if keys != [os.path.splitext(n)[0] for n in names]:
        raise AssertionError(f"lmdb: keys {keys[:4]} for files {names[:4]}")
    differ = [k for k, n in zip(keys, names) if not np.array_equal(
        common.read_lmdb_value(f"{db}::{k}"),
        common.decode_image(os.path.join(corpus, n)))]
    img = common.decode_image(os.path.join(corpus, names[0]))
    paeth = os.path.join(root, "paeth.lmdb")
    lmdb_io.write_lmdb(paeth, {b"p": common.encode_png(img, 1, row_filter=4)})
    if differ or not np.array_equal(common.read_lmdb_value(paeth + "::p"),
                                    img):
        raise AssertionError(f"lmdb: values that decode otherwise {differ}")

    def per_sample(paths) -> float:
        t0 = time.perf_counter()
        for p in paths:
            common.read_img(p)
        return (time.perf_counter() - t0) * 1e3 / len(paths)

    folder_ms = per_sample([os.path.join(corpus, n)
                            for n in names[:DECODE_SAMPLES]])
    lmdb_ms = per_sample(paths[:DECODE_SAMPLES])
    paeth_ms = per_sample([paeth + "::p"] * PAETH_SAMPLES)
    # the standard-library reader alone (what decodes where OpenCV is
    # missing) on a value with rows unfiltered, one filtered with Paeth,
    # and create_lmdb's own value
    values = {"unfiltered": common.encode_png(img, 1),
              "Paeth": common.encode_png(img, 1, row_filter=4),
              "create_lmdb's": bytes(lmdb_io.LmdbReader(db).get(
                  keys[0].encode()))}
    png_ms = {}
    for k, v in values.items():
        t0 = time.perf_counter()
        for _ in range(PAETH_SAMPLES):
            got = common.decode_png(v)
        png_ms[k] = (time.perf_counter() - t0) * 1e3 / PAETH_SAMPLES
        if not np.array_equal(got, img):
            raise AssertionError(f"lmdb: decode_png of the {k} value")
    try:
        import cv2  # noqa: F401
        decoder = "OpenCV"
    except ImportError:
        decoder = "the standard-library PNG reader"
    size = os.path.getsize(os.path.join(db, "data.mdb")) / 1e6
    print(f"lmdb: {len(keys)} keys written by create_lmdb in {t_make:.2f} s "
          f"({size:.1f} MB); every value decodes to its PNG bit for bit, and "
          f"a Paeth-filtered one too")
    print(f"times: host read_img per {CORPUS_PX} px sample, decoded by "
          f"{decoder}: PNG file {folder_ms:.3f} ms, LMDB value (rows "
          f"unfiltered) {lmdb_ms:.3f} ms, LMDB value filtered with Paeth "
          f"{paeth_ms:.3f} ms ({smi})")
    print(f"times: decode_png (the standard-library reader) per {CORPUS_PX} "
          f"px value: " + ", ".join(f"{k} {v:.3f} ms"
                                    for k, v in png_ms.items())
          + f" ({smi})")
    return db


def _batches_of(loader):
    """The loader's batches on the card, epoch after epoch, with what is
    not a tensor (paths, ``dataset_index``) passed through."""
    from trainner_tpu_torch.data.loader import device_prefetch

    while True:
        yield from device_prefetch(iter(loader), size=2, device="cuda")


def _producer_rates(smi: str, root: str, db: str) -> dict:
    """``train_sr.yml``'s graphed step (bf16, b=32, crop 128, shuffled
    bsrgan on the card) fed by the folder and by the LMDB in turns; then
    a ``WeightedMultiLoader`` over [folder, LMDB] with ``MIXED_WEIGHTS``
    for ``MIXED_BATCHES`` batches under a launch trace; then ``otf_mode:
    host`` with gaussian ``lr_noise`` (no OpenCV needed): its host ms per
    sample, the device degrader after it (C 20: its resize makes LR anew
    from HR, so the host's LR does not reach the step), and steps under a
    trace; where OpenCV is missing, each op of it raises its named error.
    Returns the traces."""
    import numpy as np
    import torch

    from trainner_tpu_torch.data import (create_dataloader, create_dataset,
                                         host_degradations, host_superpixels)
    from trainner_tpu_torch.data.loader import WeightedMultiLoader
    from trainner_tpu_torch.data.pipeline import plan_to_device
    from trainner_tpu_torch.options import parse
    from trainner_tpu_torch.train import create_trainer, make_otf_degradation

    corpus = os.path.join(root, "corpus")
    opt = parse(_cli_options(root, corpus, TRAIN_YML, "rates"),
                is_train=True)
    ds_opt = opt["datasets"]["train"]
    trainer = create_trainer(opt)
    state = trainer.init_state(0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    degrade = make_otf_degradation(opt, generator=gen)
    sets = {"folder": create_dataset(ds_opt),
            "LMDB": create_dataset({**ds_opt, "dataroot_HR": db})}
    streams = {k: _batches_of(create_dataloader(ds, ds_opt, pin_memory=True))
               for k, ds in sets.items()}
    traces = {}

    def steps(it, n):
        for _ in range(n):
            trainer.train_step(state, degrade(next(it)))

    try:
        for it in streams.values():
            steps(it, 1)  # captures the degrader's and the step's graphs
        torch.cuda.synchronize()
        rates = {k: [] for k in sets}
        for _ in range(RATE_TURNS):
            for k, it in streams.items():
                t0 = time.perf_counter()
                steps(it, RATE_STEPS)
                torch.cuda.synchronize()
                rates[k].append(RATE_STEPS / (time.perf_counter() - t0))
        print("times: train_sr.yml graphed step fed by the loader, "
              f"{RATE_STEPS} steps per turn: " + "; ".join(
                  f"{k} {', '.join(f'{r:.3f}' for r in v)} it/s"
                  for k, v in rates.items()) + f" ({smi})")
    finally:
        for it in streams.values():
            it.close()
    cached = {k: len(ds._cache) for k, ds in sets.items()}
    print(f"lmdb: decoded images kept in the tile cache: {cached} (LMDB "
          f"values are decoded at every read, as in the JAX package)")
    if cached["LMDB"] or not cached["folder"]:
        raise AssertionError(f"lmdb: the caches {cached}")

    mixed = WeightedMultiLoader([sets["folder"], sets["LMDB"]],
                                MIXED_WEIGHTS, batch_size=ds_opt["batch_size"],
                                seed=0, num_workers=ds_opt["n_workers"],
                                pin_memory=True)
    per_g = NB * 3
    came = [0, 0]
    order = []
    it = _batches_of(mixed)
    try:
        with _launch_trace({"rdb5c": per_g * MIXED_BATCHES,
                            "rdb5c_bwd": per_g * MIXED_BATCHES,
                            "blur": 2 * 2 * SHUFFLE_K * MIXED_BATCHES},
                           fresh=False, label="weighted loader") as t:
            for _ in range(MIXED_BATCHES):
                batch = next(it)
                came[batch["dataset_index"]] += 1
                order.append(batch["dataset_index"])
                trainer.train_step(state, degrade(batch))
    finally:
        it.close()
    traces["weighted loader"] = t
    print(f"lmdb: WeightedMultiLoader over [folder, LMDB] with weights "
          f"{list(MIXED_WEIGHTS)}: {MIXED_BATCHES} batches through the "
          f"graphed step, {came[0]} from the folder and {came[1]} from the "
          f"LMDB (seed 0; two batches of each per epoch, in the order "
          f"{order}); the card ran {t['ran']}")

    host_opt = {**ds_opt, "otf_mode": "host", "lr_blur": False,
                "compression": None}
    host = create_dataset(host_opt)
    if host.skip_host_lr or host._fast_u8:
        raise AssertionError("otf host: the dataset took the device's path")
    timed = {}
    for k, ds in (("without", sets["folder"]), ("with", host)):
        t0 = time.perf_counter()
        for i in range(HOST_SAMPLES):
            ds[i]
        timed[k] = (time.perf_counter() - t0) * 1e3 / HOST_SAMPLES
    host_full = {**opt, "datasets": {**opt["datasets"], "train": host_opt}}
    eager = make_otf_degradation(host_full, graphs=False,
                                 generator=torch.Generator(device="cuda"))
    it = _batches_of(create_dataloader(host, host_opt, pin_memory=True))
    try:
        batch = next(it)
        # one host plan and one generator state, the host's LR and zeros
        plans = eager._plans(batch)
        seed_state = eager.gen.get_state()
        out = eager._run(batch, plans, lambda p: plan_to_device(p, eager.dev))
        eager.gen.set_state(seed_state)
        zeroed = eager._run({**batch, "LR": torch.zeros_like(batch["LR"])},
                            plans, lambda p: plan_to_device(p, eager.dev))
        thrown = eager.lr_from_hr and torch.equal(out["LR"], zeroed["LR"])
        graphed = make_otf_degradation(host_full, generator=gen)
        with _launch_trace(label="otf host") as t:
            for _ in range(HOST_STEPS):
                _mark()
                trainer.train_step(state, graphed(next(it)))
    finally:
        it.close()
    traces["otf host"] = t
    per_batch = t["ran"]["blur"] / HOST_STEPS
    print(f"times: otf_mode host (gaussian lr_noise on the host) "
          f"{timed['with']:.3f} ms per sample in the loader against "
          f"{timed['without']:.3f} ms without it ({smi})")
    print(f"otf host: the device degrader still runs after the host's "
          f"work: {per_batch:g} blur launches per batch over {HOST_STEPS} "
          f"graphed steps ({t['ran']}); it makes LR anew from HR "
          f"(lr_from_hr {eager.lr_from_hr}), so a zeroed host LR gives the "
          f"same LR bit for bit: {thrown} (ROADMAP C 20)")
    if not thrown or per_batch < 1 or t["ran"]["blur"] % HOST_STEPS \
            or t["ran"]["rdb5c"] != per_g * HOST_STEPS:
        raise AssertionError(f"otf host: {t['ran']}, thrown {thrown}")

    x = np.random.default_rng(0).random((32, 32, 3)).astype(np.float32)
    ops = {"jpeg_compress_exact":
           lambda: host_degradations.jpeg_compress_exact(x, 50),
           "webp_compress_exact":
           lambda: host_degradations.webp_compress_exact(x, 50),
           "gaussian_blur_exact":
           lambda: host_degradations.gaussian_blur_exact(x, 11, 1.0),
           "motion_blur_exact":
           lambda: host_degradations.motion_blur_exact(x, 7, 30.0),
           "clahe_exact": lambda: host_degradations.clahe_exact(x),
           "superpixels": lambda: host_superpixels.superpixels(x)}
    try:
        import cv2  # noqa: F401
        have_cv2 = True
    except ImportError:
        have_cv2 = False
    for name, call in ops.items():
        try:
            call()
            raised = None
        except host_degradations.HostOpUnavailable as e:
            raised = str(e)
        if have_cv2 == (raised is not None) or \
                (raised and (name not in raised or "C 20" not in raised)):
            raise AssertionError(f"otf host: {name} with OpenCV "
                                 f"{have_cv2}: {raised}")
    print(f"otf host: OpenCV {'present: the' if have_cv2 else 'missing: '
                               'each of the'} {len(ops)} OpenCV ops "
          f"{'ran' if have_cv2 else 'raised the error that names it'} "
          f"({', '.join(ops)})")
    del state, trainer
    torch.cuda.empty_cache()
    return traces


def phase_producer_rest(smi: str, root: str) -> dict:
    """Phase 18: the rest of the producer at full width. (a) The corpus as
    an LMDB (``_lmdb_corpus``); the training CLI on ``train_sr.yml`` with
    the LMDB as its train set, 12 iterations and a resume to 16; (b) the
    same CLI with ``aug_downscale: 0.5`` and a ``subset_file`` of half the
    corpus (every sample from the subset); (c) the rates, the weighted
    loader and ``otf_mode: host`` (``_producer_rates``). Returns the
    traces of its main-path runs."""
    from trainner_tpu_torch.data import datasets

    t0 = time.perf_counter()
    db = _lmdb_corpus(smi, root)
    traces = {f"lmdb cli {k}": v for k, v in phase_cli(
        smi, root, TRAIN_YML, "cli_lmdb", corpus=db).items()}
    t_lmdb = time.perf_counter() - t0

    subset = sorted(os.listdir(os.path.join(root, "corpus")))[::2]
    subset_path = os.path.join(root, "subset.txt")
    with open(subset_path, "w") as f:
        f.write("\n".join(subset) + "\n")

    def edit(opt):
        opt["datasets"]["train"].update(aug_downscale=0.5,
                                        subset_file=subset_path)

    seen = []
    orig = datasets.AlignedDataset.__getitem__

    def getitem(self, index):
        out = orig(self, index)
        if self.phase == "train":
            seen.append(os.path.basename(out["HR_path"]))
        return out

    datasets.AlignedDataset.__getitem__ = getitem
    try:
        runs = phase_cli(smi, root, TRAIN_YML, "cli_dataopts", edit=edit,
                         niter=DATAOPTS_NITER, resume=False)
    finally:
        datasets.AlignedDataset.__getitem__ = orig
    traces.update({f"dataopts cli {k}": v for k, v in runs.items()})
    outside = sorted(set(seen) - set(subset))
    print(f"dataopts: aug_downscale 0.5 and a subset_file of {len(subset)} "
          f"of the {N_CORPUS} images: {len(seen)} samples read, "
          f"{len(set(seen))} images, {len(outside)} outside the subset")
    if outside or not seen:
        raise AssertionError(f"dataopts: samples outside the subset "
                             f"{outside[:4]}")
    t_opts = time.perf_counter() - t0 - t_lmdb
    traces.update(_producer_rates(smi, root, db))
    print(f"producer rest: ok in {time.perf_counter() - t0:.1f} s (LMDB and "
          f"its CLI {t_lmdb:.1f}, dataset options' CLI {t_opts:.1f}, rates, "
          f"weighted loader and otf host "
          f"{time.perf_counter() - t0 - t_lmdb - t_opts:.1f}) ({smi})")
    return traces


# ---------------------------------------------------------------------------
# 19. PPON (its three phases), PAN and A2N at full width
# ---------------------------------------------------------------------------
PPON_STAGES = [4, 8]      # the CLI: phase 1 to step 4, 2 to 8, then 3
PPON_GRAPH_STAGES = [2, 4]  # graphed against eager: two steps per phase
PPON_GRAPH_B = 16
PPON_LOSSES = {"ms_criterion": "multiscale-l1", "ms_weight": 1e-2,
               "ssim_type": "ms-ssim", "ssim_weight": 0.2,
               "cx_type": "contextual", "cx_weight": 0.5}
# one f32 step per phase (_ppon_f64): each tensor of the card within this
# share of its move of the CPU's, and no further from the f64 witness than
# PPON_F64_TOL times the CPU f32's largest distance in the same net; set
# from the CPU f32's own distance from the witness on this configuration
# (G 1.5e-2 at hr1_p, D 6.5e-2 at conv4_0) as phase 14's sr_resnet limits
# were
PPON_STEP_TOL = {"g": 6e-2, "d": 3e-1}
PPON_F64_TOL = 2.0
SERVE_ITERS = 5


def _ppon_cli_edit(opt: dict) -> None:
    """``train_sr.yml`` with ``model: ppon`` at its defaults (nf 64, nb
    24), ``ppon_stages`` ``PPON_STAGES`` and the losses its phases select:
    pix (phase 1), pix-multiscale and ms-ssim (2), contextual (3, with the
    GAN on D-VGG-128)."""
    opt["model"] = "ppon"
    opt["network_G"] = {"type": "ppon"}
    opt["train"].update(ppon_stages=list(PPON_STAGES), **PPON_LOSSES)


def _ppon_phases_of(exp: str) -> dict:
    """Step -> ``ppon_phase`` from a run's JSONL scalars."""
    rows = [json.loads(line) for line in
            open(os.path.join(exp, "tb", "scalars.jsonl"))]
    return {r["step"]: r["value"] for r in rows
            if r["tag"] == "train/ppon_phase"}


def _ppon_graphed_vs_eager(smi: str, root: str) -> None:
    """The CLI's PPON configuration at full width (bf16, b=``PPON_GRAPH_B``,
    32 -> 128 px) with ``ppon_stages`` ``PPON_GRAPH_STAGES``: six steps
    graphed (each
    phase's program captured at its first step, replayed at its second)
    against the same steps eager from the same state, bit for bit under
    deterministic cuDNN; the branches outside each step's phase (and D
    outside phase 3) bit-equal across the step; each step's ms."""
    import torch

    from trainner_tpu_torch.options import parse
    from trainner_tpu_torch.train import create_trainer
    from trainner_tpu_torch.train.ppon_trainer import (PHASE_PREFIXES,
                                                       phase_params)

    def edit(opt):
        _ppon_cli_edit(opt)
        opt["train"]["ppon_stages"] = list(PPON_GRAPH_STAGES)

    opt = parse(_cli_options(root, os.path.join(root, "corpus"), TRAIN_YML,
                             "ppon_graphs", edit), is_train=True)
    trainers = {"graphed": create_trainer(opt),
                "eager": create_trainer(opt, graphs=False)}
    states = {k: t.init_state(0) for k, t in trainers.items()}
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    n_steps = 2 * (len(PPON_GRAPH_STAGES) + 1)
    lines, unequal, moved = [], [], []
    try:
        for i in range(n_steps):
            batch = _train_batch(PPON_GRAPH_B, seed=40 + i)
            _load_from(states["eager"], states["graphed"])
            before = _net_tensors(states["graphed"])
            logs, ms = {}, {}
            for k in ("graphed", "eager"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logs[k] = trainers[k].train_step(states[k], batch)[1]
                torch.cuda.synchronize()
                ms[k] = (time.perf_counter() - t0) * 1e3
            phase = int(logs["graphed"]["ppon_phase"])
            after = {k: _net_tensors(states[k]) for k in states}
            unequal += [(i, k) for k, v in after["graphed"].items()
                        if not torch.equal(v, after["eager"][k])]
            unequal += [(i, k) for k, v in logs["graphed"].items()
                        if not torch.equal(v, logs["eager"][k])]
            prefixes = tuple(f"g.{p}" for p in PHASE_PREFIXES[phase])
            for k, v in after["graphed"].items():
                frozen = (k.startswith("g.") and not k.startswith(prefixes)) \
                    or (k.startswith("d.") and phase != 3)
                if frozen and not torch.equal(v, before[k]):
                    moved.append((i, k))
            lines.append(f"step {i} phase {phase}: graphed {ms['graphed']:.1f}"
                         f" ms, eager {ms['eager']:.1f} ms")
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    graphs = trainers["graphed"].step_graphs()
    live = [len(phase_params(states["graphed"].g.net, p)[0])
            for p in (1, 2, 3)]
    print(f"ppon: {n_steps} steps at full width (nf 64, nb 24; bf16, "
          f"b={PPON_GRAPH_B}, 32 -> 128 px), graphed ({len(graphs)} programs captured: "
          f"{sorted(k[:2] for k in graphs)}) against eager: "
          f"{len(unequal)} tensors or logs differ; {len(moved)} frozen "
          f"tensors moved; live parameters per phase {live}; "
          + "; ".join(lines) + f" ({smi})")
    if unequal or moved or len(graphs) != 3:
        raise AssertionError(f"ppon graphs: unequal {unequal[:6]}, moved "
                             f"{moved[:6]}, graphs {list(graphs)}")
    del trainers, states
    torch.cuda.empty_cache()


def _ppon_f64(smi: str) -> None:
    """One step per phase (``ppon_stages`` [1, 2]) of PPON at full width
    and cut depth (nf 64, nb 1) with D-VGG-128 (batch norms) in f32 (b=2,
    32 -> 128 px, SGD at lr 1e-2; pix, pix-multiscale with ms-ssim, pix
    with the GAN), on the card (graphed, three programs), the CPU and an
    f64 witness on the CPU, each side's D branches replayed by its own
    witness (``_steps_card_cpu_f64``): logs within 1e-4 relative; every
    tensor of G and D within ``PPON_STEP_TOL`` of its move, card against
    CPU; the card no further from its witness than ``PPON_F64_TOL`` times
    the CPU f32's largest distance in the same net."""
    import torch

    from trainner_tpu_torch.options.config import parse_dict

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = dict(parse_dict({
        "name": "ppon_f64", "model": "ppon", "scale": 4,
        "network_G": {"type": "ppon", "nb": 1},
        "network_D": {"type": "discriminator_vgg", "size": 128,
                      "base_nf": 64},
        "path": {"root": "/nonexistent"},
        "train": {"lr_G": 1e-2, "lr_D": 1e-2, "optim_G": "sgd",
                  "optim_D": "sgd", "pixel_criterion": "l1",
                  "pixel_weight": 1.0, "ms_criterion": "multiscale-l1",
                  "ms_weight": 1.0, "ssim_type": "ms-ssim",
                  "ssim_weight": 1.0, "gan_type": "vanilla",
                  "gan_weight": 5e-3, "p3_losses": ["pix"],
                  "ppon_stages": [1, 2], "lr_scheme": "MultiStepLR",
                  "lr_steps": [50]}}, is_train=True))
    gen = torch.Generator().manual_seed(8)
    batches = [{"LR": torch.rand(2, 32, 32, 3, generator=gen),
                "HR": torch.rand(2, 128, 128, 3, generator=gen)}
               for _ in range(3)]
    r = _steps_card_cpu_f64("ppon", opt, batches, graphs=3, branches=True)
    bad = []
    for net in ("g", "d"):
        cc, f64, cpu = (_worst(r[key], net + ".") for key in
                        ("card_cpu", "card_f64", "cpu_f64"))
        step_tol, f64_tol = PPON_STEP_TOL[net], PPON_F64_TOL * cpu[0]
        print(f"ppon: one f32 SGD step per phase (nf 64, nb 1; D-VGG-128), "
              f"{net.upper()}'s tensors as a share of their move: card vs "
              f"CPU up to {cc[0]:.3e} ({cc[1]}; tol {step_tol}); against "
              f"the f64 witness: card {f64[0]:.3e} ({f64[1]}; tol "
              f"{f64_tol:.3e}), CPU f32 {cpu[0]:.3e} ({cpu[1]}) ({smi})")
        bad += [(k, v, step_tol) for k, v in r["card_cpu"].items()
                if k.startswith(net + ".") and not v <= step_tol]
        bad += [(k, v, f64_tol) for k, v in r["card_f64"].items()
                if k.startswith(net + ".") and not v <= f64_tol]
    print(f"ppon: logs card vs CPU within {r['logs']:.3e} relative (tol "
          f"1e-4) by step {['%.2e' % v for v in r['logs_by_step']]}; D's "
          f"branches that differ, card against CPU, by step {r['flips']} "
          f"of {r['records']} records")
    if bad or not r["logs"] <= 1e-4:
        raise AssertionError(f"ppon f64: {bad[:6]}, logs {r['logs']}")
    torch.cuda.empty_cache()


def _serve_rates(smi: str) -> None:
    """PPON (nf 64, nb 24), PAN (nf 40, unf 24, nb 16, self-attention) and
    A2N (its defaults) at b=8, 128 -> 512 px: Mpx/s of the forward in f32
    (TF32 off) and bf16, CUDA events; no block kernel launched."""
    import torch

    from trainner_tpu_torch.models import define_G
    from trainner_tpu_torch.options.defaults import get_network_G_config

    b, h, w = MAIN_SHAPE
    x = torch.rand(b, h, w, 3, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(3))
    mpx = b * h * w * 16 / 1e6
    for name, cfg in (("ppon", {"type": "ppon"}),
                      ("pan", {"type": "pan_net", "self_attention": True}),
                      ("a2n", {"type": "a2n_net"})):
        g = get_network_G_config(cfg, 4)
        row = []
        for dt in (torch.float32, torch.bfloat16):
            net = define_G({"network_G": g}, dtype=dt)
            _gain_weights(net, seed=2)
            net = net.cuda().eval()
            with torch.inference_mode():
                with _launch_trace({"rdb5c": 0}, label=f"serve {name}"):
                    net(x)
                ms = _time_ms(lambda: net(x), iters=SERVE_ITERS, warmup=1)
            row.append(f"{str(dt)[6:]} {ms:.2f} ms, {mpx / ms * 1e3:.2f} "
                       f"Mpx/s")
            del net
        print(f"times: {name} forward b={b} {h}->{4 * h} px: "
              f"{'; '.join(row)} ({smi})")
    torch.cuda.empty_cache()


def _pan_cli_edit(opt: dict) -> None:
    """``train_sr.yml`` with ``network_G: pan_net`` at its defaults (nf 40,
    unf 24, nb 16), trained by the ``sr`` trainer."""
    opt["network_G"] = {"type": "pan_net"}


def phase_models(smi: str, root: str) -> dict:
    """Phase 19: PPON, PAN and A2N at full width. PPON: its forward card
    against CPU (f32, bf16) on every output; the training CLI on
    ``train_sr.yml`` with ``model: ppon`` (12 iterations through its three
    phases and a resume to 16 in phase 3; no block kernel, 24 blur launches
    per batch); its saved G served by the test CLI at ``ppon_phase`` 3 and
    1; graphed against eager (``_ppon_graphed_vs_eager``); the f64 witness
    of one step per phase (``_ppon_f64``). PAN (with self-attention) and
    A2N card against CPU; PAN through the ``sr`` training CLI with a
    resume; the three models' serving rates. Returns the CLI traces."""
    import torch

    from trainner_tpu_torch import test as test_cli
    from trainner_tpu_torch.options.defaults import get_network_G_config
    from trainner_tpu_torch.train.ppon_trainer import PPONTrainer

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, cfg in (("ppon", {"type": "ppon"}),
                      ("pan", {"type": "pan_net", "self_attention": True}),
                      ("a2n", {"type": "a2n_net"})):
        _card_vs_cpu_forward(name, {"network_G": get_network_G_config(
            cfg, 4)}, ZOO_CPU_LR, (torch.float32, torch.bfloat16),
            tag="models")

    runs = phase_cli(smi, root, TRAIN_YML, "cli_ppon", edit=_ppon_cli_edit,
                     trainer_cls=PPONTrainer, g_launches=lambda n: 0,
                     val_launches=0)
    traces = {f"ppon cli {k}": v for k, v in runs.items()}
    with open(os.path.join(root, "cli_ppon_options.json")) as f:
        opt = json.load(f)
    exp = os.path.join(root, "cli_ppon", "experiments", opt["name"])
    phases = _ppon_phases_of(exp)
    want = {s: 1 + (s - 1 >= PPON_STAGES[0]) + (s - 1 >= PPON_STAGES[1])
            for s in phases}
    print(f"ppon: the CLI's ppon_phase by iteration {phases} (expected "
          f"{want}); the resume to {CLI_RESUME_NITER} continued in phase 3")
    if phases != want or set(phases.values()) != {1, 2, 3} or \
            max(phases) != CLI_RESUME_NITER:
        raise AssertionError(f"ppon cli phases {phases}")
    g_file = os.path.join(exp, "models", f"{CLI_RESUME_NITER}_G.ckpt")
    psnr = {}
    for phase in (3, 1):
        serve = {"name": f"serve_ppon_{phase}", "model": "ppon", "scale": 4,
                 "ppon_phase": phase,
                 "datasets": {"test_1": {
                     "name": "val", "mode": "aligned",
                     "dataroot_HR": opt["datasets"]["val"]["dataroot_HR"],
                     "dataroot_LR": opt["datasets"]["val"]["dataroot_LR"]}},
                 "network_G": {"type": "ppon"},
                 "path": {"root": os.path.join(root, f"serve_ppon_{phase}"),
                          "pretrain_model_G": g_file},
                 "metrics": "psnr,ssim"}
        path = os.path.join(root, f"serve_ppon_{phase}.json")
        with open(path, "w") as f:
            json.dump(serve, f)
        with _launch_trace({"rdb5c": 0}, label="serve ppon"):
            averages = test_cli.main(["-opt", path])
        psnr[phase] = [m["average"] for m in averages["val"]
                       if m["name"] == "psnr"]
    print(f"ppon: {CLI_RESUME_NITER}_G.ckpt served by the test CLI at b=1 on "
          f"{N_VAL} LRs of {CORPUS_PX // 4} px: PSNR with ppon_phase 3 "
          f"{psnr[3]}, with ppon_phase 1 {psnr[1]} ({smi})")
    if not all(v and math.isfinite(v[0]) for v in psnr.values()):
        raise AssertionError(f"ppon serving {psnr}")
    parts = [f"{time.perf_counter() - t0:.1f}"]
    for part in (lambda: _ppon_graphed_vs_eager(smi, root),
                 lambda: _ppon_f64(smi),
                 lambda: traces.update(
                     {f"pan cli {k}": v for k, v in phase_cli(
                         smi, root, TRAIN_YML, "cli_pan",
                         edit=_pan_cli_edit, g_launches=lambda n: 0,
                         val_launches=0).items()}),
                 lambda: _serve_rates(smi)):
        t1 = time.perf_counter()
        part()
        parts.append(f"{time.perf_counter() - t1:.1f}")
    print(f"models: ok in {time.perf_counter() - t0:.1f} s (forwards, PPON "
          f"CLI and serving; graphs; f64; PAN CLI; rates: "
          f"{', '.join(parts)} s) ({smi})")
    return traces


def phase_graphs(smi: str, root: str) -> None:
    """The programs as CUDA graphs against the same programs run eagerly
    (``graphs=False``), in one process: the step (bf16, f32) with its
    recorded launches against a profiler trace of one replay and the
    latent noise of a replay; a resume after capture; ``train_steps``; the
    degrader; ``eval_step``, x8 and chop; then eager against graphed times
    of the end-to-end rate and the CLI's steady rate."""
    t0 = time.perf_counter()
    parts = []
    for part in (lambda: _graph_step(smi), lambda: _graph_resume(smi, root),
                 lambda: _graph_window(smi),
                 lambda: _graph_degrader(smi, root),
                 lambda: _graph_serving(smi),
                 lambda: _graph_mixed_sizes(smi, root),
                 lambda: _graph_e2e(smi, root),
                 lambda: _graph_cli(smi, root)):
        t1 = time.perf_counter()
        part()
        parts.append(f"{time.perf_counter() - t1:.1f}")
    print(f"graphs: ok in {time.perf_counter() - t0:.1f} s (step, resume, "
          f"window, degrader, serving, mixed sizes, e2e, cli: "
          f"{', '.join(parts)} s) ({smi})")


def _later_phases(smi: str, root: str, which: tuple) -> dict:
    """Phases 18 (``phase_producer_rest``) and 19 (``phase_models``) of
    ``which``, TF32 off before each; returns their traces."""
    import torch

    phases = {18: phase_producer_rest, 19: phase_models}
    traces = {}
    for n in which:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        traces.update(phases[n](smi, root))
    return traces


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels-only", action="store_true")
    parser.add_argument("--parent", default="",
                        help="another tree (e.g. the parent commit from "
                        "git archive) whose blur kernel is timed beside "
                        "this one's")
    parser.add_argument("--only", default="",
                        help="comma-separated phases among 18 and 19: build "
                        "the kernels, write the corpus and run those alone "
                        "(no result line)")
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
    if flags.only:
        with tempfile.TemporaryDirectory() as root:
            os.makedirs(os.path.join(root, "corpus"))
            _write_corpus(os.path.join(root, "corpus"))
            _later_phases(smi, root, tuple(
                int(p) for p in flags.only.split(",")))
        print(f"chip_smoke: phases {flags.only} alone, "
              f"{time.time() - t_start:.1f} s")
        print(smi)
        return 0
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
        phase_graphs(smi, root)
        cli_counts.update(phase_realesrgan(smi, root))
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cli_counts.update(phase_zoo(smi, root))
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        deg_traces, caller_rows = phase_degradations(smi, root)
        cli_counts.update(deg_traces)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cli_counts.update(phase_losses(smi, root))
        cli_counts.update(phase_trainer_options(smi, root))
        cli_counts.update(_later_phases(smi, root, (18, 19)))
        rows = phase_times(smi, root)
        blur_rows = phase_blur_times(smi, flags.parent)
        phase_trace(smi, root, {k: r["step_ms"] for k, r in train.items()})
    kernels = _kernel_rows(rows, launches, train, main_err, bwd_err,
                           blur_rows, producer, blur_err, forms, cli_counts,
                           caller_rows)
    print(f"chip_smoke: {time.time() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
