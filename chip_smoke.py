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
   validation set of 2 corpus images and their x4 LR, 12 iterations,
   validation at 6 and 12, checkpoints at 12): launches per step and per
   batch, the artifacts, the JSONL scalars, the steady it/s, the save and
   validation times; then a second ``main`` that resumes from
   ``training_state/`` to 14, whose loaded state equals the saved one bit
   for bit;
10. times: CUDA-event times of each kernel, its plain version, its bound
   and a library call as a yardstick (the cuDNN five-conv chain; reflect
   padding and a grouped cuDNN convolution for the blur), the device-alone
   time of the block kernels and the blur from the profiler (the forward
   also at phase 14's serving shape, both f32 block kernels at SRFlow's
   encoder step F = b 16, 40 x 40, the blur at its LR canvas), and the G
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
   resume into a captured state, bit for bit; ``train_steps`` k = 6 with
   a MultiStep boundary inside the window; the degrader from one
   generator state and plan stream; ``eval_step`` at b = 8 in f32 and
   bf16, x8 on a 72 x 64 and chop on a 136 x 128 image (replaying their
   graphs)
   against the CPU's eager composition; and eager against graphed times
   of each with the graphed program's device-busy ms and idle share, the
   captures' seconds and pool memory, and the test CLI's seconds per
   image on a test set of one size per image;
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
   times; then the training CLI on a copy of the
   options (the corpus, 6 iterations, checkpoints with ``_emaG`` and
   validation at 6, a resume to 8 whose EMA and spectral-norm
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
   with the x2 layout and the D preset through the training CLI (6
   iterations, a resume to 8 that loads bit for bit); full-width
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
   CLI on ``train_sr.yml`` with combo (6 iterations, 31 blur launches
   per batch from the trace; the flagship's state, whose resume phase 9
   holds) and with realsr (6, no blur); the blur kernel's times for this slice's callers (the pool and
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
   block launches per replay from a trace), its times; the training CLI
   on the yml (6 iterations and a resume to 8, 69 + 69 block and 24
   blur launches per step from the trace, LPIPS in the validation, its
   steady rate graphed);
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
   multiple of 8; 6 iterations and a resume to 8 that restores SWA, the
   LocNet, the clip history and every optimizer state, the launches per
   step from the trace), its ``14_swaG`` file served by the test CLI with
   ``which: swa``.

18. the rest of the producer (after the options): the corpus written
   into an LMDB by the port's ``create_lmdb`` (every value decodes to its
   PNG bit for bit, a Paeth-filtered one too; the host's decode ms per
   sample of a PNG file, an LMDB value and a Paeth-filtered value); the
   training CLI on ``train_sr.yml`` with the LMDB as its train set (12
   iterations, launches from the trace; the flagship's state, whose resume
   phase 9 holds); the CLI with
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
   3), 6 iterations through the three phases and a resume to 8, its G
   served by the test CLI at ``ppon_phase`` 3 and 1; six PPON steps
   graphed against eager bit for bit, the frozen branches bit-equal across
   each; one f32 step of phases 1 and 3 at cut depth (nb 1) on the card,
   the CPU and an f64 witness; PAN through the ``sr`` training CLI (6 and
   a resume to 8); the three models' serving Mpx/s at b=8, 128 -> 512 px.
20. i2i and sft (after phase 19): SFTGAN (``options/sr/train_sftgan.json``),
   pix2pix (``options/i2i/train_pix2pix.yml``, ``serial_batches``) and
   CycleGAN (``options/i2i/train_cyclegan.yml``) at full width on seeded
   data (A: 16 corpus images; B: a second 1/f corpus; SFTGAN's seeded
   probability maps as ``.npy``): each training CLI for 6 iterations
   (sample grids at 6 for the i2i cells) and a resume to 8 whose
   loaded state equals the saved one, its G served by the test CLI,
   three steps graphed against eager bit for bit (dropout masks and pool
   swaps included), one f32 SGD step at cut depth on the card, the CPU
   and an f64 witness replaying each side's branches of every net; the
   Gs' forward Mpx/s (SFTNet at b=8, 128 -> 512 px; the U-Net and ResNet
   G at b=1, 256 px); the multiscale and pixel Ds' forward and backward
   card against CPU. No kernel of the repo runs in these nets.
21. video (after phase 20): SOF-VSR with its RRDB tail at the full width
   of ``options/video/train_video.yml`` (channels 320, 3 frames, x4; nf
   64, nb 23, gc 32; bf16) on seeded folders of 1/f frames moving a pixel
   or two per frame: the training CLI for 6 iterations (validation at 6)
   and a resume to 8 whose loaded state equals the saved one, 69
   block forwards and 69 backwards per step and 69 forwards per
   validation window from the traces; the block kernels against their
   plain versions at SOF-VSR's shapes (each block at b=8, 32 x 32,
   forward and backward, and at 144 x 180 and 80 x 98; the whole G
   forward at the last two; the f32 G gradient of a b=8 step); three
   steps graphed against eager
   bit for bit; one f32 SGD step at cut depth (channels 32, nb 2, b=2) on
   the card, the CPU and an f64 witness replaying each side's branches of
   the flow net and the losses; the test CLI on ``test_video.yml`` at LR
   144 x 180 in f32 and bf16, plain and with ``chop`` (four quadrants per
   window), 69 block forwards per window or quadrant from the traces;
   SR3D, EDVR (DCNv2), EVSRGAN (Conv3D) and RIFE at full width card
   against CPU; every video net's forward Mpx/s.
22. srflow (after phase 21): SRFlow at the full width of
   ``options/srflow/train_srflow.yml`` (SRFlowNet nf 64, nb 23, K 16, L 3,
   hidden 64; b 16, crop 160; f32), its encoder's 23 blocks on the f32
   block kernels: the training CLI for 6 iterations, the encoder frozen
   for the first 3 (23 block forwards and no backward per step, then 23
   and 23; 23 forwards per validation image at heat 0) and a resume to
   8; the block kernels against their plain versions at F (b=16, 40 x
   40: one block forward and backward, the whole encoder forward, the
   encoder's gradient of one step); four steps graphed against eager bit
   for bit across the unfreeze (one graph per freeze state); one f32 SGD
   step at cut depth (nb 2, K 2) on the card, the CPU and an f64 witness
   replaying each side's branches of the flow; two ``srflow_interop``
   steps (69 blocks) graphed against eager; the test CLI on
   ``test_srflow.yml`` (4 heats x 1 sample on 1 image) with both nets,
   23 or 69 block forwards per sample, the heat-0 sample card against
   CPU; then ABPN, ASRResNet, ASRCNN and the segmenter at their JAX
   defaults card against CPU, an ``sr`` step with each graphed against
   eager, and their forward Mpx/s.
23. zoo rest (after phase 22): PBR at full width on the block kernels
   (``train_sr.yml``'s G, nf 64, nb 23, gc 32, as ``model: pbr``: b 8,
   crop 128, bf16, pixel L1 and VGG19 feature L1) on 16 seeded material
   folders of four 256 px maps: the training CLI for 6 iterations (276
   block forwards and 276 backwards per step: one G pass per map; 69
   forwards per validation material) and a resume to 8; one block
   forward and backward at P (b 8, 32 x 32, bf16) and the f32 G gradient
   of a step against the plain versions; three steps graphed against
   eager bit for bit; one f32 SGD step at cut depth against an f64
   witness; the test CLI (69 forwards per material) and its output card
   against CPU. DVD on ``train_deinterlace.yml`` and WBC on
   ``train_wbc.yml`` (no kernel of the repo runs there): each CLI for 6
   iterations and a resume to 8, three steps graphed against eager bit
   for bit, an f64 witness, its G card against CPU (WBC's ``mode: tf``),
   WBC's SLIC card against CPU and one ``sp_exact`` step, the test CLI
   (DVD's ``{i}_bottom.png``); each G's forward Mpx/s.
24. parallel (after phase 23): several GPUs' paths on the one card at
   full width: the flagship's graphed bf16 step (b 32) on a one-rank NCCL
   group bit for bit against the same step with no group, its
   all-reduces captured; two gloo processes on the card, 16 + 16 of the
   batch, their averaged f32 gradients against one process's; the
   training CLI on ``train_sr.yml`` with ``parallel: {data: 1}`` (6
   iterations) resumed to 8 without it; the flagship G in f32 on a 512 x
   512 LR image in 4 bands (69 blocks a band) against the whole image.

The launch traces of the serving slice, of phase 14's serving, of every
training CLI and of phases 21 to 23 run their body again when the
profiler lost records (``_retried_trace``, at most three times; a count
over the wanted one fails at once; ROADMAP C 24).

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
       python3 chip_smoke.py --only 18,19,22   (any of phases 18-24 alone,
           after the build and the corpus; no result line)
       python3 chip_smoke.py --kernels-only [--parent DIR]   (phases 1-3
           and the kernels' part of 10: a short run while a kernel is
           worked on; it prints no result line)
"""

from __future__ import annotations

import collections
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
N_VAL = 2
CLI_NITER, CLI_FREQ, CLI_RESUME_NITER = 12, 6, 14
# the CLIs that repeat on other options what the flagship CLI's 12 steps
# check (realesrgan, the x2 layout, combo, the loss stack, LMDB, PPON,
# PAN, the i2i cells, the video CLI, SRFlow, PBR, the trainer options)
# run 6 steps, one validation and a resume to 8, which pays for phase
# 24's time
SHORT_NITER, SHORT_RESUME = 6, 8
# the CLIs' save_checkpoint_freq: a step no run reaches, so the end's save
# alone writes the checkpoints (a periodic save at the last step would
# write the same files once more, 1.1-2.8 s a run on the H100)
CLI_SAVE_FREQ = 10 ** 6
# How one tf32 mma.sync.m16n8k8 adds on the card, as phase_tf32_mma reads
# it (mma_tf32_sum): the eight products, exact, and the running sum are
# aligned to the largest exponent among them, a product's exponent being
# the sum of its operands' (its significand not renormalised); every term
# is cut towards zero below 2^(E - 25), the cut terms are added exactly and
# the sum is cut towards zero to f32. The CPU emulation of 3xTF32 in
# tests/test_torch_rdb5c_tf32.py adds the same way. The f32 tile runs each
# k-step's three mmas on a zeroed sum and adds that to its running sum in
# f32, rounded to nearest (stage_sums_emulated).
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

    # one pass, each record's fields read once (a whole run reads
    # millions of records on the host's clock)
    cuda = DeviceType.CUDA
    launched, device = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            device.append((e.correlation_id(), e.start_ns(),
                           e.duration_ns(), e.name()))
        elif e.name().startswith("cu"):
            launched[e.correlation_id()] = e.start_ns()
    device.sort(key=lambda r: (launched.get(r[0], r[1]), r[1]))
    events = [(start, dur, name) for _, start, dur, name in device]
    first = 0
    while first < len(events) and MARKER in events[first][2]:
        first += 1
    return events[first:]


@contextlib.contextmanager
def _profiled(cpu: bool = False):
    """torch.profiler over the body: the device's activity (and the
    host's, with ``cpu``), the body starting ``OPENING_PAUSE`` s after
    ``OPENING_MARKERS`` markers. The profiler drops the first records of
    a session (on the H100, now and then every launch of a short timing
    session that launched at once; with a pause of 0.1 s, once the eager
    first step of a debug-width training session; with three markers and
    0.3 s, late in a whole run of this script, the first 21-23 records of
    a step's replay, two of them block stages, while a fresh process lost
    none: a count of records, which a longer pause did not prevent); the
    markers take their place, and the body runs after the pause."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        for _ in range(OPENING_MARKERS):
            _mark()
        torch.cuda.synchronize()
        time.sleep(OPENING_PAUSE)
        t1 = time.perf_counter()
        yield prof
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    SESSIONS.append((t1 - t0, time.perf_counter() - t2))


# (seconds to open, seconds to close) of each ``_profiled`` session
SESSIONS = []
# wall seconds and calls of each phase and helper of this script, by the
# phase that called it (``_time_parts``)
PARTS = collections.defaultdict(lambda: [0.0, 0])
TIMED_HELPERS = ("_retried_trace", "_device_events", "_steps_card_cpu_f64",
                 "_card_vs_cpu_forward", "_graphed_vs_eager", "_time_ms",
                 "_save_breakdown", "_state_tensors", "_compare_block")


def _time_parts() -> None:
    """Wraps each phase and helper of this script that takes the card's
    name (``smi``), and those of ``TIMED_HELPERS``, so that ``PARTS``
    adds up the wall seconds and calls of each by the phase it ran
    under; ``_print_parts`` prints them."""
    import functools
    import inspect

    stack = []
    module = sys.modules[__name__]
    for name, fn in list(vars(module).items()):
        if not inspect.isfunction(fn) or fn.__module__ != __name__:
            continue
        params = list(inspect.signature(fn).parameters)
        if not ((params[:1] == ["smi"] and name != "main")
                or name in TIMED_HELPERS):
            continue

        def timed(*args, _fn=fn, _name=name, **kwargs):
            phase = next((p for p in reversed(stack)
                          if p.startswith("phase_")), "")
            key = f"{phase}/{_name}" if phase and phase != _name else _name
            stack.append(_name)
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                stack.pop()
                PARTS[key][0] += time.perf_counter() - t0
                PARTS[key][1] += 1

        setattr(module, name, functools.wraps(fn)(timed))


def _print_parts(smi: str, top: int = 60) -> None:
    """The ``top`` parts of ``PARTS`` by their wall seconds, and the
    profiler sessions' own seconds to open and to close."""
    opened = sum(a for a, _ in SESSIONS)
    closed = sum(b for _, b in SESSIONS)
    print(f"parts: {len(SESSIONS)} profiler sessions, {opened:.1f} s to "
          f"open (with the markers and the pause), {closed:.1f} s to close "
          f"({smi})")
    for key, (secs, calls) in sorted(PARTS.items(),
                                     key=lambda kv: -kv[1][0])[:top]:
        print(f"parts: {secs:8.1f} s  x{calls:<4d} {key}")


def _calls_per_wrapper(names) -> dict:
    """Kernel names in a trace -> calls of the kernel wrappers: five stage
    kernels per block forward (``rdb_*`` but ``rdb_dx_*``), one dW kernel
    per block backward, one blur kernel per blur."""
    stages = dw = blur = 0
    for name, n in collections.Counter(names).items():
        short = _short_name(name)
        if short.startswith("rdb_") and "_dx_" not in short:
            stages += n
        elif short.startswith("dw_"):
            dw += n
        elif short == "blur_kernel":
            blur += n
    return {"rdb5c": stages // 5 if stages % 5 == 0 else stages / 5,
            "rdb5c_bwd": dw, "blur": blur}


MARKER = "spin_kernel"
OPENING_MARKERS = 128  # per profiler session, ahead of the body
# seconds between the markers and the body; 0.3 s cost a whole run of this
# script 87 s over its 291 sessions
OPENING_PAUSE = 0.05


def _mark() -> None:
    """A marker on the current stream that a trace shows between the work
    before it and the work after it (``torch.cuda._sleep``'s one-block
    ``spin_kernel``, a few cycles long)."""
    import torch

    torch.cuda._sleep(1)


class ShortTrace(AssertionError):
    """A launch trace that holds fewer launches than the body made, of
    every kernel, and none more: the profiler lost records."""


def _check_launches(out: dict, want: dict, fresh: bool, label: str) -> None:
    """``ran`` must equal ``want`` and, when ``fresh``, every wrapper with
    launches must have counted some. A trace short of ``want`` on some
    kernel and over it on none raises ``ShortTrace``; any other mismatch
    an ``AssertionError``."""
    want = {k: want.get(k, 0) for k in out["ran"]}
    idle = [k for k, n in want.items() if n and fresh
            and not out["counted"][k]]
    if out["ran"] == want and not idle:
        return
    msg = (f"{label}: the card ran {out['ran']}, expected {want}; the "
           f"wrappers counted {out['counted']}; {out['records']} device "
           f"records in the profiler session")
    short = not idle and all(out["ran"][k] <= want[k] for k in want)
    raise (ShortTrace if short else AssertionError)(msg)


@contextlib.contextmanager
def _launch_trace(want: dict = None, fresh: bool = True, label: str = ""):
    """Runs the body under torch.profiler, the device's activity only (the
    kernels of graph replays included), with every wrapper's count set to
    0 just before it. Yields a dict that, after the body, holds ``ran``,
    the launches of each kernel in the trace by wrapper (what the card
    ran), ``counted``, the wrappers' own counts over the body,
    ``segments``, ``ran`` between the ``_mark`` markers, and ``records``,
    the session's device records. With ``want`` ({wrapper: launches})
    ``_check_launches`` holds ``ran`` to it (a short trace raises
    ``ShortTrace``, which ``_retried_trace`` answers)."""
    out = {}
    with _profiled() as prof:
        _reset_launches()
        yield out
    out["counted"] = _counted()
    names = [name for _, _, name in _device_events(prof)]
    out["records"] = len(names)
    out["ran"] = _calls_per_wrapper(names)
    out["nccl"] = sum(1 for n in names if "nccl" in n.lower())
    cuts = [i for i, n in enumerate(names) if MARKER in n]
    out["segments"] = [_calls_per_wrapper(names[a + 1:b]) for a, b in
                       zip([-1] + cuts, cuts + [len(names)])]
    if want is not None:
        _check_launches(out, want, fresh, label)


@contextlib.contextmanager
def _no_block_launch(label: str):
    """Fails unless the body, eager calls alone, launched no block kernel:
    the wrappers count every eager launch (a profiler session for these
    checks cost about 0.5 s each, in phase 23's time cut)."""
    before = _counted()
    yield
    ran = {k: _counted()[k] - before[k] for k in ("rdb5c", "rdb5c_bwd")}
    if any(ran.values()):
        raise AssertionError(f"{label}: block kernels launched {ran}")


TRACE_ATTEMPTS = 3


def _retried_trace(body, want: dict, fresh: bool = True, label: str = "",
                   trace=None):
    """``body()`` under ``_launch_trace(want, fresh, label)``; when the
    trace comes up short (``ShortTrace``: the profiler lost records), the
    body runs again in a fresh session, up to ``TRACE_ATTEMPTS`` times in
    all, and then the run fails. Every attempt's wrappers must count what
    the first one's did, or it fails at once; so must a trace over
    ``want``. ``trace`` (a stub in the tests) stands for
    ``_launch_trace``. Returns (the trace, what the body returned)."""
    trace = trace or _launch_trace
    first = None
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        t = {}
        try:
            with trace(want, fresh, label) as t:
                result = body()
            return t, result
        except ShortTrace as e:
            if first is None:
                first = t["counted"]
            elif t["counted"] != first:
                raise AssertionError(
                    f"{label}: the wrappers counted {t['counted']} in "
                    f"attempt {attempt}, {first} in the first") from e
            if attempt == TRACE_ATTEMPTS:
                raise
            print(f"trace: {label}: attempt {attempt} short ({e}); "
                  "tracing the body again")


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
    3xTF32 on the card, each k-step's mma sum added rounded to nearest,
    reads about 0.04 of that, as the CPU emulation of
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


def _compare_block(shape, dt, x, g_out, ws, bs, label: str,
                   exact_forward=None):
    """One block forward and, with ``g_out``, backward on the kernels
    against the plain versions; raises past the tolerances. With
    ``exact_forward`` (out, c1..c4 of ``rdb_forward_emulated``) the
    forward's outputs must equal those bit for bit instead, and their
    distances from the plain version are printed. Returns the two largest
    errors (forward, backward or None). The widths are the weights' own;
    where they are not multiples of 32 the wrappers pad the block and the
    plain versions run it unpadded: the padded residuals' extra channels
    must be exactly zero and the rest agree."""
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
    for i, (name, g, r) in enumerate(zip(("out", "c1", "c2", "c3", "c4"),
                                         cut, ref)):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{name}: {g.shape} {g.dtype} vs "
                                 f"{r.shape} {r.dtype}")
        err = float((g.float() - r.float()).abs().max())
        size = float(r.float().abs().max())
        if exact_forward is not None:
            same = torch.equal(g, exact_forward[i])
            print(f"kernels: {label}rdb5c {shape} {dt} {name} max_abs_err "
                  f"{err:.3e} ({err / size:.3e} of max|ref| {size:.3f}); "
                  f"equal to the emulated arithmetic: {same}")
            if not same:
                raise AssertionError(f"{label}rdb5c {shape} {dt} {name}: "
                                     "not its emulated arithmetic")
            errs.append(err)
            continue
        tol = _tolerance(dt, r.float())
        print(f"kernels: {label}rdb5c {shape} {dt} {name} max_abs_err "
              f"{err:.3e} tol {tol:.3e} max|ref| {size:.3f}")
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


def tf32_split(t):
    """The kernels' split of f32 ``t`` (``split_tf32`` of
    ``csrc/conv3x3_mma.cuh``): hi = cvt.rna.tf32(t), lo = cvt.rna.tf32(t -
    hi), both f32. cvt.rna rounds the 13 dropped mantissa bits to nearest,
    ties away from zero."""
    import torch

    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(t)
    return hi, rna(t - hi)


def _mma_step(acc, a, ea, b, eb):
    """One tf32 mma of eight products as ``mma_tf32_sum`` under
    ``TF32_MMA`` adds them, with the operands' exponents (``_exponent``)
    taken once per stage: ``acc`` (..., P, N), ``a`` (..., P, 8), ``b``
    (..., N, 8), all f64; returns the f32 sums as f64. The cut terms are
    integers times a power of two, so summing them before the scaling is
    exact."""
    import torch

    frac = TF32_MMA["frac_bits"]
    top = torch.maximum(
        (ea[..., :, None, :] + eb[..., None, :, :]).amax(-1),
        _exponent(acc)).clamp(min=-900)
    q = torch.ldexp(torch.ones_like(acc), top - frac)
    s = ((a[..., :, None, :] * b[..., None, :, :] / q[..., None]).trunc()
         .sum(-1) + (acc / q).trunc()) * q
    return _round_f32(s, TF32_MMA["rounding"])


def stage_sums_emulated(inp, B, one_way: bool = False):
    """One f32 stage of the block kernels' tile (``rdb_stage_tf32``) as the
    card computes it: ``inp`` (..., b, h, w, K) f32 against ``B`` (..., 9,
    K, N) f32 (tap t = 3 ky + kx, zero padding; leading axes, if any, are
    independent stages run side by side), for each 32-channel chunk, tap
    and eight channels the three tf32 products lo*hi', hi*lo', hi*hi', each
    one mma (``_mma_step``) on a zeroed sum of that k-step, which is then
    added to the running sum in f32, rounded to nearest (``mma_3xtf32``).
    ``one_way`` emulates the tile before that repair (ROADMAP C 27): the
    three mmas straight onto the running sum, which each cut towards zero.
    Returns the f32 sums (..., b, h, w, N) as f64, on ``inp``'s device."""
    import torch
    import torch.nn.functional as F

    *lead, b, h, w, k_ch = inp.shape
    n_out = B.shape[-1]
    a = [F.pad(t.double(), (0, 0, 1, 1, 1, 1)) for t in tf32_split(inp)]
    bw = [t.double() for t in tf32_split(B.contiguous())]
    ea, eb = [_exponent(t) for t in a], [_exponent(t) for t in bw]
    acc = torch.zeros(*lead, b * h * w, n_out, dtype=torch.float64,
                      device=inp.device)
    for chunk in range(k_ch // 32):
        for t in range(9):
            dy, dx = t // 3, t % 3
            for kk in range(4):
                cs = slice(32 * chunk + 8 * kk, 32 * chunk + 8 * kk + 8)
                win = [v[..., dy:dy + h, dx:dx + w, cs].reshape(
                    *lead, -1, 8) for v in a + ea]
                ops = [v[..., t, cs, :].transpose(-1, -2).contiguous()
                       for v in bw + eb]
                # (lo, hi'), (hi, lo'), (hi, hi'): a index 0 is hi, 1 lo
                part = acc if one_way else torch.zeros_like(acc)
                for ia, ib in ((1, 0), (0, 1), (0, 0)):
                    part = _mma_step(part, win[ia], win[2 + ia], ops[ib],
                                     ops[2 + ib])
                acc = part if one_way else _round_f32(acc + part, "rn")
    return acc.reshape(*lead, b, h, w, n_out)


def rdb_forward_emulated(x, packed_w, biases, return_residuals=False,
                         one_way: bool = False):
    """The f32 block forward of ``csrc/rdb5c.cu`` as the card computes it,
    on x's device: stage k sums the chunks of [x|c1..ck] against conv k's
    rows of the packed weights (``stage_sums_emulated``), then its
    epilogue in f32 as the kernel's: the bias, then lrelu (c1..c4) or one
    fused multiply-add, 0.2 v + x (out). ``packed_w`` and ``biases`` at
    widths that are multiples of 32 (``pack_block``'s); with leading axes
    on x, the weights and the biases (x (..., b, h, w, nf), each packed
    weight (..., 9 cin, N), each bias (..., N)), independent blocks side
    by side. ``one_way``: the tile before the repair of ROADMAP C 27
    (``stage_sums_emulated``)."""
    import numpy as np
    import torch

    nf = x.shape[-1]
    gc = packed_w[1].shape[-2] // 9
    x = x.float().contiguous()
    feats = [x]
    for k in range(5):
        cout = gc if k < 4 else nf
        B = torch.cat([p.float().reshape(*p.shape[:-2], 9, -1, p.shape[-1])[
            ..., (k - s) * gc:(k - s) * gc + cout]
            for s, p in enumerate(packed_w[:k + 1])], -2)
        bias = biases[k].float()[..., None, None, None, :]
        v = stage_sums_emulated(torch.cat(feats, -1), B,
                                one_way).float() + bias
        if k == 4:
            out = (v.double() * float(np.float32(0.2)) + x.double()).float()
        else:
            feats.append(torch.where(v >= 0, v, v * 0.2))
    if return_residuals:
        return (out, *feats[1:])
    return out


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

    from trainner_tpu_torch.ops.deform_conv import DCNv2Pack

    gen = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, DCNv2Pack):  # its own kernel (flax's ``kernel``)
            with torch.no_grad():
                m.weight.copy_(kaiming_init_(torch.empty(m.weight.shape),
                                             0.7, gen))
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
    128 x 128 tile per image), each run under a launch trace
    (``_retried_trace``). Returns the launches the card ran and the
    wrappers counted, over all runs."""
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
        t, averages = _retried_trace(lambda: test_cli.main(["-opt", path]),
                                     want, label=os.path.basename(path))
        secs = time.time() - t0
        vals = {m["name"]: m["average"] for m in averages["synth"]}
        print(f"slice: {os.path.basename(path)} {N_IMAGES} images in "
              f"{secs:.2f} s (traced, {t['records']} device records), "
              f"launches the card ran "
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
    # 5 timed steps each (10 until phase 25's time cut)
    for use_amp, n_check, n_timed in ((True, 3, 5), (False, 2, 5)):
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
                 name: str = "cli", edit=None, niter: int = CLI_NITER,
                 val_root: str = None) -> str:
    """An options file of the repo (``options/sr/train_sr.yml`` unless
    ``yml``) as written, read by the port's reader, but for ``edit``
    (applied to the options dict), its data roots (the corpus; a
    validation set of ``N_VAL`` corpus images and their bicubic LR at the
    options' scale, written here), ``niter``, the frequencies and
    ``path.root`` (``root/name``; the other ``path`` keys as the file and
    ``edit`` left them). ``corpus`` may be another form of the corpus (its
    LMDB); the validation set comes from the PNGs of ``root/corpus``, or
    is ``val_root`` (its ``dataroot_HR``) where given. Returns the path of
    the options file."""
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
    if val_root:
        opt["datasets"]["val"]["dataroot_HR"] = val_root
    else:
        opt["datasets"]["val"].update(dataroot_HR=val_hr,
                                      dataroot_LR=val_lr)
    opt["train"].update(niter=niter, val_freq=CLI_FREQ)
    opt["logger"].update(print_freq=2, save_checkpoint_freq=CLI_SAVE_FREQ)
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


def _resume_state(exp: str, niter: int) -> str:
    """The state file a resume starts from: ``training_state/{niter}.state``
    itself, not the directory, whose newest state a resume would take, so
    that a traced resume that runs again (``_retried_trace``) starts where
    the first attempt did and not from the state that attempt saved."""
    return os.path.join(exp, "training_state", f"{niter}.state")


def phase_cli(smi: str, root: str, yml: str = None, label: str = "cli",
              per_batch: int = 2 * 2 * SHUFFLE_K,
              nets: tuple = ("G", "D"), edit=None, niter: int = CLI_NITER,
              resume: bool = True, g_launches=None, corpus: str = None,
              trainer_cls=None, val_launches: int = None,
              save_breakdown: bool = False, val_root: str = None,
              resume_edit=None, resume_niter: int = CLI_RESUME_NITER
              ) -> dict:
    """The training CLI at the full width of an options file of the repo
    (``yml``; by default ``options/sr/train_sr.yml``: G nf 64, nb 23, gc
    32, D-VGG-128, batch 32, crop 128, bsrgan with the per-sample shuffle,
    bf16), ``trainner_tpu_torch.train.main`` on the card for 12 iterations
    with checkpoints at 12 (one file per net of ``nets``) and validation
    at 6 and 12; then a second ``main`` that resumes from
    ``training_state/12.state`` to 14, whose loaded state must equal the
    saved one bit for bit. Each run under a launch trace
    (``_retried_trace``): the three kernels' launches per step, per batch
    (``per_batch`` blur launches) and in all. ``niter`` (a multiple of 6)
    and ``resume`` shorten it. ``g_launches(n)``: the forward (and
    backward) block launches of step n where they are not 69 (a virtual
    batch runs G once per microbatch), or a pair (forward, backward) where
    they differ (SRFlow's frozen encoder). ``corpus`` replaces the train
    set
    (``root/corpus``); ``trainer_cls`` is the trainer whose ``train_step``
    the markers wrap (``SRTrainer``); ``val_launches`` the block launches
    of one validation forward (69); ``save_breakdown`` times a state
    file's save by its parts (``_save_breakdown``; the flagship's run
    alone, the other CLIs' saves are timed whole); ``val_root`` the
    validation set's root (its ``N_VAL`` entries name the validation's
    images); ``resume_edit`` edits the resume's options (phase 24 drops
    ``parallel:`` there) and ``resume_niter`` is where it ends
    (``CLI_RESUME_NITER``). Returns the runs' traces."""
    import torch

    from trainner_tpu_torch.train import cli
    from trainner_tpu_torch.train.sr_trainer import SRTrainer
    from trainner_tpu_torch.utils import checkpoint

    corpus = corpus or os.path.join(root, "corpus")
    opt_path = _cli_options(root, corpus, yml, label, edit, niter, val_root)
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

    def run(argv, want, what):
        def body():
            for key in ("steps", "save", "val"):
                rec[key].clear()
            return cli.main(argv)

        t0 = time.perf_counter()
        t, state = _retried_trace(body, want, label=what)
        return state, t, time.perf_counter() - t0

    # launches per step, per batch and in all: before step 1 its batch's
    # degrader, then each step, then the next batch's degrader (after a
    # validation at 6, its forwards too), and after step 12 the validation
    # at 12
    n_val = niter // CLI_FREQ * N_VAL  # validation every CLI_FREQ
    per_step = g_launches or (lambda n: per_g)

    def g_run(steps, i):
        return sum(_fwd_bwd(per_step(n))[i] for n in steps)

    first = range(1, niter + 1)
    want = dict(blur=per_batch * niter,
                rdb5c=g_run(first, 0) + per_val * n_val,
                rdb5c_bwd=g_run(first, 1))
    n2 = resume_niter - niter
    second = range(niter + 1, resume_niter + 1)
    want2 = dict(blur=per_batch * n2, rdb5c=g_run(second, 0),
                 rdb5c_bwd=g_run(second, 1))
    cls.train_step = train_step
    checkpoint.save_checkpoint = timed(orig[1], "save")
    cli.validate = timed(orig[2], "val")
    checkpoint.load_state = load_state
    try:
        state, counts, wall = run(["-opt", opt_path], want, label)
        steps = list(rec["steps"])
        timed_parts = rec["save"] + rec["val"]
        save_ms = [d * 1e3 for _, d in rec["save"]]
        val_ms = [d * 1e3 for _, d in rec["val"]]
        saved = _state_tensors(state)
        save_parts = _save_breakdown(state, os.path.join(
            root, "t.state")) if save_breakdown else None
        del state
        torch.cuda.empty_cache()
        if resume:
            with open(opt_path) as f:
                opt2 = json.load(f)
            opt2["train"]["niter"] = resume_niter
            opt2["path"]["resume_state"] = _resume_state(exp, niter)
            if resume_edit is not None:
                resume_edit(opt2)
            opt2_path = os.path.join(root, f"{label}_resume.json")
            with open(opt2_path, "w") as f:
                json.dump(opt2, f)
            state2, counts2, wall2 = run(["-opt", opt2_path], want2,
                                         f"{label} resume")
            steps2 = list(rec["steps"])
    finally:
        (cls.train_step, checkpoint.save_checkpoint, cli.validate,
         checkpoint.load_state) = orig

    # the first run's launches per step and per batch, from its trace
    _check_cli_trace(label, counts, want, steps, range(1, niter + 1),
                     per_val, per_batch, per_step)
    print(f"{label}: main() on {niter} iterations, {wall:.2f} s (traced): "
          f"launches the card ran {counts['ran']} (expected {want}); the "
          f"wrappers counted {counts['counted']}")
    print(f"{label}: every step's block launches (forward, backward) "
          f"{sorted({_fwd_bwd(per_step(n)) for n in range(1, niter + 1)})}"
          f" and its batch's {per_batch} blur launches before it ({niter} "
          f"steps, from the trace)")

    # the artifacts
    files = {os.path.relpath(os.path.join(d, f), exp)
             for d, _, fs in os.walk(exp) for f in fs}
    need = {f"models/{niter}_{n}.ckpt" for n in nets} | {
        f"training_state/{niter}.state{e}" for e in ("", ".json")} \
        | {"tb/scalars.jsonl"}
    names = [os.path.splitext(n)[0] for n in
             sorted(os.listdir(val_root or os.path.join(root, "val_HR")))]
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
    steady = span - sum(d for t0, d in timed_parts
                        if steps[2][1] <= t0 < rec["end"])
    n = niter - 2
    print(f"times: {label} main() steps 3-{niter} on the host clock, "
          f"under the launch trace: "
          f"{steady * 1e3 / n:.3f} ms per iteration, {n / steady:.4f} it/s "
          f"steady; {span * 1e3 / n:.3f} ms, {n / span:.4f} it/s with the "
          f"save and validation at {CLI_FREQ} ({smi})")
    parts = "" if save_parts is None else (
        f"; of a state file ({save_parts['mb']:.1f} MB): to host trees "
        f"{save_parts['host_ms']:.1f} ms, encoded and written "
        f"{save_parts['write_ms']:.1f} ms")
    print(f"times: {label} save_checkpoint ({', '.join(nets)}, state; "
          f"synchronised) {', '.join(f'{t:.1f}' for t in save_ms)} ms"
          f"{parts}; validation "
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
    _check_cli_trace(f"{label} resume", counts2, want2, steps2,
                     range(niter + 1, resume_niter + 1), per_val,
                     per_batch, per_step)
    print(f"{label}: resumed from {os.path.relpath(path, exp)} (iter "
          f"{meta['iter']}, epoch {meta['epoch']}) to {state2.step} in "
          f"{wall2:.2f} s (traced): {len(saved)} tensors and counts of the "
          f"saved state, {len(diff)} differ after loading; launches the "
          f"card ran {counts2['ran']}, the wrappers counted "
          f"{counts2['counted']}")
    if diff or meta["iter"] != niter or state2.step != resume_niter \
            or not os.path.exists(os.path.join(
                exp, "models", f"{resume_niter}_G.ckpt")):
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
    are not ``per_g``: one count for both, or (forward, backward)."""
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
        gf, gb = _fwd_bwd(per_step(number))
        if step != {"rdb5c": gf, "rdb5c_bwd": gb, "blur": 0} \
                or before["blur"] != per_batch or before["rdb5c_bwd"] \
                or (before["rdb5c"] % per_g if per_g else before["rdb5c"]):
            raise AssertionError(
                f"{label} step {number}: {step} in the step, {before} "
                f"before it")


def _fwd_bwd(launches) -> tuple:
    """A step's block launches as (forward, backward): a pair as it is,
    one count for both."""
    return tuple(launches) if isinstance(launches, tuple) else (
        launches, launches)


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
    both types (at SRFlow's F in f32 alone),
    beside the plain version, the
    bound and the cuDNN five-conv chain (its forward, and autograd's
    backward through it), and the kernels' time on the device alone; then
    (unless ``kernels_only``) the G
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
    # and SRFlow's encoder step (F, f32 alone) from one of its own, PBR's
    # step (P) too
    srflow_gen = torch.Generator().manual_seed(22)
    pbr_gen = torch.Generator().manual_seed(23)
    rows = {}
    both = (torch.float32, torch.bfloat16)
    for shape, dtypes in ((MAIN_SHAPE, both), (TRAIN_SHAPE, both),
                          (ZOO_SERVE_SHAPE, both),
                          (SRFLOW_F, (torch.float32,)),
                          (PBR_P, both)):
        b, h, w = shape
        npix = b * h * w
        for dt in dtypes:
            name = str(dt).replace("torch.", "")
            g_draw = {ZOO_SERVE_SHAPE: zoo_gen, SRFLOW_F: srflow_gen,
                      PBR_P: pbr_gen}.get(shape, gen)
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
            g = torch.randn(b, h, w, NF, generator=g_draw if shape in (
                SRFLOW_F, PBR_P) else gen).cuda().to(dt)
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
            (ZOO_SERVE_SHAPE,) if kernel == "rdb5c_forward" else ()) + tuple(
            sh for sh in (SRFLOW_F, PBR_P) if (kernel, sh, dtype) in rows)
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
    128->512 px, and one train step at b=32, 32->128 px in bf16 (``step_ms``:
    its time without the profiler by type name, from the training phase;
    the f32 step's trace went in phase 23's time cut)."""
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
    for use_amp, name in ((True, "bfloat16"),):
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

GRAPH_STEPS = 2     # graphed against eager steps, per type
GRAPH_TIMED = 5     # timed steps each way (10 until phase 25's time cut)
# the order of eager (False) and graphed (True) runs that a phase times:
# one turn each (eager, graphed), where four turns ran before (eager,
# graphed, graphed, eager)
TURNS = (False, True)
WINDOW_K = 6        # train_steps' window (bench.py's is 10)
WINDOW_BOUNDARY = 3  # a MultiStep boundary inside the window
EMA_MOVE_TOL = 1e-2  # bf16 graph against eager: the EMA weights' moves
X8_LR = (1, 72, 64, 3)      # x8 on the card against the CPU
CHOP_LR = (1, 136, 128, 3)  # chop: two 128 x 128 tiles


# CycleGAN's state has two Ds, WBC's two (D_S and D_T)
NET_STATES = ("g", "d", "d_a", "d_b", "d_s", "d_t")


def _net_states(state) -> list:
    """(name, NetState) of each trained net a state holds: G and D, or
    CycleGAN's G (both Gs) and its two Ds."""
    return [(w, getattr(state, w)) for w in NET_STATES
            if getattr(state, w, None) is not None]


def _net_tensors(state) -> dict:
    """Each net's state_dict (``g.``, ``d.``, ``d_a.``, ``d_b.``) and the
    EMA weights (``e.``), cloned."""
    out = {f"{w}.{k}": v.detach().clone()
           for w, ns in _net_states(state) for k, v in
           ns.net.state_dict().items()}
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
    moments = [torch.equal(x, y) for w, _ in _net_states(state_a)
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
                batch_fn=None, timed: bool = True) -> dict:
    """The step of ``options()`` (the flagship configuration by default) as
    a graph against the eager step, in bf16 and f32 (``types``: the values
    of ``use_amp``): three steps each from one seed on the same batches,
    within the step tolerances of ``_check_steps``; the recorded launches
    of one replay against a profiler trace of it; with ``noise``, fresh
    latent noise per replay; with ``timed``, 10 steps each way in turns
    and a traced replay (measurement alone: the flagship's; the other
    cells' went in phase 23's time cut). Returns the graphs' capture
    seconds, pool bytes and step times by type."""
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
        out[name] = dict(capture_s=cap.capture_s, pool=cap.pool_bytes)
        if not timed:
            del runs, trainer, state, cap, caps
            torch.cuda.empty_cache()
            continue
        # times: GRAPH_TIMED steps each, in turns (eager, graphed)
        ms = {}
        for graphs in TURNS:
            tr, st = runs[graphs][:2]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GRAPH_TIMED):
                tr.train_step(st, batches[1])
            torch.cuda.synchronize()
            ms.setdefault(graphs, []).append(
                (time.perf_counter() - t0) / GRAPH_TIMED * 1e3)
        lr_px, hr_px = batches[1]["LR"].shape[1], batches[1]["HR"].shape[1]
        print(f"times: train_step {name} b={batches[1]['LR'].shape[0]} "
              f"{lr_px}->{hr_px} px, ms per step over "
              f"{GRAPH_TIMED} (eager, graphed): eager {ms[False]}, "
              f"graphed {ms[True]}; it/s eager {1e3 / min(ms[False]):.4f}, "
              f"graphed {1e3 / min(ms[True]):.4f} ({smi})")
        tr, st = runs[True][:2]
        _traced(lambda: tr.train_step(st, batches[1]),
                f"graphed train_step {name}", smi, min(ms[True]))
        out[name].update(eager_ms=min(ms[False]), graphed_ms=min(ms[True]))
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
    """``train_steps`` with k = ``WINDOW_K`` at b = 32, 32 -> 128 px, bf16,
    a MultiStep boundary at step ``WINDOW_BOUNDARY``: the window (the
    first step of a fresh trainer runs eagerly and captures, the rest
    replay) against as many eager ``train_step`` calls, the learning
    rates the window handed the step, and both times over a second
    window."""
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
                                                      state)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, lg = tr.train_steps(st, batches)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / WINDOW_K
        times.setdefault(label, []).append(ms)
    print(f"times: train_steps k={WINDOW_K} b={b} {px}->{px * 4} px bf16, "
          f"ms per step over a window (eager, graphed): "
          f"eager {times['eager']}, graphed {times['graphed']}; it/s "
          f"eager {1e3 / min(times['eager']):.4f}, graphed "
          f"{1e3 / min(times['graphed']):.4f} ({smi})")
    _traced(lambda: trainer.train_steps(state, batches),
            f"graphed train_steps k={WINDOW_K}", smi,
            min(times["graphed"]) * WINDOW_K)
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
    the kernels of a replay; both times, one turn each, and a trace of a
    replay."""
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
        for which, fn in (("eager", eager), ("graphed", graphed)):
            ms.setdefault(which, []).append(
                _time_ms(lambda: fn(raws[1]), iters=10, warmup=2))
        print(f"times: degrade {preset} {label} b={b} {hr}->{hr // 4} px, "
              f"ms per batch (CUDA events over 10; eager, graphed): eager "
              f"{ms['eager']}, graphed {ms['graphed']} ({smi})")
        _traced(lambda: graphed(raws[1]),
                f"graphed degrade, {preset} {label}, b={b}", smi,
                min(ms["graphed"]))
        result[label] = dict(eager_ms=min(ms["eager"]),
                             graphed_ms=min(ms["graphed"]),
                             capture_s=cap.capture_s, pool=cap.pool_bytes)
        del graphed, eager
        torch.cuda.empty_cache()
    return result


def _graph_serving(smi: str) -> None:
    """``eval_step`` as a graph against the eager one at b = 8, 128 -> 512
    px (f32 within 1e-5 and bf16 within 3e-2 of the output's size, the
    full-G tolerances; its times in turns and trace went in phase 23's
    time cut, measurement alone); then x8 on one 72 x 64 and chop on
    one 136 x 128 LR image in f32 on the card against the eager
    ``eval_step`` over the same rotations and tiles on the card's plain
    versions with the same weights, within the full-G f32 tolerance."""
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
        del pair
        torch.cuda.empty_cache()

    # x8 and chop on one image, against the eager composition on the
    # plain versions
    tr = create_trainer(dict(opt))
    st = tr.init_state(0)
    _gain_weights(st.g.net, seed=2)
    plain = create_trainer(dict(opt), graphs=False)
    pst = plain.init_state(0)
    pst.g.net.load_state_dict(st.g.net.state_dict())
    # x8 meets each of its two shapes four times a call, chop its one
    # chunk of two tiles once: the last call replays graphs of them
    for label, run, calls, shape in (
            ("x8", lambda t, s, v: t.eval_step_x8(s, v),
             tr.EVAL_CAPTURE_AT // 4 + 1, X8_LR),
            ("chop", lambda t, s, v: t.eval_step_chop(s, v),
             tr.EVAL_CAPTURE_AT + 1, CHOP_LR)):
        x = torch.rand(*shape,
                       generator=torch.Generator().manual_seed(32))
        before = {k: c.replays for k, c in tr.eval_graphs().items()}
        for _ in range(calls):
            got = run(tr, st, x.cuda())
        torch.cuda.synchronize()
        replayed = sorted(k[0] for k, c in tr.eval_graphs().items()
                          if c.replays > before.get(k, 0))
        t0 = time.perf_counter()
        with _plain_blocks():
            want = run(plain, pst, x.cuda()).cpu()
        plain_s = time.perf_counter() - t0
        scale = float(want.abs().max())
        err = float((got.cpu() - want).abs().max())
        print(f"graphs: {label} on a {shape[1]}x{shape[2]} "
              f"LR image, f32 on the card, call {calls} (graph replays "
              f"of the shapes {replayed}) against the eager "
              f"composition on the plain versions ({plain_s:.1f} s): "
              f"max_abs_err {err:.3e} on max|ref| {scale:.3e}, tol "
              f"{1e-5 * scale:.3e}")
        _, lh, lw, _ = shape
        want_shapes = (sorted([(1, lh, lw, 3), (1, lw, lh, 3)])
                       if label == "x8" else [(2, 128, 128, 3)])
        if tuple(got.shape) != (1, lh * 4, lw * 4, 3) \
                or not err <= 1e-5 * scale \
                or replayed != want_shapes:
            raise AssertionError(f"graphs: {label}")
    del tr, st, plain, pst
    torch.cuda.empty_cache()


MIXED_LR = ((128, 128), (96, 128), (128, 96), (120, 80), (100, 140),
            (88, 112), (140, 100), (112, 88))  # h, w: one size per image


def _graph_mixed_sizes(smi: str, root: str) -> None:
    """The test CLI, f32 at full width, plain and with x8, eager
    (``graphs=False``) against graphed (the default) in turns, on a test
    set of one size per image (``MIXED_LR``, LR crops of the corpus,
    ``mode: single``): seconds per image through ``main()`` (set-up included)
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
    # the synthetic set of one size is phase 4's, which times it alone
    sets = (("one size per image", len(MIXED_LR),
             {"name": "mixed", "mode": "single", "dataroot_LR": lr_dir}),)
    orig = (sr_trainer.create_trainer, sr_trainer.SRTrainer.eval_step,
            sr_trainer.SRTrainer.eval_step_x8)
    for (kind, n_img, ds), x8 in ((d, x8) for d in sets
                                  for x8 in (False, True)):
        label = "x8" if x8 else "plain"
        runs = {}
        for n, graphs in enumerate(TURNS):
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
    times; then ``main`` on a copy of the options for
    6 iterations and a resume to 8 whose EMA and spectral-norm state
    load bit for bit. Returns the CLI runs' launch traces."""
    t0 = time.perf_counter()
    _resrgan_ops(smi)
    _resrgan_degrader(smi, root)
    _graph_degrader(smi, root, programs=(
        ("fixed order", False, RESRGAN_BLUR, _resrgan_e2e_options),),
        preset="resrgan")
    _graph_step(smi, _resrgan_options, types=(True,), label="resrgan ",
                noise=False, timed=False)
    traces = phase_cli(smi, root, RESRGAN_YML, "cli_realesrgan",
                       RESRGAN_BLUR, ("G", "D", "emaG"), niter=SHORT_NITER,
                       resume_niter=SHORT_RESUME)
    print(f"realesrgan: ok in {time.perf_counter() - t0:.1f} s ({smi})")
    return {f"realesrgan {k}": v for k, v in traces.items()}


N_ZOO_IMAGES = 3  # serving runs of phase 14 (x8: 24 calls of one shape)
# full-width sr_resnet's steps with train_sr.yml's D-VGG (batch norms):
# each tensor's error as a share of its move, card against CPU, by net (G,
# D), set from the H100's readings (G 1.07e-2, D 1.14e-1); and each
# tensor's distance of the card to the f64 witness at most this many times
# the CPU f32's largest distance to it in the same net (read: G 0.40, D
# 0.78)
SRRESNET_STEP_TOL = {"g": 3e-2, "d": 3e-1}
SRRESNET_STEPS = 1  # 2 until phase 23's time cut
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
    one forward per image), each under a launch trace (``_retried_trace``)
    with 69 block launches per G forward; then the full G on the kernels
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

        def body():
            seen.clear()
            return test_cli.main(["-opt", path])

        t0 = time.time()
        SRTrainer.eval_step = spy
        try:
            t, averages = _retried_trace(body, want, label=name)
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
            with _no_block_launch(label):
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
    for net in [ns.net for _, ns in _net_states(state)] + [
            trainer.generator_loss, getattr(trainer, "loss_1ch", None), loc,
            state.swa]:
        if net is None:
            continue
        net.double()
        for m in net.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64
    for w, ns in _net_states(state):
        ns.opt = trainer._optimizer(ns.net, "G" if w == "g" else "D")
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

    for w in NET_STATES + ("loc",):
        a, b = getattr(dst, w, None), getattr(src, w, None)
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


def _same_records(a, b) -> bool:
    """Whether two ``_Branches`` records took every branch alike (a run
    that replays one is then the run that replays the other)."""
    import torch

    return a is not None and b is not None and len(a) == len(b) and all(
        torch.equal(x, y) for x, y in zip(a, b))


def _d_branches(nets, replay=None):
    """``_Branches`` over the forward passes of D alone (``nets``: one
    module or several, each D of CycleGAN's, or also G and the loss stack
    where no kernel hides G's LeakyReLUs: ``branches="all"`` of
    ``_steps_card_cpu_f64``), entered by a forward pre-hook and left by a
    forward hook: D runs the same Python on every side, where G's blocks
    take their LeakyReLU inside the kernels on the card. Returns the
    ``_Branches`` and a function that removes the hooks."""
    branches = _Branches(replay)

    def enter(module, args):
        branches.__enter__()

    def leave(module, args, out):
        branches.__exit__(None, None, None)

    hooks = []
    for net in nets if isinstance(nets, (list, tuple)) else [nets]:
        hooks += [net.register_forward_pre_hook(enter),
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
    move D's gradients by that element's whole share. ``branches="all"``
    records G's (each of CycleGAN's two) and the loss stack's branches
    too, for nets whose ReLUs no kernel hides; a callable ``branches(state,
    trainer)`` names the modules whose branches are recorded. Returns per
    tensor
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
            logs, records, skipped = {}, {}, set()
            for side in order:
                if callable(branches):
                    d_nets = branches(states[side], trainers[side])
                else:
                    d_nets = [m for w, ns in _net_states(states[side])
                              if w != "g" or branches == "all"
                              for m in (ns.net.values() if hasattr(
                                  ns.net, "values") else [ns.net])]
                if branches == "all":
                    d_nets.append(trainers[side].generator_loss)
                rec = None
                if side == "f64 cpu" and i == len(batches) - 1 and \
                        _same_records(records.get("cpu"),
                                      records.get("eager")):
                    # the card's witness replayed the same branches from
                    # the same state: the same f64 step. The last step
                    # only: a skipped step would leave this witness's step
                    # count and generator behind the other's
                    skipped.add(side)
                    continue
                if branches and d_nets and side != "cuda":
                    rec, remove = _d_branches(d_nets, records.get(
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
                 for side in order if side not in skipped}
            t.update({side: t["f64"] for side in skipped})
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
    its forward card against CPU in f32 and bf16, and ``SRRESNET_STEPS``
    steps with
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
               for _ in range(SRRESNET_STEPS)]
    r = _steps_card_cpu_f64("zoo: sr_resnet", srresnet, batches)
    bad = []
    for net in ("g", "d"):
        cc, f64, cpu = (_worst(r[key], net + ".") for key in
                        ("card_cpu", "card_f64", "cpu_f64"))
        step_tol, f64_tol = SRRESNET_STEP_TOL[net], SRRESNET_F64_TOL * cpu[0]
        print(f"zoo: sr_resnet with D-VGG-128 (batch norms), "
              f"{SRRESNET_STEPS} f32 SGD steps (lr 1e-2) b=4 32 -> 128 px, {net.upper()}'s tensors "
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
    the x2 layout through the CLI for 6 iterations and a resume to 8
    that loads bit for bit; then ``sr_resnet`` and ESRGAN+ card against
    CPU. Returns the main paths' launch traces."""
    t0 = time.perf_counter()
    traces = _zoo_serving(smi, root)
    _graph_step(smi, _zoo_train_options, types=(True,), label="zoo x2 ",
                noise=False, batch_fn=_zoo_batch, timed=False)
    cli_traces = phase_cli(smi, root, TRAIN_YML, "cli_zoo",
                           edit=_zoo_cli_edit, niter=SHORT_NITER,
                           resume_niter=SHORT_RESUME)
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
    ``augs_strategy: combo`` and its assets at full width (6 iterations,
    ``COMBO_BLUR`` blur launches per batch and 69 + 69 block launches per
    step from the trace; no resume: the state is the flagship's, whose
    resume phase 9 holds) and with ``realsr`` (6
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
                     edit=_strategy_edit("combo", assets), resume=False,
                     niter=SHORT_NITER)
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
LOSS_CPU = (1, 128, 128, 3)   # each loss and the penalty, card against CPU
FEATNET_CPU = (2, 64, 64, 3)  # the ResNet-101 and MINC feature losses
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
    the CPU's (where the CPU took the card's branches, that is the card's
    run, which is not made twice). Prints and returns the readings; fails
    unless the card's value is within ``LOSS_VALUE_TOL`` of the CPU's and
    its gradient within ``LOSS_GRAD_TOL`` of the f64 gradient on its own
    branches."""
    def host(g):
        return {k: v.detach().double().cpu().clone() for k, v in g.items()} \
            if isinstance(g, dict) else g.detach().double().cpu().clone()

    got, records = {}, {}
    for side, replay in (("cpu", None), ("cuda", None), ("f64", None),
                         ("f64 card", "cuda"), ("f64 cpu", "cpu")):
        if side == "f64 cpu" and _same_records(records["cpu"],
                                               records["cuda"]):
            # the same replay as the card's: the same f64 run
            got[side] = got["f64 card"]
            continue
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


def phase_losses(smi: str, root: str) -> dict:
    """Phase 16: the rest of the loss stack. Writes the seeded weight
    files (``_write_loss_assets``); holds each loss, the penalty, the
    LPIPS metric and the ResNet-101 and MINC losses card against CPU
    (``_losses_card_vs_cpu``); the step with the stack as a graph against
    eager (``_graph_step``: within the step tolerances, 69 + 69 block
    launches per replay from a trace, times in turns); then
    ``train_sr.yml`` with the stack
    through the training CLI (6 iterations and a resume to 8, 69 + 69
    block and 24 blur launches per step from the trace, LPIPS in each
    validation, its steady rate graphed). Returns the CLI runs'
    traces."""
    t0 = time.perf_counter()
    vgg, squeeze = _write_loss_assets(os.path.join(root, "loss_assets"))
    _losses_card_vs_cpu(smi, vgg, squeeze)
    _graph_step(smi, _loss_stack_options(vgg), types=(True,), timed=False,
                label="loss stack ", noise=False)
    runs = phase_cli(smi, root, TRAIN_YML, "cli_losses",
                     edit=_loss_stack_edit(vgg, squeeze), niter=SHORT_NITER,
                     resume_niter=SHORT_RESUME)
    with open(os.path.join(root, "cli_losses_options.json")) as f:
        name = json.load(f)["name"]
    rows = [json.loads(line) for line in open(os.path.join(
        root, "cli_losses", "experiments", name, "tb", "scalars.jsonl"))]
    lpips = {r["step"]: r["value"] for r in rows if r["tag"] == "val/lpips"}
    losses = {r["tag"] for r in rows if r["tag"].startswith("train/l_")}
    want = {f"train/{k}" for k in LOSS_NAMES + ["l_d_gp"]}
    print(f"losses: cli_losses validation LPIPS {lpips}; losses logged "
          f"{sorted(losses)}")
    if sorted(lpips) != [CLI_FREQ] or not all(
            math.isfinite(v) and v >= 0 for v in lpips.values()) \
            or not want <= losses:
        raise AssertionError(f"losses: the CLI's scalars: lpips {lpips}, "
                             f"missing {sorted(want - losses)}")
    print(f"losses: ok in {time.perf_counter() - t0:.1f} s ({smi})")
    return {f"loss stack cli {k}": v for k, v in runs.items()}


OPT_CROP = 112  # AdaTarget with D-VGG: a crop of a multiple of 7 x scale
# the CLI's crop: its bsrgan pipeline compresses the LR in 8 x 8 blocks
# (jpeg), so the LR must be a multiple of 8 too: 224 = lcm(28, 32)
OPT_CLI_CROP = 224
OPT_ATG_START, OPT_SWA_START = 4, 6
OPT_GRAPH_STEPS = 8   # graphed against eager, across both starts
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
        lr_D=1e-4 if o in ADAPTIVE else 1e-2), 2, 32, None, 1)
        for o in ("rmsprop", "adamp", "sgdp", "ranger", "madgrad")]
    configs += [
        # step 0 updates G, step 1 does not: two programs
        ("grad_clip auto", _small_options(grad_clip="auto",
                                          D_update_ratio=2), 2, 32, None, 2),
        # one step each: nothing of these options carries over a step
        ("virtual_batch_size 2", _small_options(virtual_batch_size=2), 1,
         32, None, 1),
        ("freeze_loc 4", _small_options(freeze_loc=4), 1, 32, None, 1),
        ("fs", _small_options(fs=True), 1, 32, None, 1)]
    configs += [(f"diffaug {p}", _small_options(diffaug=True, dapolicy=p),
                 1, 32, None, 1) for p in OPT_POLICIES]
    configs += [
        ("batch augmentations", _small_options(
            mixup=True, mixopts=OPT_AUGS, mixalpha=[0.2]),
         len(OPT_AUGS), 32, list(range(len(OPT_AUGS))), 1),
        # AdaTarget's program from step 1 on: two programs
        ("AdaTarget", atg, 2, 28, None, 2), ("SWA", swa, 2, 32, None, 1)]
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
    224 px; ``SHORT_NITER`` iterations and a resume to ``SHORT_RESUME``
    that restores SWA, the LocNet, the clip history and every optimizer
    state bit for bit; 69 x 2 + 69 x 2 block launches per step before
    AdaTarget, 69 + 69 after, 24 blur launches per shuffled batch, from
    the trace); the ``8_swaG`` file equal to the state's SWA weights and
    served by the port's test CLI with ``which: swa``."""
    import numpy as np

    from trainner_tpu_torch import test as test_cli
    from trainner_tpu_torch.utils import checkpoint

    per_g = NB * 3
    runs = phase_cli(smi, root, TRAIN_YML, "cli_options",
                     edit=_options_cli_edit,
                     g_launches=lambda n: per_g * (
                         1 if n > OPT_ATG_START else 2),
                     niter=SHORT_NITER, resume_niter=SHORT_RESUME)
    with open(os.path.join(root, "cli_options_options.json")) as f:
        opt = json.load(f)
    exp = os.path.join(root, "cli_options", "experiments", opt["name"])
    swa_file = os.path.join(exp, "models", f"{SHORT_RESUME}_swaG.ckpt")
    with open(os.path.join(exp, "training_state",
                           f"{SHORT_RESUME}.state"), "rb") as f:
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
    print(f"options: {SHORT_RESUME}_swaG.ckpt equals the state's SWA "
          f"weights bit for bit: {same} (swa_n {int(tree['swa_n'])}); "
          f"served by the test CLI with which: swa, PSNR {psnr} ({smi})")
    if not same or not psnr or not all(math.isfinite(v) for v in psnr) \
            or int(tree["swa_n"]) != SHORT_RESUME - OPT_SWA_START:
        raise AssertionError("options: the SWA checkpoint or its serving")
    return {f"options cli {k}": v for k, v in runs.items()}


def phase_trainer_options(smi: str, root: str) -> dict:
    """Phase 17: the rest of the sr trainer's options. (a) each option card
    against CPU and an f64 witness at small widths; (b) the full-width
    options cell graphed against eager bit for bit across AdaTarget's and
    SWA's starts, each program's replay traced; (c) the training CLI on
    the cell with a resume and the SWA file served. Returns the launch
    traces of its main-path runs."""
    import torch

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _options_card_cpu(smi)
    _options_graphed_vs_eager(smi)
    traces = _options_cli(smi, root)
    print(f"options: ok in {time.perf_counter() - t0:.1f} s ({smi})")
    return traces


# ---------------------------------------------------------------------------
# 18. the rest of the producer: LMDB, the dataset options, host-side OTF
# ---------------------------------------------------------------------------
DECODE_SAMPLES = 16  # host decode ms per sample, folder and LMDB
PAETH_SAMPLES = 2    # ... and of a value filtered with Paeth on every row
RATE_TURNS = 1       # the folder's and the LMDB's graphed rates, in turns
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

    def weighted():
        came, order = [0, 0], []
        it = _batches_of(mixed)
        try:
            for _ in range(MIXED_BATCHES):
                batch = next(it)
                came[batch["dataset_index"]] += 1
                order.append(batch["dataset_index"])
                trainer.train_step(state, degrade(batch))
        finally:
            it.close()
        return came, order

    # retried where the profiler lost records (C 24), as the CLIs' traces
    t, (came, order) = _retried_trace(
        weighted, {"rdb5c": per_g * MIXED_BATCHES,
                   "rdb5c_bwd": per_g * MIXED_BATCHES,
                   "blur": 2 * 2 * SHUFFLE_K * MIXED_BATCHES},
        fresh=False, label="weighted loader")
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
    the LMDB as its train set, 6 iterations (no resume: the state is the
    flagship's, whose resume phase 9 holds); (b) the
    same CLI with ``aug_downscale: 0.5`` and a ``subset_file`` of half the
    corpus (every sample from the subset); (c) the rates, the weighted
    loader and ``otf_mode: host`` (``_producer_rates``). Returns the
    traces of its main-path runs."""
    from trainner_tpu_torch.data import datasets

    t0 = time.perf_counter()
    db = _lmdb_corpus(smi, root)
    traces = {f"lmdb cli {k}": v for k, v in phase_cli(
        smi, root, TRAIN_YML, "cli_lmdb", corpus=db, resume=False,
        niter=SHORT_NITER).items()}
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
PPON_STAGES = [2, 4]      # the CLI: phase 1 to step 2, 2 to 4, then 3
PPON_GRAPH_STAGES = [2, 4]  # graphed against eager: two steps per phase
PPON_GRAPH_B = 16
PPON_LOSSES = {"ms_criterion": "multiscale-l1", "ms_weight": 1e-2,
               "ssim_type": "ms-ssim", "ssim_weight": 0.2,
               "cx_type": "contextual", "cx_weight": 0.5}
# one f32 step of phases 1 and 3 (_ppon_f64): each tensor of the card
# within this share of its move of the CPU's, and no further from the f64
# witness than PPON_F64_TOL times the CPU f32's largest distance in the same
# net; set from the CPU f32's own distance from the witness on this
# configuration (G 1.5e-2 at hr1_p, D 6.5e-2 at conv4_0) as phase 14's
# sr_resnet limits were
PPON_STEP_TOL = {"g": 6e-2, "d": 3e-1}
# phase 19's card-against-CPU forwards (their bf16 runs on the CPU are slow)
MODELS_CPU_LR = (1, 16, 16, 3)
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
    """One step of phase 1 and one of phase 3 (``ppon_stages`` [1, 1];
    phase 2's losses, pix-multiscale and ms-ssim, each have phase 16's
    witness) of PPON at full width and cut depth (nf 64, nb 1) with
    D-VGG-128 (batch norms) in f32 (b=2, 32 -> 128 px, SGD at lr 1e-2;
    pix, then pix with the GAN), on the card (graphed, two programs), the
    CPU and an
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
                  "ppon_stages": [1, 1], "lr_scheme": "MultiStepLR",
                  "lr_steps": [50]}}, is_train=True))
    gen = torch.Generator().manual_seed(8)
    batches = [{"LR": torch.rand(2, 32, 32, 3, generator=gen),
                "HR": torch.rand(2, 128, 128, 3, generator=gen)}
               for _ in range(2)]
    r = _steps_card_cpu_f64("ppon", opt, batches, graphs=2, branches=True)
    bad = []
    for net in ("g", "d"):
        cc, f64, cpu = (_worst(r[key], net + ".") for key in
                        ("card_cpu", "card_f64", "cpu_f64"))
        step_tol, f64_tol = PPON_STEP_TOL[net], PPON_F64_TOL * cpu[0]
        print(f"ppon: one f32 SGD step of phases 1 and 3 (nf 64, nb 1; "
              f"D-VGG-128), "
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


def _pan_cli_edit(opt: dict) -> None:
    """``train_sr.yml`` with ``network_G: pan_net`` at its defaults (nf 40,
    unf 24, nb 16), trained by the ``sr`` trainer."""
    opt["network_G"] = {"type": "pan_net"}


def phase_models(smi: str, root: str) -> dict:
    """Phase 19: PPON, PAN and A2N at full width. PPON: its forward card
    against CPU (f32, bf16) on every output; the training CLI on
    ``train_sr.yml`` with ``model: ppon`` (6 iterations through its three
    phases and a resume to 8 in phase 3; no block kernel, 24 blur launches
    per batch); its saved G served by the test CLI at ``ppon_phase`` 3 and
    1; graphed against eager (``_ppon_graphed_vs_eager``); the f64 witness
    of one step per phase (``_ppon_f64``). PAN (with self-attention) and
    A2N card against CPU; PAN through the ``sr`` training CLI with a
    resume (the three models' serving rates, measurement alone, went in
    the time cut of phase 23's slice). Returns the CLI traces."""
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
            cfg, 4)}, MODELS_CPU_LR, (torch.float32, torch.bfloat16),
            tag="models")

    runs = phase_cli(smi, root, TRAIN_YML, "cli_ppon", edit=_ppon_cli_edit,
                     trainer_cls=PPONTrainer, g_launches=lambda n: 0,
                     val_launches=0, niter=SHORT_NITER,
                     resume_niter=SHORT_RESUME)
    traces = {f"ppon cli {k}": v for k, v in runs.items()}
    with open(os.path.join(root, "cli_ppon_options.json")) as f:
        opt = json.load(f)
    exp = os.path.join(root, "cli_ppon", "experiments", opt["name"])
    phases = _ppon_phases_of(exp)
    want = {s: 1 + (s - 1 >= PPON_STAGES[0]) + (s - 1 >= PPON_STAGES[1])
            for s in phases}
    print(f"ppon: the CLI's ppon_phase by iteration {phases} (expected "
          f"{want}); the resume to {SHORT_RESUME} continued in phase 3")
    if phases != want or set(phases.values()) != {1, 2, 3} or \
            max(phases) != SHORT_RESUME:
        raise AssertionError(f"ppon cli phases {phases}")
    g_file = os.path.join(exp, "models", f"{SHORT_RESUME}_G.ckpt")
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
    print(f"ppon: {SHORT_RESUME}_G.ckpt served by the test CLI at b=1 on "
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
                         val_launches=0, niter=SHORT_NITER,
                         resume_niter=SHORT_RESUME).items()})):
        t1 = time.perf_counter()
        part()
        parts.append(f"{time.perf_counter() - t1:.1f}")
    print(f"models: ok in {time.perf_counter() - t0:.1f} s (forwards, PPON "
          f"CLI and serving; graphs; f64; PAN CLI: "
          f"{', '.join(parts)} s) ({smi})")
    return traces


# ---------------------------------------------------------------------------
# phase 20: SFTGAN, pix2pix and CycleGAN at full width
# ---------------------------------------------------------------------------

SFT_JSON = os.path.join(OPTIONS_DIR, "train_sftgan.json")
I2I_DIR = os.path.join(os.path.dirname(OPTIONS_DIR), "i2i")
I2I_CELLS = ("sftgan", "pix2pix", "cyclegan")
I2I_N = 16            # images of each cell's train set (with seg maps)
I2I_GRAPH_STEPS = 3   # graphed against eager: a capture and two replays
I2I_FILES = {"sftgan": ("G", "D"), "pix2pix": ("G", "D"),
             "cyclegan": ("G_A", "G_B", "D_A", "D_B")}
I2I_SERVED = {"sftgan": "G", "pix2pix": "G", "cyclegan": "G_A"}
# one f32 SGD step against an f64 witness that replays each side's
# branches of every net and of the loss stack (_steps_card_cpu_f64 with
# branches="all"): each tensor of the card no further from its witness
# than I2I_F64_TOL times the CPU f32's largest distance in the same net,
# or I2I_F64_FLOOR of its move, or I2I_F64_ABS outright: two f32 ulps at
# 1, the size of a batch norm's scale, whose SGD move can be a few
# hundred ulps (the witness is read rounded once to f32, the card's
# update rounds once more)
I2I_F64_TOL = 2.0
I2I_F64_FLOOR = 1e-4
I2I_F64_ABS = 2.5e-7


def _i2i_data(root: str) -> dict:
    """The cells' data from seeds: A, the first ``I2I_N`` images of the
    corpus; B, a second 1/f corpus (seed 1); SFTGAN's (h, w, 8)
    probability maps of A's images as ``.npy`` files (seed 2); a
    validation set of ``N_VAL`` of A's images with their maps."""
    import shutil

    import numpy as np

    corpus = os.path.join(root, "corpus")
    names = sorted(os.listdir(corpus))[:I2I_N]
    out = {k: os.path.join(root, f"i2i_{k}")
           for k in ("A", "B", "seg", "val", "val_seg")}
    for d in out.values():
        os.makedirs(d, exist_ok=True)
    _write_corpus(out["B"], n=I2I_N, seed=1)
    rng = np.random.default_rng(2)
    for i, name in enumerate(names):
        shutil.copy(os.path.join(corpus, name), out["A"])
        p = rng.random((CORPUS_PX, CORPUS_PX, 8), dtype=np.float32)
        p /= p.sum(-1, keepdims=True)
        stem = os.path.splitext(name)[0]
        np.save(os.path.join(out["seg"], stem + ".npy"), p)
        if i < N_VAL:
            shutil.copy(os.path.join(corpus, name), out["val"])
            np.save(os.path.join(out["val_seg"], stem + ".npy"), p)
    return out


def _i2i_options(root: str, data: dict, cell: str,
                 niter: int = CLI_NITER) -> dict:
    """The cell's template as written (``options/sr/train_sftgan.json``,
    ``options/i2i/train_{cell}.yml``) with its data roots on ``data``
    (pix2pix's ``unaligned`` with ``serial_batches``), ``niter``, prints
    every 2, saves at the end (``CLI_SAVE_FREQ``), the i2i sample grids
    and SFTGAN's validation every ``CLI_FREQ``, and ``path.root`` under
    ``root``; the name without the template's ``debug`` prefix."""
    from trainner_tpu_torch.options.config import load_file

    if cell == "sftgan":
        opt = load_file(SFT_JSON)
        opt["datasets"]["train"].update(dataroot_HR=data["A"],
                                        dataroot_seg=data["seg"],
                                        n_workers=4)
        opt["datasets"]["val"].update(dataroot_HR=data["val"],
                                      dataroot_seg=data["val_seg"])
        opt["train"]["val_freq"] = CLI_FREQ
        logger = {}
    else:
        opt = read_options_yml(os.path.join(I2I_DIR, f"train_{cell}.yml"))
        opt["datasets"]["train"].update(dataroot_A=data["A"],
                                        dataroot_B=data["B"], n_workers=2)
        if cell == "pix2pix":
            opt["datasets"]["train"]["serial_batches"] = True
        logger = {"display_freq": CLI_FREQ}
    opt["name"] = f"{cell}_cell"
    opt["train"]["niter"] = niter
    opt["logger"] = {"print_freq": 2, "save_checkpoint_freq": CLI_SAVE_FREQ,
                     **logger}
    opt["path"] = {"root": os.path.join(root, f"cli_{cell}")}
    return opt


def _cell_tensors(state) -> dict:
    """The step and every net's state_dict and optimizer state, on the
    host."""
    out = {"step": state.step}
    for w, ns in _net_states(state):
        for k, v in ns.net.state_dict().items():
            out[f"{w}.{k}"] = v.detach().cpu().clone()
        for key, v in ns.opt.state_dict().items():
            if isinstance(v, int):
                out[f"{w}.{key}"] = v
            else:
                for i, t in enumerate(v):
                    out[f"{w}.{key}.{i}"] = t.detach().cpu().clone()
    return out


def _i2i_cli(smi: str, root: str, data: dict, cell: str) -> dict:
    """The training CLI on the cell's template at full width for
    ``SHORT_NITER`` iterations under a launch trace (no kernel of the repo
    may run), checkpoints at 6 (the cell's net files and ``.state``),
    SFTGAN's validation at 6, the i2i sample grids at 6
    (A | G(A) | B, 256 x 768); then a resume to ``SHORT_RESUME`` whose
    loaded state equals the saved one bit for bit. Prints the steady it/s
    (steps 3-6, the saves, validations and grids taken out) and returns
    the trace."""
    import torch

    from trainner_tpu_torch.data.common import read_png
    from trainner_tpu_torch.train import cli
    from trainner_tpu_torch.train.cyclegan_trainer import CycleGANTrainer
    from trainner_tpu_torch.train.pix2pix_trainer import Pix2PixTrainer
    from trainner_tpu_torch.train.sftgan_trainer import SFTGANTrainer
    from trainner_tpu_torch.utils import checkpoint

    opt = _i2i_options(root, data, cell, niter=SHORT_NITER)
    path = os.path.join(root, f"{cell}_cli.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    exp = os.path.join(opt["path"]["root"], "experiments", opt["name"])
    cls = {"sftgan": SFTGANTrainer, "pix2pix": Pix2PixTrainer,
           "cyclegan": CycleGANTrainer}[cell]
    rec = {"steps": [], "other": []}
    orig = (cls.train_step, checkpoint.save_checkpoint, cli.validate,
            cli.save_sample_grid, checkpoint.load_state)

    def train_step(self, state, batch):
        out = orig[0](self, state, batch)
        rec["steps"].append(time.perf_counter())
        return out

    def timed(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec["other"].append((t0, time.perf_counter() - t0))
            return out
        return run

    def load_state(p, state):
        state, meta = orig[4](p, state)
        rec["loaded"] = (meta, _cell_tensors(state))
        return state, meta

    cls.train_step = train_step
    checkpoint.save_checkpoint = timed(orig[1])
    cli.validate = timed(orig[2])
    cli.save_sample_grid = timed(orig[3])
    checkpoint.load_state = load_state
    try:
        t0 = time.perf_counter()
        with _launch_trace({}, label=f"{cell} cli") as trace:
            state = cli.main(["-opt", path])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = list(rec["steps"])
        saved = _cell_tensors(state)
        del state
        torch.cuda.empty_cache()
        opt["train"]["niter"] = SHORT_RESUME
        opt["path"]["resume_state"] = os.path.join(exp, "training_state")
        with open(path, "w") as f:
            json.dump(opt, f)
        t1 = time.perf_counter()
        state2 = cli.main(["-opt", path])
        wall2 = time.perf_counter() - t1
    finally:
        (cls.train_step, checkpoint.save_checkpoint, cli.validate,
         cli.save_sample_grid, checkpoint.load_state) = orig
    span = steps[-1] - steps[2]
    inside = sum(d for t, d in rec["other"] if steps[2] <= t < steps[-1])
    n = len(steps) - 3
    meta, loaded = rec["loaded"]
    diff = [k for k in saved if not (
        torch.equal(saved[k], loaded[k]) if isinstance(saved[k],
                                                       torch.Tensor)
        else saved[k] == loaded[k])]
    files = {os.path.relpath(os.path.join(d, f), exp)
             for d, _, fs in os.walk(exp) for f in fs}
    need = {f"models/{t}_{n_}.ckpt" for t in (SHORT_NITER, SHORT_RESUME)
            for n_ in I2I_FILES[cell]} | {
        f"training_state/{t}.state" for t in (SHORT_NITER,
                                              SHORT_RESUME)}
    grids = []
    if cell != "sftgan":
        need |= {f"samples/{t:08d}.png" for t in (CLI_FREQ, SHORT_NITER)}
        grids = [read_png(os.path.join(exp, "samples", f"{t:08d}.png")
                         ).shape for t in (CLI_FREQ, SHORT_NITER)]
    else:
        need |= {f"val_images/{os.path.splitext(v)[0]}/"
                 f"{os.path.splitext(v)[0]}_{SHORT_NITER}.png"
                 for v in os.listdir(data["val"])}
    rows = [json.loads(line) for line in
            open(os.path.join(exp, "tb", "scalars.jsonl"))]
    print(f"i2i: {cell} CLI ({opt['network_G']}, D {opt['network_D']}; "
          f"batch {opt['datasets']['train']['batch_size']}, crop "
          f"{opt['datasets']['train']['crop_size']}) {SHORT_NITER} iterations "
          f"in {wall:.1f} s (traced; the card ran {trace['ran']}), the "
          f"resume to {state2.step} in {wall2:.1f} s: {len(saved)} tensors "
          f"and counts of the saved state, {len(diff)} differ after "
          f"loading; {len(rows)} JSONL scalars; sample grids {grids}")
    print(f"times: {cell} CLI steps 3-{SHORT_NITER} on the host clock: "
          f"{n / (span - inside):.4f} it/s steady, {n / span:.4f} it/s "
          f"with the saves, validations and grids ({smi})")
    if diff or meta["iter"] != SHORT_NITER or state2.step != \
            SHORT_RESUME or need - files or any(
                g != (256, 768, 3) for g in grids) or not all(
                    math.isfinite(r["value"]) for r in rows):
        raise AssertionError(f"i2i {cell} cli: differs {diff[:4]}, missing "
                             f"{sorted(need - files)[:4]}, grids {grids}")
    del state2
    torch.cuda.empty_cache()
    return trace


def _i2i_serve(smi: str, root: str, data: dict, cell: str) -> None:
    """The test CLI on the cell's G of ``SHORT_RESUME``: SFTGAN with a
    ``seg`` dataset's maps (PSNR against the HR), pix2pix's G and
    CycleGAN's G_A from a ``single`` dataset; one PNG per image."""
    from trainner_tpu_torch import test as test_cli

    opt = _i2i_options(root, data, cell)
    exp = os.path.join(opt["path"]["root"], "experiments", opt["name"])
    ds = {"name": "val", "mode": "LRHRseg_bg", "dataroot_HR": data["val"],
          "dataroot_seg": data["val_seg"]} if cell == "sftgan" else {
        "name": "val", "mode": "single", "dataroot_LR": data["val"]}
    serve = {"name": f"serve_{cell}", "model": cell,
             "scale": opt.get("scale", 1), "datasets": {"test_1": ds},
             "network_G": opt["network_G"],
             "path": {"root": os.path.join(root, f"serve_{cell}"),
                      "pretrain_model_G": os.path.join(
                          exp, "models", f"{SHORT_RESUME}_"
                          f"{I2I_SERVED[cell]}.ckpt")}}
    path = os.path.join(root, f"serve_{cell}.json")
    with open(path, "w") as f:
        json.dump(serve, f)
    t0 = time.perf_counter()
    with _launch_trace({}, label=f"{cell} serve"):
        averages = test_cli.main(["-opt", path])
    wall = time.perf_counter() - t0
    pngs = [f for _, _, fs in os.walk(os.path.join(root, f"serve_{cell}"))
            for f in fs if f.endswith(".png")]
    psnr = [m["average"] for m in averages.get("val", [])
            if m["name"] == "psnr"]
    print(f"i2i: {cell} served by the test CLI from {SHORT_RESUME}_"
          f"{I2I_SERVED[cell]}.ckpt: {len(pngs)} images of {CORPUS_PX} px "
          f"in {wall:.2f} s (set-up included); PSNR {psnr} ({smi})")
    if len(pngs) != N_VAL or (cell == "sftgan" and not (
            psnr and math.isfinite(psnr[0]))):
        raise AssertionError(f"i2i {cell} serving: {pngs}, {psnr}")


def _i2i_batch(cell: str, seed: int) -> dict:
    """One batch of the cell's shape on the card, from a seed: SFTGAN's
    b=16 (LR 24, HR and maps 96 px), the i2i b=1 A and B of 256 px in
    [-1, 1]."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    if cell == "sftgan":
        seg = torch.rand(16, 96, 96, 8, generator=gen, device="cuda")
        return {"LR": torch.rand(16, 24, 24, 3, generator=gen,
                                 device="cuda"),
                "HR": torch.rand(16, 96, 96, 3, generator=gen,
                                 device="cuda"),
                "seg": seg / seg.sum(-1, keepdim=True)}
    return {k: torch.rand(1, 256, 256, 3, generator=gen, device="cuda")
            * 2 - 1 for k in ("A", "B")}


def _i2i_graphed_vs_eager(smi: str, root: str, data: dict,
                          cell: str) -> None:
    """The cell's step at full width (its template, bf16): graphed (the
    default) against eager from the same state and the same dropout
    generator state, step by step, bit for bit under deterministic
    cuDNN, ``I2I_GRAPH_STEPS`` steps (pix2pix's dropout masks and
    CycleGAN's pool swaps included: its pools must hold the same images);
    the step's ms each way."""
    import torch

    from trainner_tpu_torch.options.config import parse_dict
    from trainner_tpu_torch.train.sr_trainer import create_trainer

    opt = parse_dict(_i2i_options(root, data, cell), is_train=True)
    trainers = {"graphed": create_trainer(opt),
                "eager": create_trainer(opt, graphs=False)}
    states = {k: t.init_state(0) for k, t in trainers.items()}
    twin = _GroupTwin(cell, opt)
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    unequal, ms = [], {"graphed": [], "eager": []}
    try:
        for i in range(I2I_GRAPH_STEPS):
            batch = _i2i_batch(cell, 60 + i)
            _load_from(states["eager"], states["graphed"])
            states["eager"].noise_generator.set_state(
                states["graphed"].noise_generator.get_state())
            logs = {}
            for k in ("graphed", "eager"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logs[k] = trainers[k].train_step(states[k], batch)[1]
                torch.cuda.synchronize()
                ms[k].append((time.perf_counter() - t0) * 1e3)
            after = {k: _net_tensors(states[k]) for k in states}
            unequal += [(i, k) for k, v in after["graphed"].items()
                        if not torch.equal(v, after["eager"][k])]
            unequal += [(i, k) for k, v in logs["graphed"].items()
                        if not torch.equal(v, logs["eager"][k])]
            if cell == "cyclegan":
                for pool in ("fake_a_pool", "fake_b_pool"):
                    a, b = (getattr(trainers[k], pool) for k in trainers)
                    if a.count != b.count or not torch.equal(
                            a.images[:a.count], b.images[:b.count]):
                        unequal.append((i, pool))
            twin.step(batch, trainers["graphed"], states["graphed"],
                      logs["graphed"], ms["graphed"][-1])
        twin.finish(batch)
    finally:
        twin.close()
        cudnn.deterministic, cudnn.benchmark = saved
    graphs = trainers["graphed"].step_graphs()
    want = 2 if cell == "cyclegan" else 1
    rep = sorted(ms["graphed"][1:])[len(ms["graphed"][1:]) // 2]
    eag = sorted(ms["eager"][1:])[len(ms["eager"][1:]) // 2]
    print(f"i2i: {cell} {I2I_GRAPH_STEPS} steps at full width (bf16), "
          f"graphed ({len(graphs)} programs) against eager: {len(unequal)}"
          f" tensors or logs differ")
    print(f"times: {cell} train_step bf16, ms per step (first: eager + "
          f"capture; then replays), graphed "
          f"{[round(v, 3) for v in ms['graphed']]}, eager "
          f"{[round(v, 3) for v in ms['eager']]}; median after the first "
          f"graphed {rep:.3f}, eager {eag:.3f} ({smi})")
    if unequal or len(graphs) != want:
        raise AssertionError(f"i2i {cell} graphs: {unequal[:6]}, "
                             f"{list(graphs)}")
    del trainers, states
    torch.cuda.empty_cache()


def _i2i_f64_options(cell: str) -> dict:
    """The cell's step at full width and cut depth for the f64 witness on
    the CPU, f32, SGD at lr 1e-2: SFTGAN with 2 SFT blocks (of 16), b=2,
    96 px, the template's losses (VGG19 feature L1, vanilla GAN 5e-3);
    pix2pix's U-Net with 6 levels (of 8) without dropout, b=2, 64 px
    (of 256); CycleGAN's ResNet G with 2 blocks (of 9), b=1, 64 px."""
    from trainner_tpu_torch.options.config import parse_dict

    train = {"lr_G": 1e-2, "lr_D": 1e-2, "optim_G": "sgd",
             "optim_D": "sgd", "lr_scheme": "MultiStepLR", "lr_steps": [50]}
    if cell == "sftgan":
        opt = {"model": "sftgan", "scale": 4,
               "network_G": {"type": "sft_arch", "n_blocks": 2},
               "network_D": {"type": "dis_acd"},
               "train": {**train, "pixel_weight": 0,
                         "pixel_criterion": "l1", "feature_weight": 1,
                         "feature_criterion": "l1", "gan_type": "vanilla",
                         "gan_weight": 5e-3}}
    elif cell == "pix2pix":
        opt = {"model": "pix2pix", "scale": 1,
               "network_G": {"type": "unet_net", "num_downs": 6},
               "network_D": {"type": "patchgan", "ndf": 64,
                             "n_layers": 3},
               "train": {**train, "pixel_criterion": "l1",
                         "pixel_weight": 100.0, "gan_type": "vanilla",
                         "gan_weight": 1.0}}
    else:
        opt = {"model": "cyclegan", "scale": 1,
               "network_G": {"type": "resnet_net", "n_blocks": 2},
               "network_D": {"type": "patchgan", "ndf": 64, "n_layers": 3,
                             "norm_type": "instance"},
               "train": {**train, "gan_type": "lsgan", "gan_weight": 1.0,
                         "lambda_A": 10.0, "lambda_B": 10.0,
                         "lambda_identity": 0.5}}
    opt.update(name=f"{cell}_f64", path={"root": "/nonexistent"})
    return dict(parse_dict(opt, is_train=True))


def _i2i_f64(smi: str, cell: str) -> None:
    """One f32 SGD step of the cut cell (``_i2i_f64_options``) on the card
    (graphed), the CPU and an f64 witness of each side that replays that
    side's branches of every net and of the loss stack
    (``_steps_card_cpu_f64``, ``branches="all"``; no kernel hides a ReLU
    in these nets): logs within 1e-4 relative, card against CPU; each
    tensor of the card no further from its witness than ``I2I_F64_TOL``
    times the CPU f32's largest distance in the same net, or
    ``I2I_F64_FLOOR`` of its move, or ``I2I_F64_ABS`` outright."""
    import torch

    opt = _i2i_f64_options(cell)
    gen = torch.Generator().manual_seed(9)
    if cell == "sftgan":
        def batch():
            seg = torch.rand(2, 96, 96, 8, generator=gen)
            return {"LR": torch.rand(2, 24, 24, 3, generator=gen),
                    "HR": torch.rand(2, 96, 96, 3, generator=gen),
                    "seg": seg / seg.sum(-1, keepdim=True)}
    else:
        b = 2 if cell == "pix2pix" else 1

        def batch():
            return {k: torch.rand(b, 64, 64, 3, generator=gen) * 2 - 1
                    for k in ("A", "B")}
    r = _steps_card_cpu_f64(cell, opt, [batch()],
                            graphs=2 if cell == "cyclegan" else 1,
                            branches="all", lr=1e-2)
    bad = []
    for net in sorted({k.split(".")[0] for k in r["card_f64"]}):
        cc, f64, cpu = (_worst(r[key], net + ".") for key in
                        ("card_cpu", "card_f64", "cpu_f64"))
        tol = max(I2I_F64_TOL * cpu[0], I2I_F64_FLOOR)
        print(f"i2i: {cell} one f32 SGD step (cut: {opt['network_G']}), "
              f"{net}'s tensors as a share of their move: card vs CPU up "
              f"to {cc[0]:.3e} ({cc[1]}); against each side's f64 witness:"
              f" card {f64[0]:.3e} ({f64[1]}, "
              f"{r['abs_card'].get(f64[1], 0):.2e} absolute; tol "
              f"{tol:.3e}), CPU f32 "
              f"{cpu[0]:.3e} ({cpu[1]}) ({smi})")
        bad += [(k, v, tol, r["abs_card"].get(k))
                for k, v in r["card_f64"].items()
                if k.startswith(net + ".") and not v <= tol
                and not r["abs_card"].get(k, 1.0) <= I2I_F64_ABS]
    print(f"i2i: {cell} logs card vs CPU within {r['logs']:.3e} relative "
          f"(tol 1e-4) by step {['%.2e' % v for v in r['logs_by_step']]}; "
          f"branches that differ, card against CPU, by step {r['flips']} "
          f"of {r['records']} records")
    if bad or not r["logs"] <= 1e-4:
        raise AssertionError(f"i2i {cell} f64: {bad[:6]}, logs {r['logs']}")
    torch.cuda.empty_cache()


def _i2i_discriminators(smi: str) -> None:
    """The multiscale (3 PatchGANs, ndf 64, batch norm) and pixel (ndf 64)
    discriminators' forward and backward, f32, card against CPU on one
    batch (b=2, 256 px; TF32 off, deterministic cuDNN), the card replaying
    the CPU's branches (``_Branches``): outputs within 1e-5 and input and
    parameter gradients within 1e-4 of their sizes."""
    import torch

    from trainner_tpu_torch.models.discriminators import (
        MultiscaleDiscriminator, PixelDiscriminator)

    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        for name, make in (("multiscale", lambda: MultiscaleDiscriminator(
                ndf=64, n_layers=3, num_D=3)),
                           ("pixelgan", lambda: PixelDiscriminator(ndf=64))):
            net = make()
            net.init_weights(torch.Generator().manual_seed(3))
            card = make().cuda()
            card.load_state_dict(net.state_dict())
            x = torch.rand(2, 256, 256, 3, generator=torch.Generator(
            ).manual_seed(5)) * 2 - 1
            got = {}
            for side, model, rec in (("cpu", net, _Branches()),
                                     ("card", card, None)):
                rec = rec if rec is not None else _Branches(
                    got["cpu"]["records"])
                xs = x.detach().to(next(model.parameters()).device
                                   ).requires_grad_()
                with rec:
                    outs = model(xs, train=True)
                outs = outs if isinstance(outs, list) else [outs]
                gen = torch.Generator().manual_seed(6)
                loss = sum((o * torch.randn(o.shape, generator=gen).to(
                    o.device)).sum() for o in outs)
                loss.backward()
                got[side] = {"outs": [o.detach().cpu() for o in outs],
                             "dx": xs.grad.cpu(), "records": rec.records,
                             "grads": {k: p.grad.cpu() for k, p in
                                       model.named_parameters()}}
            def rel(a, b):
                return float((a - b).abs().max() / b.abs().max())
            out_err = max(rel(a, b) for a, b in zip(got["card"]["outs"],
                                                     got["cpu"]["outs"]))
            dx_err = rel(got["card"]["dx"], got["cpu"]["dx"])
            g_err = max((rel(got["card"]["grads"][k], v), k)
                        for k, v in got["cpu"]["grads"].items()
                        if v.abs().max() > 0)
            print(f"i2i: {name} D forward and backward, f32, card against "
                  f"CPU (b=2, 256 px, {len(got['cpu']['outs'])} outputs, "
                  f"the CPU's {len(got['cpu']['records'])} branch records "
                  f"replayed): outputs {out_err:.3e} (tol 1e-5), input "
                  f"gradient {dx_err:.3e}, parameter gradients up to "
                  f"{g_err[0]:.3e} ({g_err[1]}; tol 1e-4) of their sizes "
                  f"({smi})")
            if not (out_err <= 1e-5 and dx_err <= 1e-4 and
                    g_err[0] <= 1e-4):
                raise AssertionError(f"i2i {name} D card vs CPU")
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    torch.cuda.empty_cache()


def phase_i2i(smi: str, root: str) -> dict:
    """Phase 20: SFTGAN (``options/sr/train_sftgan.json``: SFTNet nf 64, 16
    blocks; the ACD D; b=16, crop 96; VGG19 feature L1 and GAN 5e-3; Adam,
    MultiStepLR; bf16), pix2pix (``options/i2i/train_pix2pix.yml`` with
    ``serial_batches``: the U-Net, 8 levels, ngf 64, batch norm, dropout;
    PatchGAN ndf 64; b=1, crop 256; L1 x 100 and the conditional GAN) and
    CycleGAN (``options/i2i/train_cyclegan.yml``: the ResNet G, 9 blocks,
    ngf 64, instance norm; PatchGAN with instance norm; b=1, crop 256;
    lsgan; pools of 50) on seeded data (``_i2i_data``). For each: the
    training CLI (6 and a resume to 8, the sample grids), the test CLI,
    graphed against eager bit for bit, the f64 witness at cut depth; then
    the multiscale and pixel Ds card against CPU (the Gs' serving rates,
    measurement alone, went in the time cut of phase 23's slice). No
    kernel of the repo runs here. Returns the CLI traces."""
    import torch

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    data = _i2i_data(root)
    traces, parts = {}, []
    for cell in I2I_CELLS:
        t1 = time.perf_counter()
        traces[f"{cell} cli"] = _i2i_cli(smi, root, data, cell)
        _i2i_serve(smi, root, data, cell)
        _i2i_graphed_vs_eager(smi, root, data, cell)
        _i2i_f64(smi, cell)
        parts.append(f"{time.perf_counter() - t1:.1f}")
    for part in (lambda: _i2i_discriminators(smi),):
        t1 = time.perf_counter()
        part()
        parts.append(f"{time.perf_counter() - t1:.1f}")
    print(f"i2i: ok in {time.perf_counter() - t0:.1f} s (sftgan, pix2pix, "
          f"cyclegan: CLI, serving, graphs, f64 each; Ds: "
          f"{', '.join(parts)} s) ({smi})")
    return traces


VIDEO_DIR = os.path.join(os.path.dirname(OPTIONS_DIR), "video")
VSR_TRAIN_YML = os.path.join(VIDEO_DIR, "train_video.yml")
VSR_TEST_YML = os.path.join(VIDEO_DIR, "test_video.yml")
VSR_VIDEOS, VSR_FRAMES, VSR_PX = 4, 8, 256  # training folders of frames
VSR_VAL_FRAMES = 4        # the validation clip: 2 windows of 3
VSR_SERVE_FRAMES = 4      # the served clip: 2 windows of 3
VSR_SERVE_HW = (576, 720)  # its frames; the test CLI serves them at 1/4,
#                            144 x 180 (Vid4 calendar's LR)
VSR_GRAPH_STEPS = 3
VSR_PER_G = NB * 3        # the RRDB tail's block launches per G pass
# the f64 witness's cut: SOF-VSR channels 32 with its RRDB tail at its
# real block widths (nf 64, gc 32) and nb 2; b=2, 16 -> 64 px; SGD
VSR_F64_G = {"channels": 32, "sr_nb": 2}
VSR_F64_SHAPE = (2, 3, 16, 16, 3)
# the RRDB tail's LR shapes: a served window (144 x 180) and one of its chop
# quadrants (each half plus 8 px: 80 x 98)
VSR_SERVE_LR = (VSR_SERVE_HW[0] // 4, VSR_SERVE_HW[1] // 4)
VSR_QUAD_LR = (VSR_SERVE_LR[0] // 2 + 8, VSR_SERVE_LR[1] // 2 + 8)


def _vsr_frames(out: str, n: int, hw: tuple, seed: int) -> None:
    """``n`` frames of ``hw``: one 1/f^1.2 RGB field from a seed, each
    frame a window of it 2 px right and 1 px down of the last, written as
    PNGs by the port's own writer."""
    import numpy as np

    from trainner_tpu_torch.data import save_img

    h, w = hw
    rng = np.random.default_rng(seed)
    H, W = h + 2 * n, w + 2 * n
    fy, fx = np.fft.fftfreq(H)[:, None], np.fft.fftfreq(W)[None, :]
    radius = np.hypot(fy, fx)
    radius[0, 0] = 1.0
    field = np.real(np.fft.ifft2(np.fft.fft2(rng.standard_normal(
        (3, H, W))) / radius ** 1.2))
    field = field + 0.6 * field.mean(0, keepdims=True)
    field = (field - field.mean()) / field.std() * 0.18 + 0.5
    u8 = (np.clip(field, 0, 1) * 255).round().astype(np.uint8)
    os.makedirs(out, exist_ok=True)
    for i in range(n):
        save_img(np.ascontiguousarray(
            u8[:, i:i + h, 2 * i:2 * i + w].transpose(1, 2, 0)),
                 os.path.join(out, f"{i:03d}.png"))


def _vsr_data(root: str) -> dict:
    """The training folders (``VSR_VIDEOS`` x ``VSR_FRAMES`` frames of
    ``VSR_PX``²), the validation clip and the clip to serve."""
    out = {k: os.path.join(root, "vsr", k) for k in ("train", "val",
                                                     "serve")}
    for v in range(VSR_VIDEOS):
        _vsr_frames(os.path.join(out["train"], f"video{v}"), VSR_FRAMES,
                    (VSR_PX, VSR_PX), seed=10 + v)
    _vsr_frames(out["val"], VSR_VAL_FRAMES, (VSR_PX, VSR_PX), seed=20)
    _vsr_frames(out["serve"], VSR_SERVE_FRAMES, VSR_SERVE_HW, seed=21)
    return out


def _vsr_options(root: str, data: dict, niter: int = CLI_NITER) -> dict:
    """``train_video.yml`` as written (SOF-VSR channels 320, the RRDB tail
    nf 64 / nb 23, b 8, crop 128, 3 frames, frame skips and reversal, cb
    pixel loss, the OFR term, Adam, cosine restarts) with its data roots
    on ``data``, ``niter``, prints every 2, saves at the end
    (``CLI_SAVE_FREQ``), validation every ``CLI_FREQ``, ``path.root`` under
    ``root``."""
    opt = read_options_yml(VSR_TRAIN_YML)
    opt["datasets"]["train"].update(dataroot_HR=data["train"], n_workers=4)
    opt["datasets"]["val"]["dataroot_HR"] = data["val"]
    opt["train"].update(niter=niter, val_freq=CLI_FREQ)
    opt["logger"] = {"print_freq": 2, "save_checkpoint_freq": CLI_SAVE_FREQ}
    opt["path"] = {"root": os.path.join(root, "cli_vsr")}
    return opt


def _vsr_cli(smi: str, root: str, data: dict, label: str = "vsr",
             edit=None, resume_edit=None) -> dict:
    """The training CLI on ``train_video.yml`` at full width for
    ``SHORT_NITER`` iterations under a launch trace (``_retried_trace``):
    the card must run 69 block forwards and 69 backwards in each step
    (between markers around it, ``_check_cli_trace``) and 69 forwards per
    validation window (at ``CLI_FREQ`` and ``SHORT_NITER``); checkpoints
    at ``SHORT_NITER``; then a resume to ``SHORT_RESUME`` (69 + 69 per
    step, traced too) whose loaded state equals the saved one bit for bit.
    ``edit`` and ``resume_edit`` edit the options of each run (phase 25
    adds ``parallel:`` to the first); ``label`` names the run. Prints the
    steady it/s and returns both traces."""
    import torch

    from trainner_tpu_torch.train import cli
    from trainner_tpu_torch.train.vsr_trainer import VSRTrainer
    from trainner_tpu_torch.utils import checkpoint

    opt = _vsr_options(root, data, niter=SHORT_NITER)
    tag = label.replace(" ", "_")
    if edit is not None:
        edit(opt)
    parallel = opt.get("parallel")
    path = os.path.join(root, f"{tag}_cli.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    exp = os.path.join(opt["path"]["root"], "experiments", opt["name"])
    windows = VSR_VAL_FRAMES - 2
    rec = {"steps": [], "other": []}
    orig = (VSRTrainer.train_step, checkpoint.save_checkpoint, cli.validate,
            checkpoint.load_state)

    def train_step(self, state, batch):
        step = state.step
        _mark()
        out = orig[0](self, state, batch)
        _mark()
        rec["steps"].append(time.perf_counter())
        rec["numbers"].append((step + 1, None))
        return out

    def timed(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec["other"].append((t0, time.perf_counter() - t0))
            return out
        return run

    def load_state(p, state):
        state, meta = orig[3](p, state)
        rec["loaded"] = (meta, _cell_tensors(state))
        return state, meta

    def main():
        rec["steps"].clear()
        rec["other"].clear()
        rec["numbers"] = []
        return cli.main(["-opt", path])

    n_val = SHORT_NITER // CLI_FREQ * windows
    want = {"rdb5c": VSR_PER_G * (SHORT_NITER + n_val),
            "rdb5c_bwd": VSR_PER_G * SHORT_NITER, "blur": 0}
    resumed = SHORT_RESUME - SHORT_NITER
    want2 = {"rdb5c": VSR_PER_G * resumed, "rdb5c_bwd": VSR_PER_G * resumed,
             "blur": 0}
    VSRTrainer.train_step = train_step
    checkpoint.save_checkpoint = timed(orig[1])
    cli.validate = timed(orig[2])
    checkpoint.load_state = load_state
    try:
        t0 = time.perf_counter()
        trace, state = _retried_trace(main, want, label=f"{label} cli")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _check_cli_trace(f"{label} cli", trace, want, rec["numbers"],
                         range(1, SHORT_NITER + 1), VSR_PER_G, 0)
        steps = list(rec["steps"])
        other = list(rec["other"])
        saved = _cell_tensors(state)
        del state
        torch.cuda.empty_cache()
        opt["train"]["niter"] = SHORT_RESUME
        opt["path"]["resume_state"] = _resume_state(exp, SHORT_NITER)
        if resume_edit is not None:
            resume_edit(opt)
        with open(path, "w") as f:
            json.dump(opt, f)
        t1 = time.perf_counter()
        trace2, state2 = _retried_trace(main, want2,
                                        label=f"{label} resume")
        wall2 = time.perf_counter() - t1
    finally:
        (VSRTrainer.train_step, checkpoint.save_checkpoint, cli.validate,
         checkpoint.load_state) = orig
    span = steps[-1] - steps[2]
    inside = sum(d for t, d in other if steps[2] <= t < steps[-1])
    n = len(steps) - 3
    meta, loaded = rec["loaded"]
    diff = [k for k in saved if not (
        torch.equal(saved[k], loaded[k]) if isinstance(saved[k],
                                                       torch.Tensor)
        else saved[k] == loaded[k])]
    files = {os.path.relpath(os.path.join(d, f), exp)
             for d, _, fs in os.walk(exp) for f in fs}
    need = {f"models/{t}_G.ckpt" for t in (SHORT_NITER, SHORT_RESUME)} | {
        f"training_state/{t}.state" for t in (SHORT_NITER, SHORT_RESUME)}
    need |= {f"val_images/001/001_{t}.png" for t in (CLI_FREQ, SHORT_NITER)}
    rows = [json.loads(line) for line in
            open(os.path.join(exp, "tb", "scalars.jsonl"))]
    ofr = [r["value"] for r in rows if r.get("tag") == "train/ofr"]
    print(f"{label}: training CLI on train_video.yml ({opt['network_G']}; "
          f"parallel {parallel}, the resume without; batch "
          f"{opt['datasets']['train']['batch_size']}, crop "
          f"{opt['datasets']['train']['crop_size']}, 3 frames) {SHORT_NITER} "
          f"iterations in {wall:.1f} s (traced, {trace['records']} "
          f"device records; the card ran {trace['ran']}: "
          f"{VSR_PER_G} + {VSR_PER_G} per step, {VSR_PER_G} per validation "
          f"window x {n_val}); the resume to {state2.step} in {wall2:.1f} s "
          f"(the card ran {trace2['ran']}): {len(saved)} tensors and counts "
          f"of the saved state, {len(diff)} differ after loading; "
          f"{len(rows)} JSONL scalars, ofr logged {len(ofr)} times")
    print(f"times: {label} CLI steps 3-{SHORT_NITER} on the host clock: "
          f"{n / (span - inside):.4f} it/s steady, {n / span:.4f} it/s "
          f"with the saves and validations ({smi})")
    if diff or meta["iter"] != SHORT_NITER or state2.step != \
            SHORT_RESUME or need - files or not ofr or not all(
                math.isfinite(r["value"]) for r in rows):
        raise AssertionError(f"{label} cli: differs {diff[:4]}, missing "
                             f"{sorted(need - files)[:4]}, ofr {ofr}")
    del state2
    torch.cuda.empty_cache()
    return {f"{label} cli": trace, f"{label} resume": trace2}


def _vsr_batch(seed: int, shape=(8, 3, 32, 32, 3), scale: int = 4) -> dict:
    """A clip batch from a seed: HR frames of a 1/f-like field moved by a
    pixel per frame, LR their 4x box averages."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    b, t, h, w, c = shape
    H, W = h * scale, w * scale
    base = torch.rand(b, c, H // 8 + 2, W // 8 + 2, generator=gen)
    base = torch.nn.functional.interpolate(base, size=(H + 2 * t, W + 2 * t),
                                           mode="bicubic",
                                           align_corners=False)
    base = base + 0.1 * torch.rand(base.shape, generator=gen)
    hr = torch.stack([base[:, :, i:i + H, 2 * i:2 * i + W]
                      for i in range(t)], 1).permute(0, 1, 3, 4, 2)
    hr = hr.clamp(0, 1).contiguous()
    lr = hr.reshape(b, t, h, scale, w, scale, c).mean((3, 5))
    return {"LR": lr, "HR": hr}


def _graphed_vs_eager(opt: dict, batches, name: str = "",
                      per=None) -> tuple:
    """``opt``'s step graphed against eager from one state (seed 0) and
    one noise generator state, a step per batch (on the card), under
    deterministic cuDNN. Returns the (step, tensor or log) pairs that
    differ, the ms of each step each way, and the trainers and states.
    While ``P25_GROUP`` is on, a model of ``P25_MODELS`` (``name``;
    ``per`` its block launches per step) also runs graphed on a one-rank
    group (``_GroupTwin``, phase 25 (a))."""
    import torch

    from trainner_tpu_torch.train.sr_trainer import create_trainer

    trainers = {"graphed": create_trainer(opt),
                "eager": create_trainer(opt, graphs=False)}
    states = {k: t.init_state(0) for k, t in trainers.items()}
    twin = _GroupTwin(name, opt, per)
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    unequal, ms = [], {"graphed": [], "eager": []}
    try:
        for i, batch in enumerate(batches):
            _load_from(states["eager"], states["graphed"])
            states["eager"].noise_generator.set_state(
                states["graphed"].noise_generator.get_state())
            logs = {}
            for k in ("graphed", "eager"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logs[k] = trainers[k].train_step(states[k], batch)[1]
                torch.cuda.synchronize()
                ms[k].append((time.perf_counter() - t0) * 1e3)
            after = {k: _net_tensors(states[k]) for k in states}
            unequal += [(i, k) for k, v in after["graphed"].items()
                        if not torch.equal(v, after["eager"][k])]
            unequal += [(i, k) for k, v in logs["graphed"].items()
                        if not torch.equal(v, logs["eager"][k])]
            twin.step(batch, trainers["graphed"], states["graphed"],
                      logs["graphed"], ms["graphed"][-1])
        twin.finish(batches[-1])
    finally:
        twin.close()
        cudnn.deterministic, cudnn.benchmark = saved
    return unequal, ms, trainers, states


def _vsr_graphed_vs_eager(smi: str, root: str, data: dict) -> dict:
    """The template's step at full width (bf16, b=8, 32 -> 128 px, the
    latent noise on): graphed against eager from the same state and noise
    generator state, ``VSR_GRAPH_STEPS`` steps, bit for bit under
    deterministic cuDNN; the step's ms each way."""
    import torch

    from trainner_tpu_torch.options.config import parse_dict

    opt = parse_dict(_vsr_options(root, data), is_train=True)
    unequal, ms, trainers, states = _graphed_vs_eager(opt, [
        {k: v.cuda() for k, v in _vsr_batch(70 + i).items()}
        for i in range(VSR_GRAPH_STEPS)], "sofvsr", (VSR_PER_G, VSR_PER_G))
    graphs = trainers["graphed"].step_graphs()
    rep = sorted(ms["graphed"][1:])[len(ms["graphed"][1:]) // 2]
    eag = sorted(ms["eager"][1:])[len(ms["eager"][1:]) // 2]
    print(f"vsr: {VSR_GRAPH_STEPS} SOF-VSR steps at full width (bf16, b=8, "
          f"32 -> 128 px), graphed ({len(graphs)} program, "
          f"{list(graphs.values())[0].launches} kernel launches recorded) "
          f"against eager: {len(unequal)} tensors or logs differ")
    print(f"times: vsr train_step bf16, ms per step (first: eager + "
          f"capture; then replays), graphed "
          f"{[round(v, 3) for v in ms['graphed']]}, eager "
          f"{[round(v, 3) for v in ms['eager']]}; median after the first "
          f"graphed {rep:.3f}, eager {eag:.3f} ({smi})")
    if unequal or len(graphs) != 1:
        raise AssertionError(f"vsr graphs: {unequal[:6]}, {list(graphs)}")
    del trainers, states
    torch.cuda.empty_cache()
    return {"graphed": rep, "eager": eag}


@contextlib.contextmanager
def _quiet_sofvsr():
    """``sofvsr_net`` built with the RRDB tail's latent noise off (its
    streams cannot match between two runs, C 9) inside the body."""
    from trainner_tpu_torch.models import networks
    from trainner_tpu_torch.models.sofvsr import SOFVSR

    build = networks._G_REGISTRY["sofvsr_net"]

    def quiet(cfg, dtype):
        net = build(cfg, dtype)
        return SOFVSR(scale=net.scale, n_frames=net.n_frames,
                      channels=cfg["channels"], img_ch=cfg["img_ch"],
                      sr_net="rrdb", sr_nf=cfg["sr_nf"],
                      sr_nb=cfg["sr_nb"], sr_gaussian_noise=False,
                      dtype=dtype)

    networks._G_REGISTRY["sofvsr_net"] = quiet
    try:
        yield
    finally:
        networks._G_REGISTRY["sofvsr_net"] = build


def _vsr_kernels_vs_plain(smi: str, root: str, data: dict) -> None:
    """The block kernels against their plain versions at the shapes that
    SOF-VSR gives them, TF32 off: each block alone (``_compare_block``, the
    kernel phase's tolerances) at the training shape (b=8, LR 32 x 32;
    forward and backward) and at a served window and a chop quadrant (b=1,
    ``VSR_SERVE_LR`` and ``VSR_QUAD_LR``; forward), f32 and bf16; the
    template's whole G forward at those two shapes on the kernels against
    the same G on the plain versions, within phase 12's full-G tolerances
    (1e-5 of the output's size in f32, 3e-2 in bf16); and the f32 G
    gradient of one template step (b=8, 32 -> 128 px, the pixel and OFR
    terms, latent noise off), each tensor within 3e-3 of its own largest
    gradient, as phase 12's. Eager calls: the wrappers' counts are the
    launches (69 per pass on the kernels, none on the plain versions)."""
    import torch

    from trainner_tpu_torch.models import define_G
    from trainner_tpu_torch.options.config import parse_dict
    from trainner_tpu_torch.options.defaults import get_network_G_config
    from trainner_tpu_torch.train.sr_trainer import create_trainer

    gen = torch.Generator().manual_seed(21)
    ws, bs = _block_weights(gen)
    bs = [b.cuda() for b in bs]
    for shape, backward in (((8, 32, 32), True), ((1,) + VSR_SERVE_LR, False),
                            ((1,) + VSR_QUAD_LR, False)):
        x = (torch.randn(*shape, NF, generator=gen) * 0.5).cuda()
        g_out = (torch.randn(*shape, NF, generator=gen).cuda() if backward
                 else None)
        for dt in (torch.float32, torch.bfloat16):
            _compare_block(shape, dt, x, g_out, ws, bs, "vsr: ")

    opt = _vsr_options(root, data)
    spec = get_network_G_config(dict(opt["network_G"]), 4)
    clips = {hw: torch.rand(1, 3, *hw, 3, generator=gen).cuda()
             for hw in (VSR_SERVE_LR, VSR_QUAD_LR)}
    for dt, rel_tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        net = define_G({"network_G": spec}, dt)
        net.init_weights(torch.Generator().manual_seed(2))
        _gain_weights(net, seed=1)
        net = net.cuda().eval()
        for hw, x in clips.items():
            before = _counted()["rdb5c"]
            with torch.inference_mode():
                got = net(x)[3]
                ran = _counted()["rdb5c"] - before
                with _plain_blocks():
                    ref = net(x)[3]
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            print(f"vsr: full SOF-VSR {dt} at b=1, LR {hw[0]} x {hw[1]}: "
                  f"kernel vs plain max_abs_err {err:.3e} on max|ref| "
                  f"{scale:.3e}, tol {rel_tol * scale:.3e}; block launches "
                  f"{ran} on the kernels, "
                  f"{_counted()['rdb5c'] - before - ran} on the plain "
                  "versions")
            if got.shape != (1, 4 * hw[0], 4 * hw[1], 3) or not (
                    err <= rel_tol * scale) or ran != VSR_PER_G or \
                    _counted()["rdb5c"] - before != ran:
                raise AssertionError(f"vsr G {dt} {hw}: {got.shape}, {err}"
                                     f", {ran} launches")
        del net
        torch.cuda.empty_cache()

    opt["use_amp"] = False
    with _quiet_sofvsr():
        trainer = create_trainer(parse_dict(opt, is_train=True),
                                 graphs=False)
        state = trainer.init_state(2)
    _gain_weights(state.g.net, seed=3)
    batch = {k: v.cuda() for k, v in _vsr_batch(90).items()}

    def grads():
        # a G update at learning rate 0: the gradients stay on .grad
        trainer._vsr_step(state, batch, 0.0, 0.0)
        torch.cuda.synchronize()
        return {k: p.grad.clone() for k, p in
                state.g.net.named_parameters() if p.grad is not None}

    before = _counted()["rdb5c_bwd"]
    got = grads()
    ran = _counted()["rdb5c_bwd"] - before
    with _plain_blocks():
        ref = grads()
    worst, worst_name, top = 0.0, "", 0.0
    for k, r in ref.items():
        scale = float(r.abs().max())
        top = max(top, scale)
        ratio = float((got[k] - r).abs().max()) / max(scale, 1e-30)
        if ratio > worst:
            worst, worst_name = ratio, k
    print(f"vsr: full SOF-VSR f32 G gradient (b=8, 32 -> 128 px, pixel and "
          f"OFR terms), kernels vs plain: worst relative error {worst:.3e} "
          f"({worst_name}), tol 3.000e-03, largest gradient {top:.3e} over "
          f"{len(ref)} tensors; backward block launches {ran} on the "
          f"kernels, {_counted()['rdb5c_bwd'] - before - ran} on the plain "
          f"versions ({smi})")
    if not (worst <= 3e-3 and top > 0 and math.isfinite(top)) or \
            set(got) != set(ref) or ran != VSR_PER_G or \
            _counted()["rdb5c_bwd"] - before != ran:
        raise AssertionError(f"vsr G gradient: {worst} at {worst_name}, "
                             f"{ran} launches")
    del trainer, state
    torch.cuda.empty_cache()


def _vsr_f64(smi: str, root: str, data: dict) -> None:
    """One f32 SGD step of the cut template (``VSR_F64_G``; the latent
    noise off, C 9) on the card (graphed), the CPU and an f64 witness of
    each side that replays that side's branches of the flow net and the
    loss stack (the RRDB tail's LeakyReLUs run inside the block kernels on
    the card): logs within 1e-4 relative, card against CPU; each G tensor
    of the card no further from its witness than ``I2I_F64_TOL`` times the
    CPU f32's largest distance, or ``I2I_F64_FLOOR`` of its move, or
    ``I2I_F64_ABS`` outright."""
    import torch

    from trainner_tpu_torch.options.config import parse_dict

    opt = _vsr_options(root, data)
    opt["network_G"].update(VSR_F64_G)
    opt["datasets"]["train"].update(batch_size=VSR_F64_SHAPE[0],
                                    crop_size=VSR_F64_SHAPE[2] * 4)
    opt["train"].update(optim_G="sgd", lr_G=1e-2)
    opt = parse_dict(opt, is_train=True)

    def hooked(state, trainer):
        return [state.g.net.OFR, trainer.generator_loss]

    with _quiet_sofvsr():
        r = _steps_card_cpu_f64("vsr", opt, [_vsr_batch(
            80, VSR_F64_SHAPE)], graphs=1, branches=hooked, lr=1e-2)
    cc, f64, cpu = (_worst(r[key], "g.") for key in
                    ("card_cpu", "card_f64", "cpu_f64"))
    tol = max(I2I_F64_TOL * cpu[0], I2I_F64_FLOOR)
    bad = [(k, v, tol, r["abs_card"].get(k)) for k, v in
           r["card_f64"].items() if not v <= tol
           and not r["abs_card"].get(k, 1.0) <= I2I_F64_ABS]
    print(f"vsr: one f32 SGD step (cut: {opt['network_G']['channels']} "
          f"channels, the tail nb {opt['network_G']['sr_nb']}, b "
          f"{VSR_F64_SHAPE[0]}), G's tensors as a share of their move: card "
          f"vs CPU up to {cc[0]:.3e} ({cc[1]}); against each side's f64 "
          f"witness: card {f64[0]:.3e} ({f64[1]}, "
          f"{r['abs_card'].get(f64[1], 0):.2e} absolute; tol {tol:.3e}), "
          f"CPU f32 {cpu[0]:.3e} ({cpu[1]}); logs card vs CPU within "
          f"{r['logs']:.3e} relative (tol 1e-4); branches that differ, card "
          f"against CPU, {r['flips']} of {r['records']} records ({smi})")
    if bad or not r["logs"] <= 1e-4:
        raise AssertionError(f"vsr f64: {bad[:6]}, logs {r['logs']}")
    torch.cuda.empty_cache()


def _vsr_serve(smi: str, root: str, data: dict) -> dict:
    """The test CLI on ``test_video.yml`` (its first dataset; the second
    names a folder that is not there) with the CLI's G of
    ``SHORT_RESUME``, on the served clip (2 windows; the dataset makes
    the LR 144 x 180 from the frames, as the JAX one does when only
    ``dataroot_LR`` is given): f32 and bf16, plain and with ``chop`` (four
    quadrants of 80 x 98 per window), each under a launch trace (69 block
    forwards per quadrant or window), PSNR against the frames' centre.
    Returns the traces."""
    from trainner_tpu_torch import test as test_cli

    trained = _vsr_options(root, data)
    exp = os.path.join(trained["path"]["root"], "experiments",
                       trained["name"])
    windows = VSR_SERVE_FRAMES - 2
    traces = {}
    for amp, chop in ((False, False), (True, False), (False, True),
                      (True, True)):
        opt = read_options_yml(VSR_TEST_YML)
        name = f"serve_vsr_{'bf16' if amp else 'f32'}" + (
            "_chop" if chop else "")
        opt["name"] = name
        opt["datasets"] = {"test_1": dict(opt["datasets"]["test_1"],
                                          dataroot_LR=data["serve"])}
        opt["path"] = {"root": os.path.join(root, name),
                       "pretrain_model_G": os.path.join(
                           exp, "models", f"{SHORT_RESUME}_G.ckpt")}
        opt["use_amp"] = amp
        opt["chop"] = chop
        path = os.path.join(root, name + ".json")
        with open(path, "w") as f:
            json.dump(opt, f)
        want = {"rdb5c": VSR_PER_G * windows * (4 if chop else 1)}
        t0 = time.perf_counter()
        t, averages = _retried_trace(lambda: test_cli.main(["-opt", path]),
                                     want, label=name)
        wall = time.perf_counter() - t0
        vals = {m["name"]: m["average"] for m in averages["calendar"]}
        pngs = [f for _, _, fs in os.walk(os.path.join(root, name))
                for f in fs if f.endswith(".png")]
        hr_px = VSR_SERVE_HW[0] * VSR_SERVE_HW[1]
        print(f"vsr: {name}: {windows} windows of 144 x 180 -> 576 x 720 in "
              f"{wall:.2f} s ({wall / windows:.3f} s per window, "
              f"{hr_px * windows / wall / 1e6:.3f} Mpx/s with the CLI's "
              f"host work; traced), the card ran {t['ran']['rdb5c']} block "
              f"forwards, the wrapper counted {t['counted']['rdb5c']}; "
              f"metrics {vals} ({smi})")
        if len(pngs) != windows or not all(math.isfinite(v)
                                           for v in vals.values()):
            raise AssertionError(f"vsr serving {name}: {pngs}, {vals}")
        traces[name] = t
    return traces


def _vsr_nets_card_vs_cpu(smi: str) -> None:
    """SR3D, EDVR (DCNv2, TSA), EVSRGAN's Conv3D RRDBNet and RIFE at their
    full widths (the JAX package's defaults), each forward on the card
    against the CPU's on one small seeded clip, f32, TF32 off, within 1e-5
    of the output's size; no block kernel runs in these nets."""
    import torch

    from trainner_tpu_torch.options.defaults import get_network_G_config

    for kind, shape in (("sr3d", (1, 5, 16, 16, 3)),
                        ("edvr", (1, 5, 32, 32, 3)),
                        ("evsrgan", (1, 3, 8, 8, 3)),
                        ("rife", (1, 64, 64, 6))):
        opt = {"network_G": get_network_G_config({"type": kind}, 4)}
        _card_vs_cpu_forward(kind, opt, shape, (torch.float32,), tag="vsr")


def _par_data_edit(opt: dict) -> None:
    opt["parallel"] = {"data": 1}


def _par_drop_edit(opt: dict) -> None:
    opt.pop("parallel", None)


def _vsr_cli_on_a_group(smi: str, root: str, data: dict) -> dict:
    """The video training CLI (``_vsr_cli``) with ``parallel: {data: 1}``,
    resumed without it: phase 21's CLI run and phase 25 (c), which reads
    its traces from ``P25_GROUP``."""
    traces = _vsr_cli(smi, root, data, label="vsr parallel",
                      edit=_par_data_edit, resume_edit=_par_drop_edit)
    P25_GROUP["cli"] = traces
    return traces


def phase_video(smi: str, root: str) -> dict:
    """Phase 21: the video models. SOF-VSR with its RRDB tail at the
    template's full width (``options/video/train_video.yml``: channels
    320, 3 frames, x4; nf 64, nb 23, gc 32; b 8, crop 128; cb pixel loss,
    the OFR term at 0.01 with ``ofr_wl1`` 0.1 and ``ofr_wl2`` 0.2; Adam;
    cosine restarts; bf16) on seeded folders of frames (``_vsr_data``):
    the training CLI (``SHORT_NITER`` with ``parallel: {data: 1}``, on a
    one-rank group, and a resume to ``SHORT_RESUME`` without it: phase
    25 (c); 69 + 69 block launches per step and 69 per validation window
    from the traces), the block kernels against their plain versions at the
    shapes SOF-VSR gives them (``_vsr_kernels_vs_plain``), three steps
    graphed against eager bit for bit, one f32 step at cut depth against
    an f64 witness, the test CLI on
    ``test_video.yml`` (f32 and bf16, plain and chop, 69 block launches
    per window or quadrant); then SR3D, EDVR, EVSRGAN and RIFE card
    against CPU (their serving rates, measurement alone, were cut for
    phase 23's time; PERF.md keeps the last ones read). Returns the
    traces."""
    import torch

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    data = _vsr_data(root)
    traces, parts = {}, [f"{time.perf_counter() - t0:.1f}"]
    for part in (lambda: traces.update(_vsr_cli_on_a_group(smi, root,
                                                           data)),
                 lambda: _vsr_kernels_vs_plain(smi, root, data),
                 lambda: _vsr_graphed_vs_eager(smi, root, data),
                 lambda: _vsr_f64(smi, root, data),
                 lambda: traces.update(_vsr_serve(smi, root, data)),
                 lambda: _vsr_nets_card_vs_cpu(smi)):
        t1 = time.perf_counter()
        part()
        parts.append(f"{time.perf_counter() - t1:.1f}")
    print(f"vsr: ok in {time.perf_counter() - t0:.1f} s (data, CLI, kernels "
          f"vs plain, graphs, f64, serving, nets card vs CPU: "
          f"{', '.join(parts)} s) "
          f"({smi})")
    return traces


# ---------------------------------------------------------------------------
# phase 22: SRFlow (both nets) and the sr trainer's other generators
# ---------------------------------------------------------------------------

SRFLOW_DIR = os.path.join(os.path.dirname(OPTIONS_DIR), "srflow")
SRFLOW_TRAIN_YML = os.path.join(SRFLOW_DIR, "train_srflow.yml")
SRFLOW_TEST_YML = os.path.join(SRFLOW_DIR, "test_srflow.yml")
SRFLOW_PER = NB        # srflow_net's encoder: block launches per pass
SRFLOW_I_PER = NB * 3  # the interop net's 23 RRDBs
SRFLOW_F = (16, 40, 40)  # the encoder's blocks in a template step (F)
SRFLOW_UNFREEZE = SHORT_NITER // 2  # train_RRDB_delay 0.5 of niter 6
SRFLOW_GRAPH_STEPS = 4   # graphed against eager, the unfreeze at 2
# the f64 witness's cut: the encoder at its real block widths (nf 64, gc
# 32) and nb 2, K 2, L 3, hidden 64; b=2, 16 -> 64 px; unfrozen; SGD
SRFLOW_F64_G = {"nb": 2, "K": 2}
SRFLOW_F64_SHAPE = (2, 16, 16)
SRFLOW_SERVE_PX = 160    # the served images (HR; LR 40 x 40)
SRFLOW_SERVE_N = 1       # of them (2 until phase 23's time cut)
SRFLOW_SERVE_SAMPLES = 1  # draws per heat (the template's 3, until then)
SRFLOW_SERVE_SHAPE = (1, SRFLOW_SERVE_PX // 4, SRFLOW_SERVE_PX // 4)
# a served heat-0 sample's distance from the f64 witness, as a multiple of
# the CPU f32's: the card (cuDNN's f32 flow, the 3xTF32 encoder) read
# 1.19-2.33x it with srflow_net's 14-step G and 0.86x with the interop
# net's, in four runs, the card with the encoder on the plain versions
# 0.64x and 0.92x (PERF.md section 6); 4x leaves 1.7x over the largest
SRFLOW_SERVE_TOL = 4.0
# the sr trainer's other Gs: card against CPU (LR), the graphed step's
# batch (b, LR px; the attention of ABPN is (h w)^2 per image and block),
# the serving rate's LR
ZOO_A = {"abpn": ({"type": "abpn_net"}, 4, (1, 32, 32, 3), (16, 32), 128),
         "asr_resnet": ({"type": "asr_resnet"}, 4, (1, 32, 32, 3), (16, 32),
                        128),
         "asr_cnn": ({"type": "asr_cnn"}, 4, (1, 32, 32, 3), (16, 32), 128),
         "seg_arch": ({"type": "seg_arch", "n_classes": 3}, 1,
                      (2, 64, 64, 3), (8, 64), 256)}


def _srflow_options(interop: bool = False, **train) -> dict:
    """``train_srflow.yml`` as written (SRFlowNet nf 64, nb 23, K 16, L 3,
    hidden 64; b 16, crop 160; Adam, MultiStepLR, the norm clip;
    ``train_RRDB_delay`` 0.5), the flow's ``interop`` as asked, ``train``
    keys over the file's, parsed by the port."""
    from trainner_tpu_torch.options.config import parse_dict

    opt = read_options_yml(SRFLOW_TRAIN_YML)
    opt["datasets"] = {"train": opt["datasets"]["train"]}
    if interop:
        opt["network_G"].setdefault("flow", {})["interop"] = True
    opt["train"].update(train)
    opt["path"] = {"root": "/nonexistent"}
    return dict(parse_dict(opt, is_train=True))


def _srflow_batch(seed: int, b: int = SRFLOW_F[0], px: int = SRFLOW_F[1]):
    """An HR batch of a smooth random field plus texture, its LR the 4x
    box mean (on the card)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    hr = torch.nn.functional.interpolate(
        torch.rand(b, 3, px // 2, px // 2, generator=gen), scale_factor=8,
        mode="bicubic", align_corners=False)
    hr = (hr + 0.1 * torch.rand(hr.shape, generator=gen)).clamp(0, 1)
    hr = hr.permute(0, 2, 3, 1).contiguous()
    lr = hr.reshape(b, px, 4, px, 4, 3).mean((2, 4))
    return {"LR": lr.cuda(), "HR": hr.cuda()}


def _srflow_cli(smi: str, root: str) -> dict:
    """The training CLI on ``train_srflow.yml`` at full width through
    ``phase_cli``: 6 iterations, the encoder unfrozen at step 4 (3 frozen
    steps: 23 block forwards and no backward each; then 23 and 23), 23
    forwards per validation image (heat 0), no blur; a resume to 8 from
    the saved state, bit for bit."""
    from trainner_tpu_torch.train.srflow_trainer import SRFlowTrainer

    def edit(opt):
        opt["datasets"]["train"]["n_workers"] = 4

    return {f"srflow cli {k}": v for k, v in phase_cli(
        smi, root, SRFLOW_TRAIN_YML, "cli_srflow", per_batch=0, nets=("G",),
        edit=edit, trainer_cls=SRFlowTrainer, val_launches=SRFLOW_PER,
        g_launches=lambda n: (SRFLOW_PER, SRFLOW_PER
                              if n > SRFLOW_UNFREEZE else 0),
        niter=SHORT_NITER, resume_niter=SHORT_RESUME).items()}


def _srflow_kernels_vs_plain(smi: str) -> None:
    """The block kernels against their plain versions at F (b=16, LR 40 x
    40, f32, TF32 off): one block forward and backward
    (``_compare_block``, the kernel phase's f32 tolerances), and its
    forward at the serving shape (b=1, 40 x 40); the
    template's whole encoder forward at its init within 1e-5 of its size,
    and at Kaiming gain 0.7 within the per-block 1e-4; the encoder's
    gradient of one unfrozen template step with the whole net at gain 0.7
    (at init the couplings' zero convs pass the encoder none; the same
    quantisation noise both ways) within 3e-3 of each tensor's largest.
    Eager calls: the wrappers' counts are the launches (23 per pass on
    the kernels, none on the plain versions)."""
    import torch

    from trainner_tpu_torch.train.sr_trainer import create_trainer

    gen = torch.Generator().manual_seed(22)
    ws, bs = _block_weights(gen)
    bs = [b.cuda() for b in bs]
    x = (torch.randn(*SRFLOW_F, NF, generator=gen) * 0.5).cuda()
    g_out = torch.randn(*SRFLOW_F, NF, generator=gen).cuda()
    _compare_block(SRFLOW_F, torch.float32, x, g_out, ws, bs, "srflow: ")
    # the serving shape (one LR image of 40 x 40), forward alone
    _compare_block(SRFLOW_SERVE_SHAPE, torch.float32, x[:1].contiguous(),
                   None, ws, bs, "srflow serve: ")

    trainer = create_trainer(_srflow_options(train_RRDB_delay=0),
                             graphs=False)
    state = trainer.init_state(2)
    net = state.g.net
    batch = _srflow_batch(90)
    # the encoder at its own init (Kaiming x 0.1 in the blocks: what the
    # path trains from), held to 1e-5 of its size; then at gain 0.7,
    # where each bare block adds 0.2 c5 of the trunk's size and the
    # chain of 23 grows 3xTF32's rounding against f32's: held to the
    # per-block f32 tolerance, 1e-4
    for gain, rel_tol in ((None, 1e-5), (0.7, 1e-4)):
        if gain is not None:
            _gain_weights(net.RRDB, seed=3)
        with torch.inference_mode():
            before = _counted()["rdb5c"]
            got = net.RRDB(batch["LR"])
            ran = _counted()["rdb5c"] - before
            with _plain_blocks():
                ref = net.RRDB(batch["LR"])
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        print(f"srflow: the encoder's forward at F (b=16, 40 x 40, f32; "
              f"{'its init' if gain is None else 'Kaiming gain 0.7'}): "
              f"kernels vs plain max_abs_err {err:.3e} on max|ref| "
              f"{scale:.3e} ({err / scale:.3e} of it), tol "
              f"{rel_tol * scale:.3e}; {ran} block launches on the kernels, "
              f"{_counted()['rdb5c'] - before - ran} on the plain versions")
        if not err <= rel_tol * scale or ran != SRFLOW_PER or \
                _counted()["rdb5c"] - before != ran:
            raise AssertionError(f"srflow encoder: {err}, {ran} launches")

    # the flow at gain 0.7 too: its couplings' zero-initialised last
    # convs would pass the encoder no gradient at all
    _gain_weights(net, seed=4)
    noise = torch.rand(batch["HR"].shape,
                       generator=torch.Generator().manual_seed(4)).cuda()
    trainer.draw_hook = lambda shapes: {"noise": noise}
    names = [f"RRDB.{k}" for k, _ in net.RRDB.named_parameters()]

    def grads():
        # an update at learning rate 0: the gradients stay on .grad
        trainer._flow_step(state, batch, 0.0, 0.0, train_rrdb=True)
        torch.cuda.synchronize()
        params = dict(net.named_parameters())
        return {k: params[k].grad.clone() for k in names}

    before = _counted()["rdb5c_bwd"]
    got = grads()
    ran = _counted()["rdb5c_bwd"] - before
    with _plain_blocks():
        ref = grads()
    worst, worst_name, top = 0.0, "", 0.0
    for k, r in ref.items():
        s = float(r.abs().max())
        top = max(top, s)
        ratio = float((got[k] - r).abs().max()) / max(s, 1e-30)
        if ratio > worst:
            worst, worst_name = ratio, k
    print(f"srflow: the encoder's gradient of one unfrozen template step at "
          f"F (f32), kernels vs plain: worst relative error {worst:.3e} "
          f"({worst_name}), tol 3.000e-03, largest gradient {top:.3e} over "
          f"{len(ref)} tensors; backward block launches {ran} on the "
          f"kernels, {_counted()['rdb5c_bwd'] - before - ran} on the plain "
          f"versions ({smi})")
    if not (worst <= 3e-3 and top > 0 and math.isfinite(top)) or \
            ran != SRFLOW_PER or _counted()["rdb5c_bwd"] - before != ran:
        raise AssertionError(f"srflow encoder gradient: {worst} at "
                             f"{worst_name}, {ran} launches")
    del trainer, state, net
    torch.cuda.empty_cache()


def _srflow_graphed_vs_eager(smi: str, root: str, interop: bool) -> dict:
    """The template's step at full width (f32, b=16, 40 -> 160 px),
    graphed against eager from the same state and noise generator state,
    across the unfreeze: ``SRFLOW_GRAPH_STEPS`` steps with the unfreeze
    at 2 (srflow_net), or 2 steps with it at 1 (the interop net), bit for
    bit under deterministic cuDNN; one graph per freeze state, each with
    the block launches it recorded (23 or 69 forwards; backwards only
    unfrozen). The interop net's G is saved for the test CLI. Returns the
    step's ms each way by freeze state."""
    import torch

    from trainner_tpu_torch.utils import checkpoint
    from trainner_tpu_torch.utils.torch_interop import g_to_jax

    steps = 2 if interop else SRFLOW_GRAPH_STEPS
    per = SRFLOW_I_PER if interop else SRFLOW_PER
    opt = _srflow_options(interop, niter=steps)
    unequal, ms, trainers, states = _graphed_vs_eager(
        opt, [_srflow_batch(70 + i) for i in range(steps)],
        "srflow_interop" if interop else "srflow", (per, per))
    graphs = trainers["graphed"].step_graphs()
    recorded = {key[1]: {k: cap.launches[k] for k in ("rdb5c", "rdb5c_bwd")}
                for key, cap in graphs.items()}
    want = {False: {"rdb5c": per, "rdb5c_bwd": 0},
            True: {"rdb5c": per, "rdb5c_bwd": per}}
    name = "interop" if interop else "srflow_net"
    print(f"srflow: {steps} {name} steps at full width (f32, b=16, 40 -> "
          f"160 px), the unfreeze at {steps // 2}, graphed ({len(graphs)} "
          f"programs; block launches recorded by freeze state {recorded}) "
          f"against eager: {len(unequal)} tensors or logs differ")
    print(f"times: srflow {name} train_step f32, ms per step (a freeze "
          f"state's first: eager + capture; then replays), graphed "
          f"{[round(v, 3) for v in ms['graphed']]}, eager "
          f"{[round(v, 3) for v in ms['eager']]} ({smi})")
    if unequal or recorded != want:
        raise AssertionError(f"srflow graphs {name}: {unequal[:6]}, "
                             f"{recorded}")
    if interop:
        st = states["graphed"]
        torch.cuda.synchronize()
        checkpoint.save_params(g_to_jax(st.g.net.state_dict(), st.g.net)[0],
                               os.path.join(root, "srflow_interop_G.ckpt"))
    out = {"graphed": ms["graphed"][-1], "eager": ms["eager"][-1]}
    del trainers, states
    torch.cuda.empty_cache()
    return out


def _srflow_f64(smi: str) -> None:
    """One f32 SGD step of the cut template (``SRFLOW_F64_G``, unfrozen)
    on the card (graphed), the CPU and an f64 witness of each side that
    replays that side's branches of the flow (the encoder's LeakyReLUs run
    inside the block kernels on the card), the quantisation noise the
    CPU's: logs within 1e-4 relative, card against CPU; each G tensor of
    the card no further from its witness than ``I2I_F64_TOL`` times the
    CPU f32's largest distance, or ``I2I_F64_FLOOR`` of its move, or
    ``I2I_F64_ABS`` outright."""
    import torch

    from trainner_tpu_torch.options.config import parse_dict

    opt = read_options_yml(SRFLOW_TRAIN_YML)
    opt["datasets"] = {"train": dict(opt["datasets"]["train"],
                                     batch_size=SRFLOW_F64_SHAPE[0],
                                     crop_size=SRFLOW_F64_SHAPE[1] * 4)}
    opt["network_G"].update(SRFLOW_F64_G)
    opt["train"].update(optim_G="sgd", lr_G=1e-2, train_RRDB_delay=0)
    opt["path"] = {"root": "/nonexistent"}
    opt = dict(parse_dict(opt, is_train=True))

    def flow(state, trainer):
        return [m for n, m in state.g.net.named_children() if n != "RRDB"]

    gen = torch.Generator().manual_seed(80)
    b, h, w = SRFLOW_F64_SHAPE
    hr = torch.rand(b, 4 * h, 4 * w, 3, generator=gen)
    batch = {"LR": hr.reshape(b, h, 4, w, 4, 3).mean((2, 4)), "HR": hr}
    r = _steps_card_cpu_f64("srflow", opt, [batch], graphs=1,
                            share_draws=True, branches=flow, lr=1e-2)
    cc, f64, cpu = (_worst(r[key], "g.") for key in
                    ("card_cpu", "card_f64", "cpu_f64"))
    tol = max(I2I_F64_TOL * cpu[0], I2I_F64_FLOOR)
    bad = [(k, v, tol, r["abs_card"].get(k)) for k, v in
           r["card_f64"].items() if not v <= tol
           and not r["abs_card"].get(k, 1.0) <= I2I_F64_ABS]
    print(f"srflow: one f32 SGD step (cut: nb {SRFLOW_F64_G['nb']}, K "
          f"{SRFLOW_F64_G['K']}, b {b}, {h} -> {4 * h} px, unfrozen), G's "
          f"tensors as a share of their move: card vs CPU up to {cc[0]:.3e} "
          f"({cc[1]}); against each side's f64 witness: card {f64[0]:.3e} "
          f"({f64[1]}, {r['abs_card'].get(f64[1], 0):.2e} absolute; tol "
          f"{tol:.3e}), CPU f32 {cpu[0]:.3e} ({cpu[1]}); logs card vs CPU "
          f"within {r['logs']:.3e} relative (tol 1e-4); branches that "
          f"differ, card against CPU, {r['flips']} of {r['records']} "
          f"records ({smi})")
    if bad or not r["logs"] <= 1e-4:
        raise AssertionError(f"srflow f64: {bad[:6]}, logs {r['logs']}")
    torch.cuda.empty_cache()


def _srflow_serve_data(root: str) -> dict:
    """``SRFLOW_SERVE_N`` corpus images cropped to ``SRFLOW_SERVE_PX`` and
    their bicubic LR (40 x 40)."""
    import numpy as np

    from trainner_tpu_torch.data.common import decode_image, save_img
    from trainner_tpu_torch.ops.imresize import imresize_np

    out = {k: os.path.join(root, "srflow_serve", k) for k in ("HR", "LR")}
    for d in out.values():
        os.makedirs(d, exist_ok=True)
    pngs = sorted(os.listdir(os.path.join(root, "corpus")))[:SRFLOW_SERVE_N]
    p = SRFLOW_SERVE_PX
    for img in pngs:
        hr = decode_image(os.path.join(root, "corpus", img))[:p, :p]
        save_img(np.ascontiguousarray(hr), os.path.join(out["HR"], img))
        lr = imresize_np(hr.astype(np.float32) / 255.0, 0.25, kernel="cubic")
        save_img((lr * 255.0).round().astype(np.uint8),
                 os.path.join(out["LR"], img))
    return out


def _srflow_serve(smi: str, root: str) -> dict:
    """The test CLI on ``test_srflow.yml`` (heats 0, 0.5, 0.75, 1.0 x
    ``SRFLOW_SERVE_SAMPLES`` draws, the first heat's first sample also
    saved under the image's name and scored) on ``SRFLOW_SERVE_N``
    images, with the training CLI's G (srflow_net) and the interop net's
    graphed steps' G, each under a
    launch trace: 23 or 69 block forwards per sample. The heat-0 sample
    of each (``eval_step``) on the card, on the card with the encoder on
    the plain versions (``_plain_blocks``) and on the CPU (f32), against
    an f64 witness of the CPU's net: both card samples no further from it
    than ``SRFLOW_SERVE_TOL`` times the CPU's distance, or 1e-5 of the
    size (a G of 14 steps inverts couplings whose scales lie near their
    floor of 1e-4, so the rounding of either device grows in the reverse;
    the card against the CPU is printed beside). Returns the traces."""
    import torch

    from trainner_tpu_torch import test as test_cli
    from trainner_tpu_torch.options.config import parse_dict
    from trainner_tpu_torch.train.srflow_trainer import SRFlowTrainer

    data = _srflow_serve_data(root)
    cli_opt = read_options_yml(SRFLOW_TRAIN_YML)
    g_files = {"srflow_net": os.path.join(
        root, "cli_srflow", "experiments", cli_opt["name"], "models",
        f"{SHORT_RESUME}_G.ckpt"),
        "interop": os.path.join(root, "srflow_interop_G.ckpt")}
    traces = {}
    for name, per in (("srflow_net", SRFLOW_PER),
                      ("interop", SRFLOW_I_PER)):
        opt = read_options_yml(SRFLOW_TEST_YML)
        # every draw at one heat is the same image (C 26): one a heat
        opt["val"]["n_sample"] = SRFLOW_SERVE_SAMPLES
        heats, n_sample = opt["val"]["heats"], opt["val"]["n_sample"]
        opt["name"] = f"serve_srflow_{name}"
        opt["datasets"]["test_1"].update(dataroot_HR=data["HR"],
                                         dataroot_LR=data["LR"])
        opt["network_G"]["flow"]["interop"] = name == "interop"
        opt["path"] = {"root": os.path.join(root, opt["name"]),
                       "pretrain_model_G": g_files[name]}
        path = os.path.join(root, opt["name"] + ".json")
        with open(path, "w") as f:
            json.dump(opt, f)
        passes = SRFLOW_SERVE_N * len(heats) * n_sample
        t0 = time.perf_counter()
        t, averages = _retried_trace(lambda: test_cli.main(["-opt", path]),
                                     {"rdb5c": per * passes},
                                     label=opt["name"])
        wall = time.perf_counter() - t0
        pngs = sorted(f for _, _, fs in os.walk(os.path.join(
            root, opt["name"])) for f in fs if f.endswith(".png"))
        vals = {m["name"]: m["average"] for m in averages["seta"]}
        # the heat-0 sample through each trainer's eval_step, card and CPU
        parsed = dict(parse_dict(opt, is_train=False))
        lr = torch.from_numpy(_read_lr(data["LR"]))
        outs = {}
        for side, dev in (("cuda", "cuda"), ("plain", "cuda"),
                          ("cpu", "cpu")):
            tr = SRFlowTrainer(parsed, device=dev, graphs=False)
            st = tr.init_state(0, g_files[name])
            with _plain_blocks() if side == "plain" else \
                    contextlib.nullcontext():
                outs[side] = tr.eval_step(st, lr, 0.0).cpu()
            del tr, st
        # held with an f64 witness of the CPU's net beside it
        net64 = _f64_net(SRFlowTrainer(parsed, device="cpu").init_state(
            0, g_files[name]).g.net)
        lr64 = lr.double()
        cold64 = [torch.zeros(sh, dtype=torch.float64)
                  for sh in net64.sample_shapes(lr.shape)]
        with _in_f64() as f32_ops, torch.inference_mode():
            exact = net64.sample_from(lr64, cold64)
        if f32_ops:
            raise AssertionError(f"srflow witness f32 ops {set(f32_ops)}")
        del net64
        r = _witness_reading(outs, exact)
        px = passes * SRFLOW_SERVE_PX ** 2
        print(f"srflow: {opt['name']}: {SRFLOW_SERVE_N} image(s) of 40 x 40 "
              f"-> 160 x 160, heats {heats} x {n_sample} samples (the first "
              f"scored), in {wall:.2f} s ({wall / SRFLOW_SERVE_N:.3f} s per "
              f"image, "
              f"{px / wall / 1e6:.4f} Mpx/s of samples with the CLI's host "
              f"work; traced), "
              f"the card ran {t['ran']['rdb5c']} block forwards ({per} per "
              f"sample), the wrapper counted {t['counted']['rdb5c']}; "
              f"{len(pngs)} PNGs; metrics {vals} ({smi})")
        print(f"srflow: {opt['name']} heat 0 sample (eval_step), max |ref| "
              f"{r['size']:.3e}: card vs CPU {r['card_cpu']:.3e} "
              f"({r['card_cpu'] / r['size']:.3e} of it); against the f64 "
              f"witness card {r['card']:.3e} ({r['card'] / r['cpu']:.2f}x "
              f"the CPU's), card with the encoder on the plain versions "
              f"{r['plain']:.3e} ({r['plain'] / r['cpu']:.2f}x), CPU f32 "
              f"{r['cpu']:.3e}, tol {r['tol']:.3e} (the larger of "
              f"{SRFLOW_SERVE_TOL} x the CPU's and 1e-5 of the size)")
        if len(pngs) != SRFLOW_SERVE_N * (len(heats) * n_sample + 1) or \
                not all(math.isfinite(v) for v in vals.values()) or \
                not max(r["card"], r["plain"]) <= r["tol"]:
            raise AssertionError(f"srflow serving {name}: {len(pngs)} PNGs, "
                                 f"{vals}, {r}")
        traces[opt["name"]] = t
    torch.cuda.empty_cache()
    return traces


def _f64_net(net):
    """A CPU copy of a net in f64 (its modules' ``dtype`` too), for
    ``_in_f64``."""
    import copy

    import torch

    out = copy.deepcopy(net).double()
    for m in out.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    return out


def _witness_reading(sides: dict, exact) -> dict:
    """Card (kernels and plain blocks) and CPU f32 outputs against an f64
    witness: each one's largest distance from it, the card's from the
    CPU's, the size, and the tolerance of the card's distances
    (``SRFLOW_SERVE_TOL`` times the CPU's, at least 1e-5 of the size)."""
    exact = exact.double()
    size = float(exact.abs().max())
    cpu = float((sides["cpu"].double() - exact).abs().max())
    return {"size": size, "cpu": cpu,
            "card": float((sides["cuda"].double() - exact).abs().max()),
            "plain": float((sides["plain"].double() - exact).abs().max()),
            "card_cpu": float((sides["cuda"] - sides["cpu"]).abs().max()),
            "tol": max(SRFLOW_SERVE_TOL * cpu, 1e-5 * size)}


def _read_lr(folder: str):
    """The first LR image of ``folder`` as a (1, h, w, 3) f32 array in
    [0, 1]."""
    import numpy as np

    from trainner_tpu_torch.data.common import decode_image

    img = decode_image(os.path.join(folder, sorted(os.listdir(folder))[0]))
    return (img[None].astype(np.float32) / 255.0)


def _zoo_a_net(name: str, dt, calibrate: bool = False):
    """One of the sr trainer's other Gs at its JAX defaults (``ZOO_A``),
    init from a seed; with ``calibrate`` the segmenter's running
    statistics set to one train-mode pass's batch statistics, its
    variance plus 1, on a seeded image (its 37 batch norms, at init, would
    leave eval-mode logits in the thousands, where f32's softmax
    saturates on either side)."""
    import torch

    from trainner_tpu_torch.models import define_G
    from trainner_tpu_torch.ops.blocks import BatchNorm, commit_stats
    from trainner_tpu_torch.options.defaults import get_network_G_config

    spec, scale = ZOO_A[name][:2]
    net = define_G({"network_G": get_network_G_config(dict(spec), scale)},
                   dtype=dt)
    net.init_weights(torch.Generator().manual_seed(2))
    if calibrate and name == "seg_arch":
        norms = [m for m in net.modules() if isinstance(m, BatchNorm)]
        for m in norms:
            m.momentum = 0.0
        net.train()
        with torch.no_grad():
            net(torch.rand(2, 64, 64, 3,
                           generator=torch.Generator().manual_seed(3)))
        commit_stats(net)
        with torch.no_grad():
            for m in norms:
                m.momentum = 0.99
                m.running_var.add_(1.0)
    return net.eval()


def _zoo_a(smi: str) -> None:
    """ABPN, ASRResNet, ASRCNN and the segmenter (``seg_arch``, 3 classes
    at scale 1) at their JAX defaults: each forward card against CPU (f32,
    TF32 off) within 1e-5 of the output's size, no block kernel launched;
    one ``sr`` step of ``train_sr.yml`` with the G swapped (bf16, D-VGG at
    the crop, the flagship losses; the batch of ``ZOO_A``, which the
    attention fits) graphed against eager bit for bit; each forward's
    Mpx/s by CUDA events at b=1 (f32)."""
    import torch

    from trainner_tpu_torch.options.config import parse_dict

    for name, (spec, scale, cpu_lr, (b, px), serve_px) in ZOO_A.items():
        x = torch.rand(*cpu_lr, generator=torch.Generator().manual_seed(5))
        net = _zoo_a_net(name, torch.float32, calibrate=True)
        with torch.inference_mode():
            ref = net(x)
            net = net.cuda()
            with _no_block_launch(name):
                got = net(x.cuda()).cpu()
        size = float(ref.abs().max())
        err = float((got - ref).abs().max())
        print(f"zoo_a: {name} f32 forward {tuple(x.shape)} -> "
              f"{tuple(ref.shape)}, card vs CPU: max_abs_err {err:.3e} on "
              f"max|ref| {size:.3e}, tol {1e-5 * size:.3e}, no block kernel "
              f"launched")
        if not (err <= 1e-5 * size and bool(got.isfinite().all())):
            raise AssertionError(f"zoo_a {name}: {err}")

        opt = read_options_yml(TRAIN_YML)
        opt["network_G"] = dict(spec)
        opt["scale"] = scale
        opt["datasets"] = {"train": dict(opt["datasets"]["train"],
                                         batch_size=b,
                                         crop_size=px * scale)}
        opt["network_D"] = {"type": "discriminator_vgg",
                            "size": px * scale, "nf": 64}
        opt["path"] = {"root": "/nonexistent"}
        opt = dict(parse_dict(opt, is_train=True))
        gens = [torch.Generator().manual_seed(60 + i) for i in range(2)]
        unequal, ms, trainers, states = _graphed_vs_eager(opt, [
            {"LR": torch.rand(b, px, px, 3, generator=g).cuda(),
             "HR": torch.rand(b, px * scale, px * scale, 3,
                              generator=g).cuda()} for g in gens])
        n_graphs = len(trainers["graphed"].step_graphs())
        print(f"zoo_a: {name} sr step (train_sr.yml with the G; bf16, b={b},"
              f" {px} -> {px * scale} px) graphed ({n_graphs} program) "
              f"against eager, 2 steps: {len(unequal)} tensors or logs "
              f"differ; ms graphed {[round(v, 3) for v in ms['graphed']]}, "
              f"eager {[round(v, 3) for v in ms['eager']]} ({smi})")
        if unequal or n_graphs != 1:
            raise AssertionError(f"zoo_a {name} graphs: {unequal[:6]}")
        del trainers, states

        row = []
        lr = torch.rand(1, serve_px, serve_px, 3, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(
                            6))
        for dt in (torch.float32,):
            net = _zoo_a_net(name, dt).cuda()
            with torch.inference_mode():
                t_ms = _time_ms(lambda: net(lr), iters=SERVE_ITERS, warmup=1)
            mpx = (serve_px * scale) ** 2 / 1e6
            row.append(f"{str(dt)[6:]} {t_ms:.3f} ms, {mpx / t_ms * 1e3:.3f} "
                       "Mpx/s")
            del net
        print(f"times: {name} forward, b=1, {serve_px} -> {serve_px * scale} "
              f"px: {'; '.join(row)} ({smi})")
        torch.cuda.empty_cache()


def phase_srflow(smi: str, root: str) -> dict:
    """Phase 22: SRFlow at the template's full width
    (``options/srflow/train_srflow.yml``: SRFlowNet nf 64, nb 23, K 16, L
    3, hidden 64; b 16, crop 160; f32), its encoder's 23 blocks on the
    block kernels: the training CLI (6 iterations, the encoder unfrozen
    at step 4, and a resume to 8), the kernels against their plain
    versions at F, steps graphed against eager across the unfreeze, one
    f32 step at cut depth against an f64 witness, the interop net's
    steps graphed against eager (69 blocks per pass), the test CLI on
    ``test_srflow.yml`` with both nets; then ABPN, ASRResNet, ASRCNN and
    the segmenter (``_zoo_a``). Returns the traces."""
    import torch

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    traces, parts = {}, []
    for part in (lambda: traces.update(_srflow_cli(smi, root)),
                 lambda: _srflow_kernels_vs_plain(smi),
                 lambda: _srflow_graphed_vs_eager(smi, root, False),
                 lambda: _srflow_graphed_vs_eager(smi, root, True),
                 lambda: _srflow_f64(smi),
                 lambda: traces.update(_srflow_serve(smi, root)),
                 lambda: _zoo_a(smi)):
        t1 = time.perf_counter()
        part()
        parts.append(f"{time.perf_counter() - t1:.1f}")
    print(f"srflow: ok in {time.perf_counter() - t0:.1f} s (CLI, kernels vs "
          f"plain, graphs, interop graphs, f64, serving, the other sr Gs: "
          f"{', '.join(parts)} s) ({smi})")
    return traces


# ---------------------------------------------------------------------------
# phase 23: PBR on the block kernels, DVD and WBC (the rest of the zoo)
# ---------------------------------------------------------------------------

DVD_TRAIN_YML = os.path.join(VIDEO_DIR, "train_deinterlace.yml")
DVD_TEST_YML = os.path.join(VIDEO_DIR, "test_deinterlace.yml")
WBC_TRAIN_YML = os.path.join(I2I_DIR, "train_wbc.yml")
PBR_MAPS = ("diffuse", "normal", "roughness", "height")
PBR_3CH = ("diffuse", "normal")
PBR_N = 16               # seeded material folders for training
PBR_PX = 256             # their maps (and the N_VAL validation ones)
PBR_P = (8, 32, 32)      # the blocks of a PBR step: b 8, LR 32 x 32 (P)
PBR_PER_PASS = NB * 3    # block launches per G pass
PBR_PER_STEP = PBR_PER_PASS * len(PBR_MAPS)  # one G pass per map: 276
PBR_SERVE_CROP = 128     # the served materials' crop (LR 32 x 32)
DVD_FRAMES = 33          # the DVD set: 32 pairs of consecutive frames
ZOO_REST_NITER, ZOO_REST_RESUME = 6, 8  # the DVD and WBC CLIs
ZOO_REST_GRAPH_STEPS = 3
# the f64 witnesses' cuts: PBR's G at nb 2 (of 23), b 2, 8 -> 32 px; DVD
# at nf 64, b 2, 32 px; WBC at nf 32 (D ndf 32), b 2, 64 px
PBR_F64_NB, ZOO_F64_B = 2, 2
WBC_SP_EXACT_PX = 32     # the sp_exact step: b 2 at 32 px


def _zoo_rest_data(root: str) -> dict:
    """The phase's data from seeds: ``PBR_N`` material folders for
    training and ``N_VAL`` for validation and serving, each with the four
    maps of ``PBR_MAPS`` as ``PBR_PX``² PNGs (one 1/f field of
    ``_write_corpus`` a map; a one-channel map reads the first channel);
    DVD's frames, the first ``DVD_FRAMES`` corpus images, and the 3 it
    serves; WBC's B, a second corpus (seed 4; A is the corpus)."""
    import shutil

    base = os.path.join(root, "zoo_rest")
    out = {k: os.path.join(base, k) for k in ("pbr_train", "pbr_val",
                                              "fields", "dvd", "dvd_serve",
                                              "wbc_b", "wbc_serve")}
    for d in out.values():
        os.makedirs(d, exist_ok=True)
    n_mat = PBR_N + N_VAL
    _write_corpus(out["fields"], n=n_mat * len(PBR_MAPS), px=PBR_PX, seed=3)
    fields = sorted(os.listdir(out["fields"]))
    for i in range(n_mat):
        mat = os.path.join(out["pbr_train"] if i < PBR_N else
                           out["pbr_val"], f"mat{i:02d}")
        os.makedirs(mat)
        for j, m in enumerate(PBR_MAPS):
            shutil.move(os.path.join(out["fields"],
                                     fields[i * len(PBR_MAPS) + j]),
                        os.path.join(mat, f"mat{i:02d}_{m}.png"))
    corpus = os.path.join(root, "corpus")
    names = sorted(os.listdir(corpus))
    for i, name in enumerate(names[:DVD_FRAMES]):
        shutil.copy(os.path.join(corpus, name), out["dvd"])
        if i < 3:
            shutil.copy(os.path.join(corpus, name), out["dvd_serve"])
        if i < N_VAL:
            shutil.copy(os.path.join(corpus, name), out["wbc_serve"])
    _write_corpus(out["wbc_b"], n=I2I_N, seed=4)
    out["wbc_a"] = corpus
    return out


def _pbr_edit(opt: dict) -> None:
    """``train_sr.yml`` as a PBR run: ``model: pbr``, its G (``rrdb_net``
    nf 64, nb 23, gc 32) and losses (pixel L1 1e-2, VGG19 feature L1; its
    GAN keys, which the PBR trainer does not read), bf16; the material
    set (b 8, crop 128: LR 32) for training and validation."""
    opt["model"] = "pbr"
    opt.pop("network_D", None)
    opt["datasets"]["train"] = {"name": "materials", "mode": "pbr",
                                "crop_size": 128, "batch_size": 8,
                                "n_workers": 4, "use_shuffle": True}
    opt["datasets"]["val"] = {"name": "materials_val", "mode": "pbr",
                              "crop_size": 128}


def _pbr_options(noise: bool = True, **train) -> dict:
    """The PBR cell's options (``_pbr_edit``), parsed, with the latent
    noise on or off and ``train`` over the template's keys."""
    from trainner_tpu_torch.options.config import parse_dict

    opt = read_options_yml(TRAIN_YML)
    _pbr_edit(opt)
    opt["network_G"]["gaussian_noise"] = noise
    opt["train"].update(train)
    opt["path"] = {"root": "/nonexistent"}
    return dict(parse_dict(opt, is_train=True))


def _pbr_batch(seed: int, b: int = PBR_P[0], lr_px: int = PBR_P[1],
               device: str = "cuda") -> dict:
    """A material batch from a seed: each map a smooth field (its HR at 4x
    the LR, the LR its 4 x 4 box means), two of three channels and two of
    one."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    hr_px = lr_px * 4
    out = {}
    for m in PBR_MAPS:
        nc = 3 if m in PBR_3CH else 1
        base = torch.rand(b, nc, hr_px // 8 + 2, hr_px // 8 + 2,
                          generator=gen)
        hr = torch.nn.functional.interpolate(
            base, size=(hr_px, hr_px), mode="bicubic", align_corners=False)
        hr = (hr + 0.05 * torch.rand(hr.shape, generator=gen)).clamp(0, 1)
        hr = hr.permute(0, 2, 3, 1).contiguous()
        lr = hr.reshape(b, lr_px, 4, lr_px, 4, nc).mean((2, 4))
        out[f"HR_{m}"], out[f"LR_{m}"] = hr.to(device), lr.to(device)
    out["LR"], out["HR"] = out["LR_diffuse"], out["HR_diffuse"]
    return out


def _pbr_cli(smi: str, root: str, data: dict) -> dict:
    """The training CLI on the PBR cell through ``phase_cli``: 12
    iterations, each step 4 G passes (276 block forwards and 276
    backwards), 69 forwards per validation material, no blur; a resume to
    14 from the saved state, bit for bit."""
    from trainner_tpu_torch.train.pbr_trainer import PBRTrainer

    return {f"pbr cli {k}": v for k, v in phase_cli(
        smi, root, TRAIN_YML, "cli_pbr", per_batch=0, nets=("G",),
        edit=_pbr_edit, corpus=data["pbr_train"], trainer_cls=PBRTrainer,
        val_launches=PBR_PER_PASS, g_launches=lambda n: PBR_PER_STEP,
        val_root=data["pbr_val"], niter=SHORT_NITER,
        resume_niter=SHORT_RESUME).items()}


def _pbr_kernels_vs_plain(smi: str) -> None:
    """The block kernels against their plain versions at P, TF32 off: one
    block forward and backward in bf16 (``_compare_block``, the kernel
    phase's tolerances); the f32 G gradient of one PBR step (b 8, 32 ->
    128 px, the four maps, latent noise off) on the kernels against the
    same step on the plain versions, each tensor within 3e-3 of its own
    largest gradient, as phase 12's; 276 backward launches on the
    kernels, none on the plain versions. Eager calls."""
    import torch

    from trainner_tpu_torch.train.sr_trainer import create_trainer

    gen = torch.Generator().manual_seed(23)
    ws, bs = _block_weights(gen)
    bs = [b.cuda() for b in bs]
    x = (torch.randn(*PBR_P, NF, generator=gen) * 0.5).cuda()
    g_out = torch.randn(*PBR_P, NF, generator=gen).cuda()
    _compare_block(PBR_P, torch.bfloat16, x, g_out, ws, bs, "pbr: ")

    trainer = create_trainer({**_pbr_options(noise=False), "use_amp": False},
                             graphs=False)
    state = trainer.init_state(2)
    _gain_weights(state.g.net, seed=3)
    batch = _pbr_batch(90)
    keys = tuple(trainer.map_keys(batch))

    def grads():
        # an update at learning rate 0: the gradients stay on .grad
        trainer._pbr_step(state, batch, 0.0, 0.0, map_keys=keys)
        torch.cuda.synchronize()
        return {k: p.grad.clone() for k, p in
                state.g.net.named_parameters() if p.grad is not None}

    before = _counted()["rdb5c_bwd"]
    got = grads()
    ran = _counted()["rdb5c_bwd"] - before
    with _plain_blocks():
        ref = grads()
    worst, worst_name, top = 0.0, "", 0.0
    for k, r in ref.items():
        scale = float(r.abs().max())
        top = max(top, scale)
        ratio = float((got[k] - r).abs().max()) / max(scale, 1e-30)
        if ratio > worst:
            worst, worst_name = ratio, k
    print(f"pbr: full G f32 gradient of one PBR step (b=8, 32 -> 128 px, "
          f"maps {keys}), kernels vs plain: worst relative error "
          f"{worst:.3e} ({worst_name}), tol 3.000e-03, largest gradient "
          f"{top:.3e} over {len(ref)} tensors; backward block launches "
          f"{ran} on the kernels, {_counted()['rdb5c_bwd'] - before - ran} "
          f"on the plain versions ({smi})")
    if not (worst <= 3e-3 and top > 0 and math.isfinite(top)) or \
            set(got) != set(ref) or ran != PBR_PER_STEP or \
            _counted()["rdb5c_bwd"] - before != ran:
        raise AssertionError(f"pbr G gradient: {worst} at {worst_name}, "
                             f"{ran} launches")
    del trainer, state
    torch.cuda.empty_cache()


def _steps_report(label: str, unequal, ms, graphs: dict, want: int,
                  smi: str) -> None:
    """Prints a graphed-against-eager run (``_graphed_vs_eager``) and its
    step times; raises where a tensor or log differs or the graphs are
    not ``want``."""
    rep = sorted(ms["graphed"][1:])[len(ms["graphed"][1:]) // 2]
    eag = sorted(ms["eager"][1:])[len(ms["eager"][1:]) // 2]
    print(f"zoo rest: {label}: {len(ms['graphed'])} steps graphed "
          f"({len(graphs)} programs, launches recorded "
          f"{[c.launches for c in graphs.values()]}) against eager: "
          f"{len(unequal)} tensors or logs differ")
    print(f"times: {label} train_step, ms per step (first: eager + "
          f"capture; then replays), graphed "
          f"{[round(v, 3) for v in ms['graphed']]}, eager "
          f"{[round(v, 3) for v in ms['eager']]}; median after the first "
          f"graphed {rep:.3f}, eager {eag:.3f} ({smi})")
    if unequal or len(graphs) != want:
        raise AssertionError(f"{label} graphs: {unequal[:6]}, "
                             f"{list(graphs)}")


def _pbr_graphed_vs_eager(smi: str) -> None:
    """The PBR cell's step at full width (bf16, b 8, 32 -> 128 px, the
    latent noise on): graphed against eager from one state, bit for bit
    under deterministic cuDNN, ``ZOO_REST_GRAPH_STEPS`` steps; the graph
    records 276 block forwards and 276 backwards."""
    import torch

    unequal, ms, trainers, states = _graphed_vs_eager(
        _pbr_options(), [_pbr_batch(70 + i)
                         for i in range(ZOO_REST_GRAPH_STEPS)], "pbr",
        (PBR_PER_STEP, PBR_PER_STEP))
    graphs = trainers["graphed"].step_graphs()
    _steps_report("pbr bf16 b=8 32 -> 128 px, 4 maps", unequal, ms, graphs,
                  1, smi)
    cap = next(iter(graphs.values()))
    if (cap.launches["rdb5c"], cap.launches["rdb5c_bwd"]) != (
            PBR_PER_STEP, PBR_PER_STEP):
        raise AssertionError(f"pbr graph launches {cap.launches}")
    del trainers, states
    torch.cuda.empty_cache()


def _witness_report(label: str, r: dict, smi: str) -> None:
    """``_steps_card_cpu_f64``'s reading by net, held as ``_i2i_f64``
    holds it: each tensor of the card no further from its witness than
    ``I2I_F64_TOL`` times the CPU f32's largest distance in the same net,
    or ``I2I_F64_FLOOR`` of its move, or ``I2I_F64_ABS`` outright; logs
    within 1e-4 relative, card against CPU."""
    bad = []
    for net in sorted({k.split(".")[0] for k in r["card_f64"]}):
        cc, f64, cpu = (_worst(r[key], net + ".") for key in
                        ("card_cpu", "card_f64", "cpu_f64"))
        tol = max(I2I_F64_TOL * cpu[0], I2I_F64_FLOOR)
        print(f"zoo rest: {label}, {net}'s tensors as a share of their "
              f"move: card vs CPU up to {cc[0]:.3e} ({cc[1]}); against each "
              f"side's f64 witness: card {f64[0]:.3e} ({f64[1]}, "
              f"{r['abs_card'].get(f64[1], 0):.2e} absolute; tol "
              f"{tol:.3e}), CPU f32 {cpu[0]:.3e} ({cpu[1]}) ({smi})")
        bad += [(k, v, tol, r["abs_card"].get(k))
                for k, v in r["card_f64"].items()
                if k.startswith(net + ".") and not v <= tol
                and not r["abs_card"].get(k, 1.0) <= I2I_F64_ABS]
    print(f"zoo rest: {label}, logs card vs CPU within {r['logs']:.3e} "
          f"relative (tol 1e-4); branches that differ, card against CPU, "
          f"{r['flips']} of {r['records']} records")
    if bad or not r["logs"] <= 1e-4:
        raise AssertionError(f"{label} f64: {bad[:6]}, logs {r['logs']}")


def _pbr_f64(smi: str) -> None:
    """One f32 SGD step of the cut PBR cell (nb ``PBR_F64_NB``, nf 64, gc
    32; b 2, 8 -> 32 px; the latent noise off, C 9) on the card
    (graphed), the CPU and an f64 witness of each side that replays that
    side's branches of both loss stacks (the blocks' LeakyReLUs run in the
    kernels on the card): ``_witness_report``."""
    import torch

    opt = _pbr_options(noise=False, optim_G="sgd", lr_G=1e-2)
    opt["network_G"]["nb"] = PBR_F64_NB
    r = _steps_card_cpu_f64(
        "pbr", opt, [_pbr_batch(80, ZOO_F64_B, 8, "cpu")], graphs=1,
        branches=lambda st, tr: [tr.loss_3ch, tr.loss_1ch], lr=1e-2)
    _witness_report(f"pbr one f32 SGD step (cut: nb {PBR_F64_NB}, b "
                    f"{ZOO_F64_B})", r, smi)
    torch.cuda.empty_cache()


def _pbr_serve(smi: str, root: str, data: dict) -> dict:
    """The test CLI on the validation materials (a ``pbr`` set, crop
    ``PBR_SERVE_CROP``) with the CLI's G of ``SHORT_RESUME``: 69 block
    forwards per material at b=1 from the trace, PSNR on the primary map;
    G's f32 output on the first material's LR on the card (the kernels),
    on the card with the plain blocks and on the CPU, against an f64
    witness of the CPU's net: the plain blocks' card output within 1e-5
    of the output's size; each block on the kernels equal bit for bit to
    the kernels' arithmetic emulated on its witness input
    (``_pbr_block_trace``: what the kernels compute is the mma's
    arithmetic as phase 2 finds it, and no other error); the kernels'
    output within 1e-5 of its size of the CPU's (ROADMAP C 27: the f32
    tile adds each k-step's mma sum to its running sum rounded to
    nearest, so the blocks' errors no longer lean one way and add up over
    the 69 blocks)."""
    import torch

    from trainner_tpu_torch import test as test_cli
    from trainner_tpu_torch.data import create_dataset
    from trainner_tpu_torch.options.config import parse_dict
    from trainner_tpu_torch.train.sr_trainer import create_trainer

    with open(os.path.join(root, "cli_pbr_options.json")) as f:
        cli_opt = json.load(f)
    g_file = os.path.join(root, "cli_pbr", "experiments", cli_opt["name"],
                          "models", f"{SHORT_RESUME}_G.ckpt")
    ds = {"name": "materials", "mode": "pbr", "dataroot_HR": data["pbr_val"],
          "crop_size": PBR_SERVE_CROP}
    opt = {"name": "serve_pbr", "model": "pbr", "scale": 4,
           "datasets": {"test_1": ds}, "network_G": cli_opt["network_G"],
           "path": {"root": os.path.join(root, "serve_pbr"),
                    "pretrain_model_G": g_file}}
    path = os.path.join(root, "serve_pbr.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    t0 = time.perf_counter()
    t, averages = _retried_trace(
        lambda: test_cli.main(["-opt", path]),
        {"rdb5c": PBR_PER_PASS * N_VAL, "rdb5c_bwd": 0, "blur": 0},
        label="serve pbr")
    wall = time.perf_counter() - t0
    psnr = [m["average"] for m in averages["materials"]
            if m["name"] == "psnr"]
    parsed = dict(parse_dict(opt, is_train=False))
    lr = torch.from_numpy(create_dataset(
        {**ds, "phase": "test", "scale": 4})[0]["LR"][None])
    outs, recs = {}, {}
    for side, dev in (("cuda", "cuda"), ("plain", "cuda"), ("cpu", "cpu")):
        tr = create_trainer(parsed, device=dev, graphs=False)
        st = tr.init_state(0, g_file)
        with _plain_blocks() if side == "plain" else \
                contextlib.nullcontext(), \
                _block_records(st.g.net) as recs[side]:
            outs[side] = tr.eval_step(st, lr).cpu()
        if side == "cuda":
            card_net = st.g.net
    net64 = _f64_net(st.g.net)
    with _in_f64() as f32_ops, torch.inference_mode(), \
            _block_records(net64) as recs["f64"]:
        exact = net64(lr.double())
    if f32_ops:
        raise AssertionError(f"pbr witness f32 ops {set(f32_ops)}")
    r = _witness_reading(outs, exact)
    print(f"zoo rest: pbr served by the test CLI from {SHORT_RESUME}_"
          f"G.ckpt: {N_VAL} materials at b=1 (LR {PBR_SERVE_CROP // 4} px) "
          f"in {wall:.2f} s (set-up included; traced, the card ran "
          f"{t['ran']}); PSNR {psnr}; G's f32 output, max|ref| "
          f"{r['size']:.3e}: card vs CPU {r['card_cpu']:.3e} "
          f"({r['card_cpu'] / r['size']:.3e} of it); against the f64 "
          f"witness card {r['card']:.3e} ({r['card'] / r['cpu']:.2f}x the "
          f"CPU's), card with the plain blocks {r['plain']:.3e} "
          f"({r['plain'] / r['cpu']:.2f}x), CPU f32 {r['cpu']:.3e} "
          f"({smi})")
    _pbr_block_trace(recs, card_net, smi)
    print(f"zoo rest: pbr serving: plain blocks {r['plain'] / r['size']:.3e}"
          f" of the size from the witness (tol 1e-5); kernels against the "
          f"CPU {r['card_cpu'] / r['size']:.3e} of the size (tol 1e-5, "
          f"ROADMAP C 27)")
    if not (psnr and math.isfinite(psnr[0])) or \
            not r["plain"] <= 1e-5 * r["size"] or \
            not r["card_cpu"] <= 1e-5 * r["size"] or \
            not math.isfinite(r["card"]):
        raise AssertionError(f"pbr serving: {psnr}, {r}")
    torch.cuda.empty_cache()
    return {"serve pbr": t}


@contextlib.contextmanager
def _block_records(net):
    """Records each residual dense block's input and output (NCHW, f64 on
    the CPU) while ``net`` runs, in the order the blocks ran; yields the
    list."""
    from trainner_tpu_torch.models.rrdb import ResidualDenseBlock5C

    recs = []

    def hook(mod, inp, out):
        recs.append((inp[0].detach().double().cpu(),
                     out.detach().double().cpu()))

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, ResidualDenseBlock5C)]
    try:
        yield recs
    finally:
        for h in handles:
            h.remove()


def _pbr_block_trace(recs: dict, card_net, smi: str,
                     dev: str = "cuda") -> None:
    """The served G's error block by block against the f64 witness
    (``recs``: each side's block inputs and outputs, ``_block_records``):
    chained (each side on its own inputs) and local (each block on the
    witness's input rounded to f32), on the kernels and the plain blocks
    on the card and the plain blocks on the CPU, each as a share of the
    block's output size; the local errors' bias (their sum against the
    sign of the witness's 0.2 conv5, its output less its input, over
    their absolute sum: 0 for rounding to nearest, -1 where every error
    shrinks the conv's sum); every block's kernel output on its witness
    input equal bit for bit to ``rdb_forward_emulated`` of it (all blocks
    side by side); then the block of the largest local kernel error
    forward and backward at b=1, 32 x 32 with its trained weights: the
    backward against the plain version at the kernel tolerances, the
    forward equal to its emulation bit for bit (the f32 forward's 1e-4
    was set at values of size 5, and a trained block's run to 40: its
    distance from the plain version is printed) (``_compare_block``).
    ``dev`` is the card's device."""
    import copy

    import torch

    from trainner_tpu_torch.models.rrdb import ResidualDenseBlock5C

    exact = recs["f64"]
    n = len(exact)
    blocks = [m for m in card_net.modules()
              if isinstance(m, ResidualDenseBlock5C)]
    if n != len(blocks) or any(len(v) != n for v in recs.values()):
        raise AssertionError(f"pbr trace: {n} witness blocks, "
                             f"{ {k: len(v) for k, v in recs.items()} }")
    size = [float(o.abs().max()) for _, o in exact]
    sides = ("cuda", "plain", "cpu")
    chained = {s: [float((recs[s][i][1] - exact[i][1]).abs().max()) / size[i]
                   for i in range(n)] for s in sides}
    local = {s: [] for s in sides}
    bias = {s: [] for s in sides}
    ctxs = {"cuda": contextlib.nullcontext, "plain": _plain_blocks,
            "cpu": contextlib.nullcontext}
    cpu_blocks = [copy.deepcopy(b).cpu() for b in blocks]
    kernel_out = []
    for s in sides:
        with ctxs[s](), torch.inference_mode():
            for i, (x, y) in enumerate(exact):
                blk = cpu_blocks[i] if s == "cpu" else blocks[i]
                xi = x.float().to(device="cpu" if s == "cpu" else dev,
                                  memory_format=torch.channels_last)
                got = blk(xi)
                if s == "cuda":
                    kernel_out.append(got.permute(0, 2, 3, 1))
                err = got.double().cpu() - y
                local[s].append(float(err.abs().max()) / size[i])
                bias[s].append(float((err * (y - x).sign()).sum()
                                     / err.abs().sum().clamp(min=1e-300)))
    t0 = time.perf_counter()
    with torch.inference_mode():
        packs = [b.packed(torch.float32) for b in blocks]
        emulated = rdb_forward_emulated(
            torch.stack([x.float().permute(0, 2, 3, 1) for x, _ in
                         exact]).to(dev),
            [torch.stack([p[0][k] for p in packs]) for k in range(5)],
            [torch.stack([p[1][k] for p in packs]) for k in range(5)])
    unequal = [i for i in range(n)
               if not torch.equal(kernel_out[i], emulated[i])]
    emu_s = time.perf_counter() - t0
    with torch.inference_mode():
        # the tile before C 27's repair, each mma straight onto the sum
        one_way = rdb_forward_emulated(
            torch.stack([x.float().permute(0, 2, 3, 1) for x, _ in
                         exact]).to(dev),
            [torch.stack([p[0][k] for p in packs]) for k in range(5)],
            [torch.stack([p[1][k] for p in packs]) for k in range(5)],
            one_way=True)
    bias["one-way"] = []
    for i, (x, y) in enumerate(exact):
        err = one_way[i].permute(0, 3, 1, 2).double().cpu() - y
        bias["one-way"].append(float((err * (y - x).sign()).sum()
                                     / err.abs().sum().clamp(min=1e-300)))
    fmt = lambda v: "[" + ", ".join(f"{e:.2e}" for e in v) + "]"  # noqa
    for s in sides:
        print(f"pbr trace: {s}: chained {fmt(chained[s])}")
        print(f"pbr trace: {s}: local {fmt(local[s])}")
        print(f"pbr trace: {s}: local bias "
              f"[{', '.join(f'{e:.2f}' for e in bias[s])}]")
    print(f"pbr trace: one-way emulation (the tile before C 27's repair): "
          f"local bias [{', '.join(f'{e:.2f}' for e in bias['one-way'])}]")
    med = lambda v: sorted(v)[len(v) // 2]  # noqa
    ratio = [k / max(p, 1e-30) for k, p in zip(local["cuda"], local["cpu"])]
    worst = max(range(n), key=lambda i: local["cuda"][i])
    print(f"pbr trace: {n} blocks at b=1, 32 x 32, f32: local error, "
          f"kernels over the CPU's: median {med(ratio):.2f}x (from "
          f"{min(ratio):.2f} to {max(ratio):.2f}); local bias median "
          f"kernels {med(bias['cuda']):.2f} (one-way emulation "
          f"{med(bias['one-way']):.2f}), plain on the card "
          f"{med(bias['plain']):.2f}, CPU {med(bias['cpu']):.2f}; chained "
          f"at the last block: kernels {chained['cuda'][-1]:.3e}, plain "
          f"{chained['plain'][-1]:.3e}, CPU {chained['cpu'][-1]:.3e}; the "
          f"largest local kernel error at block {worst} "
          f"({local['cuda'][worst]:.3e}); the kernels against their "
          f"emulation (TF32_MMA, {emu_s:.1f} s): {n - len(unequal)} of {n} "
          f"blocks equal bit for bit ({smi})")
    if unequal:
        raise AssertionError(f"pbr trace: blocks {unequal[:8]} differ from "
                             f"the kernels' emulated arithmetic")
    blk = blocks[worst]
    ws = [c.weight.detach().float() for c in blk.convs()]
    bs = [c.bias.detach().float().to(dev) for c in blk.convs()]
    x = exact[worst][0].float().permute(0, 2, 3, 1).contiguous().to(dev)
    g_out = torch.randn(x.shape, generator=torch.Generator().manual_seed(
        24)).to(dev)
    with torch.inference_mode():
        exact_fwd = rdb_forward_emulated(x, *blk.packed(torch.float32),
                                         return_residuals=True)
    _compare_block(tuple(x.shape[:3]), torch.float32, x, g_out, ws, bs,
                   f"pbr served block {worst}: ", exact_forward=exact_fwd)


def _zoo_rest_cli(smi: str, root: str, label: str, opt: dict, files: tuple,
                  cls) -> dict:
    """The training CLI on ``opt`` at full width for ``ZOO_REST_NITER``
    iterations under a launch trace (no kernel of the repo may run),
    checkpoints (``files`` and ``.state``) at the end; then a resume to
    ``ZOO_REST_RESUME`` whose loaded state equals the saved one bit for
    bit, traced too. Prints the steady it/s (steps 3 on, the saves taken
    out) and returns both traces."""
    import torch

    from trainner_tpu_torch.train import cli
    from trainner_tpu_torch.utils import checkpoint

    opt["train"]["niter"] = ZOO_REST_NITER
    opt["logger"] = {"print_freq": 2, "save_checkpoint_freq": CLI_SAVE_FREQ}
    opt["path"] = {**(opt.get("path") or {}),
                   "root": os.path.join(root, f"cli_{label}")}
    path = os.path.join(root, f"{label}_cli.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    exp = os.path.join(opt["path"]["root"], "experiments", opt["name"])
    rec = {"steps": [], "other": []}
    orig = (cls.train_step, checkpoint.save_checkpoint,
            checkpoint.load_state)

    def train_step(self, state, batch):
        out = orig[0](self, state, batch)
        rec["steps"].append(time.perf_counter())
        return out

    def save(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig[1](*args, **kwargs)
        rec["other"].append((t0, time.perf_counter() - t0))

    def load_state(p, state):
        state, meta = orig[2](p, state)
        rec["loaded"] = (meta, _cell_tensors(state))
        return state, meta

    def main():
        rec["steps"].clear()
        rec["other"].clear()
        return cli.main(["-opt", path])

    cls.train_step = train_step
    checkpoint.save_checkpoint = save
    checkpoint.load_state = load_state
    try:
        t0 = time.perf_counter()
        trace, state = _retried_trace(main, {}, label=f"{label} cli")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps, other = list(rec["steps"]), list(rec["other"])
        saved = _cell_tensors(state)
        del state
        torch.cuda.empty_cache()
        opt["train"]["niter"] = ZOO_REST_RESUME
        opt["path"]["resume_state"] = _resume_state(exp, ZOO_REST_NITER)
        with open(path, "w") as f:
            json.dump(opt, f)
        t1 = time.perf_counter()
        trace2, state2 = _retried_trace(main, {}, label=f"{label} resume")
        wall2 = time.perf_counter() - t1
    finally:
        (cls.train_step, checkpoint.save_checkpoint,
         checkpoint.load_state) = orig
    span = steps[-1] - steps[2]
    inside = sum(d for t, d in other if steps[2] <= t < steps[-1])
    n = len(steps) - 3
    meta, loaded = rec["loaded"]
    diff = [k for k in saved if not (
        torch.equal(saved[k], loaded[k]) if isinstance(saved[k],
                                                       torch.Tensor)
        else saved[k] == loaded[k])]
    have = {os.path.relpath(os.path.join(d, f), exp)
            for d, _, fs in os.walk(exp) for f in fs}
    need = {f"models/{t}_{n_}.ckpt" for t in (ZOO_REST_NITER,
                                              ZOO_REST_RESUME)
            for n_ in files} | {f"training_state/{t}.state" for t in
                                (ZOO_REST_NITER, ZOO_REST_RESUME)}
    rows = [json.loads(line) for line in
            open(os.path.join(exp, "tb", "scalars.jsonl"))]
    ds = opt["datasets"]["train"]
    print(f"zoo rest: {label} CLI ({opt['network_G']}; batch "
          f"{ds['batch_size']}, crop {ds['crop_size']}) {ZOO_REST_NITER} "
          f"iterations in {wall:.1f} s (traced; the card ran "
          f"{trace['ran']}), the resume to {state2.step} in {wall2:.1f} s "
          f"(the card ran {trace2['ran']}): {len(saved)} tensors and counts "
          f"of the saved state, {len(diff)} differ after loading; "
          f"{len(rows)} JSONL scalars")
    print(f"times: {label} CLI steps 3-{ZOO_REST_NITER} on the host clock: "
          f"{n / (span - inside):.4f} it/s steady, {n / span:.4f} it/s "
          f"with the save ({smi})")
    if diff or meta["iter"] != ZOO_REST_NITER or \
            state2.step != ZOO_REST_RESUME or need - have or not all(
                math.isfinite(r["value"]) for r in rows):
        raise AssertionError(f"zoo rest {label} cli: differs {diff[:4]}, "
                             f"missing {sorted(need - have)[:4]}")
    del state2
    torch.cuda.empty_cache()
    return {f"{label} cli": trace, f"{label} resume": trace2}


def _dvd_options(root: str, data: dict) -> dict:
    """``train_deinterlace.yml`` as written (nf 64, b 16, crop 128, cb
    pixel loss, bf16) with its frames on ``data``."""
    opt = read_options_yml(DVD_TRAIN_YML)
    opt["datasets"]["train"].update(dataroot_HR=data["dvd"], n_workers=4)
    return opt


def _dvd_batch(seed: int, b: int = 16, px: int = 128,
               device: str = "cuda") -> dict:
    import torch

    gen = torch.Generator().manual_seed(seed)
    top, bottom = (torch.rand(b, px, px, 3, generator=gen)
                   for _ in range(2))
    x = top.clone()
    x[:, 1::2] = bottom[:, 1::2]
    return {k: v.to(device) for k, v in (("in", x), ("top", top),
                                         ("bottom", bottom))}


def _dvd_graphed_vs_eager(smi: str, root: str, data: dict) -> None:
    """DVD's template step (bf16, b 16, 128 px) graphed against eager bit
    for bit, ``ZOO_REST_GRAPH_STEPS`` steps."""
    from trainner_tpu_torch.options.config import parse_dict

    opt = parse_dict(_dvd_options(root, data), is_train=True)
    unequal, ms, trainers, states = _graphed_vs_eager(
        opt, [_dvd_batch(60 + i) for i in range(ZOO_REST_GRAPH_STEPS)],
        "dvd")
    _steps_report("dvd bf16 b=16 128 px", unequal, ms,
                  trainers["graphed"].step_graphs(), 1, smi)


def _wbc_graphed_vs_eager(smi: str, root: str, data: dict) -> None:
    """WBC's template step (bf16, b 16, 256 px) graphed against eager bit
    for bit, ``ZOO_REST_GRAPH_STEPS`` steps, the pools' images too."""
    import torch

    from trainner_tpu_torch.options.config import parse_dict

    opt = parse_dict(_wbc_options(root, data), is_train=True)
    unequal, ms, trainers, states = _graphed_vs_eager(
        opt, [_wbc_batch(60 + i) for i in range(ZOO_REST_GRAPH_STEPS)],
        "wbc")
    for pool in ("fake_s_pool", "fake_t_pool"):
        a, b = (getattr(trainers[k], pool) for k in ("graphed", "eager"))
        if a.count != b.count or not torch.equal(a.images[:a.count],
                                                 b.images[:b.count]):
            unequal.append(pool)
    _steps_report("wbc bf16 b=16 256 px", unequal, ms,
                  trainers["graphed"].step_graphs(), 2, smi)


def _dvd(smi: str, root: str, data: dict) -> dict:
    """DVD on ``train_deinterlace.yml``: the CLI (``ZOO_REST_NITER`` and a
    resume to ``ZOO_REST_RESUME``; no kernel of the repo); three steps
    graphed against eager bit for bit (bf16, b 16, 128 px); G's f32
    forward card against CPU within 1e-5 (b 1, 128 px, both frames); one
    f32 SGD step at b ``ZOO_F64_B``, 32 px, against an f64 witness that
    replays each side's ReLUs (cuDNN's convs: ``branches="all"``); the
    test CLI on a copy of ``test_deinterlace.yml`` whose set names
    ``dataroot_HR`` (the shipped one raises here, as the JAX dataset
    does): each result with its ``{i}_bottom.png``."""
    import torch

    from trainner_tpu_torch import test as test_cli
    from trainner_tpu_torch.data import create_dataset
    from trainner_tpu_torch.options.config import parse_dict
    from trainner_tpu_torch.options.defaults import get_network_G_config
    from trainner_tpu_torch.train.dvd_trainer import DVDTrainer

    traces = _zoo_rest_cli(smi, root, "dvd", _dvd_options(root, data),
                           ("G",), DVDTrainer)
    opt = parse_dict(_dvd_options(root, data), is_train=True)
    _dvd_graphed_vs_eager(smi, root, data)
    cfg = get_network_G_config(dict(opt["network_G"]), 1)
    _card_vs_cpu_forward("dvd_net", {"network_G": cfg}, (1, 128, 128, 3),
                         (torch.float32,), tag="zoo rest")
    f64 = dict(parse_dict({
        "name": "dvd_f64", "model": "dvd", "scale": 1,
        "network_G": dict(read_options_yml(DVD_TRAIN_YML)["network_G"]),
        "path": {"root": "/nonexistent"},
        "train": {**opt["train"], "optim_G": "sgd", "lr_G": 1e-2}},
        is_train=True))
    r = _steps_card_cpu_f64("dvd", f64, [_dvd_batch(80, ZOO_F64_B, 32,
                                                    "cpu")],
                            graphs=1, branches="all", lr=1e-2)
    _witness_report(f"dvd one f32 SGD step (b {ZOO_F64_B}, 32 px)", r, smi)

    shipped = read_options_yml(DVD_TEST_YML)
    try:
        create_dataset({**shipped["datasets"]["test_1"], "phase": "test"})
        raise AssertionError("the shipped test_deinterlace.yml served")
    except ValueError as e:
        print(f"zoo rest: the shipped test_deinterlace.yml (dataroot_LR "
              f"alone) raises as the JAX dataset does: {e}")
    serve = dict(shipped)
    serve["datasets"] = {"test_1": {**shipped["datasets"]["test_1"],
                                    "dataroot_HR": data["dvd_serve"]}}
    serve["datasets"]["test_1"].pop("dataroot_LR")
    exp = os.path.join(root, "cli_dvd", "experiments",
                       read_options_yml(DVD_TRAIN_YML)["name"])
    serve["path"] = {"root": os.path.join(root, "serve_dvd"),
                     "pretrain_model_G": os.path.join(
                         exp, "models", f"{ZOO_REST_RESUME}_G.ckpt")}
    path = os.path.join(root, "serve_dvd.json")
    with open(path, "w") as f:
        json.dump(serve, f)
    t0 = time.perf_counter()
    t, _ = _retried_trace(lambda: test_cli.main(["-opt", path]), {},
                          label="serve dvd")
    wall = time.perf_counter() - t0
    pngs = sorted(f for _, _, fs in os.walk(os.path.join(root, "serve_dvd"))
                  for f in fs if f.endswith(".png"))
    bottoms = [f for f in pngs if f.endswith("_bottom.png")]
    print(f"zoo rest: dvd served by the test CLI (2 frame pairs of "
          f"{CORPUS_PX} px) in {wall:.2f} s (set-up included; the card ran "
          f"{t['ran']}): {pngs} ({smi})")
    if bottoms != ["0_bottom.png", "1_bottom.png"] or len(pngs) != 4:
        raise AssertionError(f"dvd serving: {pngs}")
    traces["serve dvd"] = t
    torch.cuda.empty_cache()
    return traces


def _wbc_options(root: str, data: dict) -> dict:
    """``train_wbc.yml`` as written (nf 32; PatchGAN ndf 32, 2 layers,
    spectral norm; b 16, crop 256; lsgan; VGG19 ``fea`` on structure and
    content; ``tv``; 200 segments; bf16) with A the corpus and B the
    second corpus."""
    opt = read_options_yml(WBC_TRAIN_YML)
    opt["datasets"]["train"].update(dataroot_A=data["wbc_a"],
                                    dataroot_B=data["wbc_b"], n_workers=4)
    return opt


def _wbc_batch(seed: int, b: int = 16, px: int = 256,
               device: str = "cuda") -> dict:
    """Photos and cartoons in [0, 1] from a seed: smooth fields."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k in ("A", "B"):
        base = torch.rand(b, 3, px // 16 + 2, px // 16 + 2, generator=gen)
        img = torch.nn.functional.interpolate(
            base, size=(px, px), mode="bicubic", align_corners=False)
        out[k] = (img + 0.05 * torch.rand(img.shape, generator=gen)).clamp(
            0, 1).permute(0, 2, 3, 1).contiguous().to(device)
    return out


@contextlib.contextmanager
def _wbc_shared_structure():
    """The f64 witnesses of WBC steps take the structure representation
    that their side computed (it is a target, of a detached input, from an
    argmin over distances that rounding may tip): the CPU f32 step's and
    the eager card step's results are kept, and the f64 steps of that
    step take them in the order ``_steps_card_cpu_f64`` runs them (the
    card's witness, then the CPU's)."""
    import torch

    from trainner_tpu_torch.train.wbc_trainer import WBCTrainer

    orig = WBCTrainer._structure
    kept = {}

    def structure(self, fake_b, gamma):
        if self.dtype == torch.float64:
            side = "card" if "card" in kept else "cpu"
            return kept.pop(side).to(torch.float64)
        out = orig(self, fake_b, gamma)
        if self.device.type == "cpu":
            kept.clear()
            kept["cpu"] = out.detach().clone()
        elif not self.graphs:
            kept["card"] = out.detach().cpu()
        return out

    WBCTrainer._structure = structure
    try:
        yield
    finally:
        WBCTrainer._structure = orig


def _wbc(smi: str, root: str, data: dict) -> dict:
    """WBC on ``train_wbc.yml``: the CLI (``ZOO_REST_NITER`` and a resume
    to ``ZOO_REST_RESUME``; no kernel of the repo);
    three steps graphed against eager bit for bit (bf16, b 16, 256 px: the
    G and the D stage's graphs, the pools alike); one f32 SGD step at b
    ``ZOO_F64_B``, 64 px against an f64 witness that replays each side's
    branches of every net and of the loss stack, with the card's draws
    and each side's own structure representation; SLIC at b 2, 256 px,
    200 segments card against CPU by the share of pixels that differ
    (``SHARE_TOL``, as C 17); ``mode: tf``'s G card against CPU within
    1e-5; one ``sp_exact`` step (b 2, ``WBC_SP_EXACT_PX`` px) on the card
    (its G stage eager) against the CPU; the test CLI at 256 px."""
    import torch

    from trainner_tpu_torch import test as test_cli
    from trainner_tpu_torch.options.config import parse_dict
    from trainner_tpu_torch.options.defaults import get_network_G_config
    from trainner_tpu_torch.ops.superpixel import slic_segment_mean
    from trainner_tpu_torch.train.sr_trainer import create_trainer
    from trainner_tpu_torch.train.wbc_trainer import WBCTrainer

    traces = _zoo_rest_cli(smi, root, "wbc", _wbc_options(root, data),
                           ("G", "D_S", "D_T"), WBCTrainer)
    opt = parse_dict(_wbc_options(root, data), is_train=True)
    _wbc_graphed_vs_eager(smi, root, data)

    small = dict(parse_dict({
        "name": "wbc_f64", "model": "wbc", "scale": 1, "pool_size": 50,
        "network_G": dict(read_options_yml(WBC_TRAIN_YML)["network_G"]),
        "network_D": dict(read_options_yml(WBC_TRAIN_YML)["network_D"]),
        "path": {"root": "/nonexistent"},
        "train": {**read_options_yml(WBC_TRAIN_YML)["train"],
                  "optim_G": "sgd", "optim_D": "sgd", "lr_G": 1e-2,
                  "lr_D": 1e-2}}, is_train=True))
    with _wbc_shared_structure():
        r = _steps_card_cpu_f64("wbc", small, [_wbc_batch(
            80, ZOO_F64_B, 64, "cpu")], graphs=2, share_draws=True,
            branches="all", lr=1e-2)
    _witness_report(f"wbc one f32 SGD step (b {ZOO_F64_B}, 64 px)", r, smi)

    x = _wbc_batch(81, 2, 256, "cpu")["A"]
    got = slic_segment_mean(x.cuda(), 200, 5).cpu()
    want = slic_segment_mean(x, 200, 5)
    share = float(((got - want).abs().amax(-1) > 1e-5).float().mean())
    print(f"zoo rest: SLIC (200 segments, 5 iterations) b=2 256 px card vs "
          f"CPU: share of pixels off by more than 1e-5 {share:.4%} (tol "
          f"{SHARE_TOL:.0%})")
    if not share <= SHARE_TOL:
        raise AssertionError(f"wbc slic: {share}")
    cfg = get_network_G_config({"type": "wbcunet_tf", "nf": 32}, 1)
    _card_vs_cpu_forward("wbcunet mode tf", {"network_G": cfg},
                         (1, 256, 256, 3), (torch.float32,), tag="zoo rest")

    # sp_exact: the host's superpixels inside the step, card against CPU
    exact = {**small, "use_amp": False,
             "train": {**small["train"], "sp_exact": True}}
    sides, sps, draws = {}, {}, {}
    for dev in ("cpu", "cuda"):
        tr = create_trainer(exact, device=dev)
        st = tr.init_state(0)
        orig = tr._host_superpixels
        tr._host_superpixels = (lambda imgs, d=dev, o=orig:
                                sps.setdefault(d, o(imgs)))
        if dev == "cuda":
            tr.draw_hook = lambda shapes: {k: (
                {c: t.cuda() for c, t in v.items()} if isinstance(v, dict)
                else v.cuda()) for k, v in draws.items()}
        else:
            base = tr._draws

            def record(state, shapes, base=base):
                out = base(state, shapes)
                draws.update(out)
                return out
            tr._draws = record
        batch = _wbc_batch(82, ZOO_F64_B, WBC_SP_EXACT_PX, dev)
        logs = tr.train_step(st, batch)[1]
        sides[dev] = ({k: float(v) for k, v in logs.items()}, tr)
    diff = (sps["cuda"].cpu() - sps["cpu"]).abs().amax(-1)
    sp_share = float((diff > 1e-5).float().mean())
    worst = max(abs(v - sides["cpu"][0][k]) / max(abs(sides["cpu"][0][k]),
                                                  1e-3)
                for k, v in sides["cuda"][0].items())
    stage = sides["cuda"][1]._step_fns
    eager_g = not hasattr(stage[("g",)], "entries")
    graphed_d = hasattr(stage[("d",)], "entries")
    print(f"zoo rest: wbc sp_exact step (b {ZOO_F64_B}, {WBC_SP_EXACT_PX} "
          f"px, f32) card vs CPU: the host superpixels differ on "
          f"{sp_share:.4%} of the pixels (tol {SHARE_TOL:.0%}), logs within "
          f"{worst:.3e} relative (tol 1e-3); the card's G stage eager "
          f"{eager_g}, its D stage a graph {graphed_d}")
    if not (sp_share <= SHARE_TOL and worst <= 1e-3 and eager_g
            and graphed_d):
        raise AssertionError(f"wbc sp_exact: {sp_share}, {worst}")
    del sides

    exp = os.path.join(root, "cli_wbc", "experiments",
                       read_options_yml(WBC_TRAIN_YML)["name"])
    serve = {"name": "serve_wbc", "model": "wbc", "scale": 1,
             "datasets": {"test_1": {"name": "photos", "mode": "single",
                                     "dataroot_LR": data["wbc_serve"]}},
             "network_G": opt["network_G"],
             "path": {"root": os.path.join(root, "serve_wbc"),
                      "pretrain_model_G": os.path.join(
                          exp, "models", f"{ZOO_REST_RESUME}_G.ckpt")}}
    path = os.path.join(root, "serve_wbc.json")
    with open(path, "w") as f:
        json.dump(serve, f)
    t0 = time.perf_counter()
    t, _ = _retried_trace(lambda: test_cli.main(["-opt", path]), {},
                          label="serve wbc")
    wall = time.perf_counter() - t0
    pngs = [f for _, _, fs in os.walk(os.path.join(root, "serve_wbc"))
            for f in fs if f.endswith(".png")]
    print(f"zoo rest: wbc served by the test CLI ({N_VAL} photos of "
          f"{CORPUS_PX} px) in {wall:.2f} s (set-up included; the card ran "
          f"{t['ran']}) ({smi})")
    if len(pngs) != N_VAL:
        raise AssertionError(f"wbc serving: {pngs}")
    traces["serve wbc"] = t
    torch.cuda.empty_cache()
    return traces


def _zoo_rest_rates(smi: str) -> None:
    """Each G's forward at b=1 on the card by CUDA events, f32 (TF32 off)
    and bf16, in Mpx/s of output: PBR's ``rrdb_net`` at 64 -> 256 px (69
    blocks on the kernels), ``dvd_net`` at 256 px (both frames), the WBC
    U-Net at 256 px."""
    import torch

    from trainner_tpu_torch.models import define_G
    from trainner_tpu_torch.options.defaults import get_network_G_config

    gen = torch.Generator().manual_seed(84)
    for name, cfg, scale, px in (
            ("pbr rrdb_net", {"type": "rrdb_net"}, 4, 64),
            ("dvd_net", {"type": "dvd_net"}, 1, 256),
            ("wbcunet_net", {"type": "wbcunet_net"}, 1, 256)):
        x = torch.rand(1, px, px, 3, generator=gen).cuda()
        spec = {"network_G": get_network_G_config(cfg, scale)}
        line = []
        for dt in (torch.float32, torch.bfloat16):
            net = define_G(spec, dt)
            net.init_weights(torch.Generator().manual_seed(0))
            net = net.cuda().eval()
            with torch.inference_mode():
                ms = _time_ms(lambda: net(x), iters=10, warmup=3)
            mpx = (px * scale) ** 2 / 1e6 / (ms / 1e3)
            line.append(f"{str(dt).replace('torch.', '')} {ms:.3f} ms "
                        f"({mpx:.3f} Mpx/s)")
            del net
        print(f"times: {name} forward b=1 {px} -> {px * scale} px: "
              f"{', '.join(line)} ({smi})")
    torch.cuda.empty_cache()


def phase_zoo_rest(smi: str, root: str) -> dict:
    """Phase 23: the rest of the zoo. PBR on the block kernels at full
    width (``train_sr.yml``'s G, nf 64, nb 23, gc 32, as ``model: pbr``:
    b 8, crop 128, bf16, pixel L1 and VGG19 feature L1, four maps):
    the training CLI (6 iterations and a resume to 8: 276 block
    forwards and 276 backwards per step, 69 forwards per validation
    material), the kernels against their plain versions at P, three
    steps graphed against eager, the f64 witness, the test CLI; DVD
    (``_dvd``) and WBC (``_wbc``) on their templates, where no kernel of
    the repo runs; each G's forward rate. Returns the traces."""
    import torch

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    data = _zoo_rest_data(root)
    traces, parts = {}, [f"{time.perf_counter() - t0:.1f}"]
    for part in (lambda: traces.update(_pbr_cli(smi, root, data)),
                 lambda: _pbr_kernels_vs_plain(smi),
                 lambda: _pbr_graphed_vs_eager(smi),
                 lambda: _pbr_f64(smi),
                 lambda: traces.update(_pbr_serve(smi, root, data)),
                 lambda: traces.update(_dvd(smi, root, data)),
                 lambda: traces.update(_wbc(smi, root, data)),
                 lambda: _zoo_rest_rates(smi)):
        t1 = time.perf_counter()
        part()
        parts.append(f"{time.perf_counter() - t1:.1f}")
    print(f"zoo rest: ok in {time.perf_counter() - t0:.1f} s (data, PBR CLI, "
          f"kernels vs plain, graphs, f64, serving; DVD; WBC; rates: "
          f"{', '.join(parts)} s) ({smi})")
    return traces


def phase_graphs(smi: str, root: str) -> None:
    """The programs as CUDA graphs against the same programs run eagerly
    (``graphs=False``), in one process: the step (bf16, f32) with its
    recorded launches against a profiler trace of one replay and the
    latent noise of a replay; a resume after capture; ``train_steps``; the
    degrader; ``eval_step``, x8 and chop; the test CLI on images of mixed
    sizes."""
    t0 = time.perf_counter()
    parts = []
    for part in (lambda: _graph_step(smi), lambda: _graph_resume(smi, root),
                 lambda: _graph_window(smi),
                 lambda: _graph_degrader(smi, root),
                 lambda: _graph_serving(smi),
                 lambda: _graph_mixed_sizes(smi, root)):
        t1 = time.perf_counter()
        part()
        parts.append(f"{time.perf_counter() - t1:.1f}")
    print(f"graphs: ok in {time.perf_counter() - t0:.1f} s (step, resume, "
          f"window, degrader, serving, mixed sizes: "
          f"{', '.join(parts)} s) ({smi})")


PAR_STEPS, PAR_TIMED = 3, 5    # phase 24 (a): steps compared, timed
#   (10 timed until phase 25's time cut)
PAR_SPLIT = 16                  # (b): the global batch of 32 as 16 + 16
# (b): a gradient that the one-process step itself moves by more when
# its batch comes in another order (of PAR_REORDERS orders) is held to
# PAR_REORDER_X times that move: one order's move is a single draw of the
# rounding, 0.47-1.0x the 16 + 16 split's in the first runs
PAR_REORDERS, PAR_REORDER_X = 2, 3.0
# (b): faults planted in the two ranks' step, each of which the check
# must reject (``_par_fault``)
PAR_FAULTS = ("batch norm per rank", "relativistic means per rank",
              "D's gradient not averaged")
BAND_PX, N_BANDS, BAND_HALO = 512, 4, 32   # (d): the served LR image


@contextlib.contextmanager
def _group_of_one():
    """A one-rank NCCL process group in this process (an in-process
    store) and its ``(data: 1)`` mesh; the group is destroyed after."""
    import torch
    import torch.distributed as dist

    from trainner_tpu_torch.parallel import mesh as M

    dev = torch.device("cuda", 0)
    M.init_distributed(dev)
    try:
        yield M.make_mesh(M.MeshConfig(data=1), device=dev)
    finally:
        dist.destroy_process_group()


def _par_nccl_step(smi: str) -> dict:
    """Phase 24 (a): the flagship GAN step (b 32, 32 -> 128 px, bf16,
    graphed) on a one-rank NCCL group against the same step with no
    group, from the same state and batches, ``PAR_STEPS`` steps (the
    first eager and captured, the others replays): every tensor of the
    state and every log bit for bit (cuDNN deterministic: its atomics
    would differ between any two runs); then one more replay under a
    launch trace (69 block forwards and 69 backwards on the kernels);
    the all-reduces issued into the capture counted (``collectives.issued``;
    a replay issues none from Python); then both timed in turns. Returns
    the trace."""
    import torch

    from trainner_tpu_torch.parallel import collectives as C
    from trainner_tpu_torch.train.sr_trainer import create_trainer

    per_g = NB * 3
    batches = [_train_batch(seed=s) for s in range(PAR_STEPS)]
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain = create_trainer(_train_options())
        ps = plain.init_state(0)
        for b in batches:
            ps, plogs = plain.train_step(ps, b)
        with _group_of_one() as mesh:
            tr = create_trainer(_train_options(), mesh=mesh)
            st = tr.init_state(0)
            issued = [C.issued]
            for b in batches:
                st, logs = tr.train_step(st, b)
                issued.append(C.issued)
            torch.cuda.synchronize()
            # the first step runs eagerly and then captures: each issues
            # the step's collectives once; a replay issues none
            per_step = (issued[1] - issued[0]) // 2
            replayed = [b - a for a, b in zip(issued[1:], issued[2:])]
            want, got = _state_tensors(ps), _state_tensors(st)
            unequal = [k for k, v in want.items()
                       if not (torch.equal(v, got[k])
                               if isinstance(v, torch.Tensor)
                               else v == got[k])]
            log_diff = {k: (float(plogs[k]), float(logs[k])) for k in plogs
                        if not torch.equal(plogs[k], logs[k])}
            # a replay of the captured step, traced
            t, _ = _retried_trace(
                lambda: tr.train_step(st, batches[0]),
                {"rdb5c": per_g, "rdb5c_bwd": per_g}, fresh=False,
                label="parallel: one-rank NCCL step")
            ms = {"no group": [], "one-rank NCCL group": []}
            for _ in range(2):
                for name, (trn, state) in (("no group", (plain, ps)),
                                           ("one-rank NCCL group",
                                            (tr, st))):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(PAR_TIMED):
                        trn.train_step(state, batches[0])
                    torch.cuda.synchronize()
                    ms[name].append((time.perf_counter() - t0)
                                    / PAR_TIMED * 1e3)
            graphs = len(tr.step_graphs())
            del tr, st
    finally:
        torch.backends.cudnn.deterministic = prev
    print(f"parallel: (a) the flagship GAN step bf16 b=32 graphed on a "
          f"one-rank NCCL group: {PAR_STEPS} steps, {len(want)} state "
          f"tensors, {len(unequal)} differ from the step with no group, "
          f"logs differing {log_diff}; {per_step} all-reduces captured "
          f"into the step's graph ({graphs} graph(s); the replays issued "
          f"{replayed} from Python); a traced replay: the card ran "
          f"{t['ran']} ({per_g} + {per_g} per step) and {t['nccl']} NCCL "
          f"kernels (an all-reduce in place over one rank launches none); "
          f"times in turns, ms per step: "
          f"{ {k: [round(v, 3) for v in vs] for k, vs in ms.items()} } "
          f"({smi})")
    if unequal or log_diff or per_step <= 0 or any(replayed) or \
            (issued[1] - issued[0]) % 2:
        raise AssertionError(f"parallel (a): {unequal[:8]} {log_diff} "
                             f"collectives {issued}")
    del plain, ps
    torch.cuda.empty_cache()
    return t


def _par_grad_options() -> dict:
    """Phase 24 (b)'s step: the flagship's in f32, G's latent noise off,
    as phase 12's f32 gradient check runs it (with G's weights at gain
    0.7, ``_gain_weights``): at init most of G's gradients are 1e-7 to
    1e-11 of the largest, sums of rounding that any other order of the
    same sums moves by 1e-2 of their size."""
    opt = {**_train_options(), "use_amp": False}
    opt["network_G"] = {**opt["network_G"], "gaussian_noise": False}
    return opt


@contextlib.contextmanager
def _par_fault(name: str, d_params):
    """One of ``PAR_FAULTS`` planted in this process's step while the
    context is open: D's batch norms on this rank's statistics (their
    ``batch_mean`` the identity), the relativistic loss's means over this
    rank's samples (likewise), or D's gradients left unaveraged
    (``average_grads`` skipped for ``d_params``)."""
    from trainner_tpu_torch.losses import gan
    from trainner_tpu_torch.ops import blocks
    from trainner_tpu_torch.train import sr_trainer

    if name == PAR_FAULTS[0]:
        mod, attr, fn = blocks, "batch_mean", lambda x: x
    elif name == PAR_FAULTS[1]:
        mod, attr, fn = gan, "batch_mean", lambda x: x
    elif name == PAR_FAULTS[2]:
        whole = sr_trainer.average_grads
        ids = {id(p) for p in d_params}

        def fn(params):
            params = list(params)
            if not any(id(p) in ids for p in params):
                whole(params)
        mod, attr = sr_trainer, "average_grads"
    else:
        raise ValueError(name)
    kept = getattr(mod, attr)
    setattr(mod, attr, fn)
    try:
        yield
    finally:
        setattr(mod, attr, kept)


def _par_rank(store: str, rank: int, out: str) -> int:
    """One rank of phase 24 (b), in a process of its own: a gloo group of
    two on the one card, the flagship's f32 step (eager, TF32 off) on
    this rank's 16 of the 32 samples, from the same state, once sound and
    once with each of ``PAR_FAULTS`` planted; rank 0 saves G's and D's
    averaged gradients and the logs of each."""
    import torch
    import torch.distributed as dist

    from trainner_tpu_torch.parallel import mesh as M
    from trainner_tpu_torch.train.sr_trainer import create_trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    M.init_distributed(dev, rank=rank, world_size=2,
                       init_method=f"file://{store}", backend="gloo")
    mesh = M.make_mesh(M.MeshConfig(data=2), device=dev)
    tr = create_trainer(_par_grad_options(), graphs=False, mesh=mesh)
    batch = M.shard_batch(_train_batch(seed=7), mesh)
    runs = {}
    for fault in ("sound",) + PAR_FAULTS:
        st = tr.init_state(0)
        _gain_weights(st.g.net, seed=3)
        with contextlib.nullcontext() if fault == "sound" else \
                _par_fault(fault, list(st.d.net.parameters())):
            st, logs = tr.train_step(st, batch)
        runs[fault] = {w: {k: p.grad.cpu() for k, p in
                           getattr(st, w).net.named_parameters()}
                       for w in ("g", "d")}
        runs[fault]["logs"] = {k: float(v) for k, v in logs.items()}
        del st
    if rank == 0:
        torch.save({"runs": runs, "b": int(batch["LR"].shape[0])}, out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _grad_errors(got: dict, net, which: str) -> dict:
    """Each of ``net``'s gradients against ``got`` (name -> tensor on the
    host): the largest difference over the tensor's largest magnitude,
    by ``{which}.{name}``; for D's biases whose gradient is 0 but for
    rounding (a conv's that a batch norm follows, the dense layers')
    over D's largest gradient instead."""
    names = dict(net.named_parameters())
    top = max(float(p.grad.abs().max()) for p in names.values())
    out = {}
    for k, p in names.items():
        ref = p.grad.detach().cpu()
        err = float((got[k] - ref).abs().max())
        noise = which == "d" and k.endswith("bias") and (
            k.startswith("linear")
            or k.replace("bias", "norm.weight") in names)
        size = top if noise else float(ref.abs().max())
        out[f"{which}.{k}"] = err / max(size, 1e-30)
    return out


def _par_two_gloo_ranks(smi: str, root: str) -> None:
    """Phase 24 (b): two processes on the one card over gloo, eager, f32
    with TF32 off, the global batch of 32 split 16 + 16, G at phase 12's
    gain (``_par_grad_options``): the averaged G and D gradients against
    the one-process step's on the whole batch at phase 12's f32 gradient
    tolerance (3e-3 of each tensor's size; D's biases whose gradient is 0
    but for rounding, in front of a batch norm and in the dense layers
    under the relativistic loss, at 3e-3 of D's largest gradient), or,
    for a tensor whose one-process gradient itself moves by more when the
    same batch comes in another order (sums of rounding: at init the
    relativistic loss gives D's logits gradients that are differences of
    near-equal terms), within ``PAR_REORDER_X`` times the larger move of
    ``PAR_REORDERS`` such orders; the logs within 1e-3 relative. The same
    check must reject each of ``PAR_FAULTS`` planted in the ranks' step
    (a tensor over its limit or the logs over theirs). The one-process
    steps run while the ranks do."""
    import torch

    from trainner_tpu_torch.train.sr_trainer import create_trainer

    store = os.path.join(root, "par_store")
    out = os.path.join(root, "par_grads.pt")
    t0 = time.perf_counter()
    procs = _rank_processes(root, "par", [
        "--par-store", store, "--par-out", out])

    def one_process(order=None):
        tr = create_trainer(_par_grad_options(), graphs=False)
        st = tr.init_state(0)
        _gain_weights(st.g.net, seed=3)
        batch = _train_batch(seed=7)
        if order is not None:
            batch = {k: v[order] for k, v in batch.items()}
        st, logs = tr.train_step(st, batch)
        grads = {w: {k: p.grad.detach().cpu() for k, p in
                     getattr(st, w).net.named_parameters()}
                 for w in ("g", "d")}
        return st, logs, grads

    # the same step on the batch in two other orders: the same function,
    # its sums in other orders, which read each gradient's own rounding
    perm = torch.Generator().manual_seed(24)
    try:
        agains = [one_process(torch.randperm(TRAIN_SHAPE[0],
                                             generator=perm))[2]
                  for _ in range(PAR_REORDERS)]
        st, logs1, _ = one_process()
    finally:
        logs = [_rank_log(p) for p in procs]
    wall = time.perf_counter() - t0
    for (p, _), log in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"parallel (b): a rank failed:\n"
                                 f"{log[-3000:]}")
    saved = torch.load(out, weights_only=False)
    runs = saved["runs"]
    spread = {}
    for w in ("g", "d"):
        net = getattr(st, w).net
        for again in agains:
            for k, v in _grad_errors(again[w], net, w).items():
                spread[k] = max(spread.get(k, 0.0), v)
    readings = {name: _par_reading(run, st, logs1, spread)
                for name, run in runs.items()}
    worst, over, ratio, log_err = readings["sound"]
    name = max(worst, key=worst.get)
    n_over = sum(1 for k in worst if worst[k] > 3e-3)
    faults = "; ".join(
        f"{f}: {readings[f][2]:.3f}, {len(readings[f][1])} tensors over, "
        f"logs {readings[f][3]:.3e}" for f in PAR_FAULTS)
    print(f"parallel: (b) two gloo ranks on the one card, f32 eager, b "
          f"{saved['b']} + {saved['b']} = 32: averaged gradients against "
          f"the one-process step's, worst {worst[name]:.3e} of the "
          f"tensor's size ({name}; the one-process step on the batch "
          f"reordered moves it by up to {spread[name]:.3e}), tol 3e-3 or "
          f"{PAR_REORDER_X}x the larger of {PAR_REORDERS} reorders' moves; "
          f"{n_over} of {len(worst)} tensors past 3e-3, all within that; "
          f"the largest reorder move "
          f"{max(spread.values()):.3e} ({max(spread, key=spread.get)}); "
          f"logs within {log_err:.2e} relative; the largest error over "
          f"its limit {ratio:.3f}; planted faults (the largest error over "
          f"its limit, the tensors over it, the logs' relative error): "
          f"{faults}; the ranks' wall, the one-process steps beside them, "
          f"{wall:.1f} s ({smi})")
    missed = [f for f in PAR_FAULTS
              if not readings[f][1] and readings[f][3] <= 1e-3]
    if saved["b"] != PAR_SPLIT or over or log_err > 1e-3 or missed:
        raise AssertionError(f"parallel (b): {sorted(over.items())[:6]}, "
                             f"logs {log_err}, faults not rejected "
                             f"{missed}")
    del st
    torch.cuda.empty_cache()


def _rank_processes(root: str, tag: str, args: list) -> list:
    """Two ranks of this script (``--par-rank 0`` and ``1`` with ``args``)
    started in processes of their own, each writing its output to a file
    under ``root`` (a pipe would fill while the caller works beside
    them)."""
    procs = []
    for r in range(2):
        log = open(os.path.join(root, f"{tag}_rank{r}.log"), "w+b")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--par-rank",
             str(r)] + args, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _rank_log(proc) -> str:
    """Waits for a (process, log file) pair of ``_rank_processes`` and
    returns the process's output."""
    p, log = proc
    p.wait(timeout=600)
    log.seek(0)
    text = log.read().decode(errors="replace")
    log.close()
    return text


def _par_reading(run: dict, st, logs1: dict, spread: dict) -> tuple:
    """Phase 24 (b)'s reading of one two-rank run (``run``: G's and D's
    gradients and the logs) against the one-process step (``st``'s
    gradients, ``logs1``): each tensor's error (``_grad_errors``), those
    over their limit (3e-3, or ``PAR_REORDER_X`` times ``spread``, the
    reorders' move) with their move, the largest error over its limit,
    and the logs' largest relative error."""
    worst = {}
    for w in ("g", "d"):
        worst.update(_grad_errors(run[w], getattr(st, w).net, w))
    limit = {k: max(3e-3, PAR_REORDER_X * spread[k]) for k in worst}
    over = {k: (v, spread[k]) for k, v in worst.items() if v > limit[k]}
    ratio = max(v / limit[k] for k, v in worst.items())
    log_err = max(abs(run["logs"][k] - float(v)) / max(abs(float(v)), 1e-3)
                  for k, v in logs1.items())
    return worst, over, ratio, log_err


def _par_bands(smi: str) -> dict:
    """Phase 24 (d): the flagship G (random weights from seed 0) served
    in f32 on one LR image of ``BAND_PX`` x ``BAND_PX`` in ``N_BANDS``
    bands on the one card, halo ``BAND_HALO``: the rows beyond halo x
    scale from the outer edges within 1e-5 of the output's size of the
    whole-image ``eval_step``, the edge rows' difference printed; every
    band's 69 blocks on the kernel (a trace); both times; G's effective
    radius. Returns the trace."""
    import torch

    from trainner_tpu_torch.parallel.spatial import effective_radius
    from trainner_tpu_torch.train.sr_trainer import create_trainer

    per_g = NB * 3
    tr = create_trainer({"is_train": False, "scale": 4, "network_G": {
        "type": "rrdb_net", "nf": NF, "nb": NB, "gc": GC, "upscale": 4}})
    st = tr.init_state(0)
    x = torch.rand(1, BAND_PX, BAND_PX, 3,
                   generator=torch.Generator().manual_seed(24)).cuda()
    devs = [torch.device("cuda", 0)] * N_BANDS
    whole = tr.eval_step(st, x)
    t, bands = _retried_trace(
        lambda: tr.eval_step_spatial(st, x, devs, halo=BAND_HALO),
        {"rdb5c": per_g * N_BANDS, "rdb5c_bwd": 0, "blur": 0},
        label="parallel: bands")
    edge = BAND_HALO * 4
    size = float(whole.abs().max())
    inner = float((bands - whole)[:, edge:-edge].abs().max()) / size
    outer = float((bands - whole).abs().max()) / size
    ms_whole = _time_ms(lambda: tr.eval_step(st, x), iters=3, warmup=1)
    ms_bands = _time_ms(lambda: tr.eval_step_spatial(
        st, x, devs, halo=BAND_HALO), iters=3, warmup=1)
    small = x[:, :128, :128]
    radius = {rtol: effective_radius(lambda v: tr.eval_step(st, v), small,
                                     rtol=rtol, scale=4)
              for rtol in (1e-3, 1e-4)}
    band = BAND_PX // N_BANDS
    print(f"parallel: (d) the flagship G f32 on a {BAND_PX} x {BAND_PX} LR "
          f"image in {N_BANDS} bands of {band} rows on the one card, halo "
          f"{BAND_HALO}: rows beyond {edge} of the outer edges "
          f"{inner:.3e} of the output's size (max|y| {size:.3e}) from the "
          f"whole-image eval_step (tol 1e-5), the edge rows {outer:.3e}; "
          f"the card ran {t['ran']} ({per_g} per band); whole "
          f"{ms_whole:.2f} ms, bands {ms_bands:.2f} ms "
          f"({ms_bands / ms_whole:.3f}x; (band + 2 halo) / band = "
          f"{(band + 2 * BAND_HALO) / band:.3f}); G's effective radius at "
          f"128 x 128 (rtol: rows) {radius} ({smi})")
    if inner > 1e-5 or not math.isfinite(outer) or \
            tuple(bands.shape) != tuple(whole.shape):
        raise AssertionError(f"parallel (d): interior {inner}")
    del tr, st, whole, bands
    torch.cuda.empty_cache()
    return t


def phase_parallel(smi: str, root: str) -> dict:
    """Phase 24: several GPUs' paths on the one card at full width
    (RRDBNet nf 64, nb 23, gc 32; D-VGG-128; the flagship's losses):
    (a) a one-rank NCCL group's graphed step bit for bit against the step
    with no group (``_par_nccl_step``); (b) two gloo ranks' averaged
    gradients against one process's (``_par_two_gloo_ranks``); (c) the
    training CLI on ``train_sr.yml`` with ``parallel: {data: 1}``, resumed
    by the CLI without ``parallel:`` (the blur kernel runs in its
    degradations): in a whole run the cli phase's run (12 iterations and
    a resume to 14, ``P24_CLI``), alone 6 and a resume to 8; (d) band
    serving (``_par_bands``). Returns the traces."""
    import torch

    t0 = time.perf_counter()
    traces, parts = {}, []

    def cli():
        if P24_CLI:
            print(f"parallel: (c) the cli phase's run of train_sr.yml ran "
                  f"with parallel: {{data: 1}} and resumed without it: "
                  f"{ {k: v['ran'] for k, v in P24_CLI.items()} }")
            return
        traces.update({f"parallel cli {k}": v for k, v in phase_cli(
            smi, root, TRAIN_YML, "cli_parallel", edit=_par_data_edit,
            niter=6, resume_niter=8, resume_edit=_par_drop_edit).items()})

    for part in (lambda: traces.update({"parallel nccl step":
                                        _par_nccl_step(smi)}),
                 lambda: _par_two_gloo_ranks(smi, root), cli,
                 lambda: traces.update({"parallel bands":
                                        _par_bands(smi)})):
        t1 = time.perf_counter()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        part()
        parts.append(f"{time.perf_counter() - t1:.1f}")
    ran = {k: sum(t["ran"][k] for t in traces.values())
           for k in ("rdb5c", "rdb5c_bwd", "blur")}
    print(f"parallel: kernels {json.dumps(ran)} (launches the card ran in "
          f"phase 24's traces)")
    print(f"parallel: ok in {time.perf_counter() - t0:.1f} s (NCCL step, "
          f"gloo ranks, CLI, bands: {', '.join(parts)} s) ({smi})")
    return traces


# the flagship CLI's traces where the cli phase ran it with parallel:
# {data: 1} (phase 24 (c)'s check in a whole run)
P24_CLI = {}
P25_CYC_B, P25_POOL, P25_CYC_STEPS = 4, 4, 2   # (b): CycleGAN's global
#   batch, its pools and its steps (the second swaps: the first fills)
P25_CYC_PX = 128           # (b): its crop (the template's 256, cut)
P25_PBR_B = 8              # (b): PBR's global batch (four maps, LR 32 px)
# (b): faults planted in the two ranks' steps, one a model, each of which
# the check must reject (``_p25_fault``)
P25_FAULTS = {"cyclegan": "pool queried with the local batch",
              "pbr": "PBR's held draw per rank, no sample_draw"}
P25_DL_BATCHES = 2         # (d): the batches test_dataloader dumps


# phase 25 (a)'s models, with the helper of phases 20-23 that runs each
# one's graphed step against eager (and its twin on the group)
P25_MODELS = ("cyclegan", "sftgan", "sofvsr", "srflow", "srflow_interop",
              "pbr", "dvd", "wbc")
# phase 25's state across phases: while ``on`` (``_p25_group``) the
# graphed-vs-eager checks of ``P25_MODELS`` run a twin on a one-rank group;
# its readings (``rows``) and traced replays (``traces``) by model, and the
# video CLI's traces (``cli``) where phase 21 ran it on a group
P25_GROUP = {"on": False, "rows": {}, "traces": {}, "cli": None}


@contextlib.contextmanager
def _p25_group():
    """The graphed-vs-eager checks of ``P25_MODELS`` run their twins on a
    one-rank group while the body runs (``_GroupTwin``)."""
    P25_GROUP["on"] = True
    try:
        yield
    finally:
        P25_GROUP["on"] = False


class _GroupTwin:
    """Phase 25 (a)'s third run of a graphed-vs-eager check: while
    ``P25_GROUP`` is on, a model of ``P25_MODELS`` runs the same steps
    graphed on a one-rank NCCL group of its own (``_group_of_one``, open
    until ``close``) from its own ``init_state(0)``, each step after the
    graphed one with no group, and every log and state tensor (the image
    pools' too, ``_p25_tensors``) must equal that one's bit for bit; it
    counts the collectives each step issued and, with ``per`` (its block
    launches per step, forward and backward), replays its step once more
    under a launch trace. Inactive otherwise."""

    def __init__(self, name: str, opt: dict, per=None):
        from trainner_tpu_torch.train.sr_trainer import create_trainer

        self.on = P25_GROUP["on"] and name in P25_MODELS
        self.group = None
        if not self.on:
            return
        self.name, self.per = name, per
        self.group = _group_of_one()
        mesh = self.group.__enter__()
        self.trainer = create_trainer(opt, mesh=mesh)
        self.state = self.trainer.init_state(0)
        self.unequal, self.issued, self.ms, self.ref_ms = [], [], [], []

    def close(self) -> None:
        """Frees the twin's graphs, then its group (NCCL does not destroy
        a communicator that a live graph holds)."""
        import gc

        import torch

        if self.group is None:
            return
        self.trainer = self.state = None
        gc.collect()
        torch.cuda.synchronize()
        group, self.group = self.group, None
        group.__exit__(None, None, None)
        torch.cuda.empty_cache()

    def step(self, batch, trainer, state, logs, ref_ms: float) -> None:
        import torch

        from trainner_tpu_torch.parallel import collectives as C

        if not self.on:
            return
        before = C.issued
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = self.trainer.train_step(self.state, batch)[1]
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.ref_ms.append(ref_ms)
        self.issued.append(C.issued - before)
        i = len(self.ms) - 1
        want = _p25_tensors(trainer, state)
        have = _p25_tensors(self.trainer, self.state)
        self.unequal += [(i, k) for k, v in want.items() if not (
            torch.equal(v, have[k]) if isinstance(v, torch.Tensor)
            else v == have[k])]
        self.unequal += [(i, k) for k, v in logs.items()
                         if not torch.equal(v, got[k])]
        self.tensors = len(want)

    def finish(self, batch) -> None:
        import torch

        if not self.on:
            return
        row = {"tensors": self.tensors, "unequal": self.unequal[:6],
               "n_unequal": len(self.unequal), "issued": self.issued,
               "graphs": len(self.trainer.step_graphs()),
               "ms": [round(v, 2) for v in self.ms],
               "ms_no_group": [round(v, 2) for v in self.ref_ms]}
        if self.per is not None:
            gf, gb = self.per
            t, _ = _retried_trace(
                lambda: self.trainer.train_step(self.state, batch),
                {"rdb5c": gf, "rdb5c_bwd": gb, "blur": 0}, fresh=False,
                label=f"parallel models: {self.name}")
            P25_GROUP["traces"][self.name] = t
            row["ran"] = t["ran"]
        P25_GROUP["rows"][self.name] = row
        self.close()


def _p25_tensors(trainer, state) -> dict:
    """The step and every tensor of a model's state (each net's
    state_dict and optimizer state, as ``_cell_tensors`` reads them) and
    its image pools' stored images, cloned on the card."""
    out = {"step": state.step}
    for w, ns in _net_states(state):
        for k, v in ns.net.state_dict().items():
            out[f"{w}.{k}"] = v.detach().clone()
        for key, v in ns.opt.state_dict().items():
            if isinstance(v, int):
                out[f"{w}.{key}"] = v
            else:
                for i, t in enumerate(v):
                    out[f"{w}.{key}.{i}"] = t.detach().clone()
    for name in ("fake_a_pool", "fake_b_pool", "fake_s_pool",
                 "fake_t_pool"):
        pool = getattr(trainer, name, None)
        if pool is not None and pool.images is not None:
            out[name] = pool.images[:pool.count].detach().clone()
    return out


def _p25_nccl_steps(smi: str, root: str) -> dict:
    """Phase 25 (a): each model of ``P25_MODELS`` graphed on a one-rank
    NCCL group and with no group, in turns, from the same seeds, bit for
    bit (``_GroupTwin``, the third run of its graphed-vs-eager check of
    phases 20-23: CycleGAN, SFTGAN, SOF-VSR, PBR, DVD and WBC 3 steps,
    SRFlow 4 across its unfreeze at 2, the interop net 2 across it at 1);
    a traced replay runs PBR's 276 + 276 block launches, SOF-VSR's 69 +
    69, SRFlow's 23 + 23 (interop 69 + 69). Where phases 20-23 did not run
    with the group open (``--only 25``), their checks of these models run
    here under it. Prints each model's reading; returns the traces."""
    import torch

    missing = [m for m in P25_MODELS if m not in P25_GROUP["rows"]]
    if missing:
        none = {k: "/nonexistent" for k in (
            "A", "B", "seg", "val", "val_seg", "train", "dvd", "wbc_a",
            "wbc_b")}
        checks = {
            "cyclegan": lambda: _i2i_graphed_vs_eager(smi, root, none,
                                                      "cyclegan"),
            "sftgan": lambda: _i2i_graphed_vs_eager(smi, root, none,
                                                    "sftgan"),
            "sofvsr": lambda: _vsr_graphed_vs_eager(smi, root, none),
            "srflow": lambda: _srflow_graphed_vs_eager(smi, root, False),
            "srflow_interop": lambda: _srflow_graphed_vs_eager(smi, root,
                                                               True),
            "pbr": lambda: _pbr_graphed_vs_eager(smi),
            "dvd": lambda: _dvd_graphed_vs_eager(smi, root, none),
            "wbc": lambda: _wbc_graphed_vs_eager(smi, root, none)}
        with _p25_group():
            for m in missing:
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
                checks[m]()
    rows = P25_GROUP["rows"]
    bad = {}
    for m in P25_MODELS:
        r = rows[m]
        print(f"parallel models: (a) {m}: graphed on a one-rank NCCL group "
              f"against graphed with no group, {len(r['ms'])} steps in "
              f"turns: {r['tensors']} state tensors, {r['n_unequal']} differ "
              f"or logs; collectives issued per step {r['issued']} (the "
              f"first eager and captured; CycleGAN's and WBC's pools gather "
              f"eagerly between the stages); {r['graphs']} graph(s); ms per "
              f"step group {r['ms']}, no group {r['ms_no_group']}"
              + (f"; a traced replay ran {r['ran']}" if "ran" in r else "")
              + f" ({smi})")
        if r["n_unequal"] or not r["issued"][0]:
            bad[m] = r["unequal"]
    if bad:
        raise AssertionError(f"parallel models (a): {bad}")
    return {f"parallel models {k}": v for k, v in
            P25_GROUP["traces"].items()}


def _p25_f32_options(name: str, root: str) -> dict:
    """Phase 25 (b)'s options: CycleGAN's template (b ``P25_CYC_B``, crop
    ``P25_CYC_PX``, pools of ``P25_POOL``) or the PBR cell (b
    ``P25_PBR_B``, the latent noise on), in f32."""
    from trainner_tpu_torch.options.config import parse_dict

    if name == "pbr":
        opt = _pbr_options()
        opt["use_amp"] = False
        return opt
    none = {k: "/nonexistent" for k in ("A", "B")}
    opt = _i2i_options(root, none, "cyclegan")
    opt["use_amp"] = False
    opt["pool_size"] = P25_POOL
    opt["datasets"]["train"].update(batch_size=P25_CYC_B,
                                    crop_size=P25_CYC_PX)
    return dict(parse_dict(opt, is_train=True))


def _p25_batches(name: str) -> list:
    """Phase 25 (b)'s global batches, on the card, from seeds."""
    import torch

    if name == "pbr":
        return [_pbr_batch(31, b=P25_PBR_B)]
    out = []
    for s in range(P25_CYC_STEPS):
        gen = torch.Generator(device="cuda").manual_seed(260 + s)
        out.append({k: torch.rand(P25_CYC_B, P25_CYC_PX, P25_CYC_PX, 3,
                                  generator=gen, device="cuda") * 2 - 1
                    for k in "AB"})
    return out


def _p25_nets(state) -> dict:
    """A state's trained nets by field (CycleGAN's G holds G_A and G_B)."""
    return {w: ns.net for w, ns in _net_states(state)}


@contextlib.contextmanager
def _p25_fault(name: str, trainer):
    """``P25_FAULTS[name]`` planted while the context is open: CycleGAN's
    pools queried by each rank with its local fakes alone, or PBR's held
    latent draw made per rank for its own samples (``sample_draw``
    skipped)."""
    from trainner_tpu_torch.ops import blocks

    if name == "cyclegan":
        trainer._pooled = lambda pool, fakes: pool.query(fakes)
        try:
            yield
        finally:
            del trainer._pooled
        return
    kept = blocks.sample_draw
    blocks.sample_draw = lambda draw, n: draw(n)
    try:
        yield
    finally:
        blocks.sample_draw = kept


def _p25_trainer(name: str, root: str, mesh=None):
    """Phase 25 (b)'s trainer of one model (``_p25_f32_options``), eager,
    on ``mesh`` when given; its runs (``_p25_run``) share it."""
    from trainner_tpu_torch.train.sr_trainer import create_trainer

    return create_trainer(_p25_f32_options(name, root), graphs=False,
                          mesh=mesh)


def _p25_run(tr, name: str, fault: bool = False, perm=None) -> dict:
    """Phase 25 (b)'s steps of one model with trainer ``tr``
    (``_p25_trainer``; its pools made anew), f32 eager from
    ``init_state(0)``: on this rank's part of each global batch under
    ``tr``'s mesh, with its fault planted when ``fault``; or in one
    process with the batches' rows in the order ``perm`` (its pools and
    its latent draw kept in the batch's own order, so the function is the
    same and only its sums run in another order). Under deterministic
    cuDNN: its f32 weight gradients' atomics would move CycleGAN's from
    run to run by as much as the reorders do. Returns the last step's
    gradients by net and its logs."""
    import torch

    from trainner_tpu_torch.ops import blocks
    from trainner_tpu_torch.parallel import mesh as M
    from trainner_tpu_torch.utils.image_pool import ImagePool

    mesh = tr.mesh
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    for pool in ("fake_a_pool", "fake_b_pool"):
        if hasattr(tr, pool):
            setattr(tr, pool, ImagePool(P25_POOL))
    st = tr.init_state(0)
    batches = _p25_batches(name)
    kept = blocks.sample_draw
    ctx = _p25_fault(name, tr) if fault else contextlib.nullcontext()
    if perm is not None:
        inv = torch.argsort(perm)
        real = tr._pooled
        tr._pooled = lambda pool, fakes: real(pool, fakes[inv.cuda()])[
            perm.cuda()]
        blocks.sample_draw = lambda draw, n: kept(draw, n)[perm.cuda()]
        batches = [{k: v[perm.cuda()] for k, v in b.items()}
                   for b in batches]
    try:
        with ctx:
            for b in batches:
                if mesh is not None:
                    b = M.shard_batch(b, mesh)
                st, logs = tr.train_step(st, b)
    finally:
        blocks.sample_draw = kept
        vars(tr).pop("_pooled", None)
        cudnn.deterministic, cudnn.benchmark = saved
    out = {w: {k: p.grad.detach().cpu() for k, p in net.named_parameters()
               if p.grad is not None} for w, net in _p25_nets(st).items()}
    out["logs"] = {k: float(v) for k, v in logs.items()}
    swaps = [getattr(tr, p) for p in ("fake_a_pool", "fake_b_pool")
             if hasattr(tr, p)]
    out["pools"] = [p.count for p in swaps]
    del st
    torch.cuda.empty_cache()
    return out


def _p25_rank(store: str, rank: int, out: str, root: str) -> int:
    """One rank of phase 25 (b), in a process of its own: a gloo group of
    two on the one card, each model of ``P25_FAULTS`` sound and with its
    fault planted; rank 0 saves the gradients and logs of each."""
    import torch
    import torch.distributed as dist

    from trainner_tpu_torch.parallel import mesh as M

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    M.init_distributed(dev, rank=rank, world_size=2,
                       init_method=f"file://{store}", backend="gloo")
    mesh = M.make_mesh(M.MeshConfig(data=2), device=dev)
    runs = {}
    for name in P25_FAULTS:
        tr = _p25_trainer(name, root, mesh)
        for fault in (False, True):
            runs[(name, fault)] = _p25_run(tr, name, fault)
        del tr
    if rank == 0:
        torch.save(runs, out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _p25_errors(got: dict, ref: dict) -> dict:
    """Each net's gradients of ``got`` against ``ref`` (field -> name ->
    tensor on the host), as ``_grad_errors`` reads them: the largest
    difference over the tensor's largest magnitude, for a D's bias whose
    gradient is 0 but for rounding (a conv's that a norm follows) over
    that D's largest gradient, by ``{field}.{name}``."""
    out = {}
    for w, grads in ref.items():
        if w in ("logs", "pools"):
            continue
        top = max(float(g.abs().max()) for g in grads.values())
        for k, g in grads.items():
            err = float((got[w][k] - g).abs().max())
            noise = w.startswith("d") and k.endswith("bias") and \
                k.replace("bias", "norm.weight") in grads
            size = top if noise else float(g.abs().max())
            out[f"{w}.{k}"] = err / max(size, 1e-30)
    return out


def _p25_reading(run: dict, ref: dict, spread: dict) -> tuple:
    """Phase 25 (b)'s reading of one two-rank run against the one-process
    step (``ref``), as ``_par_reading`` reads phase 24 (b): each tensor's
    error (``_p25_errors``), the tensors over their limit (3e-3, or
    ``PAR_REORDER_X`` times the reorders' move ``spread``), the largest
    error over its limit and the logs' largest relative error."""
    worst = _p25_errors(run, ref)
    limit = {k: max(3e-3, PAR_REORDER_X * spread[k]) for k in worst}
    over = {k: (v, spread[k]) for k, v in worst.items() if v > limit[k]}
    ratio = max(v / limit[k] for k, v in worst.items())
    log_err = max(abs(run["logs"][k] - v) / max(abs(v), 1e-3)
                  for k, v in ref["logs"].items())
    return worst, over, ratio, log_err


def _p25_two_gloo_ranks(smi: str, root: str) -> None:
    """Phase 25 (b): two processes on the one card over gloo, f32 eager,
    TF32 off: CycleGAN (b ``P25_CYC_B`` split 2 + 2, pools of
    ``P25_POOL``, ``P25_CYC_STEPS`` steps: the second's pools swap) and
    PBR (b ``P25_PBR_B`` split 4 + 4, four maps, one held latent draw):
    the last step's averaged gradients of every net against the
    one-process step's on the global batch under phase 24 (b)'s rule (3e-3
    of each tensor's size, or ``PAR_REORDER_X`` times the larger move of
    ``PAR_REORDERS`` reorders of the batch), the logs within 1e-3; each
    model's fault of ``P25_FAULTS`` planted in the ranks' steps must be
    rejected. The one-process steps run while the ranks do."""
    import torch

    store = os.path.join(root, "p25_store")
    out = os.path.join(root, "p25_grads.pt")
    t0 = time.perf_counter()
    procs = _rank_processes(root, "p25", [
        "--par-store", store, "--par-out", out, "--par-phase", "25",
        "--par-root", root])
    refs = {}
    try:
        for name in P25_FAULTS:
            tr = _p25_trainer(name, root)
            ref = _p25_run(tr, name)
            perm = torch.Generator().manual_seed(25)
            n = P25_PBR_B if name == "pbr" else P25_CYC_B
            spread = {}
            for _ in range(PAR_REORDERS):
                again = _p25_run(tr, name,
                                 perm=torch.randperm(n, generator=perm))
                for k, v in _p25_errors(again, ref).items():
                    spread[k] = max(spread.get(k, 0.0), v)
            refs[name] = (ref, spread)
    finally:
        logs = [_rank_log(p) for p in procs]
    wall = time.perf_counter() - t0
    for (p, _), log in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"parallel models (b): a rank failed:\n"
                                 f"{log[-3000:]}")
    runs = torch.load(out, weights_only=False)
    missed, failed = [], []
    for name, fault_name in P25_FAULTS.items():
        ref, spread = refs[name]
        sound = _p25_reading(runs[(name, False)], ref, spread)
        fault = _p25_reading(runs[(name, True)], ref, spread)
        worst, over, ratio, log_err = sound
        top = max(worst, key=worst.get)
        print(f"parallel models: (b) {name} two gloo ranks on the one card, "
              f"f32 eager: the last step's averaged gradients against the "
              f"one-process step's on the global batch, worst "
              f"{worst[top]:.3e} of the tensor's size ({top}; the reorders "
              f"move it by up to {spread[top]:.3e}), "
              f"{sum(v > 3e-3 for v in worst.values())} of {len(worst)} "
              f"tensors past 3e-3; the largest error over its limit "
              f"{ratio:.3f} (limit 1), logs within {log_err:.2e} (limit "
              f"1e-3); planted fault '{fault_name}': the largest error over "
              f"its limit {fault[2]:.3f}, {len(fault[1])} tensors over, "
              f"logs {fault[3]:.3e}; pools' counts {ref['pools']} "
              f"({smi})")
        if over or log_err > 1e-3:
            failed.append((name, sorted(over.items())[:4], log_err))
        if not fault[1] and fault[3] <= 1e-3:
            missed.append(fault_name)
    print(f"parallel models: (b) the ranks' wall, the one-process steps "
          f"beside them: {wall:.1f} s ({smi})")
    if failed or missed:
        raise AssertionError(f"parallel models (b): {failed}, faults not "
                             f"rejected {missed}")
    torch.cuda.empty_cache()


def _p25_dataloader(smi: str, root: str) -> dict:
    """Phase 25 (d): the port's ``test_dataloader`` on ``train_sr.yml``
    (shuffled bsrgan, b 32, crop 128, the corpus) for ``P25_DL_BATCHES``
    batches on the card under a launch trace, a marker around each
    batch's degradations: 24 blur launches a batch (12 at the HR canvas,
    12 at the LR one), no block; every array described and dumped (b
    PNGs per key and batch). Returns the trace."""
    from trainner_tpu_torch.options import parse
    from trainner_tpu_torch.scripts import test_dataloader as tool

    path = _cli_options(root, os.path.join(root, "corpus"), TRAIN_YML,
                        "dataloader")
    opt = parse(path, is_train=True)
    out = os.path.join(root, "dataloader_vis")
    per = 2 * 2 * SHUFFLE_K
    made = tool.make_otf_degradation

    def marked(*args, **kwargs):
        degrade = made(*args, **kwargs)

        def run(batch):
            _mark()
            out = degrade(batch)
            _mark()
            return out
        return run

    tool.make_otf_degradation = marked
    try:
        t, got = _retried_trace(
            lambda: tool.run(opt, P25_DL_BATCHES, out),
            {"blur": per * P25_DL_BATCHES, "rdb5c": 0, "rdb5c_bwd": 0},
            label="test_dataloader")
    finally:
        tool.make_otf_degradation = made
    per_batch = [s["blur"] for s in t["segments"][1::2]]
    files = sum(len(fs) for _, _, fs in os.walk(out))
    want_files = sum(v.shape[0] for b in got for v in b.values())
    print(f"dataloader: the port's test_dataloader on train_sr.yml, "
          f"{P25_DL_BATCHES} batches of {tuple(got[0]['HR'].shape)} HR / "
          f"{tuple(got[0]['LR'].shape)} LR on the card: blur launches per "
          f"batch {per_batch} (the card ran {t['ran']}); {files} PNGs "
          f"dumped ({smi})")
    if per_batch != [per] * P25_DL_BATCHES or files != want_files:
        raise AssertionError(f"dataloader: {per_batch}, {files} files of "
                             f"{want_files}")
    return {"test_dataloader": t}


def phase_parallel_models(smi: str, root: str) -> dict:
    """Phase 25: every model on the data axis (Queue A 9 d) and the user
    tools (A 12) on the card: (a) each model's graphed step on a one-rank
    NCCL group bit for bit against no group (``_p25_nccl_steps``; in a
    whole run the checks of phases 20-23 make it, ``_GroupTwin``); (b)
    CycleGAN's and PBR's two gloo ranks against one process, each with a
    planted fault rejected (``_p25_two_gloo_ranks``); (c) the training CLI
    on ``train_video.yml`` with ``parallel: {data: 1}`` for
    ``SHORT_NITER`` steps, resumed to ``SHORT_RESUME`` without it, each
    step's launches checked (phase 21's CLI run, ``_vsr_cli_on_a_group``);
    (d) ``test_dataloader`` on the card (``_p25_dataloader``). Returns the
    traces."""
    import torch

    t0 = time.perf_counter()
    traces, parts = {}, []

    def cli():
        # phase 21's CLI run is this check where it ran; its traces count
        # there
        if P25_GROUP["cli"] is None:
            traces.update({f"parallel models {k}": v for k, v in
                           _vsr_cli_on_a_group(smi, root,
                                               _vsr_data(root)).items()})
        else:
            print(f"parallel models: (c) phase 21's video CLI ran with "
                  f"parallel: {{data: 1}} and resumed without it: "
                  f"{ {k: v['ran'] for k, v in P25_GROUP['cli'].items()} }")

    for part in (lambda: traces.update(_p25_nccl_steps(smi, root)),
                 lambda: _p25_two_gloo_ranks(smi, root), cli,
                 lambda: traces.update(_p25_dataloader(smi, root))):
        t1 = time.perf_counter()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        part()
        parts.append(f"{time.perf_counter() - t1:.1f}")
    ran = {k: sum(t["ran"][k] for t in traces.values())
           for k in ("rdb5c", "rdb5c_bwd", "blur")}
    print(f"parallel models: kernels {json.dumps(ran)} (launches the card "
          f"ran in phase 25's traces)")
    print(f"parallel models: ok in {time.perf_counter() - t0:.1f} s (NCCL "
          f"steps, gloo ranks, video CLI, test_dataloader: "
          f"{', '.join(parts)} s) ({smi})")
    return traces


def _later_phases(smi: str, root: str, which: tuple) -> dict:
    """Phases 18 (``phase_producer_rest``), 19 (``phase_models``), 20
    (``phase_i2i``), 21 (``phase_video``), 22 (``phase_srflow``), 23
    (``phase_zoo_rest``), 24 (``phase_parallel``) and 25
    (``phase_parallel_models``) of ``which``, TF32 off before each;
    returns their traces."""
    import torch

    phases = {18: phase_producer_rest, 19: phase_models, 20: phase_i2i,
              21: phase_video, 22: phase_srflow, 23: phase_zoo_rest,
              24: phase_parallel, 25: phase_parallel_models}
    traces = {}
    for n in which:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        # phase 25 (a) rides on phases 20-23's graphed checks
        with _p25_group() if 25 in which and 20 <= n <= 23 else \
                contextlib.nullcontext():
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
                        help="comma-separated phases among 18 to 25: "
                        "build the kernels, write the corpus and run those "
                        "alone (no result line)")
    # one rank of phase 24 (b), started by the phase itself
    parser.add_argument("--par-rank", type=int, default=-1,
                        help=argparse.SUPPRESS)
    parser.add_argument("--par-store", default="", help=argparse.SUPPRESS)
    parser.add_argument("--par-out", default="", help=argparse.SUPPRESS)
    # one rank of phase 25 (b) with these two
    parser.add_argument("--par-phase", type=int, default=24,
                        help=argparse.SUPPRESS)
    parser.add_argument("--par-root", default="", help=argparse.SUPPRESS)
    flags = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if flags.par_rank >= 0 and flags.par_phase == 25:
        return _p25_rank(flags.par_store, flags.par_rank, flags.par_out,
                         flags.par_root)
    if flags.par_rank >= 0:
        return _par_rank(flags.par_store, flags.par_rank, flags.par_out)
    from trainner_tpu_torch.ops import _build, rdb5c

    _time_parts()
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
        _print_parts(smi)
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
        # on a one-rank group, resumed without: phase 24 (c) too
        cli_counts = phase_cli(smi, root, save_breakdown=True,
                               edit=_par_data_edit,
                               resume_edit=_par_drop_edit)
        P24_CLI.update(cli_counts)
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
        cli_counts.update(_later_phases(smi, root,
                                        (18, 19, 20, 21, 22, 23, 24, 25)))
        rows = phase_times(smi, root)
        blur_rows = phase_blur_times(smi, flags.parent)
        phase_trace(smi, root, {k: r["step_ms"] for k, r in train.items()})
    _print_parts(smi)
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
