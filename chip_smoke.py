#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``trainner_tpu_torch``) on one
NVIDIA card.

Phases, each printing lines of its own; any failure ends the run with a
non-zero exit code and no result line:

1. device: the card's name and power limit, and the build of every CUDA
   kernel of the main path from the sources in ``trainner_tpu_torch/csrc``;
2. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, TF32 off, at the main path's shape and at a ragged one;
3. slice: ``python -m trainner_tpu_torch.test`` at the full width of the
   ESRGAN generator (nf 64, nb 23, gc 32, 4x) on a synthetic test set, in
   f32 and with ``use_amp``, counting kernel launches; then the full G on
   the kernel against the same G on the plain version;
4. times: CUDA-event times of each kernel, its plain version, the cuDNN
   five-conv chain as a yardstick, and the G forward at b=8, 128->512 px;
5. trace: one f32 G forward at b=8 under ``torch.profiler``: device time
   by kernel and the device's idle share of the forward's wall time.

The second-to-last lines are a JSON summary of the kernels and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py
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
RAGGED_SHAPE = (3, 37, 53)
NF, GC, NB = 64, 32, 23
N_IMAGES = 3


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


def phase_kernels(smi: str):
    """Kernel against plain version on the card; returns the max abs error
    at the main shape in f32 (the main path's default)."""
    import torch

    from trainner_tpu_torch.ops.rdb5c import (pack_rdb_weights,
                                              rdb5c_forward,
                                              rdb5c_forward_plain)

    gen = torch.Generator().manual_seed(0)
    ws, bs = _block_weights(gen)
    bs = [b.cuda() for b in bs]
    main_err = None
    for shape in (MAIN_SHAPE, RAGGED_SHAPE):
        x = (torch.randn(*shape, NF, generator=gen) * 0.5).cuda()
        for dt in (torch.float32, torch.bfloat16):
            packed = pack_rdb_weights([w.cuda() for w in ws], NF, GC, dt)
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
                print(f"kernels: rdb5c {shape} {dt} {name} max_abs_err "
                      f"{err:.3e} tol {tol:.3e} max|ref| "
                      f"{float(r.float().abs().max()):.3f}")
                if not err <= tol:
                    raise AssertionError(
                        f"rdb5c {shape} {dt} {name}: {err} > {tol}")
                errs.append(err)
            if shape == MAIN_SHAPE and dt == torch.float32:
                main_err = max(errs)
    print(f"kernels: ok ({smi})")
    return main_err


@contextlib.contextmanager
def _plain_blocks():
    """Runs every residual dense block of G through the plain version, for
    the comparison with the kernel on the card."""
    from trainner_tpu_torch.models import rrdb
    from trainner_tpu_torch.ops.rdb5c import rdb5c_forward_plain

    kernel = rrdb.rdb5c_forward
    rrdb.rdb5c_forward = rdb5c_forward_plain
    try:
        yield
    finally:
        rrdb.rdb5c_forward = kernel


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
            kaiming_init_(m.weight, 0.7, gen)
            with torch.no_grad():
                m.bias.normal_(0.0, 0.01, generator=gen)


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


def phase_times(smi: str, root: str, main_err: float, launches: int):
    """CUDA-event times at the main path's shapes; returns the kernel
    summary for the JSON line."""
    import torch

    from trainner_tpu_torch.models import define_G
    from trainner_tpu_torch.models.rrdb import ResidualDenseBlock5C
    from trainner_tpu_torch.ops.rdb5c import (rdb5c_forward,
                                              rdb5c_forward_plain)
    from trainner_tpu_torch.options import parse

    b, h, w = MAIN_SHAPE
    flops = 2 * 9 * (NF * (4 * GC + NF) + GC * (3 * GC + NF)
                     + GC * (2 * GC + NF) + GC * (GC + NF) + GC * NF)
    gen = torch.Generator().manual_seed(2)
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
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
        with torch.inference_mode():
            ms = _time_ms(lambda: rdb5c_forward(x, packed, biases))
            plain_ms = _time_ms(
                lambda: rdb5c_forward_plain(x, packed, biases), iters=5)
            conv_blk = blk.to(dt)
            library_ms = _time_ms(lambda: conv_blk._unfused_forward(x_nchw))
        name = str(dt).replace("torch.", "")
        nbytes = (x.numel() * 2 * x.element_size()
                  + sum(p.numel() * p.element_size() for p in packed)
                  + sum(t.numel() * 4 for t in biases))
        work = flops * b * h * w
        t_ops = work / PEAK_FLOPS[name] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms,
                          bound_by="operations" if t_ops >= t_bytes
                          else "bytes")
        print(f"times: rdb5c {name} b={b} {h}x{w}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, cuDNN 5-conv chain "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({rows[name]['bound_by']}), "
              f"{work / ms / 1e9:.2f} TFLOP/s ({smi})")
        del blk, conv_blk

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

    f32 = rows["float32"]
    return [{"name": "rdb5c_forward", "route": "cuda",
             "source": "trainner_tpu_torch/csrc/rdb5c.cu",
             "replaces": "trainner_tpu/ops/pallas_kernels.py:180",
             "launches": launches, "max_abs_err": main_err,
             "ms": f32["ms"], "plain_ms": f32["plain_ms"],
             "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
             "library_ms": f32["library_ms"]}]


def phase_trace(smi: str, root: str) -> None:
    """Where the G forward's time goes, from a profiler trace of one f32
    forward at b=8, 128->512 px."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from trainner_tpu_torch.models import define_G
    from trainner_tpu_torch.options import parse

    b, h, w = MAIN_SHAPE
    opt = parse(_options(root, name="smoke_trace"), is_train=False)
    net = define_G(opt, dtype=torch.float32)
    net.init_weights(torch.Generator().manual_seed(0))
    net = net.cuda().eval()
    lr = torch.rand(b, h, w, 3, generator=torch.Generator().manual_seed(3)
                    ).cuda()
    with torch.inference_mode():
        net(lr)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            net(lr)
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
              f"is not measured ({smi})")
        return
    print(f"trace: f32 G forward b={b} {h}->{h * 4} px: wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1 - busy_us / wall_us:.4f} ({smi})")
    for name, us in by_name.most_common(8):
        print(f"trace:   {us / 1e3:9.3f} ms {us / max(busy_us, 1):7.2%} "
              f"{calls[name]:4d} x {name}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from trainner_tpu_torch.ops import _build

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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    main_err = phase_kernels(smi)
    with tempfile.TemporaryDirectory() as root:
        launches = phase_slice(smi, root)
        phase_g_compare(smi, root)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        kernels = phase_times(smi, root, main_err, launches)
        phase_trace(smi, root)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
