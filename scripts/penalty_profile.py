#!/usr/bin/env python3
"""Where wgan-gp's D stage spends its device time on one NVIDIA card.

The D stage of ``train_sr.yml`` with the loss stack: ``discriminator_vgg_
128_sn`` (base_nf 64) in bf16 at b=32, 128 px, ``AdversarialLoss(gan_type=
"wgan-gp", gp_weight=10).discriminator_loss`` and its backward (the
penalty's double backward through D). Prints:

* the stage's device time under ``torch.profiler``, with the penalty and
  without it (``gp_weight`` None), and its ten costliest kernels;
* the ten costliest aten convolution ops with their input shapes, each
  with the device time of the kernels it launched;
* the stage's time by CUDA events over 5 calls: with the penalty and
  ``torch.backends.cudnn.benchmark`` off, without the penalty, and with
  the penalty and benchmark on, in turns (each order run forwards, then
  backwards).

Then the card's nvidia-smi name and power limit. TF32 off, as
``chip_smoke.py`` runs.

Usage: python3 scripts/penalty_profile.py   (needs one CUDA card)
"""

from __future__ import annotations

import collections
import dataclasses
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SHAPE = (32, 128, 128, 3)


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from trainner_tpu_torch.losses.gan import AdversarialLoss
    from trainner_tpu_torch.models.networks import define_D

    if not torch.cuda.is_available():
        print("penalty_profile: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = define_D({"network_D": {"type": "discriminator_vgg_128_sn",
                                  "base_nf": 64}}, dtype=torch.bfloat16)
    net.init_weights(torch.Generator().manual_seed(1))
    net = net.cuda()
    gen = torch.Generator(device="cuda").manual_seed(2)
    fake = torch.rand(SHAPE, device="cuda", generator=gen)
    real = torch.rand(SHAPE, device="cuda", generator=gen)
    with_gp = AdversarialLoss(gan_type="wgan-gp", gp_weight=10.0)
    without = dataclasses.replace(with_gp, gp_weight=None)

    def stage(adv):
        net.zero_grad(set_to_none=True)
        loss, _ = adv.discriminator_loss(lambda x: net(x, train=True), fake,
                                         real, generator=gen)
        loss.backward()

    def profiled(adv):
        stage(adv)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            stage(adv)
            torch.cuda.synchronize()
        return prof

    for label, adv in (("without the penalty", without),
                       ("with the penalty", with_gp)):
        prof = profiled(adv)
        kernels = collections.Counter()
        calls = collections.Counter()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name.split("(")[0][:90]
                kernels[name] += e.time_range.elapsed_us()
                calls[name] += 1
        busy = sum(kernels.values()) / 1e3
        print(f"D stage {label}, bf16, b={SHAPE[0]} at {SHAPE[1]} px: "
              f"device busy {busy:.3f} ms in {sum(calls.values())} kernels")
        for name, us in kernels.most_common(10):
            print(f"  {us / 1e3:9.3f} ms {calls[name]:4d} x {name}")
        if adv is with_gp:
            ops = [e for e in prof.key_averages(group_by_input_shape=True)
                   if "conv" in e.key]
            ops.sort(key=lambda e: -e.device_time_total)
            print("  convolution ops by input shape (device time of their "
                  "kernels):")
            for e in ops[:10]:
                print(f"  {e.device_time_total / 1e3:9.3f} ms {e.count:3d} x "
                      f"{e.key} {e.input_shapes}")

    ms = collections.defaultdict(list)
    runs = (("with the penalty", with_gp, False),
            ("without it", without, False),
            ("with the penalty, cudnn.benchmark on", with_gp, True))
    for label, adv, bench in runs + runs[::-1]:
        torch.backends.cudnn.benchmark = bench
        stage(adv)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            stage(adv)
        end.record()
        torch.cuda.synchronize()
        ms[label].append(start.elapsed_time(end) / 5)
    torch.backends.cudnn.benchmark = False
    print("D stage, ms per call over 5 (CUDA events), in turns: "
          + "; ".join(f"{k} {v}" for k, v in ms.items()))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
