#!/usr/bin/env python3
"""Three exact ways to take the k x k median of ``ops/degradations.py::
median_blur`` on one NVIDIA card, timed against one another.

Each takes the window stack of ``_window_stack`` (b, h, w, c, k*k) and
returns its middle value: ``torch.median`` along the last axis (what
``median_blur`` ran first), the middle column of ``torch.sort``, and
``torch.kthvalue`` (on the card each reads the stack once more). The
shapes are combo's: its routing q-slice (5, 128, 128, 3) at k 3 (the
median type's default size), the HR canvas (32, 128, 128, 3) at k 3 and
at k 11 (the largest the pipeline allows). Every way must equal
``torch.median`` bit for bit; each is timed with CUDA events over 20
calls, the stack included, in turns (median, sort, kthvalue, kthvalue,
sort, median), f32.

Prints one line per shape, then the card's nvidia-smi name and power
limit.

Usage: python3 scripts/median_variants.py   (needs one CUDA card)
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SHAPES = (((5, 128, 128, 3), 3), ((32, 128, 128, 3), 3),
          ((32, 128, 128, 3), 11))


def _ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
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


def main() -> int:
    import torch

    from trainner_tpu_torch.ops.degradations import _window_stack

    if not torch.cuda.is_available():
        print("median_variants: no CUDA device", file=sys.stderr)
        return 1
    ways = {
        "median": lambda w: w.median(dim=-1).values,
        "sort": lambda w: w.sort(dim=-1).values[..., w.shape[-1] // 2],
        "kthvalue": lambda w: w.kthvalue(w.shape[-1] // 2 + 1,
                                         dim=-1).values,
    }
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, k in SHAPES:
        x = (torch.randint(0, 256, shape, generator=gen, device="cuda")
             / 255.0).float()
        want = ways["median"](_window_stack(x, k))
        for name, fn in ways.items():
            if not torch.equal(fn(_window_stack(x, k)), want):
                raise AssertionError(f"{name} differs at {shape}, k {k}")
        times = {name: [] for name in ways}
        for name in ("median", "sort", "kthvalue", "kthvalue", "sort",
                     "median"):
            times[name].append(_ms(
                lambda: ways[name](_window_stack(x, k))))
        print(f"median_variants: {shape} k {k}, ms per call with the stack "
              f"(two turns each): " + "; ".join(
                  f"{name} {', '.join(f'{t:.4f}' for t in ts)}"
                  for name, ts in times.items())
              + "; all equal bit for bit")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
