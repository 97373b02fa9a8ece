#!/usr/bin/env python3
"""What bounds the f32 (3xTF32) block kernels: times each kernel with one
part of its arithmetic changed, on one NVIDIA card.

Each variant is a copy of ``trainner_tpu_torch/csrc`` with one edit of the
tile header ``conv3x3_mma.cuh``, compiled by ``ops/_build.py`` into
``build/variants/<name>`` and timed with ``chip_smoke.py``'s helpers at the
block shapes of the serving and training paths (nf 64, gc 32):

- ``as-built``: the sources as they are;
- ``no-split``: hi = lo = the f32 value (no cvt.rna, no subtraction): the
  split's ALU work removed, three products kept (results are wrong; only
  the time is read);
- ``one-product``: hi*hi' alone, the split kept (wrong results too);
- ``lo-by-integer``: lo rounded by (bits + 0x1000) & ~0x1fff instead of
  cvt.rna, which is the same value for every finite remainder.

Prints one line per variant, run and shape: the device time per block of
``rdb_stage_tf32`` (five launches), ``rdb_dx_stage_tf32`` (five) and
``dw_tf32_kernel`` (one) under the profiler, then the card's nvidia-smi
name and power limit. Variants run twice, in turn, so that the spread shows.

Usage: python3 scripts/tile_variants_f32.py   (needs one CUDA card)
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

HI = 'asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(f));'
LO = ('asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : '
      '"f"(f - __uint_as_float(hi)));')
EDITS = {
    "as-built": [],
    "no-split": [(HI, "hi = x;"), (LO, "lo = x;")],
    "one-product": [("  mma_tf32(d, alo, bhi[0], bhi[1]);\n"
                     "  mma_tf32(d, ahi, blo[0], blo[1]);\n", "")],
    "lo-by-integer": [(LO, "lo = (__float_as_uint(f - __uint_as_float(hi))"
                           " + 0x1000u) & 0xffffe000u;")],
}
KERNELS = ("rdb_stage_tf32", "rdb_dx_stage_tf32", "dw_tf32_kernel")


def _variant_sources(name: str, base: pathlib.Path) -> pathlib.Path:
    out = ROOT / "build" / "variants" / name / "csrc"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(base, out)
    header = out / "conv3x3_mma.cuh"
    text = header.read_text()
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the header no longer has {old!r}")
        text = text.replace(old, new)
    header.write_text(text)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tile_variants_f32: no CUDA device is available",
              file=sys.stderr)
        return 1
    import chip_smoke
    from trainner_tpu_torch.ops import _build, rdb5c

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke._smi()
    base = _build.CSRC
    gen = torch.Generator().manual_seed(2)
    ws, bs = chip_smoke._block_weights(gen)
    packed = rdb5c.pack_rdb_weights([w.cuda() for w in ws], chip_smoke.NF,
                                    chip_smoke.GC, torch.float32)
    bs = [b.cuda() for b in bs]
    inputs = {}
    for shape in (chip_smoke.MAIN_SHAPE, chip_smoke.TRAIN_SHAPE):
        inputs[shape] = (
            (torch.randn(*shape, chip_smoke.NF, generator=gen) * 0.5).cuda(),
            torch.randn(*shape, chip_smoke.NF, generator=gen).cuda())
    try:
        for run in (1, 2):
            for name in EDITS:
                _build.CSRC = _variant_sources(name, base)
                _build._libs.clear()
                for shape, (x, g) in inputs.items():
                    with torch.no_grad():
                        _, *cs = rdb5c.rdb5c_forward(x, packed, bs,
                                                     return_residuals=True)
                        fns = (lambda: rdb5c.rdb5c_forward(x, packed, bs),
                               lambda: rdb5c.rdb5c_backward(g, x, *cs,
                                                            packed))
                        dev = {k: chip_smoke._device_ms(fns[k != KERNELS[0]],
                                                        k)
                               for k in KERNELS}
                    print(json.dumps({"variant": name, "run": run,
                                      "shape": list(shape),
                                      "device_ms_per_block": dev}),
                          flush=True)
    finally:
        _build.CSRC = base
        _build._libs.clear()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
