#!/usr/bin/env python3
"""What bounds the per-sample blur kernel: times it with one part of its
design changed, on one NVIDIA card.

Each variant is a copy of ``trainner_tpu_torch/csrc/blur_per_sample.cu``
with one edit, compiled by ``nvcc`` (all variants at once) into
``build/variants/`` and called through its C interface at the producer's
two canvases (f32, k 21, chip_smoke.py's BLUR_HR and BLUR_LR):

- ``as-built``: the source as it is;
- ``wide-r16``: the wide tile with R = 16 outputs a thread and two column
  groups (the same 32 x 32 px, half the warps), four blocks an SM;
- ``min-blocks-3``, ``min-blocks-4``: the wide tile held to the registers
  for three or four resident blocks an SM instead of two;
- ``halo-cp-async``: the halo by 4-byte cp.async, every copy of a thread
  in flight at once, instead of through registers;
- ``halo-by-value``: the halo walked value by value, consecutive threads
  on consecutive addresses of a halo row in NHWC, instead of pixel by
  pixel;
- ``one-dy``: the tap loop cut to its first row (results are wrong; only
  the time is read): what loading the halo and storing the tile cost;
- ``no-halo-one-dy``: no halo loaded either: the launch, the taps and the
  stores alone.

Prints one line per variant, run and shape with the device time of one
launch under the profiler and its share of the bound, then the card's
nvidia-smi name and power limit. Variants run twice, in turn, so that the
spread shows.

Usage: python3 scripts/blur_variants.py   (needs one CUDA card)
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the halo loop's channel copies, as built
HALO_COPY = """    for (int ch = 0; ch < c; ++ch) {
      float v[HALO_UNROLL];
#pragma unroll
      for (int u = 0; u < HALO_UNROLL; ++u) v[u] = to_f32(src[u][ch]);
#pragma unroll
      for (int u = 0; u < HALO_UNROLL; ++u) dst[u][ch * geo.plane] = v[u];
    }
  }
  __syncthreads();"""
# the same by 4-byte cp.async (f32 only; the variants time f32)
HALO_CP_ASYNC = """    for (int ch = 0; ch < c; ++ch)
#pragma unroll
      for (int u = 0; u < HALO_UNROLL; ++u)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(
                         static_cast<unsigned>(__cvta_generic_to_shared(
                             dst[u] + ch * geo.plane))),
                     "l"(__cvta_generic_to_global(src[u] + ch)) : "memory");
  }
  asm volatile("cp.async.wait_all;\\n" ::: "memory");
  __syncthreads();"""
SOURCE = ROOT / "trainner_tpu_torch" / "csrc" / "blur_per_sample.cu"
# the halo loop as built, pixel by pixel (a thread copies a pixel's c
# values)
_text = SOURCE.read_text()
HALO_LOOP = _text[_text.index("  const int npix ="):
                  _text.index("  const int lane = tid & 31;")]
# the halo walked value by value: consecutive threads on consecutive
# addresses of a halo row's span in NHWC
HALO_BY_VALUE = """  const int span = geo.hwid * c;
  const int nval = geo.hh * span;
  for (int e0 = tid; e0 < nval; e0 += HALO_UNROLL * nthreads) {
    float v[HALO_UNROLL];
    float* dst[HALO_UNROLL];
#pragma unroll
    for (int u = 0; u < HALO_UNROLL; ++u) {
      const int e = min(e0 + u * nthreads, nval - 1);
      const int r = e / span;
      const int rem = e - r * span;
      const int col = c == 3 ? rem / 3 : rem / c;
      const int ch = rem - col * c;
      v[u] = to_f32(xn[((size_t)reflect(y0 - pad + r, h) * w +
                        reflect(x0 - pad + col, w)) * c + ch]);
      dst[u] = halo + ch * geo.plane + r * geo.pitch + col;
    }
#pragma unroll
    for (int u = 0; u < HALO_UNROLL; ++u) *dst[u] = v[u];
  }
  __syncthreads();

"""
EDITS = {
    "as-built": [],
    "wide-r16": [("constexpr int WIDE_R = 8;", "constexpr int WIDE_R = 16;"),
                 ("constexpr int WIDE_NWX = 4;",
                  "constexpr int WIDE_NWX = 2;"),
                 ("constexpr int WIDE_MIN_BLOCKS = 2;",
                  "constexpr int WIDE_MIN_BLOCKS = 4;")],
    "min-blocks-3": [("constexpr int WIDE_MIN_BLOCKS = 2;",
                      "constexpr int WIDE_MIN_BLOCKS = 3;")],
    "min-blocks-4": [("constexpr int WIDE_MIN_BLOCKS = 2;",
                      "constexpr int WIDE_MIN_BLOCKS = 4;")],
    "halo-cp-async": [(HALO_COPY, HALO_CP_ASYNC)],
    "halo-by-value": [(HALO_LOOP, HALO_BY_VALUE)],
    "one-dy": [("for (int dy = 0; dy < kk; ++dy, src += geo.pitch",
                "for (int dy = 0; dy < 1; ++dy, src += geo.pitch")],
    "no-halo-one-dy": [(HALO_COPY, "  }\n  __syncthreads();"),
                       ("for (int dy = 0; dy < kk; ++dy, src += geo.pitch",
                        "for (int dy = 0; dy < 1; ++dy, src += geo.pitch")],
}


def _build_all(nvcc: str, flags: list) -> dict:
    """Every variant's library, one nvcc each, all running together."""
    base = SOURCE.read_text()
    out = ROOT / "build" / "variants" / "blur"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        text = base
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        src = out / f"{name}.cu"
        src.write_text(text)
        lib = out / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *flags, "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        libs[name].blur_per_sample.argtypes = [i, p, p, p, i, i, i, i, i, p]
        libs[name].blur_per_sample.restype = i
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("blur_variants: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from trainner_tpu_torch.ops import _build

    smi = chip_smoke._smi()
    libs = _build_all(_build.nvcc_path(),
                      [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas",
                                                                 "-v")])
    gen = torch.Generator().manual_seed(6)
    inputs = {}
    for shape in (chip_smoke.BLUR_HR, chip_smoke.BLUR_LR):
        x = torch.rand(*shape, generator=gen).cuda()
        inputs[shape] = x, chip_smoke._blur_kernels(gen, shape[0],
                                                    chip_smoke.BLUR_K)
    for run in (1, 2):
        for name, lib in libs.items():
            for shape, (x, kern) in inputs.items():
                b, h, w, c = shape
                out = torch.empty_like(x)
                stream = torch.cuda.current_stream().cuda_stream

                def call():
                    err = lib.blur_per_sample(0, x.data_ptr(),
                                              kern.data_ptr(),
                                              out.data_ptr(), b, h, w, c,
                                              chip_smoke.BLUR_K, stream)
                    if err:
                        raise RuntimeError(f"{name}: launch error {err}")

                dev = chip_smoke._device_ms(call, "blur_kernel")
                work = 2 * chip_smoke.BLUR_K ** 2 * x.numel()
                bound, _ = chip_smoke._bound("float32", work,
                                             2 * x.numel() * 4
                                             + kern.numel() * 4)
                print(json.dumps({"variant": name, "run": run,
                                  "shape": list(shape), "device_ms": dev,
                                  "share_of_bound": bound / dev}),
                      flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
