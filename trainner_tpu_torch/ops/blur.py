"""Per-sample blur: the hand-written CUDA kernel ``csrc/blur_per_sample.cu``
and its plain PyTorch version.

Counterpart of the TPU kernel ``trainner_tpu/ops/pallas_kernels.py::
blur_per_sample_pallas``: ``x (b, h, w, c)`` NHWC and ``kernels (b, k, k)``
give ``(b, h, w, c)``, each sample cross-correlated with its own kernel
under reflect padding, summed in f32 and rounded once to x's type. There is
one result for every k (the JAX package's ``apply_kernels`` switches to an
FFT product for k >= 13 that flips the kernel; this does not).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# Launches of the CUDA kernel.
launches = 0

_SOURCE = "blur_per_sample.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448  # bytes of shared memory one block may use on sm_90


def _check(x: torch.Tensor, kernels: torch.Tensor) -> int:
    if x.dim() != 4:
        raise ValueError("x must be an NHWC (b, h, w, c) tensor")
    b, h, w, _ = x.shape
    if kernels.dim() != 3 or kernels.shape[0] != b \
            or kernels.shape[1] != kernels.shape[2]:
        raise ValueError(f"kernels must be (b, k, k) with b={b}, got "
                         f"{tuple(kernels.shape)}")
    k = kernels.shape[-1]
    if k % 2 == 0:
        raise ValueError(f"the kernel size must be odd, got k={k}")
    if k // 2 >= min(h, w):
        raise ValueError(f"reflect padding needs k//2 < min(h, w), got "
                         f"k={k} on {h}x{w}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} is not float32 or bfloat16")
    if kernels.device != x.device:
        raise ValueError("kernels must be on x's device")
    return k


def blur_per_sample_plain(x: torch.Tensor, kernels: torch.Tensor
                          ) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: reflect padding, then the
    k*k taps added in the kernel's order (dy outer, dx inner) in f32, one
    rounding to x's type."""
    k = _check(x, kernels)
    b, h, w, c = x.shape
    pad = k // 2
    xp = F.pad(x.float().permute(0, 3, 1, 2), (pad, pad, pad, pad),
               mode="reflect")  # (b, c, h + 2 pad, w + 2 pad)
    taps = kernels.float()
    acc = torch.zeros((b, c, h, w), dtype=torch.float32, device=x.device)
    for dy in range(k):
        for dx in range(k):
            acc += xp[:, :, dy:dy + h, dx:dx + w] \
                * taps[:, dy, dx][:, None, None, None]
    return acc.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _library():
    from ._build import load

    lib = load(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.blur_per_sample.argtypes = [i, p, p, p, i, i, i, i, i, p]
        lib.blur_per_sample.restype = i
        lib.blur_per_sample_smem_bytes.argtypes = [i, i]
        lib.blur_per_sample_smem_bytes.restype = ctypes.c_longlong
        lib.blur_per_sample_error_string.argtypes = [i]
        lib.blur_per_sample_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def blur_per_sample(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Per-sample blur. On a CUDA tensor it launches the CUDA kernel (or
    raises); on a CPU tensor it runs ``blur_per_sample_plain``."""
    global launches
    if x.device.type == "cpu":
        return blur_per_sample_plain(x, kernels)
    if x.device.type != "cuda":
        raise ValueError(f"blur_per_sample runs on cuda or cpu, not "
                         f"{x.device}")
    k = _check(x, kernels)
    b, h, w, c = x.shape
    x = x.contiguous()
    taps = kernels.float().contiguous()
    lib = _library()
    need = lib.blur_per_sample_smem_bytes(c, k)
    if need > _MAX_SMEM:
        raise ValueError(f"c={c}, k={k} need {need} bytes of shared memory "
                         f"per block, over the card's {_MAX_SMEM}")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.blur_per_sample(_DTYPES[x.dtype], x.data_ptr(),
                                  taps.data_ptr(), out.data_ptr(),
                                  b, h, w, c, k, stream)
    if err:
        raise RuntimeError("blur_per_sample kernel launch failed: "
                           + lib.blur_per_sample_error_string(err).decode())
    launches += 1
    return out
