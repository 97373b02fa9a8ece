"""Forward of one residual dense block (5C): the hand-written CUDA kernel
``csrc/rdb5c.cu`` and its plain PyTorch version.

Counterpart of the TPU kernel ``trainner_tpu/ops/pallas_kernels.py::
rdb5c_canvas`` (and of the XLA form ``models/rrdb.py::rdb5c_fused``, which
computes the same function). The block runs as five 3x3 "scatter-to-future"
stages against the packed weights of ``pack_rdb_weights``; see the kernel
source for the design and its bound.

Layout at this module's functions is NHWC, as in the JAX package:
x ``(b, h, w, nf)``, c1..c4 ``(b, h, w, gc)``. Packed weights are
``(9*cin, N)``, tap-major (HWIO reshaped), in the working type; biases are
f32. Sums are taken in f32; c1..c4 and out are rounded to the working type.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

# Launches of the CUDA kernel: one count per block forward (five stages).
launches = 0

_SOURCE = "rdb5c.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pack_rdb_weights(ws: Sequence[torch.Tensor], nf: int, gc: int,
                     dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """Five OIHW conv weights of a block -> the five packed stage weights
    (``models/rrdb.py::_rdb_pack_kernels`` then ``_pack9``): per stage,
    every later conv's input-channel slice for that stage's features,
    concatenated along the output axis, as a ``(9*cin, N)`` matrix."""
    h = [w.permute(2, 3, 1, 0) for w in ws]  # OIHW -> HWIO

    def sl(w, a, b):
        return w[:, :, a:b]

    cat = lambda parts: torch.cat(parts, dim=-1)  # noqa: E731
    wx = cat([h[0]] + [sl(w, 0, nf) for w in h[1:]])
    packs = [wx]
    for s in range(1, 5):
        a = nf + (s - 1) * gc
        packs.append(cat([sl(w, a, a + gc) for w in h[s:]]))
    return tuple(p.reshape(9 * p.shape[2], p.shape[3]).to(dtype).contiguous()
                 for p in packs)


def _unpack9(p: torch.Tensor) -> torch.Tensor:
    """(9*cin, N) packed -> OIHW (N, cin, 3, 3), in f32."""
    cin = p.shape[0] // 9
    return p.float().reshape(3, 3, cin, p.shape[1]).permute(3, 2, 0, 1)


def rdb5c_forward_plain(x: torch.Tensor, packed_w: Sequence[torch.Tensor],
                        biases: Sequence[torch.Tensor],
                        return_residuals: bool = False):
    """The kernel's arithmetic in plain PyTorch: f32 convs of working-type
    values, sums in the kernel's order, one rounding of c1..c4 and out."""
    dt = x.dtype
    nf = x.shape[-1]
    gc = packed_w[1].shape[0] // 9
    x32 = x.permute(0, 3, 1, 2).float()
    cur = x32
    s = None
    cs = []
    for k in range(5):
        q = F.conv2d(cur, _unpack9(packed_w[k]), padding=1)
        b = biases[k].float()[None, :, None, None]
        if k == 4:
            out = (s + q + b) * 0.2 + x32
            break
        pre = q[:, :gc] if s is None else s[:, :gc] + q[:, :gc]
        v = pre + b
        c = torch.where(v >= 0, v, v * 0.2).to(dt)
        cs.append(c)
        rest = q[:, gc:]
        s = rest if s is None else s[:, gc:] + rest
        cur = c.float()
    to_nhwc = lambda t: t.to(dt).permute(0, 2, 3, 1).contiguous()  # noqa
    out = to_nhwc(out)
    if return_residuals:
        return (out,) + tuple(to_nhwc(c) for c in cs)
    return out


def _check(x, packed_w, biases):
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC (b, h, w, nf) tensor")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} is not float32 or bfloat16")
    nf = x.shape[-1]
    if len(packed_w) != 5 or len(biases) != 5:
        raise ValueError("need five packed weights and five biases")
    gc = packed_w[1].shape[0] // 9
    if nf % 32 or gc % 32:
        raise ValueError(f"the kernel needs nf and gc multiples of 32, "
                         f"got nf={nf}, gc={gc}")
    for s, (p, b) in enumerate(zip(packed_w, biases)):
        cin = nf if s == 0 else gc
        n = 4 * gc + nf - s * gc
        if tuple(p.shape) != (9 * cin, n):
            raise ValueError(f"packed weight {s} has shape {tuple(p.shape)}"
                             f", expected {(9 * cin, n)}")
        if tuple(b.shape) != ((gc,) if s < 4 else (nf,)):
            raise ValueError(f"bias {s} has shape {tuple(b.shape)}")
        if p.dtype != x.dtype or b.dtype != torch.float32:
            raise TypeError("packed weights take x's dtype, biases f32")
        if p.device != x.device or b.device != x.device:
            raise ValueError("all operands must be on x's device")
        if not (p.is_contiguous() and b.is_contiguous()):
            raise ValueError("packed weights and biases must be contiguous")
    return nf, gc


def _library():
    from ._build import load

    lib = load(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rdb5c_forward.argtypes = [i] + [p] * 17 + [i] * 5 + [p]
        lib.rdb5c_forward.restype = i
        lib.rdb5c_error_string.argtypes = [i]
        lib.rdb5c_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def rdb5c_forward(x: torch.Tensor, packed_w: Sequence[torch.Tensor],
                  biases: Sequence[torch.Tensor],
                  return_residuals: bool = False):
    """One block forward. On a CUDA tensor it launches the CUDA kernel (or
    raises); on a CPU tensor it runs ``rdb5c_forward_plain``. Returns out,
    or (out, c1, c2, c3, c4) with ``return_residuals``."""
    global launches
    if x.device.type == "cpu":
        return rdb5c_forward_plain(x, packed_w, biases, return_residuals)
    if x.device.type != "cuda":
        raise ValueError(f"rdb5c_forward runs on cuda or cpu, not {x.device}")
    nf, gc = _check(x, packed_w, biases)
    b, h, w, _ = x.shape
    lib = _library()
    out = torch.empty_like(x)
    cs = [torch.empty((b, h, w, gc), dtype=x.dtype, device=x.device)
          for _ in range(4)]
    acc = torch.empty((b * h * w, 4 * gc + nf), dtype=torch.float32,
                      device=x.device)
    ptrs = [x, *packed_w, *biases, acc, *cs, out]
    if any(t.data_ptr() % 16 for t in ptrs):
        raise ValueError("operands must be 16-byte aligned")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.rdb5c_forward(_DTYPES[x.dtype],
                                *[t.data_ptr() for t in ptrs],
                                b, h, w, nf, gc, stream)
    if err:
        raise RuntimeError("rdb5c kernel launch failed: "
                           + lib.rdb5c_error_string(err).decode())
    launches += 1
    if return_residuals:
        return (out, *cs)
    return out
