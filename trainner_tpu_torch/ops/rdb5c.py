"""One residual dense block (5C), forward and backward: the hand-written
CUDA kernels ``csrc/rdb5c.cu`` and ``csrc/rdb5c_bwd.cu``, their plain
PyTorch versions, and ``RDB5CFunction``, which joins them under autograd.

Counterpart of the TPU kernels ``trainner_tpu/ops/pallas_kernels.py::
rdb5c_canvas`` and ``rdb5c_canvas_bwd`` (and of the XLA form
``models/rrdb.py::rdb5c_fused`` with its ``_bwd_dual``, which computes the
same function). The block runs as five 3x3 stages against the packed
weights of ``pack_rdb_weights``; the backward walks the stages in reverse
and returns packed weight gradients, which ``unpack_rdb_wgrads`` cuts into
the five per-conv gradients. See the kernel sources for the designs and
their bounds.

The working type alone selects the kernel; both types run on the tensor
cores on one tile (``csrc/conv3x3_mma.cuh``): bf16 as ``mma.sync`` with
f32 sums, f32 as 3xTF32 (each operand split into two tf32 parts, three
tf32 products per f32 product, f32 sums). The forward runs as five gather
convs over ``[x|c1..ck]`` with no scratch in device memory, the backward as
five dx stages of the same tile, reading the packed weights as they lie,
and one dW kernel whose per-split partials are added in a fixed order. On
a CPU tensor both wrappers run the plain versions below, which the CPU
tests hold against the JAX package; ``python3 chip_smoke.py`` builds the
kernels with ``nvcc`` at first use and holds them against the plain
versions on the card.

Layout at this module's functions is NHWC, as in the JAX package:
x ``(b, h, w, nf)``, c1..c4 ``(b, h, w, gc)``. Packed weights are
``(9*cin, N)``, tap-major (HWIO reshaped), in the working type; biases are
f32. Sums are taken in f32; c1..c4 and out, and in the backward dc5,
da1..da4 and dx, are rounded to the working type once.

Every width runs, on both devices by one route. The kernels take nf and gc
in multiples of 32 (a channel chunk); ``rdb5c_forward`` and
``rdb5c_backward`` bring a narrower block to the next multiples (nf', gc')
with zeros: zero input rows after nf and after each gc slice of
``[x|c1..c4]``, zero output columns per conv and zero biases
(``pad_packed``), and zero channels of x and g. A padded output channel has
zero weights and a zero bias, so lrelu(0) = 0 keeps it 0; a padded input
channel carries 0; every padded dW and db entry is a sum of products with a
zero factor. So the padded block computes the narrow one exactly, with
extra zeros. The residuals c1..c4 stay at gc'; out and dx come back at nf.
``pack_block`` packs and pads once, which is what ``models/rrdb.py`` caches.

On a tensor axis (``parallel/tensor.py``) a block whose convs the rule
splits runs the same kernels by stage: ``rdb5c_forward_split`` runs each
stage k over a range of its output columns (``rdb5c_stage``: the whole
range for a conv that stays whole, this rank's columns, written into a
zeroed buffer, for a split one, whose ranks' buffers are then summed,
which joins them), and ``rdb5c_backward_split`` computes, for a split
conv, only its own columns' terms of every dx stage (in f32, summed over
the tensor ranks before the stages' epilogues add them) and its own
columns of dW. Both are generators that yield each buffer to be summed
over the tensor group in place (``run_split``), so that a test can run T
ranks in one process in lock step (``run_lockstep``). Column ranges are
given per conv as (first, count) in its output columns, None for whole.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Callable, Sequence, Tuple

import torch
import torch.nn.functional as F

# Launches of the CUDA kernels: one count per block forward (five stages)
# and one per block backward; on a tensor axis, one per column-range
# forward stage and one per split block backward.
launches = 0
backward_launches = 0
stage_launches = 0
split_backward_launches = 0

_SOURCE = "rdb5c.cu"
_BWD_SOURCE = "rdb5c_bwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK = 32  # channels per chunk of the kernels: nf and gc are multiples
# The backward's column sums take one thread per column of [da1..da4|dc5].
_MAX_BWD_WIDTH = 1024


def _alloc(shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Every output and scratch buffer of the kernels comes from here."""
    return torch.empty(shape, dtype=dtype, device=device)


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


def padded_width(n: int) -> int:
    """The kernels' width for n channels: the next multiple of 32."""
    return -(-n // _CHUNK) * _CHUNK


def _pad_last(t: torch.Tensor, n: int) -> torch.Tensor:
    """t with zeros appended to its last axis up to n (t itself if it is
    that wide)."""
    return t if t.shape[-1] == n else F.pad(t, (0, n - t.shape[-1]))


def _pack_widths(packed_w: Sequence[torch.Tensor]) -> Tuple[int, int]:
    """(nf, gc) of a packed block, from its first two weights' rows."""
    return packed_w[0].shape[0] // 9, packed_w[1].shape[0] // 9


def pad_packed(packed_w: Sequence[torch.Tensor],
               biases: Sequence[torch.Tensor] = ()):
    """A packed block (and, if given, its biases) at (nf, gc) -> the same
    block at (nf', gc') = ``padded_width`` of each, with zeros inserted:
    stage s's rows are one feature (x, or c_s), so its tap slabs grow zero
    rows at their end; its columns are the later convs' outputs, each slice
    growing zero columns at its end. Returns (packed, biases), the inputs
    themselves where nothing is to be padded."""
    nf, gc = _pack_widths(packed_w)
    nfp, gcp = padded_width(nf), padded_width(gc)
    if (nfp, gcp) != (nf, gc):
        ws = []
        for s, p in enumerate(packed_w):
            cin, cinp = (nf, nfp) if s == 0 else (gc, gcp)
            segs = p.reshape(9, cin, -1).split([gc] * (4 - s) + [nf], -1)
            t = torch.cat([_pad_last(q, gcp if i < 4 - s else nfp)
                           for i, q in enumerate(segs)], -1)
            t = F.pad(t, (0, 0, 0, cinp - cin))
            ws.append(t.reshape(9 * cinp, t.shape[-1]).contiguous())
        packed_w = ws
    biases = [_pad_last(b, gcp if s < 4 else nfp)
              for s, b in enumerate(biases)]
    return tuple(packed_w), tuple(biases)


def unpad_grads(dws: Sequence[torch.Tensor], dbs: Sequence[torch.Tensor],
                nf: int, gc: int):
    """The inverse of ``pad_packed`` on packed weight gradients and bias
    gradients at (nf', gc'): the rows and columns of the block at (nf, gc).
    Returns (dws, dbs), the inputs themselves at the kernels' widths."""
    nfp, gcp = padded_width(nf), padded_width(gc)
    if (nfp, gcp) == (nf, gc):
        return tuple(dws), tuple(dbs)
    out = []
    for s, d in enumerate(dws):
        cin, cinp = (nf, nfp) if s == 0 else (gc, gcp)
        segs = d.reshape(9, cinp, -1)[:, :cin].split(
            [gcp] * (4 - s) + [nfp], -1)
        t = torch.cat([q[..., :gc if i < 4 - s else nf]
                       for i, q in enumerate(segs)], -1)
        out.append(t.reshape(9 * cin, t.shape[-1]))
    return tuple(out), tuple(b[:gc if s < 4 else nf]
                             for s, b in enumerate(dbs))


def pack_block(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
               nf: int, gc: int, dtype: torch.dtype):
    """Five OIHW conv weights and biases of a block -> (packed weights in
    ``dtype``, f32 biases), both at the kernels' widths (nf', gc')."""
    packed = pack_rdb_weights(ws, nf, gc, dtype)
    return pad_packed(packed, [b.detach().float().contiguous() for b in bs])


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


def _check_packed(x, packed_w):
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC (b, h, w, nf) tensor")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} is not float32 or bfloat16")
    nf = x.shape[-1]
    if len(packed_w) != 5:
        raise ValueError("need five packed weights")
    gc = packed_w[1].shape[0] // 9
    if nf % 32 or gc % 32:
        raise ValueError(f"the kernel needs nf and gc multiples of 32, "
                         f"got nf={nf}, gc={gc}")
    if x.shape[0] * x.shape[1] * x.shape[2] >= 2 ** 31:
        raise ValueError("the kernel indexes pixels with 32 bits: "
                         f"b*h*w = {x.shape[0] * x.shape[1] * x.shape[2]}")
    for s, p in enumerate(packed_w):
        cin = nf if s == 0 else gc
        n = 4 * gc + nf - s * gc
        if tuple(p.shape) != (9 * cin, n):
            raise ValueError(f"packed weight {s} has shape {tuple(p.shape)}"
                             f", expected {(9 * cin, n)}")
        if p.dtype != x.dtype:
            raise TypeError("packed weights take x's dtype")
        if p.device != x.device:
            raise ValueError("all operands must be on x's device")
        if not p.is_contiguous():
            raise ValueError("packed weights must be contiguous")
    return nf, gc


def _check(x, packed_w, biases):
    nf, gc = _check_packed(x, packed_w)
    if len(biases) != 5:
        raise ValueError("need five biases")
    for s, b in enumerate(biases):
        if tuple(b.shape) != ((gc,) if s < 4 else (nf,)):
            raise ValueError(f"bias {s} has shape {tuple(b.shape)}")
        if b.dtype != torch.float32:
            raise TypeError("biases are f32")
        if b.device != x.device:
            raise ValueError("all operands must be on x's device")
        if not b.is_contiguous():
            raise ValueError("biases must be contiguous")
    return nf, gc


def _pointers(tensors):
    """Device addresses for the C interface (None stays a null pointer)."""
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    if any(p is not None and p % 16 for p in ptrs):
        raise ValueError("operands must be 16-byte aligned")
    return ptrs


def _library():
    from ._build import load

    lib = load(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rdb5c_forward.argtypes = [i] + [p] * 16 + [i] * 5 + [p]
        lib.rdb5c_forward.restype = i
        lib.rdb5c_forward_stage.argtypes = [i, i] + [p] * 12 + [i] * 7 + [p]
        lib.rdb5c_forward_stage.restype = i
        lib.rdb5c_stage_smem_bytes.argtypes = [i, i]
        lib.rdb5c_stage_smem_bytes.restype = i
        lib.rdb5c_error_string.argtypes = [i]
        lib.rdb5c_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _padded_x(x: torch.Tensor, packed_w: Sequence[torch.Tensor]):
    """x with zero channels up to the padded pack's nf'."""
    nfp = packed_w[0].shape[0] // 9
    if padded_width(x.shape[-1]) != nfp:
        raise ValueError(f"x has {x.shape[-1]} channels, the block "
                         f"{_pack_widths(packed_w)[0]}")
    return _pad_last(x, nfp)


def rdb5c_forward(x: torch.Tensor, packed_w: Sequence[torch.Tensor],
                  biases: Sequence[torch.Tensor],
                  return_residuals: bool = False):
    """One block forward at any width: a block that is not at the kernels'
    widths is padded to them (``pad_packed``, zero channels of x). On a
    CUDA tensor it then launches the CUDA kernel (or raises); on a CPU
    tensor it runs ``rdb5c_forward_plain``. Returns out (x's width), or
    (out, c1, c2, c3, c4) with ``return_residuals``, c_k at gc'."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rdb5c_forward runs on cuda or cpu, not {x.device}")
    nf = x.shape[-1]
    packed_w, biases = pad_packed(packed_w, biases)
    xp = _padded_x(x, packed_w)
    if x.device.type == "cpu":
        res = rdb5c_forward_plain(xp, packed_w, biases, return_residuals)
    else:
        res = _forward_kernel(xp, packed_w, biases, return_residuals)
    if xp is x:
        return res
    if not return_residuals:
        return res[..., :nf].contiguous()
    return (res[0][..., :nf].contiguous(), *res[1:])


def _forward_kernel(x, packed_w, biases, return_residuals):
    global launches
    nf, gc = _check(x, packed_w, biases)
    b, h, w, _ = x.shape
    lib = _library()
    out = _alloc(x.shape, x.dtype, x.device)
    cs = [_alloc((b, h, w, gc), x.dtype, x.device) for _ in range(4)]
    ptrs = [x, *packed_w, *biases, *cs, out]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.rdb5c_forward(_DTYPES[x.dtype], *_pointers(ptrs),
                                b, h, w, nf, gc, stream)
    if err:
        raise RuntimeError("rdb5c kernel launch failed: "
                           + lib.rdb5c_error_string(err).decode())
    launches += 1
    if return_residuals:
        return (out, *cs)
    return out


def unpack_rdb_wgrads(dws: Sequence[torch.Tensor], nf: int, gc: int
                      ) -> Tuple[torch.Tensor, ...]:
    """Five packed ``(9*cin, N)`` weight gradients -> the five per-conv OIHW
    gradients (``models/rrdb.py::_unpack_wgrads``): the inverse of
    ``pack_rdb_weights`` on the output axis."""
    h = [d.reshape(3, 3, nf if s == 0 else gc, -1) for s, d in enumerate(dws)]
    outs = []
    for k in range(5):
        lo = k * gc
        hi = lo + (gc if k < 4 else nf)
        parts = [h[0][..., lo:hi]]
        for s in range(1, k + 1):
            parts.append(h[s][..., lo - s * gc:hi - s * gc])
        outs.append(torch.cat(parts, dim=2).permute(3, 2, 0, 1))
    return tuple(outs)


def rdb5c_backward_plain(g: torch.Tensor, x: torch.Tensor, c1: torch.Tensor,
                         c2: torch.Tensor, c3: torch.Tensor,
                         c4: torch.Tensor,
                         packed_w: Sequence[torch.Tensor]):
    """The backward kernel's arithmetic in plain PyTorch: f32 transposed
    convs and weight-gradient convs of working-type values, dc5 and da_k
    rounded to the working type before any product, lrelu' read from the
    sign of c_k (1 at c_k == 0, where torch's own backward gives 0.2), db5
    summed from the f32 dc5 and db1..db4 from the rounded da_k. Returns
    (dx, dW0..dW4 packed f32, db1..db5 f32)."""
    dt = x.dtype
    nchw32 = lambda t: t.permute(0, 3, 1, 2).float()  # noqa: E731
    rounded = lambda t: t.to(dt).float()  # noqa: E731
    g32 = nchw32(g)
    dc5 = g32 * 0.2
    db5 = dc5.sum((0, 2, 3))
    grads = [None, None, None, None, rounded(dc5)]  # da1..da4, dc5
    acts = (x, c1, c2, c3, c4)
    dws = [None] * 5
    for k in range(4, -1, -1):
        dy = torch.cat(grads[k:], 1)
        w = _unpack9(packed_w[k])
        a = nchw32(acts[k])
        dc = F.conv_transpose2d(dy, w, padding=1)
        dw = torch.nn.grad.conv2d_weight(a, w.shape, dy, padding=1)
        dws[k] = dw.permute(2, 3, 1, 0).reshape(9 * w.shape[1], w.shape[0])
        if k == 0:
            dx = (dc + g32).to(dt).permute(0, 2, 3, 1).contiguous()
        else:
            slope = torch.where(a >= 0, 1.0, 0.2)
            grads[k - 1] = rounded(dc * slope)
    dbs = [t.sum((0, 2, 3)) for t in grads[:4]] + [db5]
    return (dx, *[d.contiguous() for d in dws], *dbs)


def _check_backward(g, x, cs, packed_w):
    nf, gc = _check_packed(x, packed_w)
    for name, t, c in (("g", g, nf),
                       *[(f"c{i + 1}", c_, gc) for i, c_ in enumerate(cs)]):
        if tuple(t.shape) != (*x.shape[:3], c) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous NHWC tensor of "
                             f"shape {(*x.shape[:3], c)}")
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{name} must have x's dtype and device")
    if 4 * gc + nf > _MAX_BWD_WIDTH:
        raise ValueError(f"the kernel needs 4*gc + nf <= {_MAX_BWD_WIDTH}")
    return nf, gc


def _bwd_library():
    from ._build import load

    lib = load(_BWD_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rdb5c_backward.argtypes = [i] + [p] * 17 + [i] * 7 + [p]
        lib.rdb5c_backward.restype = i
        lib.rdb5c_backward_dw_splits.argtypes = [i] * 6
        lib.rdb5c_backward_dw_splits.restype = i
        ints, uints = ctypes.POINTER(i), ctypes.POINTER(ctypes.c_uint)
        lib.rdb5c_bwd_dc5.argtypes = [i, p, p] + [i] * 5 + [p]
        lib.rdb5c_bwd_part.argtypes = [i, p, p, p] + [i] * 10 + [p]
        lib.rdb5c_bwd_dx_stage.argtypes = [i, p, p, i, i, ints, ints, p, p,
                                           p] + [i] * 8 + [p]
        lib.rdb5c_bwd_dw.argtypes = [i] + [p] * 8 + [uints] + [i] * 6 + [p]
        lib.rdb5c_bwd_db.argtypes = [i] + [p] * 4 + [i] * 6 + [p]
        for name in ("rdb5c_bwd_dc5", "rdb5c_bwd_part",
                     "rdb5c_bwd_dx_stage", "rdb5c_bwd_dw", "rdb5c_bwd_db"):
            getattr(lib, name).restype = i
        lib.rdb5c_backward_dw_smem_bytes.argtypes = [i]
        lib.rdb5c_backward_dw_smem_bytes.restype = i
        lib.rdb5c_bwd_error_string.argtypes = [i]
        lib.rdb5c_bwd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _dw_splits(dt: int, b: int, h: int, w: int, nf: int, gc: int,
               device_index) -> int:
    """How many dW partials the kernel of this type writes at this shape
    on this card: its own tiling decides, so the C side is asked."""
    with torch.cuda.device(device_index):
        return _bwd_library().rdb5c_backward_dw_splits(dt, b, h, w, nf, gc)


def rdb5c_backward(g: torch.Tensor, x: torch.Tensor, c1: torch.Tensor,
                   c2: torch.Tensor, c3: torch.Tensor, c4: torch.Tensor,
                   packed_w: Sequence[torch.Tensor]):
    """One block backward from ``g = d out``, the forward's residuals and
    the packed weights, at any width: g, x and c1..c4 are padded with zero
    channels to the kernels' widths as the pack is (``pad_packed``). On a
    CUDA tensor it then launches the CUDA kernel (or raises); on a CPU
    tensor it runs ``rdb5c_backward_plain``. dx comes back at x's width,
    dW and db at the widths of the pack given. Returns
    (dx, dW0..dW4 packed f32, db1..db5 f32)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rdb5c_backward runs on cuda or cpu, not {x.device}")
    nf = x.shape[-1]
    widths = _pack_widths(packed_w)
    packed_p, _ = pad_packed(packed_w)
    gcp = packed_p[1].shape[0] // 9
    xp, gp = _padded_x(x, packed_p), _padded_x(g, packed_p)
    cs = [_pad_last(c, gcp) for c in (c1, c2, c3, c4)]
    if x.device.type == "cpu":
        dx, *rest = rdb5c_backward_plain(gp, xp, *cs, packed_p)
    else:
        dx, *rest = _backward_kernel(gp, xp, cs, packed_p)
    if xp is not x:
        dx = dx[..., :nf].contiguous()
    dws, dbs = unpad_grads(rest[:5], rest[5:], *widths)
    return (dx, *dws, *dbs)


def _backward_kernel(g, x, cs, packed_w):
    global backward_launches
    nf, gc = _check_backward(g, x, cs, packed_w)
    b, h, w, _ = x.shape
    gw = 4 * gc + nf
    npix = b * h * w
    total = sum(p.numel() for p in packed_w)
    lib = _bwd_library()
    dev = x.device
    dt = _DTYPES[x.dtype]
    # one partial per split of the pixel tiles, added in a fixed order, so
    # the result does not change from run to run
    dw_splits = _dw_splits(dt, b, h, w, nf, gc, dev.index)
    db_splits = min(npix, 256)
    grads = _alloc((npix, gw), x.dtype, dev)
    dw_part = _alloc((dw_splits, total), torch.float32, dev)
    db_part = _alloc((db_splits, gw), torch.float32, dev)
    dx = _alloc(x.shape, x.dtype, dev)
    dw = _alloc(total, torch.float32, dev)
    db = _alloc(gw, torch.float32, dev)
    ptrs = [g, x, *cs, *packed_w, grads, dw_part, db_part, dx, dw, db]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.rdb5c_backward(dt, *_pointers(ptrs),
                                 b, h, w, nf, gc, dw_splits, db_splits,
                                 stream)
    if err:
        raise RuntimeError("rdb5c backward kernel launch failed: "
                           + lib.rdb5c_bwd_error_string(err).decode())
    backward_launches += 1
    sizes = [p.numel() for p in packed_w]
    dws = [d.view(p.shape) for d, p in zip(dw.split(sizes), packed_w)]
    dbs = db.split([gc] * 4 + [nf])
    return (dx, *dws, *dbs)


# -- the tensor axis: stages over column ranges, the split backward ---------

def _stage_weight(packed_w: Sequence[torch.Tensor], k: int, lo: int,
                  n: int) -> torch.Tensor:
    """Conv k's output columns [lo, lo + n) over [x|c1..ck] as an f32 OIHW
    weight: in each packed weight s <= k they start at (k - s) * gc."""
    gc = packed_w[1].shape[0] // 9
    parts = []
    for s_ in range(k + 1):
        p = packed_w[s_]
        c0 = (k - s_) * gc + lo
        parts.append(p.reshape(9, p.shape[0] // 9, -1)[..., c0:c0 + n])
    w = torch.cat(parts, 1).float()
    return w.reshape(3, 3, w.shape[1], n).permute(3, 2, 0, 1)


def rdb5c_stage_plain(feats: Sequence[torch.Tensor],
                      packed_w: Sequence[torch.Tensor], bias: torch.Tensor,
                      k: int, lo: int, n: int, out: torch.Tensor
                      ) -> torch.Tensor:
    """Stage k of the block over its output columns [lo, lo + n), the
    kernel's arithmetic in plain PyTorch: one f32 conv of the
    working-type features [x|c1..ck] (``feats``, NHWC at the kernels'
    widths) against those columns of the packed weights, plus the bias,
    then lrelu (k < 4) or 0.2 v + x (k == 4), rounded to the working type
    once, written into ``out[..., lo:lo + n]``; returns ``out``."""
    cat = torch.cat([f.permute(0, 3, 1, 2).float() for f in feats], 1)
    v = F.conv2d(cat, _stage_weight(packed_w, k, lo, n), padding=1)
    v = v + bias.float()[lo:lo + n][None, :, None, None]
    if k == 4:
        v = v * 0.2 + feats[0][..., lo:lo + n].permute(0, 3, 1, 2).float()
    else:
        v = torch.where(v >= 0, v, v * 0.2)
    out[..., lo:lo + n] = v.to(out.dtype).permute(0, 2, 3, 1)
    return out


def rdb5c_stage(feats: Sequence[torch.Tensor],
                packed_w: Sequence[torch.Tensor], bias: torch.Tensor,
                k: int, lo: int, n: int, out: torch.Tensor) -> torch.Tensor:
    """Stage k over its output columns [lo, lo + n) into ``out`` (b, h, w,
    conv k's width), everything at the kernels' widths; the other columns
    of ``out`` are left as they are. On a CUDA tensor it launches the
    column-range stage of ``csrc/rdb5c.cu`` (or raises); on a CPU tensor
    it runs ``rdb5c_stage_plain``."""
    if feats[0].device.type == "cpu":
        return rdb5c_stage_plain(feats, packed_w, bias, k, lo, n, out)
    return _stage_kernel(feats, packed_w, bias, k, lo, n, out)


def _stage_kernel(feats, packed_w, bias, k, lo, n, out):
    global stage_launches
    x = feats[0]
    nf, gc = _check_packed(x, packed_w)
    width = gc if k < 4 else nf
    if len(feats) != k + 1:
        raise ValueError(f"stage {k} reads {k + 1} features")
    for t, c in [(f, gc) for f in feats[1:]] + [(out, width)]:
        if tuple(t.shape) != (*x.shape[:3], c) or not t.is_contiguous() \
                or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"features and out must be contiguous NHWC "
                             f"tensors of x's type, {c} channels")
    if tuple(bias.shape) != (width,) or bias.dtype != torch.float32 or \
            not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous f32 ({width},) tensor")
    if lo < 0 or n < 1 or lo + n > width:
        raise ValueError(f"columns [{lo}, {lo + n}) outside 0..{width}")
    b, h, w, _ = x.shape
    lib = _library()
    cs = list(feats[1:]) + [None] * (4 - k)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.rdb5c_forward_stage(
            _DTYPES[x.dtype], k, *_pointers([x, *packed_w, bias, *cs, out]),
            b, h, w, nf, gc, lo, n, stream)
    if err:
        raise RuntimeError("rdb5c stage kernel launch failed: "
                           + lib.rdb5c_error_string(err).decode())
    stage_launches += 1
    return out


def rdb5c_forward_split(x: torch.Tensor, packed_w: Sequence[torch.Tensor],
                        biases: Sequence[torch.Tensor], cols: Sequence,
                        plain: bool = False):
    """One block forward by stage, a generator: stage k over all its
    columns where ``cols[k]`` is None, else over this rank's (first,
    count) into a zeroed buffer, which it yields to be summed over the
    tensor ranks in place (``run_split``) before stage k + 1 reads it.
    Any width, as ``rdb5c_forward``; ``plain`` runs the plain stages on
    any device. Returns (out, c1, c2, c3, c4), out at x's width, c_k at
    gc'."""
    nf = x.shape[-1]
    packed_w, biases = pad_packed(packed_w, biases)
    xp = _padded_x(x, packed_w).contiguous()
    nfp, gcp = _pack_widths(packed_w)
    feats = [xp]
    for k in range(5):
        width = gcp if k < 4 else nfp
        y = _alloc((*xp.shape[:3], width), xp.dtype, xp.device)
        if cols[k] is not None:
            y.zero_()
        lo, n = cols[k] if cols[k] is not None else (0, width)
        (rdb5c_stage_plain if plain else rdb5c_stage)(
            feats, packed_w, biases[k], k, lo, n, y)
        if cols[k] is not None:
            yield y
        feats.append(y)
    out = feats[5] if xp is x else feats[5][..., :nf].contiguous()
    return (out, *feats[1:5])


class _PlainPieces:
    """The split backward's pieces in plain PyTorch (the CPU's), on
    flattened NHWC buffers: G (pixels, 4gc' + nf') in the working type."""

    def __init__(self, shape, device):
        self.b, self.h, self.w = shape
        self.device = device

    def nchw(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(self.b, self.h, self.w, -1).permute(0, 3, 1,
                                                             2).float()

    def flat(self, t: torch.Tensor) -> torch.Tensor:
        return t.permute(0, 2, 3, 1).reshape(self.b * self.h * self.w, -1)

    def dc5(self, g, G, nf):
        G[:, G.shape[1] - nf:] = (g.reshape(-1, nf).float() * 0.2).to(
            G.dtype)

    def part(self, dyw, wk, c0, out):
        w = _unpack9(wk[:, c0:c0 + dyw.shape[1]])
        out.copy_(self.flat(F.conv_transpose2d(self.nchw(dyw), w,
                                               padding=1)))

    def dx(self, G, wk, k, gc, runs, part, act, dst, last):
        cin, k0 = wk.shape[0] // 9, k * gc
        dc = torch.zeros((self.b, cin, self.h, self.w), device=self.device)
        if runs:
            dy = torch.cat([G[:, k0 + a:k0 + a + n] for a, n in runs], 1)
            w = torch.cat([wk[:, a:a + n] for a, n in runs], 1)
            dc = F.conv_transpose2d(self.nchw(dy), _unpack9(w), padding=1)
        if part is not None:
            dc = dc + self.nchw(part)
        a = self.nchw(act)
        v = dc + a if last else dc * torch.where(a >= 0, 1.0, 0.2)
        dst.copy_(self.flat(v).to(dst.dtype).reshape(dst.shape))

    def dw(self, G, acts, ws, gc, live):
        out = []
        for k, (a, wk) in enumerate(zip(acts, ws)):
            cin = wk.shape[0] // 9
            dy = self.nchw(G[:, k * gc:])
            d = torch.nn.grad.conv2d_weight(
                self.nchw(a), (dy.shape[1], cin, 3, 3), dy, padding=1)
            out.append(d.permute(2, 3, 1, 0).reshape(9 * cin, -1))
        return out

    def db(self, G, g, nf):
        return torch.cat([G[:, :G.shape[1] - nf].float().sum(0),
                          (g.reshape(-1, nf).float() * 0.2).sum(0)])


class _KernelPieces:
    """The split backward's pieces on the card: the entry points of
    ``csrc/rdb5c_bwd.cu`` beside ``rdb5c_backward``."""

    def __init__(self, shape, dtype, device, nf, gc):
        self.b, self.h, self.w = shape
        self.dt, self.dev = _DTYPES[dtype], device
        self.nf, self.gc = nf, gc
        self.lib = _bwd_library()
        self.stream = torch.cuda.current_stream(device).cuda_stream

    def _call(self, name, *args):
        with torch.cuda.device(self.dev):
            err = getattr(self.lib, name)(self.dt, *args)
        if err:
            raise RuntimeError(f"{name} launch failed: "
                               + self.lib.rdb5c_bwd_error_string(err)
                               .decode())

    def _dims(self):
        return (self.b, self.h, self.w, self.nf, self.gc, self.stream)

    def dc5(self, g, G, nf):
        self._call("rdb5c_bwd_dc5", *_pointers([g, G]), *self._dims())

    def part(self, dyw, wk, c0, out):
        self._call("rdb5c_bwd_part", *_pointers([dyw, wk, out]),
                   dyw.shape[1], wk.shape[0] // 9, wk.shape[1], c0,
                   out.stride(0), *self._dims())

    def dx(self, G, wk, k, gc, runs, part, act, dst, last):
        lo = (ctypes.c_int * 5)(*[a for a, _ in runs])
        ns = (ctypes.c_int * 5)(*[n for _, n in runs])
        self._call("rdb5c_bwd_dx_stage", *_pointers([G, wk]), k,
                   len(runs), lo, ns, *_pointers([part, act, dst]),
                   0 if part is None else part.stride(0),
                   dst.stride(0) if dst.dim() == 2 else self.nf, int(last),
                   *self._dims())

    def dw(self, G, acts, ws, gc, live):
        total = sum(p.numel() for p in ws)
        splits = _dw_splits(self.dt, self.b, self.h, self.w, self.nf,
                            self.gc, self.dev.index)
        part = _alloc((splits, total), torch.float32, self.dev)
        dw = _alloc(total, torch.float32, self.dev)
        masks = (ctypes.c_uint * 5)(*live)
        self._call("rdb5c_bwd_dw", *_pointers([G, *acts, part, dw]), masks,
                   splits, *self._dims())
        return [d.view(p.shape) for d, p in zip(
            dw.split([p.numel() for p in ws]), ws)]

    def db(self, G, g, nf):
        npix = G.shape[0]
        splits = min(npix, 256)
        part = _alloc((splits, G.shape[1]), torch.float32, self.dev)
        db = _alloc(G.shape[1], torch.float32, self.dev)
        self._call("rdb5c_bwd_db", *_pointers([G, g, part, db]), splits,
                   *self._dims())
        return db


def _runs(cols: Sequence, k: int, gc: int, nf: int):
    """The column runs of dy_k (relative to conv k's first column) that
    belong to the convs j >= k computed whole: (first, count) each,
    neighbours merged."""
    runs = []
    for j in range(k, 5):
        if cols[j] is not None:
            continue
        a, n = (j - k) * gc, gc if j < 4 else nf
        if runs and runs[-1][0] + runs[-1][1] == a:
            runs[-1] = (runs[-1][0], runs[-1][1] + n)
        else:
            runs.append((a, n))
    return runs


def rdb5c_backward_split(g: torch.Tensor, x: torch.Tensor, c1, c2, c3, c4,
                         packed_w: Sequence[torch.Tensor], cols: Sequence,
                         plain: bool = False):
    """One block backward with convs split by column, a generator (see
    ``rdb5c_forward_split``): for each split conv j (walking j = 4..0, as
    the dx stages do), once its output's gradient is known, this rank's
    columns' terms of every dx stage s <= j (an f32 (pixels, nf' + j gc')
    buffer), yielded to be summed over the tensor ranks; each dx stage
    then reduces over the convs computed whole alone and adds those sums
    before its lrelu' (or + g). dW of a split conv holds this rank's
    columns alone (the dW slots of the others' columns are skipped and
    zeroed), and so does its db (the bias is split with the conv). On a
    CUDA tensor the pieces are the kernels of ``csrc/rdb5c_bwd.cu``, on a
    CPU tensor (or with ``plain``) their plain versions. Returns (dx,
    dW0..dW4 packed f32, db1..db5 f32), as ``rdb5c_backward``."""
    global split_backward_launches
    nf = x.shape[-1]
    widths = _pack_widths(packed_w)
    ws, _ = pad_packed(packed_w)
    nfp, gcp = _pack_widths(ws)
    xp = _padded_x(x, ws).contiguous()
    gp = _padded_x(g, ws).contiguous()
    cs = [_pad_last(c, gcp).contiguous() for c in (c1, c2, c3, c4)]
    shape, dev, dt = tuple(xp.shape[:3]), xp.device, xp.dtype
    if dev.type == "cpu" or plain:
        ops = _PlainPieces(shape, dev)
    else:
        _check_backward(gp, xp, cs, ws)
        ops = _KernelPieces(shape, dt, dev, nfp, gcp)
    npix = shape[0] * shape[1] * shape[2]
    gw = 4 * gcp + nfp
    G = _alloc((npix, gw), dt, dev)
    ops.dc5(gp, G, nfp)
    cin = [nfp] + [gcp] * 4
    off = [0] + [nfp + i * gcp for i in range(4)]
    width = lambda j: gcp if j < 4 else nfp  # noqa: E731
    acts = [xp, *cs]
    dx = _alloc(xp.shape, dt, dev)
    part_sum = None
    for k in range(4, -1, -1):
        if cols[k] is not None:
            lo, n = cols[k]
            win_lo = lo // _CHUNK * _CHUNK
            win = padded_width(lo + n) - win_lo
            dyw = _alloc((npix, win), dt, dev).zero_()
            dyw[:, lo - win_lo:lo - win_lo + n] = \
                G[:, k * gcp + lo:k * gcp + lo + n]
            q = _alloc((npix, off[k] + cin[k]), torch.float32, dev)
            for s_ in range(k + 1):
                ops.part(dyw, ws[s_], (k - s_) * gcp + win_lo,
                         q[:, off[s_]:off[s_] + cin[s_]])
            yield q
            if part_sum is None:
                part_sum = q
            else:
                part_sum[:, :q.shape[1]].add_(q)
        part = None if part_sum is None else \
            part_sum[:, off[k]:off[k] + cin[k]]
        dst = dx if k == 0 else G[:, (k - 1) * gcp:k * gcp]
        ops.dx(G, ws[k], k, gcp, _runs(cols, k, gcp, nfp), part,
               gp if k == 0 else acts[k], dst, k == 0)
    live = []
    for s_ in range(5):
        mask = 0
        for c in range(ws[s_].shape[1] // _CHUNK):
            j = s_ + min(c * _CHUNK // gcp, 4 - s_)
            a = c * _CHUNK - (j - s_) * gcp
            if cols[j] is None or (a < cols[j][0] + cols[j][1]
                                   and cols[j][0] < a + _CHUNK):
                mask |= 1 << c
        live.append(mask)
    dws = ops.dw(G, acts, ws, gcp, live)
    for j in range(5):
        if cols[j] is None:
            continue
        lo, n = cols[j]
        for s_ in range(j + 1):
            a = (j - s_) * gcp
            dws[s_][:, a:a + lo] = 0
            dws[s_][:, a + lo + n:a + width(j)] = 0
    db = ops.db(G, gp, nfp)
    for j in range(5):
        if cols[j] is not None:
            a = 4 * gcp if j == 4 else j * gcp
            db[a:a + cols[j][0]] = 0
            db[a + sum(cols[j]):a + width(j)] = 0
    if isinstance(ops, _KernelPieces):
        split_backward_launches += 1
    if xp is not x:
        dx = dx[..., :nf].contiguous()
    dws, dbs = unpad_grads(dws, db.split([gcp] * 4 + [nfp]), *widths)
    return (dx, *dws, *dbs)


def run_split(gen, reduce: Callable[[torch.Tensor], Any]):
    """Drives a split generator on one rank: each buffer it yields is
    given to ``reduce`` (an in-place sum over the tensor group); returns
    the generator's result."""
    try:
        buf = next(gen)
        while True:
            reduce(buf)
            buf = gen.send(None)
    except StopIteration as stop:
        return stop.value


def run_lockstep(gens: Sequence):
    """Drives the split generators of T ranks in one process, in lock
    step: the buffers they yield together are summed in rank order and
    the sum written back into each. Returns each generator's result."""
    gens = list(gens)
    results = [None] * len(gens)
    bufs = []
    for i, gen in enumerate(gens):
        try:
            bufs.append(next(gen))
        except StopIteration as stop:
            results[i] = stop.value
    while bufs:
        total = bufs[0].clone()
        for b in bufs[1:]:
            total += b
        for b in bufs:
            b.copy_(total)
        nxt = []
        for i, gen in enumerate(gens):
            try:
                nxt.append(gen.send(None))
            except StopIteration as stop:
                results[i] = stop.value
        bufs = nxt
    return results


def _packed(x: torch.Tensor, packer, params):
    """(packed weights, f32 biases) of a block's ten parameters in x's
    type, from ``packer`` (its cache) or packed here."""
    if packer is not None:
        return packer(x.dtype)
    return pack_block(params[0::2], params[1::2], x.shape[-1],
                      params[0].shape[0], x.dtype)


class RDB5CSplitFunction(torch.autograd.Function):
    """One residual dense block under autograd with convs split by output
    column over the running step's tensor axis: ``rdb5c_forward_split``
    and ``rdb5c_backward_split``, their buffers summed over the tensor
    group (``collectives.tensor_all_reduce``). ``apply(x, packer, cols,
    w1, b1, ..., w5, b5)`` as ``RDB5CFunction``; ``cols``: per conv this
    rank's (first, count) of its output columns, or None. The input's
    gradient is whole on every rank; a split conv's weight and bias
    gradients hold this rank's columns alone."""

    @staticmethod
    def forward(ctx, x, packer, cols, *params):
        from ..parallel.collectives import tensor_all_reduce

        nf = x.shape[-1]
        gc = params[0].shape[0]
        with torch.no_grad():
            ws, bs = _packed(x, packer, params)
            x = x.contiguous()
            out, *cs = run_split(rdb5c_forward_split(x, ws, bs, cols),
                                 tensor_all_reduce)
        ctx.save_for_backward(x, *cs, *ws)
        ctx.dims, ctx.cols = (nf, gc), cols
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        from ..parallel.collectives import tensor_all_reduce

        x, c1, c2, c3, c4, *ws = ctx.saved_tensors
        nf, gc = ctx.dims
        g = g.to(x.dtype).contiguous()
        dx, *rest = run_split(rdb5c_backward_split(
            g, x, c1, c2, c3, c4, ws, ctx.cols), tensor_all_reduce)
        dws, dbs = unpad_grads(rest[:5], rest[5:], nf, gc)
        dws = unpack_rdb_wgrads(dws, nf, gc)
        param_grads = [t for pair in zip(dws, dbs) for t in pair]
        return (dx, None, None, *param_grads)


class RDB5CFunction(torch.autograd.Function):
    """One residual dense block under autograd: ``rdb5c_forward`` with its
    residuals kept, ``rdb5c_backward`` as the gradient.

    ``apply(x, packer, w1, b1, ..., w5, b5)``: x is NHWC in the working
    type, the ten conv parameters are f32 OIHW weights and biases.
    ``packer(dtype)`` returns the (cached) packed weights and f32 biases of
    those parameters, at the kernels' widths (``pack_block``); with
    ``None`` they are packed here. Returns out in NHWC; the parameters'
    gradients are f32, at their own widths. The residuals kept for the
    backward are at gc'."""

    @staticmethod
    def forward(ctx, x, packer, *params):
        nf = x.shape[-1]
        gc = params[0].shape[0]
        with torch.no_grad():
            ws, bs = _packed(x, packer, params)
            x = x.contiguous()
            out, *cs = rdb5c_forward(x, ws, bs, return_residuals=True)
        ctx.save_for_backward(x, *cs, *ws)
        ctx.dims = (nf, gc)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, c1, c2, c3, c4, *ws = ctx.saved_tensors
        nf, gc = ctx.dims
        # g arrives as a permuted view, possibly in another type
        g = g.to(x.dtype).contiguous()
        dx, *rest = rdb5c_backward(g, x, c1, c2, c3, c4, ws)
        dws, dbs = unpad_grads(rest[:5], rest[5:], nf, gc)
        dws = unpack_rdb_wgrads(dws, nf, gc)
        param_grads = [t for pair in zip(dws, dbs) for t in pair]
        return (dx, None, *param_grads)
