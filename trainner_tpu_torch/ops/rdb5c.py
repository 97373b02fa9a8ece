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
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

# Launches of the CUDA kernels: one count per block forward (five stages)
# and one per block backward.
launches = 0
backward_launches = 0

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
            if packer is None:
                ws, bs = pack_block(params[0::2], params[1::2], nf, gc,
                                    x.dtype)
            else:
                ws, bs = packer(x.dtype)
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
