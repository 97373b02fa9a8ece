#!/usr/bin/env python3
"""Which side of ``chip_smoke.py``'s bf16 check of the block backward at nf
64 / gc 64 on (1, 21, 45) varies between processes: the kernel
(``rdb5c_backward``) or its plain version (``rdb5c_backward_plain``, cuDNN's
f32 transposed and weight-gradient convs).

Rebuilds that check's input from phase 3's seeded draws, twice: as phase 3
draws it now ("phase3") and as it was drawn while phase 14's serving shape
drew its x and output gradient from the shared generator ("zoo-draw"),
the input that read
8.1e-4 and 1.05e-3 against a tolerance of 9.3e-4 in two calls. For each it
runs the kernel forward (the residuals both backwards take), the kernel
backward twice, the plain version twice with cuDNN's default algorithms and
once with its deterministic ones, and an f64 reference on the CPU: the
plain version's arithmetic with every sum in f64 and the same roundings of
da_k to bf16. Prints each output's error against the plain version (the
check), against the f64 reference, and whether the repeats are equal bit
for bit; saves the arrays to OUT.npz. ``--compare A.npz B.npz`` says, array
by array, whether two processes' runs are equal bit for bit.

Usage: python3 scripts/rdb5c_bwd_repeat.py OUT.npz   (needs one CUDA card)
       python3 scripts/rdb5c_bwd_repeat.py --compare A.npz B.npz
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

WIDTH = (64, 64)


def _inputs(zoo_draw: bool):
    """Phase 3's draws up to the (nf, gc) = WIDTH check: weights, biases,
    x and the output gradient, on the CPU."""
    import torch

    import chip_smoke as cs

    gen = torch.Generator().manual_seed(0)
    cs._block_weights(gen)
    for shape in (cs.MAIN_SHAPE, cs.TRAIN_SHAPE, cs.RAGGED_SHAPE,
                  cs.RAGGED_B1_SHAPE):
        torch.randn(*shape, cs.NF, generator=gen)
        torch.randn(*shape, cs.NF, generator=gen)
    if zoo_draw:  # phase 14's serving shape: x and an output gradient
        torch.randn(*cs.ZOO_SERVE_SHAPE, cs.NF, generator=gen)
        torch.randn(*cs.ZOO_SERVE_SHAPE, cs.NF, generator=gen)
    for nf, gc in cs.OTHER_WIDTHS:
        ws, bs = cs._block_weights(gen, nf, gc)
        x = torch.randn(*cs.RAGGED_B1_SHAPE, nf, generator=gen) * 0.5
        g = torch.randn(*cs.RAGGED_B1_SHAPE, nf, generator=gen)
        if (nf, gc) == WIDTH:
            return ws, bs, x, g
    raise AssertionError(f"{WIDTH} is not among chip_smoke.OTHER_WIDTHS")


def _backward_f64(g, x, cs_, packed):
    """``rdb5c_backward_plain``'s arithmetic with f64 sums: dc5 and each
    da_k rounded to bf16 before any product, as there."""
    import torch
    import torch.nn.functional as F

    from trainner_tpu_torch.ops.rdb5c import _unpack9

    def nchw(t):
        return t.cpu().permute(0, 3, 1, 2).double()

    def rounded(t):
        return t.to(torch.bfloat16).double()

    g64 = nchw(g)
    dc5 = g64 * 0.2
    db5 = dc5.sum((0, 2, 3))
    grads = [None, None, None, None, rounded(dc5)]
    acts = (x, *cs_)
    dws = [None] * 5
    dx = None
    for k in range(4, -1, -1):
        dy = torch.cat(grads[k:], 1)
        w = _unpack9(packed[k]).cpu().double()
        a = nchw(acts[k])
        dc = F.conv_transpose2d(dy, w, padding=1)
        dw = torch.nn.grad.conv2d_weight(a, w.shape, dy, padding=1)
        dws[k] = dw.permute(2, 3, 1, 0).reshape(9 * w.shape[1], w.shape[0])
        if k == 0:
            dx = (dc + g64).permute(0, 2, 3, 1)
        else:
            grads[k - 1] = rounded(dc * torch.where(a >= 0, 1.0, 0.2))
    dbs = [t.sum((0, 2, 3)) for t in grads[:4]] + [db5]
    return (dx, *dws, *dbs)


def run(out: str) -> None:
    import torch

    import chip_smoke as cs
    from trainner_tpu_torch.ops.rdb5c import (pack_rdb_weights,
                                              rdb5c_backward,
                                              rdb5c_backward_plain,
                                              rdb5c_forward)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bf16 = torch.bfloat16
    saved = {}
    for variant in ("phase3", "zoo-draw"):
        ws, bs, x, g = _inputs(variant == "zoo-draw")
        nf, gc = WIDTH
        packed = pack_rdb_weights([w.cuda() for w in ws], nf, gc, bf16)
        xd = x.cuda().to(bf16).contiguous()
        gd = g.cuda().to(bf16).contiguous()
        res = rdb5c_forward(xd, packed, [b.cuda() for b in bs],
                            return_residuals=True)[1:]
        runs = {"kernel": rdb5c_backward(gd, xd, *res, packed),
                "kernel_again": rdb5c_backward(gd, xd, *res, packed),
                "plain": rdb5c_backward_plain(gd, xd, *res, packed),
                "plain_again": rdb5c_backward_plain(gd, xd, *res, packed)}
        torch.backends.cudnn.deterministic = True
        runs["plain_deterministic"] = rdb5c_backward_plain(gd, xd, *res,
                                                           packed)
        torch.backends.cudnn.deterministic = False
        torch.cuda.synchronize()
        f64 = _backward_f64(gd, xd, res, packed)
        for i, c in enumerate(res):
            saved[f"{variant}/c{i + 1}"] = c.float().cpu().numpy()
        for name, i in zip(cs.BWD_NAMES, range(len(cs.BWD_NAMES))):
            ref = f64[i]
            tol = cs._backward_tolerance(bf16, name,
                                         runs["plain"][i].float())
            errs = {}
            for side, outs in runs.items():
                a = outs[i].float().cpu()
                saved[f"{variant}/{side}/{name}"] = a.numpy()
                errs[side] = float((a.double() - ref).abs().max())
            check = float((runs["kernel"][i].float()
                           - runs["plain"][i].float()).abs().max())
            same_k = torch.equal(runs["kernel"][i], runs["kernel_again"][i])
            same_p = torch.equal(runs["plain"][i], runs["plain_again"][i])
            same_d = torch.equal(runs["plain"][i],
                                 runs["plain_deterministic"][i])
            print(f"{variant} {name}: kernel vs plain {check:.4e} (tol "
                  f"{tol:.4e}); against f64: kernel {errs['kernel']:.4e}, "
                  f"plain {errs['plain']:.4e}, plain again "
                  f"{errs['plain_again']:.4e}, plain deterministic "
                  f"{errs['plain_deterministic']:.4e}; in this process "
                  f"kernel repeat equal {same_k}, plain repeat equal "
                  f"{same_p}, plain = deterministic {same_d}")
    np.savez(out, **saved)
    print(cs._smi())


def compare(a: str, b: str) -> None:
    fa, fb = np.load(a), np.load(b)
    for key in sorted(fa.files):
        same = np.array_equal(fa[key], fb[key])
        diff = float(np.abs(fa[key] - fb[key]).max())
        print(f"{key}: equal across processes {same} (max diff {diff:.4e})")


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        run(sys.argv[1])
