"""The residual dense block split by output column over T tensor ranks
(``trainner_tpu_torch/ops/rdb5c.py``: ``rdb5c_forward_split``,
``rdb5c_backward_split``, the plain versions of the column-range stage
and of the split backward's pieces), on the CPU: T ranks run in lock step
in one process (``run_lockstep`` sums the buffers they yield, as the
tensor group's all-reduce does), and the parts joined must equal the
unsplit block (``rdb5c_forward`` / ``rdb5c_backward``, whose plain
versions the CPU runs):

- forward: every rank's out and c1..c4 equal the unsplit block's;
- backward: dx equal on every rank and to the unsplit dx; each split
  conv's weight and bias gradients summed over the ranks, each whole
  conv's equal on every rank, equal to the unsplit gradients.

f32 at 2e-6 of each tensor's largest magnitude (the sums of a split conv
are taken in another order); bf16 at two ulps of the largest magnitude
for out, c_k and dx, 2^-10 for dW and db, as the card's kernel
tolerances (a da_k that rounds the other way feeds the later stages).
Cases: the flagship's conv5 over 2 and 4 ranks, inner stages (gc 64:
conv2-5, and conv2 and conv4 alone, nf 64 gc 32), every conv of a
narrow, padded block (nf 8, gc 4), and a range that is not 32 columns
wide.
"""

import math

import pytest
import torch

from trainner_tpu_torch.ops import rdb5c as R

torch.set_num_threads(2)

CASES = [(64, 32, (4,), 2), (64, 32, (4,), 4), (64, 64, (1, 2, 3, 4), 4),
         (64, 32, (1, 3), 2), (8, 4, (0, 1, 2, 3, 4), 2),
         (8, 4, (0, 2, 4), 4)]


def _block(nf, gc, dt, seed=0, shape=(2, 9, 7)):
    g = torch.Generator().manual_seed(seed)
    ws = [torch.randn(gc if k < 4 else nf, nf + k * gc, 3, 3, generator=g)
          * (0.5 / math.sqrt(9 * (nf + k * gc))) for k in range(5)]
    bs = [torch.randn(gc if k < 4 else nf, generator=g) * 0.05
          for k in range(5)]
    x = (torch.randn(*shape, nf, generator=g) * 0.5).to(dt)
    go = torch.randn(*shape, nf, generator=g).to(dt)
    packed, biases = R.pack_block(ws, bs, nf, gc, dt)
    return x, go, packed, biases


def _cols(nf, gc, which, n_ranks, t):
    return tuple(((gc if k < 4 else nf) // n_ranks * t,
                  (gc if k < 4 else nf) // n_ranks) if k in which else None
                 for k in range(5))


def _close(a, b, dt, what, kind="out"):
    top = float(b.float().abs().max())
    if dt == torch.float32:
        tol = 2e-6 * max(top, 1.0)
    elif kind == "out":
        tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
    else:
        tol = top * 2.0 ** -10
    err = float((a.float() - b.float()).abs().max())
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nf,gc,which,n_ranks", CASES)
def test_split_block_joins_to_the_block(nf, gc, which, n_ranks, dt):
    x, go, packed, biases = _block(nf, gc, dt)
    cols = [_cols(nf, gc, which, n_ranks, t) for t in range(n_ranks)]
    whole = R.rdb5c_forward(x, packed, biases, return_residuals=True)
    ranks = R.run_lockstep([R.rdb5c_forward_split(x, packed, biases, c)
                            for c in cols])
    for r in ranks:
        for name, a, b in zip(("out", "c1", "c2", "c3", "c4"), r, whole):
            assert a.shape == b.shape and a.dtype == b.dtype
            _close(a, b, dt, name)
    cs = ranks[0][1:]
    want = R.rdb5c_backward(go, x, *cs, packed)
    back = R.run_lockstep([R.rdb5c_backward_split(go, x, *cs, packed, c)
                           for c in cols])
    for r in back[1:]:
        assert torch.equal(r[0], back[0][0])
    _close(back[0][0], want[0], dt, "dx")
    per = [(R.unpack_rdb_wgrads(r[1:6], nf, gc), r[6:]) for r in back]
    ref_w = R.unpack_rdb_wgrads(want[1:6], nf, gc)
    for j in range(5):
        for part, ref in ((0, ref_w[j]), (1, want[6 + j])):
            got = [p[part][j] for p in per]
            if j in which:
                joined = sum(got)
            else:
                assert all(torch.equal(g, got[0]) for g in got), (j, part)
                joined = got[0]
            _close(joined, ref, dt, f"conv {j + 1} {'dW db'.split()[part]}",
                   "grad")


def test_a_split_conv_keeps_its_own_columns_alone():
    """One rank's view: a split conv's dW and db outside its columns are
    exactly 0 (their dW slots are skipped), and the forward leaves the
    other ranks' columns of a split stage's buffer at 0 before the sum."""
    nf, gc = 64, 32
    x, go, packed, biases = _block(nf, gc, torch.float32, seed=3)
    cols = _cols(nf, gc, (4,), 4, 1)  # conv5's columns 16..31
    gen = R.rdb5c_forward_split(x, packed, biases, cols)
    buf = next(gen)
    assert not bool(buf[..., :16].any()) and not bool(buf[..., 32:].any())
    assert bool(buf[..., 16:32].any())
    out, *cs = R.run_split(gen, lambda t: None)
    dx, *rest = R.run_split(R.rdb5c_backward_split(
        go, x, *cs, packed, cols), lambda t: None)
    dw5 = R.unpack_rdb_wgrads(rest[:5], nf, gc)[4]
    db5 = rest[9]
    assert not bool(dw5[:16].any()) and not bool(dw5[32:].any())
    assert bool(dw5[16:32].any())
    assert not bool(db5[:16].any()) and not bool(db5[32:].any())


def test_runs_and_live_groups():
    """The dx stages' column runs over the whole convs, neighbours merged,
    and the stage of a split conv alone has none."""
    cols = (None, (0, 16), None, None, (32, 32))
    assert R._runs(cols, 0, 32, 64) == [(0, 32), (64, 64)]
    assert R._runs(cols, 2, 32, 64) == [(0, 64)]
    assert R._runs(cols, 4, 32, 64) == []


@pytest.mark.parametrize("lo,n", [(0, 8), (4, 4)])
def test_the_library_yardstick_does_one_ranks_work(lo, n):
    """``chip_smoke._library_split_backward``, which times the split
    backward's library call on the card, run on the CPU: autograd through
    the five convs gives the block's gradients when conv5 keeps all its
    columns, and conv5's rows of them when it is cut to [lo, lo + n)."""
    import chip_smoke

    nf, gc = 8, 4
    g = torch.Generator().manual_seed(5)
    ws = [torch.randn(gc if k < 4 else nf, nf + k * gc, 3, 3, generator=g)
          * (0.5 / math.sqrt(9 * (nf + k * gc))) for k in range(5)]
    bs = [torch.randn(gc if k < 4 else nf, generator=g) * 0.05
          for k in range(5)]
    x = torch.randn(2, 9, 7, nf, generator=g) * 0.5
    go = torch.randn(2, 9, 7, nf, generator=g)
    packed = R.pack_rdb_weights(ws, nf, gc, torch.float32)  # at nf, gc
    _, *cs = R.rdb5c_forward(x, packed, bs, return_residuals=True)
    ref = R.rdb5c_backward(go, x, *cs, packed)
    dws = R.unpack_rdb_wgrads(ref[1:6], nf, gc)
    got = chip_smoke._library_split_backward(x, go, ws, bs, lo, n)()
    dx, gws, gbs = got[0].permute(0, 2, 3, 1), got[1:6], got[6:]
    _close(gws[4], dws[4][lo:lo + n], torch.float32, "dW5", "grad")
    _close(gbs[4], ref[10][lo:lo + n], torch.float32, "db5", "grad")
    if n == nf:
        _close(dx, ref[0], torch.float32, "dx", "grad")
        for k in range(4):
            _close(gws[k], dws[k], torch.float32, f"dW{k + 1}", "grad")
            _close(gbs[k], ref[6 + k], torch.float32, f"db{k + 1}", "grad")
