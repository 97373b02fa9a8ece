"""What the f32 block kernels (3xTF32 on the tensor cores: ``csrc/
conv3x3_mma.cuh`` with ``rdb_stage_tf32`` / ``rdb_dx_stage_tf32``, and
``dw_tf32_kernel`` in ``rdb5c_bwd.cu``) rely on, held on the CPU:

- the split a = hi + lo of each f32 operand into two tf32 values
  (``cvt.rna.tf32.f32``, emulated through an int32 view), run through the
  plain forward and backward, meets the tolerances ``chip_smoke.py`` holds
  the kernels to on the card, and one tf32 product alone does not;
- the fragment maps: a non-transposed 32-bit ``ldmatrix.x4`` over the
  pixel-major halo tile gives the m16n8k8 tf32 A fragment, and the swizzled
  weight slabs and the dW tiles give the B fragments, so that one tile's
  products, emulated lane by lane from the kernels' own address formulas,
  are the conv's and the weight gradient's;
- bank maps free of conflicts and shared-memory budgets within a block's
  232,448 bytes.

The kernels themselves run only on the card, where ``chip_smoke.py`` holds
them against the same plain versions.
"""

import contextlib
import pathlib
import re
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from trainner_tpu_torch.ops import rdb5c
from trainner_tpu_torch.ops.rdb5c import (pack_rdb_weights,
                                          rdb5c_backward_plain,
                                          rdb5c_forward_plain)

torch.set_num_threads(2)

CSRC = pathlib.Path(rdb5c.__file__).resolve().parent.parent / "csrc"
SMEM_PER_BLOCK = 232448


def _constants(source, names=None):
    """``constexpr int NAME = expr;`` of a source, evaluated in order with
    ``rdbm::`` dropped; a name whose expression is not plain arithmetic is
    left out."""
    names = dict(names or {})
    text = (CSRC / source).read_text().replace("rdbm::", "")
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        try:
            names[name] = eval(expr, {}, names)  # noqa: S307 - the repo's source
        except (NameError, SyntaxError, TypeError):
            pass
    return names


HDR = _constants("conv3x3_mma.cuh")
BWD = _constants("rdb5c_bwd.cu", HDR)


# ---------------------------------------------------------------------------
# cvt.rna.tf32.f32 and the three-product split
# ---------------------------------------------------------------------------
def tf32(t: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to nearest on the 13 dropped mantissa bits,
    ties away from zero (sign and magnitude: adding half of the dropped
    range to the magnitude's bits rounds the magnitude up at a tie)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(t):
    hi = tf32(t)
    return hi, tf32(t - hi)


def _products(op, passes):
    """op(a, b, ...) in tf32: three products (lo*hi' + hi*lo' + hi*hi', as
    the kernels take them) or one (hi*hi')."""
    def f(a, b, *args, **kw):
        ah, al = split(a)
        bh, bl = split(b)
        if passes == 1:
            return op(ah, bh, *args, **kw)
        return (op(al, bh, *args, **kw) + op(ah, bl, *args, **kw)
                + op(ah, bh, *args, **kw))
    return f


@contextlib.contextmanager
def tf32_products(passes):
    """The plain versions' convs, transposed convs and weight gradients
    taken in tf32 products."""
    saved = rdb5c.F, torch.nn.grad.conv2d_weight
    conv_weight = saved[1]

    def dw(a, shape, dy, **kw):
        return _products(lambda a_, d_: conv_weight(a_, shape, d_, **kw),
                         passes)(a, dy)

    rdb5c.F = types.SimpleNamespace(
        conv2d=_products(F.conv2d, passes),
        conv_transpose2d=_products(F.conv_transpose2d, passes))
    torch.nn.grad.conv2d_weight = dw
    try:
        yield
    finally:
        rdb5c.F, torch.nn.grad.conv2d_weight = saved


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),  # 1.0 stays
    (0x3F800FFF, 0x3F800000),  # below half of the dropped range: down
    (0x3F801000, 0x3F802000),  # a tie: away from zero
    (0xBF801000, 0xBF802000),  # the same on the negative side
    (0x3F801001, 0x3F802000),  # above half: up
    (0x3FFFF000, 0x40000000),  # the carry runs into the exponent
])
def test_tf32_rounds_to_nearest_ties_away(bits, want):
    t = torch.tensor([bits], dtype=torch.int64).to(torch.int32)
    got = tf32(t.view(torch.float32)).view(torch.int32)
    assert int(got) & 0xFFFFFFFF == want


def test_split_parts_are_tf32_and_sum_to_the_value():
    x = torch.from_numpy(np.random.RandomState(0).randn(10000)
                         .astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert bool((lo.abs() <= hi.abs() * 2.0 ** -11).all())
    # lo*lo' is what 3xTF32 drops: the split itself is good to 2^-22
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= x.double().abs() * 2.0 ** -22).all())


def _block(nf, gc, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    ws, bs = chip_smoke._block_weights(gen, nf, gc)
    packed = pack_rdb_weights(ws, nf, gc, torch.float32)
    x = torch.randn(*shape, nf, generator=gen) * 0.5
    g = torch.randn(*shape, nf, generator=gen)
    return packed, bs, x, g


def _errors(passes, shape, seed=0, nf=32, gc=32):
    """Largest error of each output of the plain forward and backward in
    tf32 products against the same in f32, beside the card's tolerance."""
    packed, bs, x, g = _block(nf, gc, shape, seed)
    ref = rdb5c_forward_plain(x, packed, bs, return_residuals=True)
    ref_b = rdb5c_backward_plain(g, x, *ref[1:], packed)
    with tf32_products(passes):
        got = rdb5c_forward_plain(x, packed, bs, return_residuals=True)
        got_b = rdb5c_backward_plain(g, x, *ref[1:], packed)
    out = {}
    for name, a, r in zip(("out", "c1", "c2", "c3", "c4"), got, ref):
        out[name] = (float((a - r).abs().max()),
                     chip_smoke._tolerance(torch.float32, r))
    for name, a, r in zip(chip_smoke.BWD_NAMES, got_b, ref_b):
        out[name] = (float((a - r).abs().max()),
                     chip_smoke._backward_tolerance(torch.float32, name, r))
    return out


@pytest.mark.parametrize("shape", [(1, 21, 45), (2, 9, 7), (3, 17, 5)])
def test_three_tf32_products_meet_the_card_tolerances(shape):
    for name, (err, tol) in _errors(3, shape).items():
        assert err <= tol, (name, err, tol)


def _tile_sums(inp, B, model, one_way=False):
    """One stage of the tile of conv3x3_mma.cuh in 3xTF32, mma by mma as
    the card adds (``model``: chip_smoke.TF32_MMA): for each 32-channel
    chunk of ``inp`` (b, h, w, K), tap t and k-step of 8 channels, the
    three tf32 products lo*hi', hi*lo', hi*hi', each mma adding its eight
    products to a zeroed sum of the k-step as chip_smoke.mma_tf32_sum
    does, that sum then added to the running sum in f32, rounded to
    nearest (``one_way``: each mma onto the running sum, the tile before
    the repair of ROADMAP C 27). B[t][c][n] is the weight of input channel
    c at tap t for output column n. Returns the f32 sums (b, h, w, N) as
    f64."""
    b, h, w, k_ch = inp.shape
    n_out = B.shape[-1]
    a_hi, a_lo = (t.double() for t in split(inp))
    b_hi, b_lo = (t.double() for t in split(B))
    pad = lambda t: F.pad(t.permute(0, 3, 1, 2), (1, 1, 1, 1))  # noqa
    a_hi, a_lo = pad(a_hi), pad(a_lo)
    acc = torch.zeros(b * h * w, n_out, dtype=torch.float64)
    for chunk in range(k_ch // 32):
        for t in range(9):
            win = lambda a: a[:, :, t // 3:t // 3 + h, t % 3:t % 3 + w]  # noqa
            for kk in range(4):
                cs = slice(32 * chunk + 8 * kk, 32 * chunk + 8 * kk + 8)
                ah = win(a_hi)[:, cs].permute(0, 2, 3, 1).reshape(-1, 8)
                al = win(a_lo)[:, cs].permute(0, 2, 3, 1).reshape(-1, 8)
                bh, bl = b_hi[t, cs].T, b_lo[t, cs].T  # (N, 8)
                part = acc if one_way else torch.zeros_like(acc)
                for a_, b_ in ((al, bh), (ah, bl), (ah, bh)):
                    part = chip_smoke.mma_tf32_sum(part, a_[:, None, :],
                                                   b_[None], **model)
                acc = part if one_way else part.add(acc).float().double()
    return acc.reshape(b, h, w, n_out)


def _dx_emulated(g, x, cs, packed, model):
    """The f32 backward's dx as the card computes it: dc5 = 0.2 g, then the
    five dx stages on the tile (``_tile_sums``, B the tap-flipped
    transpose of the packed W_k), each epilogue in f32: da_k = dc_k times
    lrelu' from the sign of c_k, dx = dc_0 + g."""
    nf, gc = x.shape[-1], cs[0].shape[-1]
    G = [None] * 4 + [(g * 0.2).double()]
    acts = (x,) + tuple(cs)
    for k in range(4, -1, -1):
        cin = nf if k == 0 else gc
        wk = packed[k].reshape(9, cin, -1)
        B = wk.flip(0).permute(0, 2, 1)  # [t][c of dy_k][n of dc_k]
        dc = _tile_sums(torch.cat(G[k:], -1).float(), B, model)
        if k == 0:
            return (dc + g.double()).float()
        slope = torch.where(acts[k] >= 0, 1.0, 0.2).double()
        G[k - 1] = (dc * slope).float().double()


# The card's dx error against the plain f32 dx over the 2e-6 * max|dx|
# tolerance, f32 at nf 64, gc 32, on chip_smoke.py's inputs at
# RAGGED_B1_SHAPE: 3.576e-07 / 8.502e-06 (chip_smoke.py's kernel phase on
# an NVIDIA H100 80GB HBM3 at 700 W, each k-step's mma sum added to the
# running sum rounded to nearest; 2.623e-06 when every mma added onto the
# running sum). The emulation below is to predict it within a factor of
# two.
CARD_DX_MARGIN = 3.576e-07 / 8.502e-06


def _smoke_inputs_at_ragged_b1():
    """The weights, x and g that chip_smoke.phase_kernels draws for its
    f32 comparison at RAGGED_B1_SHAPE (the same generator, the same order
    of draws)."""
    gen = torch.Generator().manual_seed(0)
    ws, bs = chip_smoke._block_weights(gen)
    for shape in (chip_smoke.MAIN_SHAPE, chip_smoke.TRAIN_SHAPE,
                  chip_smoke.RAGGED_SHAPE, chip_smoke.RAGGED_B1_SHAPE):
        x = torch.randn(*shape, chip_smoke.NF, generator=gen) * 0.5
        g = torch.randn(*shape, chip_smoke.NF, generator=gen)
    return ws, bs, x, g


def test_three_tf32_products_leave_dx_far_inside_its_tolerance():
    """dx sums up to 1,728 products per output through five chained
    stages. Emulated as the card adds (each mma's eight products and its
    running sum aligned to the largest operand exponent, cut towards zero
    below 2^-25 of it, the sum cut towards zero: chip_smoke.TF32_MMA),
    3xTF32's dx error predicts the card's margin under the 2e-6 of max|dx|
    that f32 sums in another order are held to, within a factor of two,
    and stays inside that tolerance. Each k-step's three mmas sum into a
    zeroed accumulator that is then added to the running sum rounded to
    nearest, as the tile does since ROADMAP C 27's repair."""
    ws, bs, x, g = _smoke_inputs_at_ragged_b1()
    nf, gc = chip_smoke.NF, chip_smoke.GC
    packed = pack_rdb_weights(ws, nf, gc, torch.float32)
    _, *cs = rdb5c_forward_plain(x, packed, bs, return_residuals=True)
    ref = rdb5c_backward_plain(g, x, *cs, packed)[0]
    tol = chip_smoke._backward_tolerance(torch.float32, "dx", ref)
    got = _dx_emulated(g, x, cs, packed, chip_smoke.TF32_MMA)
    margin = float((got - ref).abs().max()) / tol
    assert margin < 1.0
    assert CARD_DX_MARGIN / 2 <= margin <= CARD_DX_MARGIN * 2, margin


def test_the_stage_emulation_adds_as_the_tile_does():
    """chip_smoke.stage_sums_emulated, which the card's PBR serving check
    holds the f32 kernels to bit for bit, gives the sums of ``_tile_sums``
    (each mma through chip_smoke.mma_tf32_sum under TF32_MMA) bit for bit,
    and its split is this file's."""
    gen = torch.Generator().manual_seed(3)
    inp = torch.randn(2, 3, 5, 64, generator=gen)
    B = torch.randn(9, 64, 32, generator=gen) * 0.05
    for one_way in (False, True):
        assert torch.equal(
            chip_smoke.stage_sums_emulated(inp, B, one_way),
            _tile_sums(inp, B, chip_smoke.TF32_MMA, one_way))
    for got, want in zip(chip_smoke.tf32_split(inp), split(inp)):
        assert torch.equal(got, want)


def test_blocks_side_by_side_emulate_as_each_alone():
    """chip_smoke.rdb_forward_emulated over a leading axis of independent
    blocks (the card's PBR trace emulates all 69 at once) gives each
    block's own emulation bit for bit."""
    gen = torch.Generator().manual_seed(5)
    nf = gc = 32
    xs, packs, biases = [], [], []
    for _ in range(2):
        ws, bs = chip_smoke._block_weights(gen, nf, gc)
        xs.append(torch.randn(1, 3, 4, nf, generator=gen) * 0.5)
        packs.append(pack_rdb_weights(ws, nf, gc, torch.float32))
        biases.append(bs)
    together = chip_smoke.rdb_forward_emulated(
        torch.stack(xs), [torch.stack([p[k] for p in packs])
                          for k in range(5)],
        [torch.stack([b[k] for b in biases]) for k in range(5)])
    for i in range(2):
        assert torch.equal(together[i], chip_smoke.rdb_forward_emulated(
            xs[i], packs[i], biases[i]))


def _block_f64(x, ws, bs):
    """One block forward in f64 from OIHW weights, NHWC in and out."""
    xc = x.double().permute(0, 3, 1, 2)
    feats = [xc]
    for k in range(5):
        v = F.conv2d(torch.cat(feats, 1), ws[k].double(), bs[k].double(),
                     padding=1)
        if k == 4:
            return (v * 0.2 + xc).permute(0, 2, 3, 1)
        feats.append(torch.where(v >= 0, v, 0.2 * v))


def _trained_blocks(n_steps=(0, 8, 16), seed=4):
    """Snapshots of one block (nf 64, gc 32, OIHW weights and biases)
    trained by Adam on the CPU in f32 towards a fixed random target, after
    each of ``n_steps`` steps: weights moved off their init, as a served
    G's are."""
    from trainner_tpu_torch.models.rrdb import ResidualDenseBlock5C

    gen = torch.Generator().manual_seed(seed)
    ws, bs = chip_smoke._block_weights(gen)
    blk = ResidualDenseBlock5C(chip_smoke.NF, chip_smoke.GC)
    with torch.no_grad():
        for conv, wt, bt in zip(blk.convs(), ws, bs):
            conv.weight.copy_(wt)
            conv.bias.copy_(bt)
    x = torch.randn(2, chip_smoke.NF, 8, 8, generator=gen) * 0.5
    target = torch.randn(2, chip_smoke.NF, 8, 8, generator=gen)
    opt = torch.optim.Adam(blk.parameters(), lr=1e-2)
    out = []
    for step in range(max(n_steps) + 1):
        if step in n_steps:
            out.append(([c.weight.detach().clone() for c in blk.convs()],
                        [c.bias.detach().clone() for c in blk.convs()]))
        opt.zero_grad()
        ((blk._unfused_forward(x) - target) ** 2).mean().backward()
        opt.step()
    return out


def test_the_emulated_block_leans_towards_zero():
    """chip_smoke.rdb_forward_emulated, the f32 block forward as the card
    computes it, over a few trained blocks. Before the repair of ROADMAP
    C 27 (``one_way``: each mma onto the running sum, which it cuts
    towards zero) the error against an f64 forward was many times the
    plain f32's and shrank the last conv's sum (0.2 conv5 = out - x)
    nearly everywhere (bias share near -1), so through 69 blocks such
    errors added up, as the card's PBR serving trace read. With each
    k-step's mma sum added to the running sum rounded to nearest the
    error leans neither way (bias share near 0, as the plain f32's) and
    is no larger than the plain f32's; both stay within the f32
    tolerance of the plain version."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(1, 4, 5, chip_smoke.NF, generator=gen) * 0.5
    for ws, bs in _trained_blocks():
        packed = pack_rdb_weights(ws, chip_smoke.NF, chip_smoke.GC,
                                  torch.float32)
        plain = rdb5c_forward_plain(x, packed, bs, return_residuals=True)
        exact = _block_f64(x, ws, bs)
        sign = (exact - x.double()).sign()

        def reading(out):
            err = out.double() - exact
            return float(err.abs().max()), float((err * sign).sum()
                                                 / err.abs().sum())

        pl, pl_bias = reading(plain[0])
        readings = {}
        for one_way in (True, False):
            got = chip_smoke.rdb_forward_emulated(
                x, packed, bs, return_residuals=True, one_way=one_way)
            for g, r in zip(got, plain):
                assert float((g - r).abs().max()) <= chip_smoke._tolerance(
                    torch.float32, r)
            readings[one_way] = reading(got[0])
        (old, old_bias), (new, new_bias) = readings[True], readings[False]
        assert old > 5 * pl and old_bias < -0.8, (old, pl, old_bias)
        assert new <= 2 * pl and abs(new_bias) < 0.3, (new, pl, new_bias)
        assert abs(pl_bias) < 0.3, pl_bias


def test_one_tf32_product_fails_the_card_tolerances():
    """The tolerances can tell 3xTF32 from plain TF32: one product keeps
    about 11 bits of each operand (out, scaled by 0.2, may pass)."""
    errs = _errors(1, (1, 21, 45))
    for name in ("c1", "dx", "dW0", "dW4"):
        err, tol = errs[name]
        assert err > tol, (name, err, tol)


# ---------------------------------------------------------------------------
# the fragment maps, lane by lane
# ---------------------------------------------------------------------------
LANE = np.arange(32)
G_, T4 = LANE >> 2, LANE & 3


def _mma(a, b):
    """m16n8k8 over a warp: a (32 lanes, 4), b (32, 2) -> c (32, 4), from
    PTX's fragment layouts (a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
    a3 = A[g+8][t+4]; b0 = B[t][g], b1 = B[t+4][g]; c0/c1 = C[g][2t, 2t+1],
    c2/c3 = C[g+8][2t, 2t+1]; g = lane / 4, t = lane % 4)."""
    A = np.full((16, 8), np.nan)
    B = np.full((8, 8), np.nan)
    for r, (dm, dk) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
        A[G_ + dm, T4 + dk] = a[:, r]
    for r in range(2):
        B[T4 + 4 * r, G_] = b[:, r]
    assert not np.isnan(A).any() and not np.isnan(B).any()
    C = A @ B
    return np.stack([C[G_, 2 * T4], C[G_, 2 * T4 + 1],
                     C[G_ + 8, 2 * T4], C[G_ + 8, 2 * T4 + 1]], axis=1)


def _ldmatrix_x4(words, addrs):
    """ldmatrix.x4 (b16, not transposed) on 32-bit data: lane l names row
    l % 8 of matrix l / 8; lane T gets, from each matrix, the 32-bit word
    T % 4 of row T / 4."""
    assert all(a % 16 == 0 for a in addrs)
    out = np.empty((32, 4))
    for i in range(4):
        rows = np.asarray([addrs[8 * i + r] for r in range(8)])
        out[:, i] = words[(rows[LANE >> 2] + 4 * (LANE & 3)) // 4]
    return out


def _swizzle128(dx, row, q):
    return row * 128 + ((q ^ ((row & 7) if dx else (row & 3) << 1)) << 4)


def _tile_inputs(seed):
    """One 16x16 tile (tile (1, 1) of a 37 x 45 image, so the halo crosses
    nothing but the tile) and another at the image's corner, 32 channels."""
    rng = np.random.RandomState(seed)
    img = rng.randn(37, 45, 32).astype(np.float32)
    return img


def _conv_tile_emulated(img, w, w_tap, w_pitch, n0, dx, y0, x0):
    """One f32 tile of conv3x3_mma.cuh for one chunk, from its own address
    formulas: the halo tile and the slab filled as its cp.async loops fill
    them, A by ldmatrix, B by 32-bit loads, 3xTF32 taken as one exact
    product. Returns r[tile row][tile col][column]."""
    h, w_img, _ = img.shape
    pitch, a_bytes = HDR["F32_PITCH"], HDR["F32_A_BYTES"]
    hw, kc = HDR["HW"], HDR["KC"]
    smem = np.zeros((a_bytes + HDR["F32_W_BYTES"]) // 4, np.float32)
    for i in range(HDR["HPIX"] * 8):
        hp, q = i >> 3, i & 7
        yy, xx = y0 + hp // hw - 1, x0 + hp % hw - 1
        if 0 <= yy < h and 0 <= xx < w_img:
            smem[(hp * pitch + q * 16) // 4:][:4] = img[yy, xx, 4 * q:4 * q + 4]
    wflat = w.reshape(-1)
    for i in range(9 * kc * 8):
        q, r, t = i & 7, (i >> 3) & (kc - 1), i >> 8
        src = (((8 - t) * w_tap + n0 + r) * w_pitch + q * 4 if dx
               else (t * w_tap + r) * w_pitch + n0 + q * 4)
        dst = (a_bytes + _swizzle128(dx, t * kc + r, q)) // 4
        smem[dst:dst + 4] = wflat[src:src + 4]
    out = np.zeros((16, 16, 32))
    for warp in range(8):
        a_lane = ((2 * warp) * hw + (LANE & 15)) * pitch + (LANE >> 4) * 16
        acc = np.zeros((2, 4, 32, 4))
        for t in range(9):
            for kk in range(4):
                a = [_ldmatrix_x4(smem, a_lane + ((mt + t // 3) * hw + t % 3)
                                  * pitch + kk * 32) for mt in range(2)]
                for nt in range(4):
                    b = np.empty((32, 2))
                    for e in range(2):
                        off = (_swizzle128(True, t * kc + nt * 8 + G_,
                                           2 * kk + e) + T4 * 4 if dx else
                               _swizzle128(False, t * kc + kk * 8 + e * 4 + T4,
                                           2 * nt + (G_ >> 2)) + (G_ & 3) * 4)
                        b[:, e] = smem[(a_bytes + off) // 4]
                    for mt in range(2):
                        acc[mt, nt] += _mma(a[mt], b)
        for mt in range(2):
            for half in range(2):
                for nt in range(4):
                    for e in range(2):
                        out[2 * warp + mt, G_ + 8 * half,
                            nt * 8 + 2 * T4 + e] = acc[mt, nt, :, 2 * half + e]
    return out


@pytest.mark.parametrize("dx", [False, True])
@pytest.mark.parametrize("corner", [(16, 16), (32, 32)])
def test_f32_conv_tile_lane_maps_compute_the_conv(dx, corner):
    """B[t][c][n] as the header defines it (DX false: k-major rows of the
    packed weights; DX true: the tap-flipped transpose), the column slice
    n0 = 32, one tile inside the image and one across its corner."""
    img = _tile_inputs(0)
    rng = np.random.RandomState(1)
    if dx:
        w_tap, w_pitch = 64, 32   # (9 * 64, 32): columns of dc are rows
        w = rng.randn(9 * w_tap, w_pitch).astype(np.float32)
        B = np.stack([w.reshape(9, w_tap, w_pitch)[8 - t, 32:64, :].T
                      for t in range(9)])          # [t][c][n]
    else:
        w_tap, w_pitch = 32, 64   # (9 * 32, 64)
        w = rng.randn(9 * w_tap, w_pitch).astype(np.float32)
        B = w.reshape(9, w_tap, w_pitch)[:, :, 32:64]
    y0, x0 = corner
    got = _conv_tile_emulated(img, w, w_tap, w_pitch, 32, dx, y0, x0)
    pad = np.pad(img.astype(np.float64), ((1, 16), (1, 16), (0, 0)))
    want = sum(np.einsum("yxc,cn->yxn",
                         pad[y0 + t // 3:y0 + t // 3 + 16,
                             x0 + t % 3:x0 + t % 3 + 16], B[t])
               for t in range(9))
    h, w_img = img.shape[:2]
    inside = (slice(0, min(16, h - y0)), slice(0, min(16, w_img - x0)))
    np.testing.assert_allclose(got[inside], want[inside], rtol=0, atol=1e-9)


def _dw_tile_emulated(act, dy, y0, x0):
    """dw_tf32_kernel's products for one tile and slot (32 channels x 32
    columns x 9 taps), from its own address formulas: c_k's halo tile and
    dy_k's tile at a pitch of DWT_PITCH bytes, fragments by 32-bit loads,
    the two row halves added at the end. Returns dW[t][c][n]."""
    pw, hw = BWD["DWT_PITCH"] // 4, HDR["HW"]
    h, w, _ = act.shape
    A = np.zeros((HDR["HPIX"], pw))
    D = np.zeros((256, pw))
    for hp in range(HDR["HPIX"]):
        yy, xx = y0 + hp // hw - 1, x0 + hp % hw - 1
        if 0 <= yy < h and 0 <= xx < w:
            A[hp, :32] = act[yy, xx]
    for p in range(256):
        yy, xx = y0 + p // 16, x0 + p % 16
        if yy < h and xx < w:
            D[p, :32] = dy[yy, xx]
    a_flat, d_flat = A.reshape(-1), D.reshape(-1)
    out = np.zeros((9, 32, 32))
    halves = {}
    for warp in range(8):
        mt, nh, rh = warp & 1, (warp >> 1) & 1, warp >> 2
        a_base = T4 * pw + mt * 16 + G_
        d_base = T4 * pw + nh * 16 + G_
        acc = np.zeros((9, 2, 32, 4))
        rows = {}
        for j in range(10):
            rp = 8 * rh + j
            if j < 8:
                rows[j] = [[np.stack([d_flat[d_base + (rp * 16 + 8 * s + 4 * e)
                                             * pw + nt * 8]
                                      for e in range(2)], 1)
                            for nt in range(2)] for s in range(2)]
            for dx in range(3):
                a = [np.stack([a_flat[a_base + (rp * hw + dx + 8 * s
                                                + 4 * (e >> 1)) * pw
                                      + 8 * (e & 1)] for e in range(4)], 1)
                     for s in range(2)]
                for dyi in range(3):
                    if 0 <= j - dyi < 8:
                        for s in range(2):
                            for nt in range(2):
                                acc[dyi * 3 + dx, nt] += _mma(
                                    a[s], rows[j - dyi][s][nt])
        halves[warp] = acc
    for warp in range(4):
        mt, nh = warp & 1, warp >> 1
        acc = halves[warp] + halves[warp + 4]
        for t in range(9):
            for nt in range(2):
                for half in range(2):
                    for e in range(2):
                        out[t, mt * 16 + G_ + 8 * half,
                            nh * 16 + nt * 8 + 2 * T4 + e] = \
                            acc[t, nt, :, 2 * half + e]
    return out


@pytest.mark.parametrize("corner", [(0, 0), (16, 16)])
def test_dw_tf32_lane_maps_compute_the_tap_products(corner):
    """dW[t][c][n] = sum over the tile's pixels p of c_k[p + s_t][c] *
    dy_k[p][n], zeros outside the image (a 21 x 29 image: the second tile
    is ragged)."""
    rng = np.random.RandomState(2)
    act = rng.randn(21, 29, 32)
    dy = rng.randn(21, 29, 32)
    y0, x0 = corner
    got = _dw_tile_emulated(act, dy, y0, x0)
    pad = np.pad(act, ((1, 32), (1, 32), (0, 0)))
    dyt = np.zeros((16, 16, 32))
    part = dy[y0:y0 + 16, x0:x0 + 16]
    dyt[:part.shape[0], :part.shape[1]] = part
    for t in range(9):
        shifted = pad[y0 + t // 3:y0 + t // 3 + 16, x0 + t % 3:x0 + t % 3 + 16]
        want = np.einsum("yxc,yxn->cn", shifted, dyt)
        np.testing.assert_allclose(got[t], want, rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# bank maps and budgets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dx", [False, True])
def test_f32_weight_slab_loads_are_free_of_bank_conflicts(dx):
    """Every 32-bit B load of a warp (one tap, k-step, n-tile and register)
    touches 32 different banks, and the swizzle keeps each group in its
    row."""
    kc = HDR["KC"]
    for t in (0, 4, 8):
        for kk in range(4):
            for nt in range(4):
                for e in range(2):
                    if dx:
                        rows = t * kc + nt * 8 + G_
                        off = _swizzle128(True, rows, 2 * kk + e) + T4 * 4
                    else:
                        rows = t * kc + kk * 8 + e * 4 + T4
                        off = (_swizzle128(False, rows, 2 * nt + (G_ >> 2))
                               + (G_ & 3) * 4)
                    assert sorted((off // 4) % 32) == list(range(32))
                    assert all(r * 128 <= o < (r + 1) * 128
                               for r, o in zip(rows, off))


def test_f32_halo_pitch_and_dw_pitch_are_free_of_bank_conflicts():
    # ldmatrix: eight neighbouring pixels' 16-byte rows in eight groups
    assert sorted((i * HDR["F32_PITCH"] % 128) // 16 for i in range(8)) \
        == list(range(8))
    # dW: four pixels x eight channels (or columns) of one 32-bit load
    pw = BWD["DWT_PITCH"] // 4
    for extra in (0, 8, 4 * pw, 4 * pw + 8):
        assert sorted((T4 * pw + G_ + extra) % 32) == list(range(32))
    assert BWD["DWT_PITCH"] % 16 == 0


def test_f32_shared_memory_fits_a_block():
    """The conv stage's ring (two halo tiles, each with its chunk's slab)
    and the lo halves of one slab do not grow with the width, so the
    widest stage fits; dW's two buffers hold the row halves' 4 x 72 x 32
    sums at the end."""
    stage = HDR["F32_NSTAGE"] * HDR["F32_SLOT_BYTES"] + HDR["F32_W_BYTES"]
    assert HDR["F32_SMEM_BYTES"] == stage <= SMEM_PER_BLOCK
    assert HDR["F32_A_BYTES"] == HDR["HPIX"] * (HDR["KC"] * 4 + 16)
    assert HDR["F32_W_BYTES"] == 9 * HDR["KC"] * HDR["BN"] * 4
    dw = 2 * BWD["DWT_BUF_BYTES"]
    assert dw <= SMEM_PER_BLOCK
    assert 4 * 72 * 32 * 4 <= dw
    # stationary weights of the widest stage at nf 64, gc 32 (6 chunks)
    # beside two halo tiles would not fit
    assert 6 * HDR["F32_W_BYTES"] + 2 * HDR["F32_A_BYTES"] > SMEM_PER_BLOCK


# ---------------------------------------------------------------------------
# the model of the card's adds that the emulation follows
# ---------------------------------------------------------------------------
def test_mma_model_with_every_bit_kept_is_the_sum_rounded_once():
    """With more fraction bits than the terms span, the model's aligned sum
    is exact, and rounding to nearest gives f32's own sum of the f64
    terms."""
    rng = np.random.RandomState(12)
    draw = lambda *shape: tf32(torch.from_numpy(  # noqa: E731
        rng.randn(*shape) * 2.0 ** rng.randint(-3, 3, shape)).float()
    ).double()
    a, b, acc = draw(500, 8), draw(500, 8), draw(500)
    got = chip_smoke.mma_tf32_sum(acc, a, b, frac_bits=60,
                                  product_exponent="product",
                                  acc_in_group=True, group=8, cut="trunc",
                                  rounding="rn")
    want = (acc + (a * b).sum(-1)).float().double()
    assert torch.equal(got, want)


def test_mma_model_cuts_below_the_operands_exponents():
    """1 - 1 + 2^-j in one mma: the card keeps 2^-25 and loses 2^-26 (the
    probe's reading), and a product whose significand reaches [2, 4) keeps
    one bit less of the others than its own exponent would say."""
    one = lambda v: torch.tensor([v], dtype=torch.float64)  # noqa: E731
    for j, kept in ((25, True), (26, False)):
        a = torch.tensor([[1.0, -1.0, 2.0 ** -j] + [0.0] * 5],
                         dtype=torch.float64)
        b = torch.tensor([[1.0] * 8], dtype=torch.float64)
        got = chip_smoke.mma_tf32_sum(one(0.0), a, b, **chip_smoke.TF32_MMA)
        assert float(got) == (2.0 ** -j if kept else 0.0)
    # 1.5 * 1.5 = 2.25 sits at exponent 0 + 0 for the unit, not at 1: in
    # 2.25 - 2.25 + 2^-25 the small term is kept
    a = torch.tensor([[1.5, -1.5, 2.0 ** -25] + [0.0] * 5],
                     dtype=torch.float64)
    b = torch.tensor([[1.5, 1.5, 1.0] + [0.0] * 5], dtype=torch.float64)
    got = chip_smoke.mma_tf32_sum(one(0.0), a, b, **chip_smoke.TF32_MMA)
    assert float(got) == 2.0 ** -25
    own = dict(chip_smoke.TF32_MMA, product_exponent="product")
    assert float(chip_smoke.mma_tf32_sum(one(0.0), a, b, **own)) == 0.0


def test_probe_cases_single_out_the_model_the_emulation_uses():
    """The probe's cases give TF32_MMA's sums and no other model's, so the
    card's answer decides the model."""
    cases = chip_smoke.tf32_mma_cases()
    acc = torch.tensor([c[0] for c in cases], dtype=torch.float64)
    a = torch.stack([c[1] for c in cases])
    b = torch.stack([c[2] for c in cases])
    for v in (a, b, acc):  # the inputs are tf32 values
        assert torch.equal(tf32(v.float()).double(), v)
    want = chip_smoke.mma_tf32_sum(acc, a, b, **chip_smoke.TF32_MMA)
    models = chip_smoke.tf32_mma_models()
    assert chip_smoke.TF32_MMA in models
    same = [m for m in models
            if torch.equal(chip_smoke.mma_tf32_sum(acc, a, b, **m), want)]
    assert same == [chip_smoke.TF32_MMA]
