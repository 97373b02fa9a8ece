"""What the bf16 tensor-core kernels of the residual dense block
(``csrc/conv3x3_mma.cuh``, ``rdb5c.cu``, ``rdb5c_bwd.cu``) rely on, held on
the CPU against the plain versions of ``trainner_tpu_torch/ops/rdb5c.py``
(which ``test_torch_rdb5c.py`` and ``test_torch_rdb5c_bwd.py`` hold against
the JAX package): the gather form of the forward, the dx stages' reading of
the packed weights as they are, the dW tap formula, the shapes the wrappers
refuse, and the constants the Python and the C side share. The kernels
themselves run only on the card, where ``chip_smoke.py`` holds them against
the same plain versions.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from trainner_tpu_torch.ops import rdb5c
from trainner_tpu_torch.ops.rdb5c import (_unpack9, pack_rdb_weights,
                                          rdb5c_backward_plain,
                                          rdb5c_forward_plain,
                                          unpack_rdb_wgrads)

torch.set_num_threads(2)

CSRC = pathlib.Path(rdb5c.__file__).resolve().parent.parent / "csrc"


def _block(nf, gc, dtype, seed=0):
    """Packed weights and f32 biases of one block from a numpy seed."""
    rng = np.random.RandomState(seed)
    ws = [torch.from_numpy(rng.randn(gc if k < 4 else nf, nf + k * gc, 3, 3)
                           .astype(np.float32) * 0.05) for k in range(5)]
    bs = [torch.from_numpy(rng.randn(gc if k < 4 else nf)
                           .astype(np.float32) * 0.05) for k in range(5)]
    return ws, list(pack_rdb_weights(ws, nf, gc, dtype)), bs


def _bf16_ulp(t):
    return 2.0 ** (math.floor(math.log2(float(t.abs().max()))) - 7)


# ---------------------------------------------------------------------------
# the forward as a gather: conv k over [x|c1..ck] against conv k's columns
# of the packed weights, which is how the bf16 kernel reads them
# ---------------------------------------------------------------------------
def _gather_forward(x, packed, bs, nf, gc):
    dt = x.dtype
    convs = unpack_rdb_wgrads([p.float() for p in packed], nf, gc)
    feats = [x.permute(0, 3, 1, 2).float()]
    for k in range(5):
        v = F.conv2d(torch.cat(feats, 1), convs[k], bs[k], padding=1)
        if k == 4:
            out = (v * 0.2 + feats[0]).to(dt)
        else:
            feats.append(torch.where(v >= 0, v, v * 0.2).to(dt).float())
    nhwc = lambda t: t.to(dt).permute(0, 2, 3, 1)  # noqa: E731
    return [nhwc(out)] + [nhwc(c) for c in feats[1:]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nf,gc", [(64, 32), (32, 32)])
def test_gather_form_computes_the_scatter_form(nf, gc, dtype):
    """Only the order of the f32 sums differs. f32: 1e-5 on values of size
    ~1. bf16: a c_k that rounds the other way feeds the later convs: two
    bf16 ulps at each output's largest magnitude, as on the card."""
    ws, packed, bs = _block(nf, gc, dtype)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 9, 7, nf)
                         .astype(np.float32) * 0.5).to(dtype)
    want = rdb5c_forward_plain(x, packed, bs, return_residuals=True)
    got = _gather_forward(x, packed, bs, nf, gc)
    for name, g, r in zip(("out", "c1", "c2", "c3", "c4"), got, want):
        tol = 1e-5 if dtype == torch.float32 else 2 * _bf16_ulp(r.float())
        assert float((g.float() - r.float()).abs().max()) <= tol, name


@pytest.mark.parametrize("nf,gc", [(64, 32), (32, 32), (16, 8)])
def test_gather_weights_are_the_convs_own(nf, gc):
    """Conv k's columns of the packed weights, stacked over the features
    it reads, are conv k's weight: nothing is re-laid for the gather."""
    ws, packed, _ = _block(nf, gc, torch.float32)
    for got, want in zip(unpack_rdb_wgrads(packed, nf, gc), ws):
        assert torch.equal(got, want)
    again = pack_rdb_weights(unpack_rdb_wgrads(packed, nf, gc), nf, gc,
                             torch.float32)
    for got, want in zip(again, packed):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the dx stages: the tap-flipped transpose read straight from packed W_k
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", range(5))
def test_dx_stage_reads_the_packed_weights_as_they_are(k):
    """dc_k = sum_t dy_k[p - s_t] W_k[t]^T is the zero-padded correlation
    of dy_k with B[t'][n][c] = W_k[(8 - t') * cin + c, n]: row (tap, c) of
    the packed matrix is already the c-th output column's K-vector."""
    nf, gc = 64, 32
    _, packed, _ = _block(nf, gc, torch.float32, seed=2)
    wk = packed[k]
    cin, n = wk.shape[0] // 9, wk.shape[1]
    dy = torch.from_numpy(np.random.RandomState(3).randn(2, n, 6, 5)
                          .astype(np.float32))
    want = F.conv_transpose2d(dy, _unpack9(wk), padding=1)
    flipped = wk.reshape(9, cin, n).flip(0)          # [t'][c][n]
    weight = flipped.reshape(3, 3, cin, n).permute(2, 3, 0, 1)  # OIHW
    got = F.conv2d(dy, weight, padding=1)
    assert float((got - want).abs().max()) <= 1e-5


def test_dw_is_the_sum_over_pixels_of_shifted_outer_products():
    """dW_k[t][c][n] = sum_p c_k[p + s_t][c] dy_k[p][n] with zeros outside
    the image: the pixels are the K of that product."""
    cin, n, b, h, w = 8, 16, 2, 6, 5
    rng = np.random.RandomState(4)
    act = torch.from_numpy(rng.randn(b, cin, h, w).astype(np.float32))
    dy = torch.from_numpy(rng.randn(b, n, h, w).astype(np.float32))
    want = torch.nn.grad.conv2d_weight(act, (n, cin, 3, 3), dy, padding=1)
    halo = F.pad(act, (1, 1, 1, 1))
    for t in range(9):
        shifted = halo[:, :, t // 3:t // 3 + h, t % 3:t % 3 + w]
        got = torch.einsum("bchw,bnhw->cn", shifted, dy)
        assert float((got - want[:, :, t // 3, t % 3].T).abs().max()) <= 1e-4


def test_backward_plain_packs_dw_as_the_kernel_writes_it():
    """Row (t * cin + c), column n of the packed dW_k: the layout of the
    dW kernel's partials."""
    nf, gc = 32, 32
    _, packed, bs = _block(nf, gc, torch.float32, seed=5)
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(1, 5, 4, nf).astype(np.float32))
    g = torch.from_numpy(rng.randn(1, 5, 4, nf).astype(np.float32))
    _, *cs = rdb5c_forward_plain(x, packed, bs, return_residuals=True)
    _, *rest = rdb5c_backward_plain(g, x, *cs, packed)
    dw4 = rest[4]
    assert dw4.shape == (9 * gc, nf)
    dy = (g * 0.2).permute(0, 3, 1, 2)
    halo = F.pad(cs[3].permute(0, 3, 1, 2), (1, 1, 1, 1))
    for t in (0, 4, 8):
        shifted = halo[:, :, t // 3:t // 3 + 5, t % 3:t % 3 + 4]
        want = torch.einsum("bchw,bnhw->cn", shifted, dy)
        got = dw4[t * gc:(t + 1) * gc]
        assert float((got - want).abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# what the wrappers refuse, and the constants both sides share
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nf,gc,dtype,ok", [
    (64, 32, torch.bfloat16, True),
    (128, 32, torch.bfloat16, True),     # 256: the widest that fits
    (64, 64, torch.bfloat16, False),     # 320
    (128, 64, torch.bfloat16, False),
    (64, 64, torch.float32, True),       # the f32 kernel has no such limit
    (128, 64, torch.float32, True),
])
def test_bf16_kernel_width_limit(nf, gc, dtype, ok):
    _, packed, bs = _block(nf, gc, dtype)
    x = torch.zeros(1, 4, 4, nf, dtype=dtype)
    cs = [torch.zeros(1, 4, 4, gc, dtype=dtype) for _ in range(4)]
    if ok:
        assert rdb5c._check(x, packed, bs) == (nf, gc)
        assert rdb5c._check_backward(x, x, cs, packed) == (nf, gc)
        return
    for check, args in ((rdb5c._check, (x, packed, bs)),
                        (rdb5c._check_backward, (x, x, cs, packed))):
        with pytest.raises(ValueError, match=r"nf \+ 4\*gc <= 256"):
            check(*args)


def _header_constants():
    text = (CSRC / "conv3x3_mma.cuh").read_text()
    names = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        names[name] = eval(expr, {}, names)  # noqa: S307 - the repo's header
    return names


def test_width_limit_is_the_headers():
    c = _header_constants()
    assert rdb5c._BF16_MAX_WIDTH == c["MAXCH"] * c["KC"]
    # the widest stage's weights and the ring of halo tiles fit a block's
    # 227 KB of shared memory on sm_90
    assert c["MAXCH"] * c["W_BYTES"] + c["NSTAGE"] * c["A_BYTES"] <= 232448
    # eight neighbouring pixels at this pitch fall in eight bank groups
    assert sorted((i * c["PITCH"] % 128) // 16 for i in range(8)) \
        == list(range(8))


@pytest.mark.parametrize("row0", [0, 8, 40, 287])
def test_weight_swizzle_is_free_of_bank_conflicts(row0):
    """Eight consecutive 64-byte rows, one 16-byte group each (an 8x8
    ldmatrix tile of the weight slab): eight different bank groups, for
    every group index, and the map stays inside the row."""
    for q in range(4):
        offs = [r * 64 + ((q ^ ((r >> 1) & 3)) << 4)
                for r in range(row0, row0 + 8)]
        assert sorted((o % 128) // 16 for o in offs) == list(range(8))
        assert all(r * 64 <= o < (r + 1) * 64
                   for r, o in zip(range(row0, row0 + 8), offs))


@pytest.mark.parametrize("case", ["aligned", "none", "misaligned"])
def test_pointers_for_the_c_interface(case):
    t = torch.zeros(64)
    if case == "aligned":
        assert rdb5c._pointers([t, t[4:]]) == [t.data_ptr(),
                                               t.data_ptr() + 16]
    elif case == "none":
        assert rdb5c._pointers([t, None]) == [t.data_ptr(), None]
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            rdb5c._pointers([t[1:]])


@pytest.mark.parametrize("source,gone", [
    ("rdb5c.cu", "launch_all<__nv_bfloat16>"),
    ("rdb5c_bwd.cu", "launch_bwd<__nv_bfloat16>"),
])
def test_bf16_fma_instantiations_are_gone_from_the_build(source, gone):
    text = (CSRC / source).read_text()
    assert gone not in text
    assert '#include "conv3x3_mma.cuh"' in text
    for kernel in chip_smoke.BF16_BLOCK_KERNELS[source]:
        assert re.search(rf"\b{kernel}<<<", text), kernel


# ---------------------------------------------------------------------------
# the smoke script's helpers that need no card
# ---------------------------------------------------------------------------
def test_poisoned_buffers_fill_with_nan_and_restore():
    plain = rdb5c._alloc
    with chip_smoke._poisoned_buffers():
        for shape in ((2, 3), 5, torch.Size([1, 2])):
            t = rdb5c._alloc(shape, torch.bfloat16, torch.device("cpu"))
            assert t.dtype == torch.bfloat16 and bool(t.isnan().all())
            assert t.numel() == int(np.prod(shape))
    assert rdb5c._alloc is plain
    assert rdb5c._alloc((2,), torch.float32, torch.device("cpu")).shape == (2,)


@pytest.mark.parametrize("argv", [[], ["--kernels-only"]])
def test_smoke_script_fails_without_a_card(argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert chip_smoke.main(argv) == 1
    assert capsys.readouterr().out == ""


def test_smoke_script_has_the_second_ragged_shape():
    b, h, w = chip_smoke.RAGGED_B1_SHAPE
    assert b == 1 and h % 16 and w % 16
    assert h > 16 and w > 16  # more than one tile in both directions
