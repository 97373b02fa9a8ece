"""The port's per-sample blur (``trainner_tpu_torch/ops/blur.py``, reached
through ``ops/degradations.py::apply_kernels``) against the JAX package:
the conv path of ``apply_kernels`` (``TRAINNER_BLUR_FFT=0``; the FFT path
it takes by default for k >= 13 flips the kernel and sizes itself from h
alone) and the Pallas kernel ``blur_per_sample_pallas`` in interpret mode.
On the CPU the port runs its plain PyTorch version; the CUDA kernel is held
to that version on the card by ``chip_smoke.py``.

Tolerances: f32 1e-5 absolute on inputs in [0, 1] (up to 441 products
summed in another order); bf16 one bf16 ulp of the output (both sum in f32
and round once).

The CUDA kernel's own index maps are emulated lane by lane from its source's
constants and address formulas: every output sums its taps over the
reflected sources in order, the inner loop's shared-memory reads are free of
bank conflicts, and a block's shared memory fits.
"""

import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.ops.degradations import apply_kernels as jax_apply
from trainner_tpu.ops.pallas_kernels import blur_per_sample_pallas
from trainner_tpu_torch.ops import blur as port_blur
from trainner_tpu_torch.ops.blur import (blur_per_sample,
                                         blur_per_sample_plain)
from trainner_tpu_torch.ops.degradations import apply_kernels

torch.set_num_threads(2)

B, H, W = 7, 23, 31  # non-square; k // 2 = 10 < 23


def _inputs(k, c, seed=0):
    rng = np.random.RandomState(seed + 100 * k + c)
    x = rng.rand(B, H, W, c).astype(np.float32)
    kern = rng.rand(B, k, k).astype(np.float32) ** 3  # asymmetric
    kern /= kern.sum(axis=(1, 2), keepdims=True)
    return x, kern


@pytest.fixture(autouse=True)
def _conv_path(monkeypatch):
    """The JAX side's conv path, for the length of one test."""
    monkeypatch.setenv("TRAINNER_BLUR_FFT", "0")


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("k", [3, 7, 13, 21])
def test_blur_f32_matches_jax_conv_path_and_pallas(k, c):
    x, kern = _inputs(k, c)
    want = np.asarray(jax_apply(jnp.asarray(x), jnp.asarray(kern)))
    pallas = np.asarray(blur_per_sample_pallas(
        jnp.asarray(x), jnp.asarray(kern), interpret=True))
    xt, kt = torch.from_numpy(x), torch.from_numpy(kern)
    for fn in (blur_per_sample_plain, blur_per_sample, apply_kernels):
        got = fn(xt, kt)
        assert got.shape == (B, H, W, c) and got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() <= 1e-5
        assert np.abs(got.numpy() - pallas).max() <= 1e-5


def test_blur_is_cross_correlation_not_convolution():
    """A one-hot kernel off the centre shifts the image one way only."""
    x, _ = _inputs(5, 3)
    kern = np.zeros((B, 5, 5), np.float32)
    kern[:, 1, 4] = 1.0  # dy = -1, dx = +2
    got = apply_kernels(torch.from_numpy(x), torch.from_numpy(kern)).numpy()
    np.testing.assert_array_equal(got[:, 1:, :-2], x[:, :-1, 2:])
    want = np.asarray(jax_apply(jnp.asarray(x), jnp.asarray(kern)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [7, 21])
def test_blur_bf16_within_one_ulp(k):
    x, kern = _inputs(k, 3)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(blur_per_sample_pallas(
        xb, jnp.asarray(kern), interpret=True).astype(jnp.float32))
    got = apply_kernels(torch.from_numpy(x).to(torch.bfloat16),
                        torch.from_numpy(kern))
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    assert np.abs(got.float().numpy() - want).max() <= ulp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_identity_kernel_is_exact(dtype):
    x, _ = _inputs(9, 3)
    xt = torch.from_numpy(x).to(dtype)
    ident = torch.zeros(B, 9, 9)
    ident[:, 4, 4] = 1.0
    assert torch.equal(apply_kernels(xt, ident), xt)


def test_even_k_and_too_large_k_raise():
    x = torch.rand(2, 8, 12, 3)
    with pytest.raises(ValueError, match="odd"):
        apply_kernels(x, torch.rand(2, 4, 4))
    with pytest.raises(ValueError, match="reflect"):
        apply_kernels(x, torch.rand(2, 17, 17))  # 17 // 2 = 8 >= min(h, w)
    with pytest.raises(ValueError, match="kernels must be"):
        apply_kernels(x, torch.rand(3, 5, 5))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        apply_kernels(x.double(), torch.rand(2, 5, 5))


def test_cpu_tensors_never_count_as_launches():
    before = port_blur.launches
    x, kern = _inputs(3, 1)
    blur_per_sample(torch.from_numpy(x), torch.from_numpy(kern))
    assert port_blur.launches == before


def test_a_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    """On a CUDA tensor the wrapper goes to the kernel's library or raises;
    shown here by the device type alone (no card is needed)."""
    called = []
    monkeypatch.setattr(port_blur, "blur_per_sample_plain",
                        lambda *a: called.append(1))
    monkeypatch.setattr(port_blur, "_library",
                        lambda: (_ for _ in ()).throw(RuntimeError("no nvcc")))

    class FakeCuda:
        type = "cuda"

    class FakeTensor:
        device = FakeCuda()
        dtype = torch.float32
        shape = (2, 8, 8, 3)

        def dim(self):
            return 4

        def contiguous(self):
            return self

        def float(self):
            return self

    x, kern = FakeTensor(), FakeTensor()
    kern.shape = (2, 3, 3)
    kern.dim = lambda: 3
    with pytest.raises(RuntimeError, match="no nvcc"):
        blur_per_sample(x, kern)
    assert not called


# ---------------------------------------------------------------------------
# the CUDA kernel's index maps, lane by lane, from its own formulas
# ---------------------------------------------------------------------------
CSRC = pathlib.Path(port_blur.__file__).resolve().parent.parent / "csrc"
SMEM_PER_BLOCK = 232448


def _kernel_constants():
    """``constexpr int NAME = value;`` of the blur source."""
    text = (CSRC / "blur_per_sample.cu").read_text()
    return {n: int(v) for n, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


KC = _kernel_constants()
TILES = {"wide": (KC["WIDE_R"], KC["WIDE_NWX"]),
         "narrow": (KC["NARROW_R"], KC["NARROW_NWX"])}


class _Geometry:
    """The kernel's ``Geometry``: shared-memory offsets in floats."""

    def __init__(self, r, nwx, c, k):
        self.tw = r * nwx
        self.hh = KC["TH"] + k - 1
        self.hwid = self.tw + k - 1
        self.pitch = self.hwid | 1
        self.plane = self.hh * self.pitch
        self.kp = (k + 3) & ~3
        self.taps = k * self.kp
        self.halo = c * self.plane
        self.stage_pitch = self.tw * c + 1
        self.words = self.taps + self.halo + KC["TH"] * self.stage_pitch


def _reflect(i, n):
    if i < 0:
        i = -i
    if i >= n:
        i = 2 * (n - 1) - i
    return min(max(i, 0), n - 1)


def _banks_distinct(words):
    return len({int(a) % 32 for a in words}) == len(words)


def _emulate(b, h, w, c, k, tile):
    """Runs the kernel's loads, inner loop, staging and stores with labels
    in place of values: a tap is labelled dy * k + dx (-1 the padding of a
    tap row), a halo word by the flat NHWC index it was read from. Returns
    {output flat index: (terms, 2) array of (tap, source) in the order the
    output's FMAs take them} and checks every warp-wide shared-memory read
    and the staging writes for bank conflicts on the way."""
    r_out, nwx = TILES[tile]
    th, g = KC["TH"], _Geometry(r_out, nwx, c, k)
    generic = k > KC["MAX_K"]
    tiles_x, tiles_y = -(-w // g.tw), -(-h // th)
    nthreads = 32 * min(c, KC["CW_MAX"]) * nwx
    lanes = np.arange(32)
    result = {}
    for blk in range(b * tiles_y * tiles_x):
        tile_x, rest = blk % tiles_x, blk // tiles_x
        tile_y, n = rest % tiles_y, rest // tiles_y
        y0, x0, pad = tile_y * th, tile_x * g.tw, k // 2
        smem = np.full(g.words, -2, dtype=np.int64)  # -2: never written
        for i in range(g.taps):
            dy, dx = divmod(i, g.kp)
            smem[i] = dy * k + dx if dx < k else -1
        for p in range(g.hh * g.hwid):
            r, col = divmod(p, g.hwid)
            gy, gx = _reflect(y0 - pad + r, h), _reflect(x0 - pad + col, w)
            for ch in range(c):
                smem[g.taps + ch * g.plane + r * g.pitch + col] = \
                    ((n * h + gy) * w + gx) * c + ch
        stage = {}
        cw = nthreads // (32 * nwx)
        for warp in range(nthreads // 32):
            lx0 = (warp // cw) * r_out
            for ch in range(warp % cw, c, cw):
                acc = [[] for _ in range(r_out)]
                src0 = g.taps + ch * g.plane + lanes * g.pitch + lx0
                for dy in range(k):
                    src, tp = src0 + dy * g.pitch, dy * g.kp
                    if not generic:
                        assert tp % 4 == 0  # 16-byte broadcast reads
                        t = smem[tp:tp + g.kp]
                        win = []
                        for i in range(r_out + k - 1):
                            assert _banks_distinct(src + i)
                            win.append(smem[src + i])
                        for dx in range(k):
                            for r in range(r_out):
                                acc[r].append((np.full(32, t[dx]),
                                               win[r + dx]))
                    else:
                        win = [smem[src + r] for r in range(r_out)]
                        for dx in range(k):
                            t = smem[tp + dx]
                            for r in range(r_out):
                                acc[r].append((np.full(32, t), win[r]))
                            if dx + 1 < k:
                                assert _banks_distinct(src + dx + r_out)
                                win = win[1:] + [smem[src + dx + r_out]]
                st0 = g.taps + g.halo + lanes * g.stage_pitch + lx0 * c + ch
                for r in range(r_out):
                    assert _banks_distinct(st0 + r * c)
                    terms = np.stack([np.stack(p, -1) for p in acc[r]], 1)
                    for lane in range(32):
                        stage[int(st0[lane] + r * c)] = terms[lane]
        vh, row_len = min(th, h - y0), min(g.tw, w - x0) * c
        for i in range(vh * row_len):
            r, e = divmod(i, row_len)
            dst = ((n * h + y0) * w + x0) * c + r * w * c + e
            assert dst not in result
            result[dst] = stage[g.taps + g.halo + r * g.stage_pitch + e]
    return result


@pytest.mark.parametrize("tile", ["wide", "narrow"])
@pytest.mark.parametrize("b,h,w,c,k", [
    (2, 13, 37, 3, 3),    # ragged h and w
    (1, 11, 40, 3, 21),   # k/2 = 10 against h = 11
    (2, 34, 9, 1, 7),     # two row tiles, one channel
    (1, 12, 25, 1, 21),   # k/2 = 10 against h = 12, one channel
    (1, 12, 30, 3, 23),   # past MAX_K: the sliding window of any k
])
def test_kernel_index_maps_sum_every_tap_in_order(b, h, w, c, k, tile):
    """Every output of every tile sums exactly its k*k taps over the
    reflected sources, dy outer and dx inner, as the plain version does;
    every output is written once; no read of the inner loop meets a bank
    conflict."""
    got = _emulate(b, h, w, c, k, tile)
    assert len(got) == b * h * w * c
    pad = k // 2
    taps = np.arange(k * k)
    dys, dxs = taps // k, taps % k
    for n in range(b):
        for y in range(h):
            for x in range(w):
                for ch in range(c):
                    src = [((n * h + _reflect(y + dy - pad, h)) * w
                            + _reflect(x + dx - pad, w)) * c + ch
                           for dy, dx in zip(dys, dxs)]
                    want = np.stack([taps, np.asarray(src)], -1)
                    idx = ((n * h + y) * w + x) * c + ch
                    np.testing.assert_array_equal(got[idx], want)


@pytest.mark.parametrize("tile", ["wide", "narrow"])
@pytest.mark.parametrize("c", [1, 3])
def test_kernel_shared_memory_fits(tile, c):
    """Every instantiated k (odd, up to MAX_K) fits one block's shared
    memory on both tiles; the taps and the halo start on 16 bytes."""
    r, nwx = TILES[tile]
    for k in range(1, KC["MAX_K"] + 1, 2):
        g = _Geometry(r, nwx, c, k)
        assert g.words * 4 <= SMEM_PER_BLOCK
        assert g.taps % 4 == 0 and g.pitch % 2 == 1
        # the staging rows fit beside the halo, at an odd pitch
        assert g.stage_pitch % 2 == 1 and g.stage_pitch >= g.tw * c


@pytest.mark.parametrize("shape,tile,blocks", [
    ((32, 128, 128, 3), "wide", 512),   # the producer's HR canvas
    ((32, 32, 32, 3), "narrow", 256),   # its LR canvas
    ((5, 37, 53, 3), "narrow", 140),
])
def test_kernel_grid_follows_the_canvas(shape, tile, blocks):
    """The wide tile where it gives at least two blocks per SM (132 on an
    H100), else the narrow one, which spreads a small canvas over more
    blocks."""
    b, h, w, _ = shape
    r, nwx = TILES["wide"]
    wide = b * -(-h // KC["TH"]) * -(-w // (r * nwx))
    picked = "wide" if wide >= 2 * 132 else "narrow"
    assert picked == tile
    r, nwx = TILES[picked]
    assert b * -(-h // KC["TH"]) * -(-w // (r * nwx)) == blocks
