"""The port's residual dense block (``trainner_tpu_torch/ops/rdb5c.py``)
against the JAX package's forward of the same block: the XLA form
``models/rrdb._rdb5c_fwd_impl`` and the Pallas kernel ``rdb5c_canvas`` in
interpret mode. On the CPU ``rdb5c_forward`` runs its plain PyTorch version;
the CUDA kernel is held to that version on the card by ``chip_smoke.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.models.rrdb import _rdb5c_fwd_impl, _rdb_pack_kernels
from trainner_tpu.ops.pallas_kernels import (_canvas_geometry, from_canvas,
                                             rdb5c_canvas, to_canvas)
from trainner_tpu_torch.ops import rdb5c
from trainner_tpu_torch.ops.rdb5c import (pack_rdb_weights, rdb5c_forward,
                                          rdb5c_forward_plain)

NF, GC = 64, 32
B, H, W = 2, 11, 7  # small, ragged, non-square


def _weights(nf=NF, gc=GC, seed=0):
    """HWIO weights and biases of the five convs, from a numpy seed."""
    rng = np.random.RandomState(seed)
    cins = [nf + k * gc for k in range(5)]
    couts = [gc] * 4 + [nf]
    ws = [rng.randn(3, 3, ci, co).astype(np.float32) * 0.05
          for ci, co in zip(cins, couts)]
    bs = [rng.randn(co).astype(np.float32) * 0.05 for co in couts]
    return ws, bs


def _input(seed=1, shape=(B, H, W, NF)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) * 0.5


def _port(x, ws, bs, dtype):
    packed = pack_rdb_weights(
        [torch.from_numpy(w.transpose(3, 2, 0, 1).copy()) for w in ws],
        x.shape[-1], ws[1].shape[-1], dtype)
    got = rdb5c_forward(torch.from_numpy(x).to(dtype), packed,
                        [torch.from_numpy(b) for b in bs],
                        return_residuals=True)
    return [g.float().numpy() for g in got]


def _xla(x, ws, bs, jdt):
    nf, gc = x.shape[-1], ws[0].shape[-1]
    args = [jnp.asarray(v) for p in zip(ws, bs) for v in p]
    out, (_, c1, c2, c3, c4) = _rdb5c_fwd_impl(jdt, nf, gc, jnp.asarray(x),
                                               *args)
    return [np.asarray(v.astype(jnp.float32)) for v in (out, c1, c2, c3, c4)]


def _pallas(x, ws, bs, jdt):
    nf, gc = x.shape[-1], ws[0].shape[-1]
    h, w = x.shape[1:3]
    _, rp = _canvas_geometry(h, w, jdt)
    packed = _rdb_pack_kernels(*[jnp.asarray(v).astype(jdt) for v in ws],
                               nf, gc)
    outs = rdb5c_canvas(to_canvas(jnp.asarray(x).astype(jdt), rp), packed,
                        tuple(jnp.asarray(b) for b in bs), h, w, nf, gc,
                        interpret=True)
    return [np.asarray(from_canvas(o, h, w).astype(jnp.float32))
            for o in outs]


def _bf16_ulp(ref):
    """One bf16 ulp at the largest magnitude of ``ref``."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(ref).max()))) - 7)


NAMES = ("out", "c1", "c2", "c3", "c4")


@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
def test_rdb5c_f32_matches_jax(oracle):
    """out and c1..c4 in f32 within 1e-5 of the JAX forward: f32 sums in
    another order, over K <= 576 terms of size ~0.1."""
    ws, bs = _weights()
    x = _input()
    want = (_xla if oracle == "xla" else _pallas)(x, ws, bs, jnp.float32)
    got = _port(x, ws, bs, torch.float32)
    for name, g, r in zip(NAMES, got, want):
        assert g.shape == r.shape, name
        assert np.abs(g - r).max() < 1e-5, name


def test_rdb5c_bf16_matches_pallas_interpret():
    """bf16: the port and the Pallas kernel both keep the partial sums in
    f32 and round c1..c4 and out to bf16 once, so they may differ by one
    bf16 rounding: at most one ulp at the output's largest magnitude."""
    ws, bs = _weights(seed=2)
    x = _input(seed=3)
    want = _pallas(x, ws, bs, jnp.bfloat16)
    got = _port(x, ws, bs, torch.bfloat16)
    for name, g, r in zip(NAMES, got, want):
        assert np.abs(g - r).max() <= _bf16_ulp(r), name


def test_rdb5c_bf16_near_xla_forward():
    """The XLA forward rounds each conv to bf16 and adds the partial sums
    in bf16; the port adds them in f32. So only a loose bound holds:
    four ulps at the output's largest magnitude."""
    ws, bs = _weights(seed=2)
    x = _input(seed=3)
    want = _xla(x, ws, bs, jnp.bfloat16)
    got = _port(x, ws, bs, torch.bfloat16)
    for name, g, r in zip(NAMES, got, want):
        assert np.abs(g - r).max() <= 4 * _bf16_ulp(r), name


def test_pack_rdb_weights_matches_jax_packing():
    """Tap-major (9*cin, N) packing equals ``_rdb_pack_kernels`` then a
    reshape of HWIO, exactly."""
    ws, _ = _weights(nf=32, gc=16)
    want = _rdb_pack_kernels(*[jnp.asarray(w) for w in ws], 32, 16)
    got = pack_rdb_weights(
        [torch.from_numpy(w.transpose(3, 2, 0, 1).copy()) for w in ws],
        32, 16, torch.float32)
    for g, r in zip(got, want):
        r = np.asarray(r)
        np.testing.assert_array_equal(g.numpy(), r.reshape(-1, r.shape[-1]))


def test_rdb5c_plain_matches_unfused_chain():
    """The packed chain equals the plain five-conv chain of the block."""
    from trainner_tpu_torch.models.rrdb import ResidualDenseBlock5C

    torch.manual_seed(0)
    blk = ResidualDenseBlock5C(nf=16, gc=8)
    for c in blk.convs():
        torch.nn.init.normal_(c.weight, std=0.05)
        torch.nn.init.normal_(c.bias, std=0.05)
    x = torch.randn(2, 16, 9, 6).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = blk(x)
        want = blk._unfused_forward(x)
    assert (got - want).abs().max() < 1e-5


def test_rdb5c_cpu_runs_plain_and_counts_no_launch():
    ws, bs = _weights(nf=32, gc=32)
    x = _input(shape=(1, 5, 4, 32))
    before = rdb5c.launches
    got = _port(x, ws, bs, torch.float32)
    assert rdb5c.launches == before
    packed = pack_rdb_weights(
        [torch.from_numpy(w.transpose(3, 2, 0, 1).copy()) for w in ws],
        32, 32, torch.float32)
    plain = rdb5c_forward_plain(torch.from_numpy(x), packed,
                                [torch.from_numpy(b) for b in bs])
    np.testing.assert_array_equal(got[0], plain.numpy())


def _packed_args(nf=32, gc=32):
    ws, bs = _weights(nf=nf, gc=gc)
    packed = list(pack_rdb_weights(
        [torch.from_numpy(w.transpose(3, 2, 0, 1).copy()) for w in ws],
        nf, gc, torch.float32))
    return packed, [torch.from_numpy(b) for b in bs]


@pytest.mark.parametrize("fault", ["nf", "packed_shape", "bias_dtype",
                                   "weight_dtype", "x_dtype", "contiguous"])
def test_rdb5c_wrapper_checks_reject(fault):
    """What the CUDA kernel does not take is refused before any launch."""
    packed, bs = _packed_args()
    x = torch.zeros(1, 4, 4, 32)
    if fault == "nf":
        packed, bs = _packed_args(nf=16, gc=32)
        x = torch.zeros(1, 4, 4, 16)
    elif fault == "packed_shape":
        packed[2] = packed[2][:-9]
    elif fault == "bias_dtype":
        bs[0] = bs[0].double()
    elif fault == "weight_dtype":
        packed[0] = packed[0].bfloat16()
    elif fault == "x_dtype":
        x = x.half()
    elif fault == "contiguous":
        x = torch.zeros(1, 32, 4, 4).permute(0, 2, 3, 1)
    with pytest.raises((ValueError, TypeError)):
        rdb5c._check(x, packed, bs)


def test_rdb5c_wrapper_checks_accept():
    packed, bs = _packed_args()
    assert rdb5c._check(torch.zeros(1, 4, 4, 32), packed, bs) == (32, 32)
