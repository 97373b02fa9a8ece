"""The port's backward of the residual dense block
(``trainner_tpu_torch/ops/rdb5c.py``: ``rdb5c_backward``, ``RDB5CFunction``,
``unpack_rdb_wgrads``) against the JAX package: the Pallas kernel
``rdb5c_canvas_bwd`` in interpret mode, ``jax.grad`` of the XLA form
``rdb5c_fused`` in its default ``dual`` mode, and torch autograd of the
unfused five-conv chain. On the CPU ``rdb5c_backward`` runs its plain
PyTorch version; the CUDA kernel is held to that version on the card by
``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.models.rrdb import (_rdb_pack_kernels, _unpack_wgrads,
                                      rdb5c_fused)
from trainner_tpu.ops.pallas_kernels import (_canvas_geometry, from_canvas,
                                             rdb5c_canvas_bwd, to_canvas)
from trainner_tpu_torch.models.rrdb import ResidualDenseBlock5C
from trainner_tpu_torch.ops import rdb5c
from trainner_tpu_torch.ops.rdb5c import (RDB5CFunction, pack_rdb_weights,
                                          rdb5c_backward,
                                          rdb5c_backward_plain,
                                          rdb5c_forward, unpack_rdb_wgrads)

# The suite runs several workers on shared cores: more intra-op threads
# than free cores makes every small conv wait on a spinning pool.
torch.set_num_threads(2)

NF, GC = 64, 32
B, H, W = 2, 11, 7  # small, ragged, non-square


def _weights(nf=NF, gc=GC, seed=0):
    """HWIO weights and non-zero biases of the five convs, from a numpy
    seed."""
    rng = np.random.RandomState(seed)
    cins = [nf + k * gc for k in range(5)]
    couts = [gc] * 4 + [nf]
    ws = [rng.randn(3, 3, ci, co).astype(np.float32) * 0.05
          for ci, co in zip(cins, couts)]
    bs = [rng.randn(co).astype(np.float32) * 0.05 for co in couts]
    return ws, bs


def _arrays(nf=NF, seed=1, shape=(B, H, W)):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, nf).astype(np.float32) * 0.5
    g = rng.randn(*shape, nf).astype(np.float32)
    return x, g


def _oihw(ws):
    return [torch.from_numpy(w.transpose(3, 2, 0, 1).copy()) for w in ws]


def _port(x, g, ws, bs, dtype):
    """Forward residuals, then the port's backward: dx, five packed dW,
    five db, as f32 numpy."""
    nf, gc = x.shape[-1], ws[0].shape[-1]
    packed = pack_rdb_weights(_oihw(ws), nf, gc, dtype)
    xt = torch.from_numpy(x).to(dtype)
    _, *cs = rdb5c_forward(xt, packed, [torch.from_numpy(b) for b in bs],
                           return_residuals=True)
    got = rdb5c_backward(torch.from_numpy(g).to(dtype), xt, *cs, packed)
    return [t.float().numpy() for t in got]


def _pallas_bwd(x, g, cs, ws, jdt):
    """rdb5c_canvas_bwd(interpret=True) on canvases of g, x and the
    residuals c1..c4: dx, five packed dW, five db, as f32 numpy."""
    nf, gc = x.shape[-1], ws[0].shape[-1]
    h, w = x.shape[1:3]
    _, rp = _canvas_geometry(h, w, jdt)
    packed = _rdb_pack_kernels(*[jnp.asarray(v).astype(jdt) for v in ws],
                               nf, gc)
    can = lambda a: to_canvas(jnp.asarray(a).astype(jdt), rp)  # noqa: E731
    out = rdb5c_canvas_bwd(can(g), can(x), *[can(c) for c in cs], packed,
                           h, w, nf, gc, interpret=True)
    dx = np.asarray(from_canvas(out[0], h, w).astype(jnp.float32))
    return [dx] + [np.asarray(o.astype(jnp.float32)) for o in out[1:]]


def _residuals(x, ws, bs, dtype):
    nf, gc = x.shape[-1], ws[0].shape[-1]
    packed = pack_rdb_weights(_oihw(ws), nf, gc, dtype)
    _, *cs = rdb5c_forward(torch.from_numpy(x).to(dtype), packed,
                           [torch.from_numpy(b) for b in bs],
                           return_residuals=True)
    return [c.float().numpy() for c in cs]


def _ulp_bf16(ref):
    """One bf16 ulp at the largest magnitude of ``ref``."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(ref).max()))) - 7)


NAMES = ("dx", "dW0", "dW1", "dW2", "dW3", "dW4",
         "db1", "db2", "db3", "db4", "db5")


@pytest.mark.parametrize("nf,gc,shape", [(NF, GC, (B, H, W)),
                                         (32, 32, (3, 6, 9))])
def test_backward_f32_matches_pallas_interpret(nf, gc, shape):
    """Every output of the backward in f32 against the Pallas kernel in
    interpret mode: dx within 1e-5, packed dW and db within 1e-4 (f32 sums
    over up to 1,728 products for dx and over all pixels for dW and db, in
    another order; tests/test_pallas.py allows 1e-4 and 1e-3)."""
    ws, bs = _weights(nf, gc)
    x, g = _arrays(nf, shape=shape)
    cs = _residuals(x, ws, bs, torch.float32)
    want = _pallas_bwd(x, g, cs, ws, jnp.float32)
    got = _port(x, g, ws, bs, torch.float32)
    assert len(got) == len(want) == 11
    for name, a, r in zip(NAMES, got, want):
        assert a.shape == r.shape, name
        tol = 1e-5 if name == "dx" else 1e-4
        assert np.abs(a - r).max() < tol, (name, np.abs(a - r).max())


def test_backward_bf16_matches_pallas_interpret():
    """bf16, from the same bf16 residuals: both round dc5 and da_k to bf16
    before every product and sum in f32, so dx may differ by one rounding
    of a da_k that feeds the later stages: two bf16 ulps at dx's largest
    magnitude. dW and db are f32 sums of products of the same bf16 values
    except where a da_k differs by a rounding: 2^-7 (one bf16 ulp,
    relative) of each output's largest magnitude."""
    ws, bs = _weights(seed=2)
    x, g = _arrays(seed=3)
    bf = lambda a: torch.from_numpy(a).bfloat16().float().numpy()  # noqa
    cs = _residuals(x, ws, bs, torch.bfloat16)
    want = _pallas_bwd(bf(x), bf(g), cs, ws, jnp.bfloat16)
    got = _port(x, g, ws, bs, torch.bfloat16)
    for name, a, r in zip(NAMES, got, want):
        tol = 2 * _ulp_bf16(r) if name == "dx" else \
            float(np.abs(r).max()) * 2.0 ** -7
        assert np.abs(a - r).max() <= tol, (name, np.abs(a - r).max(), tol)


def _jax_fused_grads(x, g, ws, bs, jdt):
    nf, gc = x.shape[-1], ws[0].shape[-1]
    args = [jnp.asarray(v) for p in zip(ws, bs) for v in p]

    def loss(xx, *params):
        out = rdb5c_fused(jdt, nf, gc, xx, *params)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g))

    grads = jax.grad(loss, argnums=tuple(range(11)))(
        jnp.asarray(x).astype(jdt), *args)
    return [np.asarray(v.astype(jnp.float32)) for v in grads]


def _port_function_grads(x, g, ws, bs, dtype):
    """Gradients through RDB5CFunction: dx, then (dw, db) per conv with dw
    brought to HWIO."""
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    params = []
    for w, b in zip(_oihw(ws), bs):
        params += [w.requires_grad_(True),
                   torch.from_numpy(b.copy()).requires_grad_(True)]
    out = RDB5CFunction.apply(xt, None, *params)
    (out.float() * torch.from_numpy(g)).sum().backward()
    res = [xt.grad.float().numpy()]
    for w, b in zip(params[0::2], params[1::2]):
        assert w.grad.dtype == torch.float32 and b.grad.dtype == torch.float32
        res += [w.grad.permute(2, 3, 1, 0).numpy(), b.grad.numpy()]
    return res


def test_function_grads_f32_match_jax_grad_of_rdb5c_fused():
    """After unpacking, the gradients equal jax.grad of the XLA form in its
    default dual mode (the gate of tests/test_rdb_custom_vjp.py): f32,
    relative 1e-4 of each gradient's largest magnitude."""
    ws, bs = _weights()
    x, g = _arrays()
    want = _jax_fused_grads(x, g, ws, bs, jnp.float32)
    got = _port_function_grads(x, g, ws, bs, torch.float32)
    assert len(got) == len(want) == 11
    for i, (a, r) in enumerate(zip(got, want)):
        assert a.shape == r.shape, i
        assert np.abs(a - r).max() <= 1e-4 * np.abs(r).max() + 1e-7, i


def test_function_grads_bf16_near_jax_grad_of_rdb5c_fused():
    """bf16: the XLA form produces each conv of the backward in bf16 and
    adds partial sums in bf16, the port sums in f32 and rounds da_k once;
    and a c_k whose sign differs between the two after rounding flips a
    whole lrelu'. Measured, both bf16 forms lie up to 16 % of a gradient's
    largest magnitude from the f32 gradients and from each other. So only
    a loose bound holds: each gradient within 20 % of its largest magnitude
    of the XLA bf16 form's, and no further from the f32 gradients than
    twice what the XLA bf16 form is."""
    ws, bs = _weights(seed=4)
    x, g = _arrays(seed=5)
    want = _jax_fused_grads(x, g, ws, bs, jnp.bfloat16)
    exact = _jax_fused_grads(x, g, ws, bs, jnp.float32)
    got = _port_function_grads(x, g, ws, bs, torch.bfloat16)
    for i, (a, r, e) in enumerate(zip(got, want, exact)):
        scale = np.abs(e).max()
        assert np.abs(a - r).max() <= 0.2 * scale, i
        assert np.abs(a - e).max() <= 2 * np.abs(r - e).max() \
            + 2.0 ** -7 * scale, i


@pytest.mark.parametrize("nf,gc,shape", [(NF, GC, (B, H, W)),
                                         (32, 32, (1, 5, 8))])
def test_block_grads_match_autograd_of_unfused_chain(nf, gc, shape):
    """ResidualDenseBlock5C under autograd (RDB5CFunction) against torch
    autograd of the plain five-conv chain, in f64-checked f32: relative
    1e-4. Biases are non-zero: the kernel reads lrelu' as 1 at c == 0 where
    torch gives 0.2, and only zero biases on a zero input land there."""
    ws, bs = _weights(nf, gc, seed=6)
    x, g = _arrays(nf, seed=7, shape=shape)
    blk = ResidualDenseBlock5C(nf, gc)
    with torch.no_grad():
        for conv, w, b in zip(blk.convs(), _oihw(ws), bs):
            conv.weight.copy_(w)
            conv.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    gt = torch.from_numpy(g).permute(0, 3, 1, 2)

    def grads(fn):
        xin = xt.clone().requires_grad_(True)
        blk.zero_grad()
        (fn(xin) * gt).sum().backward()
        return [xin.grad] + [p.grad.clone() for p in blk.parameters()]

    got = grads(blk)
    want = grads(blk._unfused_forward)
    assert len(got) == 11
    for a, r in zip(got, want):
        assert a.shape == r.shape
        assert float((a - r).abs().max()) <= 1e-4 * float(r.abs().max())


def test_derivative_at_zero_follows_the_kernel():
    """At c_k == 0 the backward takes lrelu' = 1 (the sign rule of the TPU
    kernel), torch's leaky_relu backward 0.2: zero input, zero biases."""
    ws, _ = _weights(32, 32)
    packed = pack_rdb_weights(_oihw(ws), 32, 32, torch.float32)
    z = torch.zeros(1, 4, 4, 32)
    zc = torch.zeros(1, 4, 4, 32)
    g = torch.ones(1, 4, 4, 32)
    dx, *_ = rdb5c_backward_plain(g, z, zc, zc, zc, zc, packed)
    blk = ResidualDenseBlock5C(32, 32)
    with torch.no_grad():
        for conv, w in zip(blk.convs(), _oihw(ws)):
            conv.weight.copy_(w)
    xin = torch.zeros(1, 32, 4, 4, requires_grad=True)
    blk._unfused_forward(xin).sum().backward()
    assert float((dx.permute(0, 3, 1, 2) - xin.grad).abs().max()) > 1e-3


@pytest.mark.parametrize("nf,gc", [(64, 32), (32, 32), (16, 8)])
def test_unpack_inverts_pack(nf, gc):
    """unpack_rdb_wgrads(pack_rdb_weights(w)) == w exactly, and equals the
    JAX package's _unpack_wgrads on the same packed arrays."""
    ws, _ = _weights(nf, gc, seed=8)
    packed = pack_rdb_weights(_oihw(ws), nf, gc, torch.float32)
    back = unpack_rdb_wgrads(packed, nf, gc)
    for w, r in zip(_oihw(ws), back):
        assert torch.equal(w, r)
    want = _unpack_wgrads(*[jnp.asarray(p.numpy()) for p in packed], nf, gc)
    for r, j in zip(back, want):
        np.testing.assert_array_equal(r.permute(2, 3, 1, 0).numpy(),
                                      np.asarray(j))


def test_backward_on_cpu_counts_no_launch_and_checks_operands():
    ws, bs = _weights(32, 32)
    x, g = _arrays(32, shape=(1, 4, 5))
    before = rdb5c.backward_launches
    _port(x, g, ws, bs, torch.float32)
    assert rdb5c.backward_launches == before
    packed = pack_rdb_weights(_oihw(ws), 32, 32, torch.float32)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    cs = [torch.zeros(1, 4, 5, 32)] * 4
    assert rdb5c._check_backward(gt, xt, cs, packed) == (32, 32)
    with pytest.raises((ValueError, TypeError)):
        rdb5c._check_backward(gt.bfloat16(), xt, cs, packed)
    with pytest.raises((ValueError, TypeError)):
        rdb5c._check_backward(gt[:, :3], xt, cs, packed)
    with pytest.raises((ValueError, TypeError)):
        rdb5c._check_backward(gt, xt, [c[..., :16] for c in cs], packed)


def test_block_keeps_no_graph_without_grad():
    """Under no_grad / inference_mode the block runs the forward alone."""
    blk = ResidualDenseBlock5C(32, 32)
    x = torch.randn(1, 32, 4, 4).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        assert not blk(x).requires_grad
    with torch.no_grad():
        assert blk(x).grad_fn is None
    # the packed weights cached under inference_mode are not reused here:
    # they could not be saved for backward
    out = blk(x)
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(p.grad is not None for p in blk.parameters())
