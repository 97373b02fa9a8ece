"""The residual dense block at widths that are not multiples of 32
(``trainner_tpu_torch/ops/rdb5c.py``: ``pad_packed``, ``unpad_grads``,
``pack_block`` and the padded route of ``rdb5c_forward``,
``rdb5c_backward`` and ``RDB5CFunction``), on the CPU. The kernels take nf
and gc in multiples of 32; the wrappers pad a narrower block with zeros.
Here the padded block, run through the plain versions, is held to the
unpadded plain versions (which ``test_torch_rdb5c.py`` and
``test_torch_rdb5c_bwd.py`` hold to the JAX package), and the port's
``RRDBNet`` at the debug configs' widths to the JAX ``RRDBNet``.
``chip_smoke.py`` holds the kernels at the padded widths to the unpadded
plain versions on the card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.models.rrdb import RRDBNet as JaxRRDBNet
from trainner_tpu_torch.models.rrdb import ResidualDenseBlock5C, RRDBNet
from trainner_tpu_torch.ops import rdb5c
from trainner_tpu_torch.ops.rdb5c import (RDB5CFunction, pack_block,
                                          pack_rdb_weights, pad_packed,
                                          padded_width, rdb5c_backward,
                                          rdb5c_backward_plain, rdb5c_forward,
                                          rdb5c_forward_plain, unpad_grads)
from trainner_tpu_torch.utils.torch_interop import params_from_jax

torch.set_num_threads(2)

WIDTHS = [(16, 8), (48, 16), (8, 8), (64, 32)]
SHAPE = (2, 9, 7)


def _block(nf, gc, dtype, seed=0):
    """OIHW weights, packed weights in ``dtype`` and f32 biases of one
    block, x and g, from a numpy seed."""
    rng = np.random.RandomState(seed)
    ws = [torch.from_numpy(rng.randn(gc if k < 4 else nf, nf + k * gc, 3, 3)
                           .astype(np.float32) * 0.1) for k in range(5)]
    bs = [torch.from_numpy(rng.randn(gc if k < 4 else nf)
                           .astype(np.float32) * 0.05) for k in range(5)]
    x = torch.from_numpy(rng.randn(*SHAPE, nf).astype(np.float32) * 0.5)
    g = torch.from_numpy(rng.randn(*SHAPE, nf).astype(np.float32))
    packed = pack_rdb_weights(ws, nf, gc, dtype)
    return ws, packed, bs, x.to(dtype), g.to(dtype)


def _close(a, r, dtype):
    """f32: 1e-6 of the largest magnitude (the convs sum the extra zeros
    in another blocking); bf16: one ulp there (a sum that lands on a
    rounding boundary may round the other way)."""
    a, r = a.float(), r.float()
    top = float(r.abs().max())
    if dtype == torch.float32:
        tol = 1e-6 * top
    else:
        tol = 2.0 ** (math.floor(math.log2(top)) - 7) if top else 0.0
    return float((a - r).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nf,gc", WIDTHS)
def test_padded_block_computes_the_narrow_one(nf, gc, dtype):
    """pad_packed's block on zero-padded x and g, through the plain forward
    and backward, equals the unpadded plain results; the padded residual
    channels and the padded dW and db entries are exactly zero before they
    are cut away."""
    _, packed, bs, x, g = _block(nf, gc, dtype)
    nfp, gcp = padded_width(nf), padded_width(gc)
    pw, pb = pad_packed(packed, bs)
    assert [tuple(p.shape) for p in pw] == [
        (9 * (nfp if s == 0 else gcp), 4 * gcp + nfp - s * gcp)
        for s in range(5)]
    assert [b.shape[0] for b in pb] == [gcp] * 4 + [nfp]
    pad_x = lambda t: torch.nn.functional.pad(t, (0, nfp - nf))  # noqa
    want = rdb5c_forward_plain(x, packed, bs, return_residuals=True)
    got = rdb5c_forward_plain(pad_x(x), pw, pb, return_residuals=True)
    assert not got[0][..., nf:].any()
    assert _close(got[0][..., :nf], want[0], dtype)
    for c, r in zip(got[1:], want[1:]):
        assert c.shape[-1] == gcp and not c[..., gc:].any()
        assert _close(c[..., :gc], r, dtype)

    want_b = rdb5c_backward_plain(g, x, *want[1:], packed)
    got_b = rdb5c_backward_plain(pad_x(g), pad_x(x), *got[1:], pw)
    assert not got_b[0][..., nf:].any()
    assert _close(got_b[0][..., :nf], want_b[0], dtype)
    dws, dbs = unpad_grads(got_b[1:6], got_b[6:], nf, gc)
    # what unpad_grads cuts away is exactly zero: padding the cut
    # gradients with zeros gives them back bit for bit
    back_w, back_b = pad_packed(dws, dbs)
    for a, r in zip(back_w + back_b, got_b[1:]):
        assert torch.equal(a, r)
    for a, r in zip(dws + dbs, want_b[1:]):
        assert a.shape == r.shape
        assert _close(a, r, dtype)


@pytest.mark.parametrize("nf,gc", WIDTHS)
def test_unpad_grads_inverts_pad_packed(nf, gc):
    _, packed, bs, _, _ = _block(nf, gc, torch.float32, seed=1)
    pw, pb = pad_packed(packed, bs)
    back_w, back_b = unpad_grads(pw, pb, nf, gc)
    for a, r in zip(back_w + back_b, tuple(packed) + tuple(bs)):
        assert torch.equal(a, r)
    if (padded_width(nf), padded_width(gc)) == (nf, gc):
        assert all(a is r for a, r in zip(pw, packed))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nf,gc", WIDTHS)
def test_wrappers_pad_a_narrow_block(nf, gc, dtype):
    """rdb5c_forward and rdb5c_backward given the narrow pack: out and dx
    at nf, residuals at gc', dW and db at the pack's own widths, the same
    as the unpadded plain versions; pack_block's padded pack gives the
    same."""
    ws, packed, bs, x, g = _block(nf, gc, dtype, seed=2)
    out, *cs = rdb5c_forward(x, packed, bs, return_residuals=True)
    want = rdb5c_forward_plain(x, packed, bs, return_residuals=True)
    assert out.shape == x.shape and out.is_contiguous()
    assert _close(out, want[0], dtype)
    for c, r in zip(cs, want[1:]):
        assert c.shape[-1] == padded_width(gc)
        assert _close(c[..., :gc], r, dtype)
    got_b = rdb5c_backward(g, x, *cs, packed)
    want_b = rdb5c_backward_plain(g, x, *want[1:], packed)
    for a, r in zip(got_b, want_b):
        assert a.shape == r.shape
        assert _close(a, r, dtype)
    pw, pb = pack_block(ws, bs, nf, gc, dtype)
    again = rdb5c_forward(x, pw, pb, return_residuals=True)
    for a, r in zip(again, (out, *cs)):
        assert torch.equal(a, r)


@pytest.mark.parametrize("nf,gc", [(16, 8), (48, 16)])
def test_block_grads_at_narrow_widths_match_autograd(nf, gc):
    """ResidualDenseBlock5C at a narrow width under autograd (the padded
    RDB5CFunction) against torch autograd of the plain five-conv chain:
    relative 1e-4 of each gradient's largest magnitude."""
    torch.manual_seed(3)
    blk = ResidualDenseBlock5C(nf, gc)
    for c in blk.convs():
        torch.nn.init.normal_(c.weight, std=0.1)
        torch.nn.init.normal_(c.bias, std=0.05)
    x = torch.randn(2, nf, 6, 9).contiguous(memory_format=torch.channels_last)
    gt = torch.randn(2, nf, 6, 9)

    def grads(fn):
        xin = x.clone().requires_grad_(True)
        blk.zero_grad()
        (fn(xin) * gt).sum().backward()
        return [xin.grad] + [p.grad.clone() for p in blk.parameters()]

    got, want = grads(blk), grads(blk._unfused_forward)
    assert blk.packed(torch.float32)[0][0].shape == (
        9 * padded_width(nf), 4 * padded_width(gc) + padded_width(nf))
    for a, r in zip(got, want):
        assert a.shape == r.shape
        assert float((a - r).abs().max()) <= 1e-4 * float(r.abs().max())


def test_debug_width_rrdbnet_runs_padded_and_matches_jax():
    """The debug configs' G (nf 16, nb 2, gc 8) on the padded route: every
    block's cached pack is at (32, 32), and the output equals the JAX
    RRDBNet's within 1e-5, the weights carried across by params_from_jax."""
    cfg = dict(nf=16, nb=2, nr=3, gc=8, upscale=4)
    x = np.random.RandomState(4).rand(1, 7, 10, 3).astype(np.float32)
    jnet = JaxRRDBNet(**cfg, gaussian_noise=False, dtype=jnp.float32)
    rng = jax.random.PRNGKey(1)
    v = jnet.init({"params": rng, "noise": rng}, jnp.asarray(x), train=False)
    draw = np.random.RandomState(5)
    params = jax.tree.map(
        lambda a: (draw.randn(*a.shape) * (0.1 if a.ndim == 4 else 0.05))
        .astype(np.float32), v["params"])
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x),
                                 train=False))
    tnet = RRDBNet(**cfg, gaussian_noise=False)
    tnet.load_state_dict(params_from_jax(params), strict=True)
    before = rdb5c.launches
    with torch.inference_mode():
        got = tnet.eval()(torch.from_numpy(x)).numpy()
    assert rdb5c.launches == before  # the plain versions, on the CPU
    blocks = [m for m in tnet.modules()
              if isinstance(m, ResidualDenseBlock5C)]
    assert len(blocks) == 6
    for blk in blocks:
        ws, bs = blk.packed(torch.float32)
        assert [tuple(p.shape) for p in ws][0] == (9 * 32, 160)
        assert [b.shape[0] for b in bs] == [32] * 5
    assert got.shape == want.shape == (1, 28, 40, 3)
    assert np.abs(got - want).max() < 1e-5


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card: enough to walk the
    wrappers' padded route up to the kernel's library."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(t):
    return torch.Tensor._make_subclass(_FakeCuda, t)


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_a_cuda_tensor_on_the_padded_route_never_reaches_the_plain_version(
        which, monkeypatch):
    """A narrow block on a CUDA tensor is padded and goes to the kernel's
    library (here one that raises), never to the plain versions."""
    called = []
    for name in ("rdb5c_forward_plain", "rdb5c_backward_plain"):
        monkeypatch.setattr(rdb5c, name, lambda *a, **k: called.append(1))
    boom = lambda: (_ for _ in ()).throw(RuntimeError("no nvcc"))  # noqa
    monkeypatch.setattr(rdb5c, "_library", boom)
    monkeypatch.setattr(rdb5c, "_bwd_library", boom)
    monkeypatch.setattr(rdb5c, "_dw_splits", lambda *a: boom())
    _, packed, bs, x, g = _block(16, 8, torch.float32, seed=5)
    packed = [_fake(p) for p in packed]
    bs = [_fake(b) for b in bs]
    with pytest.raises(RuntimeError, match="no nvcc"):
        if which == "forward":
            rdb5c_forward(_fake(x), packed, bs)
        else:
            cs = [_fake(torch.zeros(*SHAPE, 32)) for _ in range(4)]
            rdb5c_backward(_fake(g), _fake(x), *cs, packed)
    assert not called


def test_function_packs_at_the_kernels_widths_without_a_packer():
    """RDB5CFunction with no packer pads the block itself; its gradients
    come back at the parameters' own shapes."""
    nf, gc = 16, 8
    ws, _, bs, x, g = _block(nf, gc, torch.float32, seed=6)
    params = []
    for w, b in zip(ws, bs):
        params += [w.clone().requires_grad_(True),
                   b.clone().requires_grad_(True)]
    xin = x.clone().requires_grad_(True)
    out = RDB5CFunction.apply(xin, None, *params)
    assert out.shape == x.shape
    (out * g).sum().backward()
    assert xin.grad.shape == x.shape
    for p in params:
        assert p.grad is not None and p.grad.shape == p.shape


@pytest.mark.parametrize("name", ["DEBUG_TEST_YML", "DEBUG_TRAIN_YML"])
def test_smoke_script_reads_the_debug_configs_as_yaml_does(name):
    """chip_smoke.py reads the debug configs without PyYAML (the card's
    machine has none): the same options as the port's YAML reader."""
    import chip_smoke
    from trainner_tpu_torch.options.config import read_yaml

    path = getattr(chip_smoke, name)
    opt = chip_smoke.read_options_yml(path)
    assert opt == read_yaml(path)
    assert (opt["network_G"]["nf"], opt["network_G"]["gc"]) == (16, 8)
