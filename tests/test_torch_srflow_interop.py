"""The reference-exact SRFlow net (``trainner_tpu_torch/models/
srflow_interop.py``) against the JAX package's ``SRFlowNetI`` on the CPU,
at a small size (nf 8, nb 2, gc 4, K 2, L 3, hidden 8, the taps after
blocks 0 and 1), the same weights in both: the port's init with every
tensor moved by a seeded draw (times 1 + 0.1 N, plus 0.01 N: the
couplings' scales stay away from 0, so f32 inverts them to about 5e-6 in
either package). Held within 1e-5 of each output's size: ``squeeze2d``'s
order; the encoder's conditionals (the ``fea_up`` quirks, the nearest
``stackRRDB`` concat); ``encode_eps``; the NLL with JAX's own
quantisation noise; the mean NLL's gradient (of its largest element);
``sample`` at heat 0 and from the encoded latents, and the round trip to
the HR image. The port's ``state_dict()`` through the JAX package's
``srflow_to_params`` gives the tree of ``flax_paths`` bit for bit, with
the structure of the flax init, and the JAX net on it gives the port's
output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.models import srflow_interop as JI
from trainner_tpu.utils.torch_interop import srflow_to_params
from trainner_tpu_torch.models import srflow_interop as PI
from trainner_tpu_torch.models.networks import define_G
from trainner_tpu_torch.options.config import parse_dict
from trainner_tpu_torch.utils.torch_interop import net_from_jax, net_to_jax

torch.set_num_threads(2)
KW = dict(nf=8, nb=2, gc=4, K=2, L=3, hidden=8, blocks=(0, 1))
B, LR, S = 2, 8, 4


def close(got, want, tol=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=tol * max(np.abs(want).max(), 1e-3))


def _data(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(B, LR, LR, 3).astype(np.float32),
            rs.rand(B, LR * S, LR * S, 3).astype(np.float32))


@pytest.fixture(scope="module")
def net():
    pm = PI.SRFlowNetI(**KW)
    pm.init_weights(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in pm.parameters():
            p.mul_(1 + 0.1 * torch.randn(p.shape, generator=gen))
            p.add_(0.01 * torch.randn(p.shape, generator=gen))
    params, _ = net_to_jax(pm.state_dict(), pm)
    return JI.SRFlowNetI(**KW), params, pm.eval()


def _apply(jm, params, *args, method=None, **kw):
    return jax.jit(lambda p: jm.apply(
        {"params": p}, *args, method=method,
        rngs={"sample": jax.random.PRNGKey(0),
              "noise": jax.random.PRNGKey(1)}, **kw))(params)


def test_squeeze2d_order():
    x = np.random.RandomState(0).randn(2, 6, 4, 5).astype(np.float32)
    got = PI.squeeze2d(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        JI.squeeze2d(jnp.asarray(x))))
    np.testing.assert_array_equal(PI.unsqueeze2d(got).numpy(), x)
    a, b = PI._split_cross(torch.from_numpy(x))
    ja, jb = JI._split_cross(jnp.asarray(x))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.fixture(scope="module")
def encoded(net):
    """JAX's ``encode_eps`` of one batch, compiled once."""
    jm, params, _ = net
    lr, hr = _data(2)
    return lr, hr, _apply(jm, params, jnp.asarray(hr), jnp.asarray(lr),
                          method=jm.encode_eps)


def test_state_dict_through_srflow_to_params(net, encoded):
    """The JAX converter reads the port's state_dict as it stands: the
    same tree as ``flax_paths``, bit for bit, with the flax init's
    structure and shapes; and back into the port."""
    jm, params, pm = net
    conv = srflow_to_params({k: v.numpy()
                             for k, v in pm.state_dict().items()})["params"]
    assert jax.tree_util.tree_structure(conv) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(conv),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    lr, hr, (z, ld, _) = encoded
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        gt=jnp.asarray(hr), lr=jnp.asarray(lr)))["params"]
    assert jax.tree_util.tree_structure(shapes) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(shapes),
                    jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape
    fresh = PI.SRFlowNetI(**KW)
    fresh.load_state_dict(net_from_jax(conv, None, fresh), strict=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, pm.state_dict()[k]), k
    # the JAX net on the converted tree (equal to ``params``) gives the
    # port's output
    with torch.no_grad():
        pz, pld, _ = pm.encode_eps(torch.from_numpy(hr),
                                   torch.from_numpy(lr))
    close(pz, z), close(pld, ld)


def test_encoder_conditionals(net):
    """Every key of the encoder's dict, ``out`` and ``fea_up4`` too."""
    jm, params, pm = net
    lr, _ = _data(1)
    want = _apply(jm, params, jnp.asarray(lr),
                  method=lambda m, x: m.encoder(x))
    with torch.no_grad():
        got = pm.RRDB(torch.from_numpy(lr))
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])
    assert got["fea_up2"].shape[-1] == KW["nf"] * 3


def test_encode_and_nll(net, encoded):
    jm, params, pm = net
    lr, hr, (z, ld, eps) = encoded
    with torch.no_grad():
        pz, pld, peps = pm.encode_eps(torch.from_numpy(hr),
                                      torch.from_numpy(lr))
    close(pz, z), close(pld, ld)
    assert len(peps) == len(eps) == 1
    close(peps[0], eps[0])
    # the NLL with JAX's quantisation noise (its rng given)
    key = jax.random.PRNGKey(7)
    jz, nll, jld = _apply(jm, params, gt=jnp.asarray(hr),
                          lr=jnp.asarray(lr), rng=key)
    u = np.array(jax.random.uniform(key, hr.shape))
    with torch.no_grad():
        gz, gnll, gld = pm(gt=torch.from_numpy(hr), lr=torch.from_numpy(lr),
                           noise=torch.from_numpy(u))
    close(gz, jz), close(gnll, nll), close(gld, jld)
    # no noise and no offset in eval mode
    _, enll, _ = _apply(jm, params, gt=jnp.asarray(hr), lr=jnp.asarray(lr),
                        train=False)
    with torch.no_grad():
        close(pm(gt=torch.from_numpy(hr), lr=torch.from_numpy(lr),
                 train=False)[1], enll)


def test_nll_gradient(net):
    jm, params, pm = net
    lr, hr = _data(3)
    key = jax.random.PRNGKey(9)
    grads = jax.jit(jax.grad(lambda p: jnp.mean(jm.apply(
        {"params": p}, gt=jnp.asarray(hr), lr=jnp.asarray(lr),
        rng=key)[1])))(params)
    u = np.array(jax.random.uniform(key, hr.shape))
    pm.zero_grad()
    pm(gt=torch.from_numpy(hr), lr=torch.from_numpy(lr),
       noise=torch.from_numpy(u))[1].mean().backward()
    got, _ = net_to_jax({k: torch.zeros_like(p) if p.grad is None
                         else p.grad for k, p in pm.named_parameters()}, pm)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(grads)
    flat_w = jax.tree_util.tree_leaves(grads)
    top = max(float(np.abs(np.asarray(w)).max()) for w in flat_w)
    for g, w in zip(jax.tree_util.tree_leaves(got), flat_w):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5 * top)


def test_sample(net, encoded):
    """Heat 0, the encoded latents, and the round trip to the HR image."""
    jm, params, pm = net
    lr, hr, (z, _, eps) = encoded
    sr0, _ = _apply(jm, params, jnp.asarray(lr), None, 0.0,
                    method=jm.sample)
    with torch.no_grad():
        got0 = pm.sample_from(torch.from_numpy(lr),
                              [torch.zeros(s) for s in
                               pm.sample_shapes(lr.shape)])
    close(got0, sr0)
    sr, ld = jax.jit(lambda p, zz, ee: jm.apply(
        {"params": p}, jnp.asarray(lr), zz, 1.0, ee, method=jm.sample,
        rngs={"sample": jax.random.PRNGKey(0)}))(params, z, eps)
    with torch.no_grad():
        pz, _, peps = pm.encode_eps(torch.from_numpy(hr),
                                    torch.from_numpy(lr))
        psr, pld = pm.sample(torch.from_numpy(lr), pz, 1.0, peps)
    close(psr, sr), close(pld, ld)
    close(psr, hr)


def test_interop_option_builds():
    """``flow.interop: true`` and ``type: srflow_interop`` through the
    port's parse build the reference-exact net."""
    for g in ({"type": "srflow_net", "flow": {"interop": True}},
              {"type": "srflow_interop"}):
        opt = parse_dict({"name": "t", "model": "srflow", "scale": 4,
                          "network_G": dict(g, nf=8, nb=2, K=2),
                          "path": {"root": "/tmp/srflow_cfg"}},
                         is_train=False)
        net = define_G(opt)
        assert isinstance(net, PI.SRFlowNetI)
        assert len(net.blocks()) == 6 and net.final_c == 96
