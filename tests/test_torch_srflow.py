"""SRFlow's redesigned net (``trainner_tpu_torch/models/srflow.py``)
against the JAX package's ``trainner_tpu/models/srflow.py`` on the CPU, at
a small size (nf 8, nb 2, gc 4, K 2, L 3, hidden 8; TF32 plays no part on
the CPU), the same weights in both (flax variables with every leaf moved
by a numpy draw, carried both ways bit for bit): every flow primitive
forward and reverse within 1e-5 of its output's size; ``SRFlowNet``'s
``(z, nll, logdet)`` with no noise, each split's latent
(``return_epses``), and the mean NLL's gradient within 1e-5 of its
largest element; sampling at heat 0 and from the same numpy latents in
both; ``reverse(forward(gt)) == gt``; the template's config through
``define_G``. The encoder's blocks run the block kernels' plain versions
here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from trainner_tpu.models import srflow as JF
from trainner_tpu_torch.models import srflow as PF
from trainner_tpu_torch.models.networks import define_G
from trainner_tpu_torch.ops.blocks import named_flax_paths
from trainner_tpu_torch.options.config import parse_dict
from trainner_tpu_torch.utils.torch_interop import net_from_jax, net_to_jax

torch.set_num_threads(2)
KW = dict(nf=8, nb=2, gc=4, K=2, L=3, hidden_channels=8)
B, LR, S = 2, 8, 4


def moved(tree, seed: int):
    """Every leaf times a draw near 1, zero leaves given small values (the
    zero-initialised convs and logs), from a numpy seed."""
    rng = np.random.RandomState(seed)

    def leaf(a):
        a = np.asarray(a, np.float32)
        out = a * (1 + 0.3 * rng.randn(*a.shape))
        if a.ndim <= 1 or not np.any(a):
            out = out + 0.05 * rng.randn(*a.shape)
        return out.astype(np.float32)

    return jax.tree.map(leaf, tree)


def close(got, want, tol=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=tol * max(np.abs(want).max(), 1e-3))


class Holder(nn.Module):
    """One primitive under the flax name ``m``."""

    def __init__(self, m):
        super().__init__()
        self.m = m

    def flax_paths(self):
        return named_flax_paths(self)


def carry(params, pm):
    """Flax params -> the port's module, and back bit for bit."""
    pm.load_state_dict(net_from_jax(params, None, pm), strict=True)
    back, _ = net_to_jax(pm.state_dict(), pm)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    return pm


def _data(seed=0, c=3, px=LR * S):
    rs = np.random.RandomState(seed)
    return (rs.rand(B, LR, LR, 3).astype(np.float32),
            rs.rand(B, px, px, c).astype(np.float32))


def test_squeeze_order_and_round_trip():
    x = np.random.RandomState(0).randn(2, 6, 4, 5).astype(np.float32)
    got = PF.squeeze2(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        JF.squeeze2(jnp.asarray(x))))
    np.testing.assert_array_equal(PF.unsqueeze2(got).numpy(), x)


def test_gaussian_logp():
    rs = np.random.RandomState(1)
    x, m, s = (rs.randn(2, 4, 4, 6).astype(np.float32) for _ in range(3))
    close(PF.gaussian_logp(torch.from_numpy(x)),
          JF.gaussian_logp(jnp.asarray(x)))
    close(PF.gaussian_logp(*map(torch.from_numpy, (x, m, 0.3 * s))),
          JF.gaussian_logp(*map(jnp.asarray, (x, m, 0.3 * s))))


PRIMITIVES = {
    "actnorm": (lambda: JF.ActNorm(12), lambda: PF.ActNorm(12), 12, False),
    "invconv": (lambda: JF.InvConv1x1(12), lambda: PF.InvConv1x1(12), 12,
                False),
    "fnet": (lambda: JF._FNet(10, 8), lambda: PF._FNet(12, 10, 8), 12,
             False),
    "cond_affine": (lambda: JF.CondAffine(12, 8),
                    lambda: PF.CondAffine(12, 8, 8), 12, True),
    "flow_step": (lambda: JF.FlowStep(12, 8), lambda: PF.FlowStep(12, 8, 8),
                  12, True),
    "split": (lambda: JF.Split2d(12), lambda: PF.Split2d(12), 12, False),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
@pytest.mark.parametrize("reverse", [False, True])
def test_primitive(name, reverse):
    """Each primitive forward and reverse: outputs and log-determinants
    within 1e-5 of their size; forward then reverse gives the input."""
    jf, pf, c, conds = PRIMITIVES[name]
    rs = np.random.RandomState(3)
    x = rs.randn(B, 6, 6, c).astype(np.float32)
    ft = rs.randn(B, 6, 6, 8).astype(np.float32)
    ld0 = rs.randn(B).astype(np.float32)
    jm = jf()
    if name == "fnet":
        args, pargs = (jnp.asarray(x),), (torch.from_numpy(x),)
    elif conds:
        args = (jnp.asarray(x), jnp.asarray(ft), jnp.asarray(ld0))
        pargs = tuple(map(torch.from_numpy, (x, ft, ld0)))
    else:
        args, pargs = (jnp.asarray(x), jnp.asarray(ld0)), \
            tuple(map(torch.from_numpy, (x, ld0)))
    params = moved(jm.init(jax.random.PRNGKey(0), *args)["params"], 5)
    pm = carry({"m": params}, Holder(pf())).m
    if name == "fnet":
        close(pm(*pargs), jm.apply({"params": params}, *args))
        return
    if name == "split":
        z1, ld, eps = jm.apply({"params": params}, *args)
        pz1, pld, peps = pm(*pargs)
        close(pz1, z1), close(pld, ld), close(peps, eps)
        if reverse:
            back, bld, _ = jm.apply({"params": params}, z1, ld, True,
                                    eps=eps)
            pback, pbld, _ = pm(pz1, pld, True, eps=peps)
            close(pback, back), close(pbld, bld)
            close(pback, x, 1e-5)
        return
    out = jm.apply({"params": params}, *args, reverse=reverse)
    got = pm(*pargs, reverse=reverse)
    close(got[0], out[0]), close(got[1], out[1])
    back = pm(*((got[0],) + pargs[1:-1] + (got[1],)), reverse=not reverse)
    close(back[0], x, 1e-5), close(back[1], ld0, 1e-5)


@pytest.fixture(scope="module")
def net():
    """The JAX module and the port's net with the same moved weights; the
    JAX tree's structure checked against its init's (traced, not run)."""
    jm = JF.SRFlowNet(**KW)
    pm = PF.SRFlowNet(**KW)
    pm.init_weights(torch.Generator().manual_seed(0))
    params, _ = net_to_jax(pm.state_dict(), pm)
    params = moved(params, 1)
    lr, hr = _data()
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), gt=jnp.asarray(hr), lr=jnp.asarray(lr),
        reverse=False))["params"]
    assert jax.tree_util.tree_structure(shapes) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(shapes),
                    jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape
    carry(params, pm)
    return jm, params, pm.eval()


def test_nll_forward(net):
    jm, params, pm = net
    lr, hr = _data()
    epses, nll, ld = jax.jit(lambda p: jm.apply(
        {"params": p}, gt=jnp.asarray(hr), lr=jnp.asarray(lr),
        reverse=False, return_epses=True))(params)
    with torch.no_grad():
        pep, pnll, pld = pm(gt=torch.from_numpy(hr), lr=torch.from_numpy(lr),
                            return_epses=True)
        pz, _, _ = pm(gt=torch.from_numpy(hr), lr=torch.from_numpy(lr))
    assert len(pep) == len(epses) == KW["L"]
    for a, b in zip(pep, epses):
        close(a, b)
    close(pz, epses[-1])
    close(pnll, nll)
    # the log-determinant sums over the image: relative to its size
    close(pld, ld)


def test_nll_gradient(net):
    jm, params, pm = net
    lr, hr = _data(1)
    grads = jax.jit(jax.grad(lambda p: jnp.mean(jm.apply(
        {"params": p}, gt=jnp.asarray(hr), lr=jnp.asarray(lr),
        reverse=False)[1])))(params)
    pm.zero_grad()
    pm(gt=torch.from_numpy(hr), lr=torch.from_numpy(lr))[1].mean().backward()
    got, _ = net_to_jax({k: p.grad for k, p in pm.named_parameters()}, pm)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(grads)
    flat_g = jax.tree_util.tree_leaves(got)
    flat_w = jax.tree_util.tree_leaves(grads)
    top = max(float(np.abs(np.asarray(w)).max()) for w in flat_w)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5 * top)


def test_sample_heat_zero_and_given_latents(net):
    """Heat 0 (the JAX module's own draws times 0) and the same numpy
    latents fed to both."""
    jm, params, pm = net
    lr, _ = _data(2)
    sr0, ld0 = jax.jit(lambda p: jm.apply(
        {"params": p}, lr=jnp.asarray(lr), reverse=True, eps_std=0.0,
        rng=jax.random.PRNGKey(0)))(params)
    shapes = pm.sample_shapes(lr.shape)
    with torch.no_grad():
        got = pm.sample_from(torch.from_numpy(lr),
                             [torch.zeros(s) for s in shapes])
    close(got, sr0)
    rs = np.random.RandomState(4)
    draws = [0.7 * rs.randn(*s).astype(np.float32) for s in shapes]
    epses = [jnp.asarray(d) for d in draws[1:][::-1]] + [jnp.asarray(
        draws[0])]
    sr, ld = jax.jit(lambda p, e: jm.apply(
        {"params": p}, lr=jnp.asarray(lr), reverse=True, epses=e))(params,
                                                                  epses)
    with torch.no_grad():
        got = pm.sample_from(torch.from_numpy(lr),
                             [torch.from_numpy(d) for d in draws])
        _, pld = pm(lr=torch.from_numpy(lr), reverse=True,
                    epses=[torch.from_numpy(np.asarray(e)) for e in epses])
    close(got, sr)
    close(pld, ld)


def test_round_trip(net):
    """reverse(forward(gt)) == gt, through every split's latent."""
    _, _, pm = net
    lr, hr = _data(3)
    with torch.no_grad():
        epses, _, _ = pm(gt=torch.from_numpy(hr), lr=torch.from_numpy(lr),
                         return_epses=True)
        back, _ = pm(lr=torch.from_numpy(lr), reverse=True, epses=epses)
    close(back, hr, 1e-5)


def test_template_config_builds():
    """``train_srflow.yml``'s network_G through the port's parse and
    ``define_G``: the flow defaults merged, K from the top level."""
    opt = parse_dict({"name": "t", "model": "srflow", "scale": 4,
                      "network_G": {"type": "srflow_net", "nf": 8, "nb": 2,
                                    "K": 2, "flow": {"L": 3,
                                                     "hidden_channels": 8}},
                      "path": {"root": "/tmp/srflow_cfg"}}, is_train=False)
    g = opt["network_G"]
    assert g["flow"]["stackRRDB"]["blocks"] == [1, 8, 15, 22]
    assert g["K"] == 2 and g["upscale"] == 4
    net = define_G(opt)
    assert isinstance(net, PF.SRFlowNet) and net.K == 2 and net.L == 3
    assert len(net.blocks()) == 2
