"""The spectral-norm discriminators of the port against flax, in f32 on
the CPU: ``UNetDiscriminator`` (nf 8, skip connections on and off) and
D-VGG with spectral norm (``discriminator_vgg_*_sn``), carried across from
a flax init (its names read from the init, not guessed): the forward in
both ``update_stats`` modes, ``u`` and ``sigma`` after a train-mode pass,
the gradient of the parameters; the state that two passes of one step
leave; both directions of the weights; ``SpectralNorm`` by itself against
flax's ``nn.SpectralNorm``."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.models.discriminators import (DiscriminatorVGG as JaxVGG,
                                                UNetDiscriminator as JaxUNet)
from trainner_tpu.models.networks import define_D as jax_define_D
from trainner_tpu_torch.models.discriminators import (DiscriminatorVGG,
                                                      UNetDiscriminator)
from trainner_tpu_torch.models.networks import define_D
from trainner_tpu_torch.ops.blocks import SpectralNorm
from trainner_tpu_torch.utils.torch_interop import (discriminator_from_jax,
                                                    discriminator_to_jax)

torch.set_num_threads(2)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _nets(kind, skip=True):
    """(flax module, its variables with redrawn biases, the port's net
    loaded from them)."""
    if kind == "unet":
        jm = JaxUNet(nf=8, skip_connection=skip)
        net = UNetDiscriminator(nf=8, skip_connection=skip)
    else:
        jm = JaxVGG(size=32, base_nf=8, norm_type=None, spectral_norm=True)
        net = DiscriminatorVGG(size=32, base_nf=8, norm_type=None,
                               spectral_norm=True)
    v = _numpy(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)),
                       train=False))
    rng = np.random.RandomState(3)
    v["params"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.randn(*a.shape) * 0.05).astype(np.float32)
        if p[-1].key == "bias" else a, v["params"])
    net.load_state_dict(discriminator_from_jax(v["params"], v["batch_stats"]))
    return jm, v, net


def _x(seed=0, b=2):
    return np.random.RandomState(seed).rand(b, 32, 32, 3).astype(np.float32)


CASES = [("unet", True), ("unet", False), ("vgg_sn", True)]


@pytest.mark.parametrize("kind, skip", CASES)
@pytest.mark.parametrize("train", [False, True])
def test_forward_and_state_match_flax(kind, skip, train):
    """The output within 1e-5 of its scale; after a train-mode pass the
    committed ``u`` and ``sigma`` within 1e-6 of flax's updated ones; an
    eval pass commits nothing."""
    jm, v, net = _nets(kind, skip)
    x = _x()
    want, upd = jm.apply(v, jnp.asarray(x), train=train,
                         mutable=["batch_stats"])
    got = net(torch.from_numpy(x), train=train).detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    before = {k: t.clone() for k, t in net.state_dict().items()}
    net.commit_stats()
    after = net.state_dict()
    new = discriminator_from_jax(v["params"], _numpy(upd["batch_stats"]))
    sn = [k for k in new if ".sn." in k]
    assert len(sn) == 2 * len([m for m in net.modules()
                               if isinstance(m, SpectralNorm)]) > 0
    for k in sn:
        if train:
            assert float((after[k] - new[k]).abs().max()) <= 1e-6, k
        else:
            assert torch.equal(after[k], before[k]), k


@pytest.mark.parametrize("kind, skip", CASES)
def test_gradient_matches_flax(kind, skip):
    """The gradient of sum(D(x)^2) by every parameter, through sigma
    (not through u and v): within 1e-4 of each tensor's largest."""
    jm, v, net = _nets(kind, skip)
    x = _x(1)

    def loss(p):
        out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                          jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
        return jnp.sum(out ** 2)

    want = discriminator_from_jax(_numpy(jax.grad(loss)(v["params"])))
    (net(torch.from_numpy(x), train=True) ** 2).sum().backward()
    params = dict(net.named_parameters())
    assert set(want) == set(params)
    for k, w in want.items():
        err = float((params[k].grad - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), k


def test_two_passes_of_a_step_leave_the_same_state():
    """u after one power step depends on W and the stored u alone: the
    fake and the real pass of a D stage leave the same u and sigma, so the
    last pass's commit is the step's one update whichever batch it saw."""
    _, _, net = _nets("unet")
    net(torch.from_numpy(_x(2)), train=True)
    first = [tuple(t.clone() for t in m.pending) for m in net.norms()]
    net(torch.from_numpy(_x(3)), train=True)
    for m, (u, s) in zip(net.norms(), first):
        assert torch.equal(m.pending[0], u) and torch.equal(m.pending[1], s)


@pytest.mark.parametrize("kind, skip", CASES)
def test_weights_and_state_both_ways(kind, skip):
    """The port's state_dict -> flax trees -> the port again, exactly; the
    trees have flax's names and shapes."""
    jm, v, net = _nets(kind, skip)
    net(torch.from_numpy(_x()), train=True)
    net.commit_stats()
    params, stats = discriminator_to_jax(net.state_dict())
    assert jax.tree.map(np.shape, params) == jax.tree.map(np.shape,
                                                          v["params"])
    assert jax.tree.map(np.shape, stats) == jax.tree.map(
        np.shape, v["batch_stats"])
    back = discriminator_from_jax(params, stats)
    for k, t in net.state_dict().items():
        assert torch.equal(back[k], t), k
    # the flax module runs on the carried trees as on its own
    out = jm.apply({"params": params, "batch_stats": stats},
                   jnp.asarray(_x()), train=False)
    got = net(torch.from_numpy(_x()), train=False).detach().numpy()
    assert np.abs(np.asarray(out) - got).max() <= 1e-5 * np.abs(got).max()


def test_spectral_norm_matches_flax_on_a_conv():
    """``SpectralNorm`` by itself: the normalised weight of a 4x4 kernel
    and its updated u and sigma against flax's wrapper of ``nn.Conv``."""
    rng = np.random.RandomState(0)
    conv = nn.SpectralNorm(nn.Conv(6, (4, 4)))
    x = jnp.asarray(rng.rand(1, 8, 8, 5).astype(np.float32))
    v = _numpy(conv.init(jax.random.PRNGKey(0), x, update_stats=False))
    _, upd = conv.apply(v, x, update_stats=True, mutable=["batch_stats"])
    stats = _numpy(upd["batch_stats"])
    # a wrapper at the top of the tree names its layer layer_instance
    kernel = v["params"]["layer_instance"]["kernel"]
    sn = SpectralNorm(6).train()
    sn.u.copy_(torch.tensor(v["batch_stats"]["layer_instance/kernel/u"]))
    w = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    got = sn(w)
    sn.commit()
    sigma = float(stats["layer_instance/kernel/sigma"])
    torch.testing.assert_close(got, w / sigma, atol=1e-6, rtol=1e-6)
    assert abs(float(sn.sigma) - sigma) <= 1e-6 * abs(sigma)
    np.testing.assert_allclose(sn.u.numpy(),
                               stats["layer_instance/kernel/u"], atol=1e-6)


@pytest.mark.parametrize("cfg", [
    {"type": "unet", "nf": 8}, {"type": "unet", "nf": 8,
                                "skip_connection": False},
    {"type": "discriminator_vgg_128_sn", "base_nf": 8},
    {"type": "discriminator_vgg", "size": 32, "base_nf": 8,
     "spectral_norm": True}])
def test_define_d_builds_what_jax_builds(cfg):
    """The same module with the same parameter and state names and shapes
    as the JAX package's ``define_D``."""
    net = define_D({"network_D": cfg}, dtype=torch.float32)
    jnet = jax_define_D({"network_D": cfg}, dtype=jnp.float32)
    size = 128 if "128" in cfg["type"] else 32
    v = _numpy(jnet.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, size, size, 3)), train=False))
    want = discriminator_from_jax(v["params"], v["batch_stats"])
    got = net.state_dict()
    assert {k: tuple(t.shape) for k, t in got.items()} == \
        {k: tuple(t.shape) for k, t in want.items()}
