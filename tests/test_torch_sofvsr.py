"""SOF-VSR (``trainner_tpu_torch/models/sofvsr.py``) against the JAX
package's on the CPU: the same flax weights (the init, each kernel times a
draw near 1, small biases, from a numpy seed) in both, carried both ways
bit for bit; every flow level and the SR frame f32 within 1e-5 of their
size, with the RRDB tail (whose blocks run the block kernels' plain
versions here; latent noise off, ROADMAP C 9) and with SRnet's, at x4 and
x2, 3 and 5 frames (the gradients: ``test_torch_vsr_trainer.py``);
``channel_shuffle`` and ``ResB``;
``define_G`` from the parsed template options; the RRDB tail's input width
99 at the template's x4, 3 frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.models import sofvsr as JS
from trainner_tpu_torch.models import sofvsr as PS
from trainner_tpu_torch.models.networks import define_G
from trainner_tpu_torch.models.rrdb import RRDBNet
from trainner_tpu_torch.options.config import parse_dict
from trainner_tpu_torch.utils.torch_interop import (g_from_jax, g_to_jax,
                                                    net_from_jax,
                                                    net_to_jax)

torch.set_num_threads(2)


def variables(jm, x, seed=1, **kw):
    """The module's flax variables at init, each leaf moved by a numpy
    draw (zero leaves get small ones: DCN's offset convs)."""
    v = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(x), train=False, **kw))
    rng = np.random.RandomState(seed)

    def leaf(a):
        if a.ndim == 0:
            return np.asarray(a + 0.05 * rng.randn(), np.float32)
        out = a * (1 + 0.3 * rng.randn(*a.shape))
        if a.ndim == 1 or not np.any(a):
            out = out + 0.02 * rng.randn(*a.shape)
        return out.astype(np.float32)

    out = {"params": jax.tree.map(leaf, v["params"])}
    if "batch_stats" in v:
        out["batch_stats"] = jax.tree.map(
            lambda a: (np.abs(a) + 0.5 + 0.1 * rng.rand(*a.shape)).astype(
                np.float32), v["batch_stats"])
    return out


def carry(v, pm, flax_named=True):
    """The flax variables into the port's net, and back bit for bit."""
    frm, to = (net_from_jax, net_to_jax) if flax_named else \
        (g_from_jax, g_to_jax)
    pm.load_state_dict(frm(v["params"], v.get("batch_stats"), pm),
                       strict=True)
    params, _ = to(pm.state_dict(), pm)
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(v["params"])
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(v["params"])):
        np.testing.assert_array_equal(a, b)
    return pm.eval()


def close(got, want, tol=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy() if hasattr(got, "detach") else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=tol * max(np.abs(want).max(), 1e-3))


def _clip(b=2, n=3, px=16, seed=0):
    return np.random.RandomState(seed).rand(b, n, px, px, 3).astype(
        np.float32)


@pytest.mark.parametrize("sr_net,scale,n", [("rrdb", 4, 3), ("rrdb", 2, 5),
                                            ("sofvsr", 4, 3),
                                            ("sofvsr", 2, 3)])
def test_forward_matches_jax(sr_net, scale, n):
    kw = dict(scale=scale, n_frames=n, channels=32, sr_net=sr_net,
              sr_nf=16, sr_nb=1, sr_gc=8, sr_gaussian_noise=False)
    jm, x = JS.SOFVSR(**kw), _clip(n=n)
    v = variables(jm, x)
    pm = carry(v, PS.SOFVSR(**kw))
    want = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    for level in range(3):
        assert len(got[level]) == n - 1
        for g, w in zip(got[level], want[level]):
            close(g, w)
    close(got[3], want[3])
    assert got[3].shape == (2, 16 * scale, 16 * scale, 3)


def test_channel_shuffle_and_resb_match_jax():
    x = np.random.RandomState(3).randn(2, 5, 6, 8).astype(np.float32)
    np.testing.assert_array_equal(
        PS.channel_shuffle(torch.from_numpy(x), 2).numpy(),
        np.asarray(JS.channel_shuffle(jnp.asarray(x), 2)))
    jm = JS.ResB(8)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    pm = PS.ResB(8)
    for name in ("c1", "dw", "c2"):
        k = v["params"][name]["kernel"]
        getattr(pm, name).weight.data = torch.from_numpy(
            np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    with torch.no_grad():
        close(pm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)))


def test_define_g_builds_the_template_net():
    """``network_G`` of ``train_video.yml``: SOF-VSR, channels 320, the RRDB
    tail nf 64, nb 23 with 99 input channels (3 (4² 2 + 1)), latent noise
    on, as the JAX ``_build_sofvsr`` makes it."""
    opt = parse_dict({"name": "t", "model": "vsr", "scale": 4,
                      "network_G": {"type": "sofvsr_net", "n_frames": 3,
                                    "channels": 320, "SR_net": "rrdb",
                                    "sr_nf": 64, "sr_nb": 23},
                      "datasets": {}, "path": {"root": "/tmp"}},
                     is_train=True)
    net = define_G(opt)
    assert isinstance(net.SR, RRDBNet)
    assert net.SR.conv_first.weight.shape == (64, 99, 3, 3)
    assert len(net.SR.RRDB_trunk) == 23
    assert net.OFR.rnn1_conv.weight.shape == (320, 8, 3, 3)
    blocks = [m for m in net.modules() if type(m).__name__ ==
              "ResidualDenseBlock5C"]
    assert len(blocks) == 69 and all(b.fast and b.noise is not None
                                     for b in blocks)
