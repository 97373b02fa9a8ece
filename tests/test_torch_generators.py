"""The port's SR generators against the JAX package's on the CPU, at small
widths: ``MRRDBNet``, ``SRResNet`` (no norm, and batch norm in NAC with
PReLU), ``RRDBNet`` with ``plus``, with instance norm, with NAC and with
PartialConv2D. Weights drawn by the flax modules (redrawn at unit gain)
and carried by ``g_from_jax``; the trees carried back by ``g_to_jax`` bit
for bit; the SRResNet ``.pth`` route. Tolerances: forward 1e-5 (outputs
of size ~1), gradients 1e-4 of each tensor's largest (at least 1 % of
G's largest: a conv bias before a batch norm has a gradient that is 0 but
for rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.models.rrdb import MRRDBNet as JaxMRRDBNet
from trainner_tpu.models.rrdb import RRDBNet as JaxRRDBNet
from trainner_tpu.models.srresnet import SRResNet as JaxSRResNet
from trainner_tpu.utils.torch_interop import \
    srresnet_to_params as jax_srresnet_to_params
from trainner_tpu_torch.models.networks import define_G
from trainner_tpu_torch.models.rrdb import MRRDBNet, RRDBNet
from trainner_tpu_torch.models.srresnet import SRResNet
from trainner_tpu_torch.ops import rdb5c
from trainner_tpu_torch.ops.blocks import commit_stats
from trainner_tpu_torch.utils.checkpoint import load_params
from trainner_tpu_torch.utils.torch_interop import (g_from_jax, g_to_jax,
                                                    params_from_jax,
                                                    params_to_jax)

torch.set_num_threads(2)
RNG = jax.random.PRNGKey(0)


def _x(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _redraw(tree, seed=6):
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            out = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name in ("scale", "var"):
            out = 1 + 0.2 * rng.rand(*leaf.shape)
        elif name == "negative_slope":
            out = 0.25 + 0.05 * rng.randn()
        else:
            out = 0.05 * rng.randn(*leaf.shape)
        return np.asarray(out, np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _pair(jnet, tnet, x):
    v = jnet.init({"params": RNG, "noise": RNG}, jnp.asarray(x), train=False)
    v = {k: _redraw(jax.tree.map(np.asarray, t)) for k, t in v.items()}
    tnet.load_state_dict(g_from_jax(v["params"], v.get("batch_stats"),
                                    tnet), strict=True)
    return v


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _compare(jnet, tnet, x, train=False):
    """Forward (and, in train mode, each parameter's gradient of a random
    projection of the output) of both nets on ``x``."""
    v = _pair(jnet, tnet, x)
    # the carried weights go back to the same flax trees, bit for bit
    params, stats = g_to_jax(tnet.state_dict(), tnet)
    want_p = _leaves(v["params"])
    got_p = _leaves(params)
    assert set(got_p) == set(want_p)
    for k, leaf in want_p.items():
        np.testing.assert_array_equal(got_p[k], leaf)
    assert _leaves(stats).keys() == _leaves(v.get("batch_stats", {})).keys()

    out_shape = jnet.apply(v, jnp.asarray(x), train=False).shape
    g = _x(out_shape, seed=9) - 0.5

    def jloss(p):
        out = jnet.apply({**v, "params": p}, jnp.asarray(x), train=train,
                         rngs={"noise": RNG}, mutable=["batch_stats"])[0]
        return jnp.sum(out * g), out

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    tnet.train(train)
    out = tnet(torch.from_numpy(x))
    assert out.shape == want.shape and out.dtype == torch.float32
    err = np.abs(out.detach().numpy() - np.asarray(want)).max()
    assert err < 1e-5, err
    if not train:
        return tnet
    (out * torch.from_numpy(g)).sum().backward()
    got_g = _leaves(g_to_jax({k: p.grad for k, p in
                              tnet.named_parameters()}, tnet)[0])
    want_g = _leaves(jax.tree.map(np.asarray, jgrads))
    top = max(np.abs(leaf).max() for leaf in want_g.values())
    for k, leaf in want_g.items():
        scale = max(np.abs(leaf).max(), 1e-2 * top)
        assert np.abs(got_g[k] - leaf).max() <= 1e-4 * scale, k
    return tnet


@pytest.mark.parametrize("upscale", [4, 3])
def test_mrrdbnet_matches_jax(upscale):
    """Real-ESRGAN's layout behind an unshuffle by 2 (in_nc 12), narrow;
    its blocks run the kernels' route (plain versions on the CPU)."""
    cfg = dict(in_nc=12, nf=16, nb=2, gc=8, upscale=upscale)
    tnet = MRRDBNet(**cfg)
    assert all(m.fast for m in tnet.modules()
               if type(m).__name__ == "ResidualDenseBlock5C")
    before = rdb5c.launches
    _compare(JaxMRRDBNet(**cfg), tnet, _x((2, 6, 5, 12)), train=True)
    assert rdb5c.launches == before  # the CPU runs the plain versions


def test_mrrdbnet_state_dict_has_the_jax_names():
    tnet = MRRDBNet(in_nc=12, nf=16, nb=1, gc=8, upscale=4)
    params, _ = g_to_jax(tnet.state_dict(), tnet)
    assert set(params) == {"conv_first", "RRDB0", "trunk_conv", "upconv1",
                           "upconv2", "HRconv", "conv_last"}


@pytest.mark.parametrize("cfg", [
    dict(norm_type=None, act_type="relu", mode="CNA",
         upsample_mode="pixelshuffle"),
    dict(norm_type="batch", act_type="prelu", mode="NAC",
         upsample_mode="pixelshuffle"),
    dict(norm_type="batch", act_type="relu", mode="CNA",
         upsample_mode="upconv", res_scale=0.5, final_act="tanh"),
], ids=["plain", "batch-NAC-prelu", "batch-upconv"])
def test_srresnet_matches_jax(cfg):
    jcfg = dict(cfg)
    if "final_act" in jcfg:
        jcfg["final_act"] = jcfg.pop("final_act")
    jnet = JaxSRResNet(nf=16, nb=2, upscale=4, **jcfg)
    tnet = SRResNet(nf=16, nb=2, upscale=4, **cfg)
    _compare(jnet, tnet, _x((2, 6, 7, 3), seed=1), train=True)


def test_srresnet_batch_norm_statistics_match_jax():
    """A train-mode pass of a G with batch norms: the running statistics
    flax's pass returns are what ``commit_stats`` writes."""
    jnet = JaxSRResNet(nf=16, nb=2, upscale=2, norm_type="batch",
                       mode="CNA", act_type="relu")
    tnet = SRResNet(nf=16, nb=2, upscale=2, norm_type="batch", mode="CNA",
                    act_type="relu")
    x = _x((3, 5, 6, 3), seed=2)
    v = _pair(jnet, tnet, x)
    _, upd = jnet.apply(v, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
    tnet.train()(torch.from_numpy(x))
    commit_stats(tnet)
    _, stats = g_to_jax(tnet.state_dict(), tnet)
    want = _leaves(jax.tree.map(np.asarray, upd["batch_stats"]))
    got = _leaves(stats)
    assert got.keys() == want.keys() and len(want) == 2 * 5
    for k, leaf in want.items():
        np.testing.assert_allclose(got[k], leaf, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("opts", [
    dict(plus=True), dict(norm_type="instance"),
    dict(mode="NAC", act_type="relu"), dict(convtype="PartialConv2D"),
    dict(norm_type="layer", mode="CNAC", act_type="swish"),
], ids=["plus", "instance", "NAC", "partial", "layer-CNAC-swish"])
def test_rrdbnet_composite_blocks_match_jax(opts):
    """RRDBNet whose blocks fail the JAX fast-path predicate: they run the
    composite chain (no kernel launch), as the JAX package runs them
    outside Pallas."""
    cfg = dict(nf=16, nb=2, nr=2, gc=8, upscale=2, gaussian_noise=False)
    tnet = RRDBNet(**cfg, **opts)
    assert not any(m.fast for m in tnet.modules()
                   if type(m).__name__ == "ResidualDenseBlock5C")
    _compare(JaxRRDBNet(**cfg, **opts), tnet, _x((2, 5, 6, 3), seed=3),
             train=True)


@pytest.mark.parametrize("opts", [dict(upscale=4), dict(upscale=2, plus=True)],
                         ids=["x4", "plus-x2"])
def test_key_based_converters_read_the_widths_from_the_tree(opts):
    """``params_from_jax`` / ``params_to_jax`` (no module given) build the
    plain RRDBNet of the tree's widths, depth, upsamplers and ``plus``:
    the weights load strictly, the forward equals JAX's within 1e-5, and
    the state_dict goes back to the same tree bit for bit."""
    cfg = dict(nf=16, nb=2, gc=8, gaussian_noise=False, **opts)
    x = _x((1, 6, 5, 3), seed=4)
    jnet = JaxRRDBNet(**cfg)
    v = jnet.init({"params": RNG, "noise": RNG}, jnp.asarray(x), train=False)
    params = _redraw(jax.tree.map(np.asarray, v["params"]))
    tnet = RRDBNet(**cfg)
    sd = params_from_jax({"params": params})
    tnet.load_state_dict(sd, strict=True)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x),
                                 train=False))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() < 1e-5
    back = _leaves(params_to_jax(tnet.state_dict()))
    want_p = _leaves(params)
    assert back.keys() == want_p.keys()
    for k, leaf in want_p.items():
        np.testing.assert_array_equal(back[k], leaf)


def test_key_based_converter_refuses_a_leaf_the_net_lacks():
    """A flax tree with a leaf that the plain RRDBNet has no tensor for
    (a norm's scale) raises instead of being dropped."""
    cfg = dict(nf=16, nb=1, gc=8, upscale=2, gaussian_noise=False)
    v = JaxRRDBNet(**cfg).init({"params": RNG, "noise": RNG},
                               jnp.zeros((1, 4, 4, 3)), train=False)
    params = jax.tree.map(np.asarray, v["params"])
    params["LR_conv"]["LayerNorm_0"] = {"scale": np.ones(16, np.float32)}
    with pytest.raises(ValueError, match="LR_conv/LayerNorm_0/scale"):
        params_from_jax(params)


@pytest.mark.parametrize("act,fast", [("leakyrelu", True), ("lrelu", True),
                                      ("relu", False),
                                      ("LeakyReLU", False)])
def test_block_route_follows_the_jax_predicate(act, fast):
    """The kernels' route exactly where the JAX block takes its fast path
    (its predicate reads ``act_type`` as given)."""
    net = define_G({"network_G": {"type": "rrdb_net", "nf": 16, "nb": 1,
                                  "gc": 8, "act_type": act,
                                  "upscale": 2}})
    blocks = [m for m in net.modules()
              if type(m).__name__ == "ResidualDenseBlock5C"]
    assert len(blocks) == 3 and all(b.fast == fast for b in blocks)


def test_define_g_builds_the_zoo_and_ignores_pass_through_keys():
    base = {"nf": 16, "nb": 1, "gc": 8, "upscale": 4, "group": 1,
            "strict": False}
    assert isinstance(define_G({"network_G": {"type": "mrrdb_net",
                                              **base}}), MRRDBNet)
    assert isinstance(define_G({"network_G": {"type": "sr_resnet",
                                              **base}}), SRResNet)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A 10.5"):
        define_G({"network_G": {"type": "rrdb_net", "convtype": "Conv3D",
                                **base}})


def _srresnet_pth(params, nb):
    """The reference Sequential ``.pth`` layout of a norm-free SRResNet
    with two pixel-shuffle ups, from a flax tree."""
    sd = {}

    def put(prefix, node):
        sd[prefix + "weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(node["kernel"]).transpose(3, 2, 0, 1)))
        sd[prefix + "bias"] = torch.from_numpy(np.asarray(node["bias"]))

    put("model.0.", params["fea_conv"]["Conv_0"])
    for i in range(nb):
        put(f"model.1.sub.{i}.res.0.", params[f"res{i}"]["conv0"]["Conv_0"])
        put(f"model.1.sub.{i}.res.2.", params[f"res{i}"]["conv1"]["Conv_0"])
    put(f"model.1.sub.{nb}.", params["LR_conv"]["Conv_0"])
    put("model.2.0.", params["up0"]["ConvBlock_0"]["Conv_0"])
    put("model.3.0.", params["up1"]["ConvBlock_0"]["Conv_0"])
    put("model.4.", params["HR_conv0"]["Conv_0"])
    put("model.6.", params["HR_conv1"]["Conv_0"])
    return sd


def test_srresnet_pth_route_matches_jax(tmp_path):
    """A reference SRResNet ``.pth`` -> the port's G, as the JAX
    ``srresnet_to_params`` maps it; the same output."""
    jnet = JaxSRResNet(nf=16, nb=2, upscale=4, norm_type=None, mode="CNA")
    tnet = SRResNet(nf=16, nb=2, upscale=4, norm_type=None, mode="CNA")
    x = _x((1, 6, 6, 3), seed=4)
    v = _pair(jnet, tnet, x)
    sd = _srresnet_pth(v["params"], 2)
    path = tmp_path / "srresnet.pth"
    torch.save(sd, str(path))
    want_tree = jax_srresnet_to_params({k: t.numpy() for k, t in sd.items()})
    fresh = SRResNet(nf=16, nb=2, upscale=4, norm_type=None, mode="CNA")
    fresh.load_state_dict(load_params(str(path), fresh), strict=True)
    got = _leaves(g_to_jax(fresh.state_dict(), fresh)[0])
    for k, leaf in _leaves(want_tree).items():
        np.testing.assert_array_equal(got[k], leaf)
    want = jnet.apply({"params": want_tree}, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = fresh.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(out - np.asarray(want)).max() < 1e-5
