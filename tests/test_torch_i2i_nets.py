"""The image-to-image nets of the port against the JAX package's on the
CPU: ``TorchDeconv`` (``ops/blocks.py``), ``ResnetGenerator``
(``models/resnet_g.py``), ``UnetGenerator`` (``models/unet.py``) and the
PatchGAN, multiscale and pixel discriminators
(``models/discriminators.py``), at narrow widths (ngf/ndf 8, 2 ResNet
blocks, U-Net num_downs 5) on 32 px inputs in [-1, 1] (64 px for the
multiscale D's three scales). The same flax weights (the init, each
kernel scaled by a draw near 1, small biases, from a numpy seed) go into
both: every forward in f32 within 1e-5, in eval and in train mode (batch
statistics), for every norm, padding, upsample mode and ``patch``
setting; the weights go to flax and back bit for bit. ``define_G`` and
``define_D`` build them from the parsed options as the JAX package does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.models import discriminators as JD
from trainner_tpu.models import resnet_g as JR
from trainner_tpu.models import unet as JU
from trainner_tpu.ops.blocks import TorchDeconv as JaxDeconv
from trainner_tpu.options.defaults import \
    get_network_G_config as jax_g_config
from trainner_tpu_torch.models import discriminators as PD
from trainner_tpu_torch.models import resnet_g as PR
from trainner_tpu_torch.models import unet as PU
from trainner_tpu_torch.models.networks import define_D, define_G
from trainner_tpu_torch.ops.blocks import TorchDeconv
from trainner_tpu_torch.options.config import parse_dict
from trainner_tpu_torch.options.defaults import get_network_G_config
from trainner_tpu_torch.utils.torch_interop import net_from_jax, net_to_jax

torch.set_num_threads(2)


def _x(px=32, seed=0, c=3):
    return (np.random.RandomState(seed).rand(2, px, px, c) * 2 - 1) \
        .astype(np.float32)


def _variables(jm, x, seed=1):
    """The module's flax variables at init, kernels and scales times a
    draw near 1, vectors plus small offsets, running statistics moved off
    their init."""
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x), train=False))
    rng = np.random.RandomState(seed)

    def leaf(a):
        if a.ndim == 0:
            return a
        out = a * (1 + 0.3 * rng.randn(*a.shape))
        if a.ndim == 1:
            out = out + 0.02 * rng.randn(*a.shape)
        return out.astype(np.float32)

    v = {"params": jax.tree.map(leaf, v["params"]),
         **{k: w for k, w in v.items() if k != "params"}}
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree.map(
            lambda a: (np.abs(a) + 0.5 + 0.1 * rng.rand(*a.shape)).astype(
                np.float32) if a.ndim == 1 else a, v["batch_stats"])
    return v


def check_net(jm, pm, x, tol=1e-5, train_modes=(False, True), call=None):
    """Weights both ways bit for bit, then the forwards in each mode."""
    v = _variables(jm, x)
    pm.load_state_dict(net_from_jax(v["params"], v.get("batch_stats"), pm),
                       strict=True)
    params, stats = net_to_jax(pm.state_dict(), pm)
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(v["params"])
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(params),
        jax.tree_util.tree_leaves(v["params"])))
    for a, b in zip(jax.tree_util.tree_leaves(stats),
                    jax.tree_util.tree_leaves(v.get("batch_stats", {}))):
        assert np.array_equal(a, b)
    for train in train_modes:
        want = jm.apply(v, jnp.asarray(x), train=train,
                        mutable=["batch_stats"] if train else False)
        if train:
            want = want[0]
        with torch.no_grad():
            got = call(pm, x, train) if call else pm(torch.from_numpy(x),
                                                     train=train)
        wants = jax.tree_util.tree_leaves(want)
        gots = got if isinstance(got, (list, tuple)) else [got]
        assert len(wants) == len(gots)
        for w, g in zip(wants, gots):
            assert g.dtype == torch.float32 and g.shape == w.shape
            err = np.abs(g.numpy() - np.asarray(w)).max()
            assert err < tol, (train, err)


def _g_call(pm, x, train):
    pm.train(train)
    return pm(torch.from_numpy(x))


@pytest.mark.parametrize("k, s, p, op", [(3, 2, 1, 1), (4, 2, 1, 0)])
def test_torch_deconv_maps_the_kernel_by_a_permute_only(k, s, p, op):
    """The flax kernel (kh, kw, in, out) is torch's (in, out, kh, kw)
    weight permuted: with it ``conv_transpose2d`` gives the JAX module's
    output; permuted and flipped, it does not."""
    x = _x(8, 3, c=5)
    jm = JaxDeconv(6, k, s, p, op)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2),
                                         jnp.asarray(x)))
    v = {"params": {"kernel": v["params"]["kernel"],
                    "bias": np.random.RandomState(1).randn(6).astype(
                        np.float32)}}
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    pm = TorchDeconv(5, 6, k, s, p, op)
    paths = {"weight": ("params", ("kernel",), "deconv"),
             "bias": ("params", ("bias",), "vec")}
    pm.flax_paths = lambda: paths
    sd = net_from_jax(v["params"], None, pm)
    assert torch.equal(sd["weight"], torch.from_numpy(
        v["params"]["kernel"].transpose(2, 3, 0, 1).copy()))
    pm.load_state_dict(sd)
    got = pm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert np.abs(got.detach().numpy() - want).max() < 1e-5
    back = net_to_jax(pm.state_dict(), pm)[0]
    assert np.array_equal(back["kernel"], v["params"]["kernel"])
    with torch.no_grad():
        pm.weight.copy_(pm.weight.flip(2, 3))
    flipped = pm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert np.abs(flipped.detach().numpy() - want).max() > 1e-2


@pytest.mark.parametrize("norm", ["instance", "batch"])
@pytest.mark.parametrize("pad", ["reflect", "replicate", "zero"])
@pytest.mark.parametrize("up", ["deconv", "upconv"])
def test_resnet_generator_matches_jax(norm, pad, up):
    kw = dict(ngf=8, n_blocks=2, norm_type=norm, padding_type=pad,
              upsample_mode=up, use_dropout=True)
    check_net(JR.ResnetGenerator(**kw), PR.ResnetGenerator(**kw), _x(),
              call=_g_call, train_modes=(False,))


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_resnet_generator_in_train_mode_matches_jax(norm):
    """Train mode without dropout: the batch statistics of the pass."""
    kw = dict(ngf=8, n_blocks=2, norm_type=norm)
    check_net(JR.ResnetGenerator(**kw), PR.ResnetGenerator(**kw), _x(),
              call=_g_call, train_modes=(True,))


@pytest.mark.parametrize("norm", ["instance", "batch"])
@pytest.mark.parametrize("up", ["deconv", "upconv"])
def test_unet_generator_matches_jax(norm, up):
    """Eval mode with dropout on its levels (off at eval), and train mode
    without it."""
    kw = dict(num_downs=5, ngf=8, norm_type=norm, upsample_mode=up)
    check_net(JU.UnetGenerator(use_dropout=True, **kw),
              PU.UnetGenerator(use_dropout=True, **kw), _x(), call=_g_call,
              train_modes=(False,))
    check_net(JU.UnetGenerator(**kw), PU.UnetGenerator(**kw), _x(),
              call=_g_call, train_modes=(True,))


def test_unet_skips_are_lrelu_and_dropout_sits_on_the_8ngf_levels():
    """The skip that reaches the decoder is lrelu(x, 0.2) of the encoder's
    output (``unet.py:115-120``), and dropout follows only the ups of the
    8 ngf levels that are neither innermost nor outermost."""
    net = PU.UnetGenerator(num_downs=7, ngf=4, use_dropout=True)
    assert sorted(net.dropouts) == ["3", "4", "5"]
    assert sorted(PU.UnetGenerator(num_downs=5, ngf=4,
                                   use_dropout=True).dropouts) == ["3"]
    seen = []
    net.down0.register_forward_hook(lambda m, a, o: seen.append(o))
    net.up1.register_forward_hook(lambda m, a, o: seen.append(o))
    cat = []
    orig = torch.cat

    def spy(ts, dim=0):
        cat.append(ts[0])
        return orig(ts, dim=dim)

    torch.cat = spy
    try:
        net.eval()(torch.from_numpy(_x(128)))
    finally:
        torch.cat = orig
    assert torch.equal(cat[-1], torch.nn.functional.leaky_relu(seen[0],
                                                               0.2))


@pytest.mark.parametrize("norm", ["batch", "instance"])
@pytest.mark.parametrize("patch", [True, False])
@pytest.mark.parametrize("sn", [False, True])
def test_nlayer_discriminator_matches_jax(norm, patch, sn):
    kw = dict(ndf=8, n_layers=3, norm_type=norm, patch=patch,
              use_spectral_norm=sn, use_sigmoid=True)
    check_net(JD.NLayerDiscriminator(**kw), PD.NLayerDiscriminator(**kw),
              _x())


def test_nlayer_feature_maps_match_jax():
    kw = dict(ndf=8, n_layers=2)
    jm, pm = JD.NLayerDiscriminator(**kw), PD.NLayerDiscriminator(**kw)
    x = _x()
    v = _variables(jm, x)
    pm.load_state_dict(net_from_jax(v["params"], v["batch_stats"], pm))
    out, feats = jm.apply(v, jnp.asarray(x), train=False, return_feats=True)
    got, gfeats = pm(torch.from_numpy(x), train=False, return_feats=True)
    assert len(feats) == len(gfeats) == 3
    for a, b in zip(feats + [out], gfeats + [got]):
        assert np.abs(b.detach().numpy() - np.asarray(a)).max() < 1e-5


def test_multiscale_discriminator_matches_jax():
    """Three PatchGANs named scale2..scale0, finest first, each scale a 3x3
    stride-2 average pool (padding counted out) of the last."""
    kw = dict(ndf=8, n_layers=2, num_D=3)
    pm = PD.MultiscaleDiscriminator(**kw)
    assert [n for n, _ in pm.named_children()] == ["scale2", "scale1",
                                                   "scale0"]
    check_net(JD.MultiscaleDiscriminator(**kw), pm, _x(64))


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_pixel_discriminator_matches_jax(norm):
    pm = PD.PixelDiscriminator(ndf=8, norm_type=norm)
    assert pm.conv0.bias is not None and pm.conv2.bias is None
    check_net(JD.PixelDiscriminator(ndf=8, norm_type=norm), pm, _x())


@pytest.mark.parametrize("kind", ["unet_128", "unet_256", "resnet_6blocks",
                                  "resnet_9blocks", "unet_net",
                                  "resnet_net"])
def test_generator_presets_parse_as_in_jax(kind):
    got = get_network_G_config({"type": kind, "in_nc": 3}, 1)
    want = jax_g_config({"type": kind, "in_nc": 3}, 1)
    assert got == want
    net = define_G({"network_G": got})
    assert isinstance(net, PU.UnetGenerator if kind.startswith("unet")
                      else PR.ResnetGenerator)


@pytest.mark.parametrize("cfg, cls, in_nc", [
    ({"type": "patchgan", "nf": 8, "nlayer": 2}, PD.NLayerDiscriminator, 3),
    ({"type": "nlayerdiscriminator", "ndf": 8}, PD.NLayerDiscriminator, 6),
    ({"type": "multiscale", "ndf": 8, "num_D": 2},
     PD.MultiscaleDiscriminator, 3),
    ({"type": "pixelgan", "ndf": 8}, PD.PixelDiscriminator, 6),
    ({"type": "pixeldiscriminator", "ndf": 8, "norm_type": "instance"},
     PD.PixelDiscriminator, 3),
])
def test_define_d_builds_the_i2i_discriminators(cfg, cls, in_nc):
    """From the parsed options (their key aliases), with the input's
    channels from the caller where given."""
    opt = dict(parse_dict({"name": "d", "model": "pix2pix", "scale": 1,
                           "network_G": {"type": "unet_net"},
                           "network_D": cfg, "path": {"root": "/tmp/d"}},
                          is_train=False))
    net = define_D(opt, dtype=torch.float32,
                   in_nc=in_nc if in_nc != 3 else None)
    assert isinstance(net, cls)
    first = next(m for m in net.modules() if hasattr(m, "weight")
                 and m.weight.dim() == 4)
    assert first.weight.shape[1] == in_nc


@pytest.mark.parametrize("mode", ["reflect", "replicate"])
@pytest.mark.parametrize("p", [1, 3])
def test_edge_pad_is_f_pad_with_a_fixed_order_backward(mode, p):
    """``models/resnet_g.py::pad``: ``F.pad``'s forward bit for bit, and a
    backward (added in a fixed order, where ``F.pad``'s adds with atomics
    on the card) that ``gradcheck`` holds in f64 and that agrees with
    ``F.pad``'s in f32."""
    x = torch.randn(2, 3, 9, 7, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(p))
    assert torch.autograd.gradcheck(lambda t: PR.pad(t, p, mode),
                                    (x.clone().requires_grad_(),))
    a, b = x.float().requires_grad_(), x.float().requires_grad_()
    g = torch.randn(2, 3, 9 + 2 * p, 7 + 2 * p)
    out = PR.pad(a, p, mode)
    want = torch.nn.functional.pad(b, (p,) * 4, mode=mode)
    assert torch.equal(out, want)
    out.backward(g)
    want.backward(g)
    assert torch.allclose(a.grad, b.grad, atol=1e-6)
