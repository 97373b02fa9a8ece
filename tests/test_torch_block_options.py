"""The port's block options against the JAX package's blocks on the CPU:
``ConvBlock`` over norm x mode x padding x activation (PReLU included),
``space_to_depth``, ``explicit_pad``, the partial conv and the non-nearest
upconv. Inputs from numpy seeds; weights drawn by the flax modules and
carried over by ``g_from_jax``. Tolerances: forward 1e-5, gradients 1e-4
(f32, outputs and gradients of size ~1); bf16 instance norm 2e-2 (two bf16
ulps at ~1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.ops import blocks as jb
from trainner_tpu_torch.ops import blocks as tb
from trainner_tpu_torch.utils.torch_interop import g_from_jax, g_to_jax

torch.set_num_threads(2)
RNG = jax.random.PRNGKey(0)


def _x(shape, seed=0):
    return (np.random.RandomState(seed).rand(*shape).astype(np.float32)
            - 0.5) * 2


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().float().numpy()


def _redraw(tree, seed=3):
    """Unit-gain weights, non-trivial norm scales and slopes, so that
    every leaf shows in the output."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            out = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name in ("scale", "var"):
            out = 1 + 0.2 * rng.rand(*leaf.shape)
        else:
            out = 0.1 * rng.randn(*leaf.shape)
        return np.asarray(out, np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _pair(jm, tm, x, train=False):
    """flax variables for ``jm`` (redrawn) carried into ``tm``."""
    v = jm.init({"params": RNG, "noise": RNG}, jnp.asarray(x), train=False)
    v = {k: _redraw(jax.tree.map(np.asarray, t)) for k, t in v.items()}
    tm.load_state_dict(g_from_jax(v["params"], v.get("batch_stats"), tm),
                       strict=True)
    return v


def _check(jm, tm, x, train):
    v = _pair(jm, tm, x)
    g = _x(jm.apply(v, jnp.asarray(x), train=False,
                    mutable=["batch_stats"])[0].shape, seed=9)

    def jloss(params, xx):
        out = jm.apply({**v, "params": params}, xx, train=train,
                       mutable=["batch_stats"])[0]
        return jnp.sum(out * g), out

    (_, want), (jg_p, jg_x) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    tm.train(train)
    xt = _nchw(x).requires_grad_(True)
    out = tm(xt)
    (out * _nchw(g)).sum().backward()
    assert np.abs(_nhwc(out) - np.asarray(want)).max() < 1e-5
    assert np.abs(_nhwc(xt.grad) - np.asarray(jg_x)).max() < 1e-4
    grads = {k: p.grad for k, p in tm.named_parameters()}
    want_g, _ = jax.tree.map(np.asarray, (jg_p, None))
    got_g, _ = g_to_jax(grads, tm)
    flat_w = jax.tree_util.tree_leaves_with_path(want_g)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got_g))
    assert len(flat_w) == len(flat_g) > 0
    for path, leaf in flat_w:
        assert np.abs(flat_g[path] - leaf).max() < 1e-4, path


@pytest.mark.parametrize("norm", [None, "batch", "instance", "layer"])
@pytest.mark.parametrize("mode", ["CNA", "NAC", "CNAC"])
def test_conv_block_norm_and_mode_match_flax(norm, mode):
    """Every norm in every order, reflect padding and PReLU, train mode
    (batch statistics) for its forward and gradients."""
    x = _x((2, 7, 6, 5))
    jm = jb.ConvBlock(6, 3, pad_type="reflect", norm_type=norm,
                      act_type="prelu", mode=mode)
    tm = tb.ConvBlock(5, 6, 3, act_type="prelu", norm_type=norm, mode=mode,
                      pad_type="reflect")
    _check(jm, tm, x, train=True)


@pytest.mark.parametrize("pad_type", ["zero", "reflect", "replicate",
                                      "edge"])
@pytest.mark.parametrize("act_type", ["leakyrelu", "relu", "prelu",
                                      "swish", None])
def test_conv_block_padding_and_act_match_flax(pad_type, act_type):
    x = _x((2, 6, 7, 4), seed=1)
    jm = jb.ConvBlock(5, 3, pad_type=pad_type, act_type=act_type)
    tm = tb.ConvBlock(4, 5, 3, act_type=act_type, pad_type=pad_type)
    _check(jm, tm, x, train=False)


def test_conv_block_batch_norm_running_stats_match_flax():
    """Eval mode reads the running statistics (batch_stats), and a
    train-mode pass leaves flax's update pending until ``commit_stats``."""
    x = _x((3, 5, 5, 4), seed=2)
    jm = jb.ConvBlock(6, 3, norm_type="batch", act_type="relu")
    tm = tb.ConvBlock(4, 6, 3, act_type="relu", norm_type="batch")
    v = _pair(jm, tm, x)
    _, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm.train()
    tm(_nchw(x))
    before = tm.norm.running_mean.clone()
    tb.commit_stats(tm)
    assert not torch.equal(before, tm.norm.running_mean)
    _, stats = g_to_jax(tm.state_dict(), tm)
    for k in ("mean", "var"):
        np.testing.assert_allclose(
            stats["BatchNorm_0"][k],
            np.asarray(upd["batch_stats"]["BatchNorm_0"][k]), atol=1e-6)
    want = jm.apply({**v, "batch_stats": upd["batch_stats"]},
                    jnp.asarray(x), train=False)
    got = _nhwc(tm.eval()(_nchw(x)))
    assert np.abs(got - np.asarray(want)).max() < 1e-5


@pytest.mark.parametrize("norm", ["instance", "layer", "batch"])
def test_bf16_norm_statistics_in_f32_match_flax(norm):
    """A bf16 input to the norm alone (flax's GroupNorm(C) / LayerNorm /
    BatchNorm with dtype bf16, as ConvBlock builds them): both take the
    statistics in f32 and cast the output to bf16, so they differ by at
    most one bf16 rounding: 2e-2 on outputs of size up to ~3 (bf16's ulp
    there is 1.6e-2)."""
    from flax import linen as nn

    x = _x((2, 8, 8, 6), seed=4) * 3 + 1
    xb = jnp.asarray(x, jnp.bfloat16)
    jm = {"instance": nn.GroupNorm(num_groups=6, epsilon=1e-5,
                                   use_bias=False, use_scale=False,
                                   dtype=jnp.bfloat16),
          "layer": nn.LayerNorm(dtype=jnp.bfloat16),
          "batch": nn.BatchNorm(use_running_average=False,
                                dtype=jnp.bfloat16)}[norm]
    v = jm.init(RNG, xb)
    v = {k: _redraw(jax.tree.map(np.asarray, t)) for k, t in v.items()}
    want = jm.apply(v, xb, mutable=["batch_stats"])[0]
    assert want.dtype == jnp.bfloat16
    tm = tb.norm_layer(norm, 6).train()
    if norm != "instance":
        with torch.no_grad():
            tm.weight.copy_(torch.from_numpy(v["params"]["scale"]))
            tm.bias.copy_(torch.from_numpy(v["params"]["bias"]))
    got = tm(_nchw(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    err = np.abs(_nhwc(got) - np.asarray(want, np.float32)).max()
    assert err < 2e-2


def test_partial_conv_block_matches_flax():
    """PartialConv2D owns its zero padding: the border renormalised by
    k*k over the valid taps."""
    x = _x((2, 6, 5, 4), seed=5)
    jm = jb.ConvBlock(3, 3, act_type="leakyrelu", convtype="PartialConv2D")
    tm = tb.ConvBlock(4, 3, 3, act_type="leakyrelu",
                      convtype="PartialConv2D")
    _check(jm, tm, x, train=False)
    assert set(dict(tm.named_parameters())) == {"weight", "bias"}


def test_partial_conv_with_a_mask_matches_flax():
    from trainner_tpu.ops.partial_conv import PartialConv
    from trainner_tpu_torch.ops.partial_conv import partial_conv

    x = _x((2, 7, 6, 3), seed=6)
    mask = (np.random.RandomState(7).rand(2, 7, 6, 1) > 0.4).astype(
        np.float32)
    jm = PartialConv(5, 3, pad=1, return_mask=True)
    v = jm.init(RNG, jnp.asarray(x), jnp.asarray(mask))
    v = {"params": _redraw(jax.tree.map(np.asarray, v["params"]))}
    want, want_mask = jm.apply(v, jnp.asarray(x), jnp.asarray(mask))
    w = torch.from_numpy(np.ascontiguousarray(
        v["params"]["conv"]["kernel"].transpose(3, 2, 0, 1)))
    got, got_mask = partial_conv(_nchw(x), w,
                                 torch.from_numpy(v["params"]["bias"]),
                                 pad=1, mask=_nchw(mask), return_mask=True)
    assert np.abs(_nhwc(got) - np.asarray(want)).max() < 1e-5
    np.testing.assert_array_equal(_nhwc(got_mask), np.asarray(want_mask))


@pytest.mark.parametrize("mode,upscale", [("bilinear", 2), ("bicubic", 2),
                                          ("bilinear", 3), ("nearest", 1.5)])
def test_upconv_block_other_modes_match_flax(mode, upscale):
    x = _x((2, 6, 5, 4), seed=8)
    jm = jb.UpconvBlock(3, upscale=upscale, act_type="leakyrelu", mode=mode)
    tm = tb.UpconvBlock(4, 3, upscale=upscale, act_type="leakyrelu",
                        mode=mode)
    _check(jm, tm, x, train=True)


@pytest.mark.parametrize("r", [2, 4])
def test_space_to_depth_matches_jax_and_pixel_unshuffle(r):
    x = _x((2, 8, 12, 3), seed=10)
    got = tb.space_to_depth(torch.from_numpy(x), r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jb.space_to_depth(jnp.asarray(x), r)))
    # torch.pixel_unshuffle's (c, by, bx) channel order
    want = torch.pixel_unshuffle(_nchw(x), r).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(tb.depth_to_space(got, r).numpy(), x)


@pytest.mark.parametrize("pad_type", ["zero", "reflect", "replicate",
                                      "edge"])
def test_explicit_pad_matches_jax(pad_type):
    x = _x((2, 5, 6, 3), seed=11)
    got = tb.explicit_pad(_nchw(x), 2, pad_type)
    want = jb.explicit_pad(jnp.asarray(x), 2, pad_type)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


@pytest.mark.parametrize("size,mode", [((12, 10), "nearest"),
                                       ((3, 5), "nearest"),
                                       ((9, 7), "nearest"),
                                       ((11, 13), "bilinear"),
                                       ((12, 10), "bicubic")])
def test_interpolate_matches_jax(size, mode):
    x = _x((2, 6, 5, 3), seed=12)
    got = tb.interpolate(torch.from_numpy(x), size=size, mode=mode)
    want = jb.interpolate(jnp.asarray(x), size=size, mode=mode)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5


def test_prelu_is_one_learned_slope():
    m = tb.act("prelu")
    assert isinstance(m, tb.PReLU) and m.negative_slope.shape == ()
    assert float(m.negative_slope) == 0.25
    x = torch.tensor([-2.0, 0.0, 3.0], requires_grad=True)
    m(x).sum().backward()
    assert torch.equal(m(x).detach(), torch.tensor([-0.5, 0.0, 3.0]))
    assert float(m.negative_slope.grad) == -2.0


def test_discriminator_vgg_nac_matches_flax():
    """D-VGG in the NAC order (each batch norm over its conv's input),
    which ``define_D`` refused before the block modes were ported: train
    mode, f32, within 1e-5 of flax's logits."""
    from trainner_tpu.models.discriminators import DiscriminatorVGG
    from trainner_tpu_torch.models.networks import define_D
    from trainner_tpu_torch.utils.torch_interop import discriminator_from_jax

    x = _x((3, 32, 32, 3), seed=13)
    jm = DiscriminatorVGG(size=32, base_nf=8, mode="NAC")
    v = jm.init(RNG, jnp.asarray(x), train=False)
    v = {k: _redraw(jax.tree.map(np.asarray, t)) for k, t in v.items()}
    want, _ = jm.apply(v, jnp.asarray(x), train=True,
                       mutable=["batch_stats"])
    tm = define_D({"network_D": {"type": "discriminator_vgg", "size": 32,
                                 "base_nf": 8, "mode": "NAC"}},
                  dtype=torch.float32)
    tm.load_state_dict(discriminator_from_jax(v["params"],
                                              v["batch_stats"]), strict=True)
    got = tm(torch.from_numpy(x), train=True)
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() < 1e-5
