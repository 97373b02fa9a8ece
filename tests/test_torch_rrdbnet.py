"""The port's generator blocks, its ``RRDBNet`` and its weight loaders
against the JAX package, at small widths on the CPU. Inputs come from numpy
seeds; weights are drawn by the JAX modules and carried across with
``params_from_jax`` (torch and JAX random draws cannot match)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from trainner_tpu.models.rrdb import RRDBNet as JaxRRDBNet
from trainner_tpu.ops import blocks as jb
from trainner_tpu.utils.checkpoint import save_params
from trainner_tpu.utils.torch_interop import params_to_esrgan
from trainner_tpu_torch.models.rrdb import RRDBNet
from trainner_tpu_torch.ops import blocks as tb
from trainner_tpu_torch.utils.checkpoint import load_params, msgpack_restore
from trainner_tpu_torch.utils.torch_interop import (hwio_to_oihw,
                                                    params_from_jax)

RNG = jax.random.PRNGKey(0)


def _x(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _load_conv(mod, conv_params):
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(hwio_to_oihw(
            np.asarray(conv_params["kernel"]))))
        mod.bias.copy_(torch.from_numpy(np.array(conv_params["bias"])))


def _jax_params(module, x):
    v = module.init({"params": RNG, "noise": RNG}, jnp.asarray(x),
                    train=False)
    return v, jax.tree.map(np.asarray, v["params"])


@pytest.mark.parametrize("act_type", [None, "leakyrelu", "relu"])
def test_conv_block_matches_jax(act_type):
    x = _x((2, 7, 5, 6))
    jm = jb.ConvBlock(10, 3, act_type=act_type,
                      kernel_init=jb.kaiming_init(1.0))
    v, p = _jax_params(jm, x)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    tm = tb.ConvBlock(6, 10, 3, act_type=act_type)
    _load_conv(tm, p["Conv_0"])
    got = _nhwc(tm(_nchw(x)))
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("upscale", [2, 3])
def test_upconv_block_eval_form_matches_jax(upscale):
    """At 2x the port runs the LR-space form that the JAX module runs at
    train=False: one LR conv with 4x the channels, then a pixel shuffle,
    which depends on depth_to_space's (c_out, r, r) channel order."""
    x = _x((2, 6, 9, 8), seed=1)
    jm = jb.UpconvBlock(5, upscale=upscale, act_type="leakyrelu",
                        kernel_init=jb.kaiming_init(1.0))
    v, p = _jax_params(jm, x)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    tm = tb.UpconvBlock(8, 5, upscale=upscale, act_type="leakyrelu")
    _load_conv(tm, p["ConvBlock_0"]["Conv_0"])
    got = _nhwc(tm(_nchw(x)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5


def test_upconv_lr_form_equals_nearest_then_conv():
    """The LR-space weights reproduce nearest-2x then the 3x3 conv."""
    torch.manual_seed(0)
    w, b = torch.randn(4, 3, 3, 3), torch.randn(4)
    x = torch.randn(1, 3, 5, 7)
    wp, bp = tb.upconv_lr_weights(w, b)
    fast = torch.nn.functional.pixel_shuffle(
        torch.nn.functional.conv2d(x, wp, bp, padding=1), 2)
    up = x.repeat_interleave(2, 2).repeat_interleave(2, 3)
    slow = torch.nn.functional.conv2d(up, w, b, padding=1)
    assert (fast - slow).abs().max() < 1e-5


def test_pixel_shuffle_block_matches_jax():
    x = _x((1, 5, 6, 8), seed=2)
    jm = jb.PixelShuffleBlock(4, upscale=2, act_type="leakyrelu",
                              kernel_init=jb.kaiming_init(1.0))
    v, p = _jax_params(jm, x)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    tm = tb.PixelShuffleBlock(8, 4, upscale=2, act_type="leakyrelu")
    _load_conv(tm, p["ConvBlock_0"]["Conv_0"])
    assert np.abs(_nhwc(tm(_nchw(x))) - want).max() < 1e-5


@pytest.mark.parametrize("r", [2, 3])
def test_depth_to_space_and_nearest_up_match_jax(r):
    x = _x((2, 3, 4, 2 * r * r), seed=3)
    np.testing.assert_array_equal(
        tb.depth_to_space(torch.from_numpy(x), r).numpy(),
        np.asarray(jb.depth_to_space(jnp.asarray(x), r)))
    np.testing.assert_array_equal(
        tb.nearest_up(torch.from_numpy(x), r).numpy(),
        np.asarray(jb.nearest_up(jnp.asarray(x), r)))


@pytest.mark.parametrize("mode", ["tanh", "sigmoid", "clamp", "scaltanh",
                                  None])
def test_finalact_matches_jax(mode):
    x = (_x((3, 4), seed=4) - 0.5) * 4
    np.testing.assert_allclose(
        tb.finalact(mode)(torch.from_numpy(x)).numpy(),
        np.asarray(jb.finalact(mode)(jnp.asarray(x))), atol=1e-6)


def _redraw(params, seed=6):
    """Weights of unit gain, drawn with numpy: the modules' own init
    (Kaiming times 0.1) leaves G's output near 1e-4, too small to test."""
    rng = np.random.RandomState(seed)

    def draw(leaf):
        if leaf.ndim == 4:
            return (rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:3]))
                    ).astype(np.float32)
        return (rng.randn(*leaf.shape) * 0.05).astype(np.float32)

    return jax.tree.map(draw, params)


def _small_nets(upscale=4, upsample_mode="upconv", lr=(1, 6, 9, 3)):
    cfg = dict(nf=16, nb=2, nr=3, gc=8, upscale=upscale,
               upsample_mode=upsample_mode)
    jnet = JaxRRDBNet(**cfg, gaussian_noise=True, dtype=jnp.float32)
    x = _x(lr, seed=5)
    v, p = _jax_params(jnet, x)
    p = _redraw(p)
    v = {"params": p}
    tnet = RRDBNet(**cfg, gaussian_noise=True)
    tnet.load_state_dict(params_from_jax(p), strict=True)
    return jnet, v, p, tnet.eval(), x


@pytest.mark.parametrize("upscale,upsample_mode", [(4, "upconv"),
                                                   (4, "pixelshuffle"),
                                                   (3, "upconv")])
def test_rrdbnet_f32_matches_jax(upscale, upsample_mode):
    """Whole G, nf 16, nb 2, gc 8, non-square LR, weights carried across
    by params_from_jax: f32 within 1e-5 (outputs of size ~1 after 6
    residual dense blocks and 4 more convs, summed in another order)."""
    jnet, v, _, tnet, x = _small_nets(upscale, upsample_mode)
    want = np.asarray(jnet.apply(v, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 6 * upscale, 9 * upscale, 3)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() < 1e-5


def test_rrdbnet_bf16_near_jax():
    """bf16 bodies: both round every conv to bf16, but at other places
    (the port's blocks sum in f32), so the bound is loose: 2e-2, about
    two bf16 ulps, on outputs of size ~1."""
    jnet, v, p, _, x = _small_nets()
    jnet = jnet.clone(dtype=jnp.bfloat16)
    want = np.asarray(jnet.apply(v, jnp.asarray(x), train=False))
    tnet = RRDBNet(nf=16, nb=2, nr=3, gc=8, upscale=4, dtype=torch.bfloat16)
    tnet.load_state_dict(params_from_jax(p), strict=True)
    with torch.inference_mode():
        got = tnet.eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() < 2e-2


def test_rdb_packed_weights_follow_weight_changes():
    """Packed stage weights are rebuilt after the conv weights change."""
    _, _, _, tnet, x = _small_nets()
    blk = tnet.RRDB_trunk[0].RDB1
    first = blk.packed(torch.float32)[0][0].clone()
    with torch.no_grad():
        blk.conv1.weight.mul_(2.0)
    again = blk.packed(torch.float32)[0][0]
    assert not torch.equal(first, again)


def test_params_from_jax_names_follow_reference_pth_layout():
    _, _, p, tnet, _ = _small_nets()
    sd = params_from_jax(p)
    assert set(sd) == set(tnet.state_dict())
    assert "RRDB_trunk.1.RDB3.conv5.weight" in sd
    assert sd["conv_first.weight"].shape == (16, 3, 3, 3)
    assert {"upconv1.bias", "upconv2.bias", "HRconv.bias",
            "conv_last.bias"} <= set(sd)


def test_params_from_jax_accepts_scan_layout():
    from trainner_tpu.models.rrdb import stack_rrdb_params

    _, _, p, _, _ = _small_nets()
    stacked = stack_rrdb_params(p)
    assert "RRDBs" in stacked
    a, b = params_from_jax(p), params_from_jax(stacked)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("layout", ["new", "old"])
def test_pth_checkpoint_loads(tmp_path, layout):
    """JAX params -> params_to_esrgan -> torch.save -> the port's
    load_params equals params_from_jax, in both key layouts."""
    _, _, p, tnet, _ = _small_nets()
    sd = params_to_esrgan(p, nb=2)
    if layout == "old":
        old = {}
        for k, val in sd.items():
            head, leaf = k.split(".")[0], k.split(".")[-1]
            if head == "conv_first":
                old[f"model.0.{leaf}"] = val
            elif head == "RRDB_trunk":
                parts = k.split(".")
                old[f"model.1.sub.{parts[1]}.{parts[2]}.{parts[3]}.0."
                    f"{leaf}"] = val
            elif head == "trunk_conv":
                old[f"model.1.sub.2.{leaf}"] = val
            else:
                idx = {"upconv1": 3, "upconv2": 6, "HRconv": 8,
                       "conv_last": 10}[head]
                old[f"model.{idx}.{leaf}"] = val
        sd = old
    path = tmp_path / f"G_{layout}.pth"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)
    got = load_params(str(path))
    want = params_from_jax(p)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    tnet.load_state_dict(got, strict=True)


def test_flax_ckpt_loads(tmp_path):
    """A G checkpoint written by the JAX save_params loads into the port."""
    _, _, p, tnet, _ = _small_nets()
    path = tmp_path / "G.ckpt"
    save_params(p, str(path))
    got = load_params(str(path))
    want = params_from_jax(p)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    tnet.load_state_dict(got, strict=True)


def test_msgpack_decoder_matches_flax(tmp_path):
    """The port's decoder against flax.serialization on a tree that uses
    every msgpack form flax writes: nested maps, str keys, f32/bf16/int
    arrays of several ranks, numpy and Python scalars, strings, bools,
    None and a list."""
    rng = np.random.RandomState(0)
    tree = {
        "a": {"kernel": rng.randn(3, 3, 4, 5).astype(np.float32),
              "bias": rng.randn(5).astype(np.float32)},
        "bf": np.asarray(jnp.asarray(rng.randn(7, 2), jnp.bfloat16)),
        "ints": np.arange(-300, 300, 7, dtype=np.int64).reshape(2, -1),
        "u8": np.arange(256, dtype=np.uint8),
        "scalar": np.float32(2.5), "step": np.int32(-7),
        "big": 2 ** 40, "neg": -(2 ** 20), "small": -5, "f": 0.125,
        "name": "x" * 40, "flag": True, "none": None,
        "empty": {}, "list": [1, 2, "three"],
        "long": {f"k{i}": np.float32(i) for i in range(20)},
    }
    data = serialization.msgpack_serialize(tree)
    want = serialization.msgpack_restore(data)
    got = msgpack_restore(data)

    def same(g, w, path="/"):
        if isinstance(w, dict):
            assert isinstance(g, dict) and set(g) == set(w), path
            for k in w:
                same(g[k], w[k], f"{path}{k}/")
        elif isinstance(w, (list, tuple)):
            assert list(g) == list(w), path
        elif isinstance(w, np.ndarray):
            assert g.shape == w.shape, path
            np.testing.assert_array_equal(np.asarray(g, np.float64),
                                          np.asarray(w, np.float64))
        else:
            assert g == w, path

    same(got, want)
    assert got["bf"].dtype == np.float32


def test_msgpack_decoder_rejects_trailing_bytes():
    data = serialization.msgpack_serialize({"a": np.zeros(2, np.float32)})
    with pytest.raises(ValueError):
        msgpack_restore(data + b"\x00")
