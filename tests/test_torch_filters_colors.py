"""``trainner_tpu_torch/ops/filters.py`` and ``ops/colors.py`` in full
against the JAX package's ``ops/filters.py`` and ``ops/colors.py``, on the
CPU in f32. The kernel builders are numpy on both sides and must be equal
bit for bit; the filters are convolutions that the two frameworks add in
other orders (1e-6 absolute); the colour conversions are the same
elementwise formulas (1e-6 absolute)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.ops import colors as JC
from trainner_tpu.ops import filters as JF
from trainner_tpu_torch.ops import colors as C
from trainner_tpu_torch.ops import filters as F

torch.set_num_threads(2)


def _img(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.mark.parametrize("name, args", [
    ("box_kernel", (5,)), ("gaussian_kernel_1d", (7, 1.3)),
    ("gaussian_kernel_2d", (9, 1.5)), ("gaussian_kernel_2d", (9, 1.5, 3.0, 30.0)),
    ("sinc_kernel", (13, 1.2)), ("log_kernel", (5, 0.8)),
    ("laplacian_kernel", (3,)), ("laplacian_kernel", (5,)),
    ("motion_kernel", (9,)), ("motion_kernel", (11, 35.0)),
    ("sobel_kernels", ()), ("scharr_kernels", ()), ("prewitt_kernels", ())])
def test_kernel_builders_equal_jax(name, args):
    got, want = getattr(F, name)(*args), getattr(JF, name)(*args)
    for g, w in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_laplacian_of_another_size_raises():
    with pytest.raises(ValueError):
        F.laplacian_kernel(7)


@pytest.mark.parametrize("pad_mode", ["reflect", "constant", "edge", "wrap"])
@pytest.mark.parametrize("kernel, stride", [
    (JF.sobel_kernels()[0], 1), (JF.gaussian_kernel_2d(5, 1.0), 2),
    (np.arange(12, dtype=np.float32).reshape(3, 4) / 66.0, 1)])
def test_filter2d_matches_jax(pad_mode, kernel, stride):
    x = _img((2, 13, 17, 3), 1)
    want = np.asarray(JF.filter2d(jnp.asarray(x), kernel, pad_mode, stride))
    got = F.filter2d(_t(x), kernel, pad_mode, stride).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6


def test_filter2d_per_sample_matches_jax():
    x = _img((4, 12, 15, 3), 2)
    kernels = _img((4, 5, 5), 3)
    want = np.asarray(JF.filter2d_per_sample(jnp.asarray(x),
                                             jnp.asarray(kernels)))
    got = F.filter2d_per_sample(_t(x), _t(kernels)).numpy()
    # 1e-6 of the outputs' size (about 5 here: the kernels sum to 12)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("pad_mode", ["reflect", "constant"])
def test_separable_filter2d_matches_jax(pad_mode):
    x = _img((2, 11, 14, 3), 4)
    k = JF.gaussian_kernel_1d(6, 1.1)  # an even length: pads 2 before, 3 after
    want = np.asarray(JF.separable_filter2d(jnp.asarray(x), k, pad_mode))
    got = F.separable_filter2d(_t(x), k, pad_mode).numpy()
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("filter_type, sigma", [("gaussian", None),
                                                ("gaussian", 2.0),
                                                ("average", None)])
@pytest.mark.parametrize("normalize", [True, False])
def test_filter_low_and_high_match_jax(filter_type, sigma, normalize):
    x = _img((2, 16, 16, 3), 5)
    want = np.asarray(JF.filter_low(jnp.asarray(x), 7, sigma, filter_type))
    assert np.abs(F.filter_low(_t(x), 7, sigma, filter_type).numpy()
                  - want).max() <= 1e-6
    want = np.asarray(JF.filter_high(jnp.asarray(x), 7, sigma, filter_type,
                                     normalize))
    got = F.filter_high(_t(x), 7, sigma, filter_type, normalize).numpy()
    assert np.abs(got - want).max() <= 1e-6


def test_guided_filter_matches_jax():
    g, s = _img((2, 16, 16, 3), 6), _img((2, 16, 16, 3), 7)
    want = np.asarray(JF.guided_filter(jnp.asarray(g), jnp.asarray(s), 2,
                                       1e-2))
    got = F.guided_filter(_t(g), _t(s), 2, 1e-2).numpy()
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("consts", ["yuv", "yuvK", "ycbcr", "uv", "y"])
def test_yuv_both_ways_match_jax(consts):
    x = _img((2, 8, 8, 3), 8)
    want = np.asarray(JC.rgb_to_yuv(jnp.asarray(x), consts))
    got = C.rgb_to_yuv(_t(x), consts).numpy()
    assert np.abs(got - want).max() <= 1e-6
    if consts in ("yuv", "yuvK", "ycbcr"):
        back = C.yuv_to_rgb(_t(got), consts).numpy()
        assert np.abs(back - np.asarray(JC.yuv_to_rgb(jnp.asarray(want),
                                                      consts))).max() <= 1e-6
        assert np.abs(back - x).max() <= 2e-3  # the rounded coefficients


@pytest.mark.parametrize("fn", ["rgb_to_grayscale", "srgb_to_linear",
                                "linear_to_srgb", "rgb_to_ycbcr",
                                "ycbcr_to_rgb"])
def test_colour_formulas_match_jax(fn):
    x = _img((2, 8, 8, 3), 9)
    want = np.asarray(getattr(JC, fn)(jnp.asarray(x)))
    got = getattr(C, fn)(_t(x)).numpy()
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("mode", ["uniform", "normal"])
def test_color_shift_matches_jax_on_its_draws(mode):
    x, y = _img((2, 8, 8, 3), 10), _img((2, 8, 8, 3), 11)
    key = jax.random.PRNGKey(4)
    k1, k2, k3 = jax.random.split(key, 3)
    if mode == "normal":
        w = [jax.random.normal(k, ()) * 0.1 + m
             for k, m in zip((k1, k2, k3), (0.299, 0.587, 0.114))]
    else:
        w = [jax.random.uniform(k, (), minval=lo, maxval=hi) for k, lo, hi
             in zip((k1, k2, k3), (0.199, 0.487, 0.014),
                    (0.399, 0.687, 0.214))]
    weights = dict(zip(("r", "g", "b"), (_t(v) for v in w)))
    want = JC.color_shift(key, jnp.asarray(x), jnp.asarray(y), mode)
    got = C.color_shift(weights, _t(x), _t(y))
    for g, wt in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(wt)).max() <= 1e-6
    (one,) = C.color_shift(weights, _t(x))
    assert torch.equal(one, got[0])
    drawn = C.draw_color_shift(torch.Generator().manual_seed(0), mode)
    assert set(drawn) == {"r", "g", "b"}
    if mode == "uniform":
        assert 0.199 <= float(drawn["r"]) <= 0.399
