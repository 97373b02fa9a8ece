"""The degradation ops of the realsr and combo strategies and of the
options without a preset (``trainner_tpu_torch/ops/degradations.py``,
``ops/superpixel.py``) against the JAX package's ops of the same name.

As in ``tests/test_torch_degradations.py``: each test repeats the JAX op's
own ``jax.random.split`` and draws, hands those numbers to the port's
deterministic half, and compares with the JAX op called with the same key.
Tolerances are stated at each test; all compare f32 on the CPU. The
k-means, SOM and SLIC assignments are argmins over sums that the two
frameworks add in other orders, so a near tie can go the other way: those
tests print and bound the share of pixels that differ.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.ops import degradations as JD
from trainner_tpu.ops import superpixel as JS
from trainner_tpu_torch.ops import degradations as D
from trainner_tpu_torch.ops import superpixel as S

torch.set_num_threads(2)

B = 5
KEY = jax.random.PRNGKey(7)


@pytest.fixture(autouse=True)
def _conv_path(monkeypatch):
    """The JAX side blurs by its conv path (cross-correlation)."""
    monkeypatch.setenv("TRAINNER_BLUR_FFT", "0")


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _fractal(shape, seed=0, alpha=1.2):
    """Textured images (b, h, w, 3) in [0, 1] with a 1/f^alpha spectrum
    and correlated channels, on the 1/255 lattice."""
    b, h, w, c = shape
    rng = np.random.RandomState(seed)
    f = np.hypot(np.fft.fftfreq(h)[:, None], np.fft.fftfreq(w)[None, :])
    f[0, 0] = 1.0
    img = np.real(np.fft.ifft2(np.fft.fft2(rng.randn(b, c, h, w))
                               / f ** alpha)).transpose(0, 2, 3, 1)
    img = img + 0.6 * img.mean(-1, keepdims=True)
    img = (img - img.mean()) / img.std() * 0.18 + 0.5
    return np.round(np.clip(img, 0, 1) * 255).astype(np.float32) / 255


# ---------------------------------------------------------------------------
# kernel banks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k, length_range", [(21, (3.0, 15.0)),
                                             (13, (1.0, 30.0))])
def test_motion_kernels_match_jax(k, length_range):
    """1e-6 absolute on the JAX draws (angle, length)."""
    r1, r2 = jax.random.split(KEY)
    params = {"theta": _t(jax.random.uniform(r1, (B, 1, 1), minval=0.0,
                                             maxval=math.pi)),
              "length": _t(jax.random.uniform(
                  r2, (B, 1, 1), minval=length_range[0],
                  maxval=length_range[1]))}
    want = np.asarray(JD.motion_kernels(KEY, B, k, length_range))
    got = D.motion_kernels(params, k).numpy()
    assert got.shape == (B, k, k)
    assert np.abs(got - want).max() <= 1e-6
    assert np.abs(got.sum(axis=(1, 2)) - 1.0).max() <= 1e-5


@pytest.mark.parametrize("k, size_range", [(21, (3, 11)), (9, (3, 9))])
def test_box_kernels_match_jax(k, size_range):
    """Exact: the drawn odd sizes as masks over their area."""
    sizes = jax.random.randint(KEY, (B, 1, 1), size_range[0] // 2,
                               size_range[1] // 2 + 1) * 2 + 1
    want = np.asarray(JD.box_kernels(KEY, B, k, size_range))
    got = D.box_kernels({"size": _t(sizes).long()}, k).numpy()
    np.testing.assert_array_equal(got, want)
    draws = D.draw_box_kernels(torch.Generator().manual_seed(0), 400,
                               size_range)["size"]
    assert set(draws.unique().tolist()) == set(
        range(size_range[0], size_range[1] + 1, 2))


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------


def test_speckle_noise_matches_jax():
    """1e-6 absolute: x (1 + sigma n) on the JAX draws."""
    x = _fractal((B, 16, 16, 3), 1)
    r1, r2 = jax.random.split(KEY)
    params = {"sigma": _t(jax.random.uniform(r1, (B, 1, 1, 1), minval=0.03,
                                             maxval=0.1)),
              "normal": _t(jax.random.normal(r2, x.shape))}
    want = np.asarray(JD.speckle_noise(KEY, jnp.asarray(x), (0.03, 0.1)))
    got = D.speckle_noise(_t(x), params).numpy()
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("sp_ratio", [0.5, 0.2])
def test_salt_pepper_noise_matches_jax(sp_ratio):
    """Exact: salt and pepper where the JAX uniforms fall."""
    x = _fractal((B, 16, 16, 3), 2)
    r1, r2, _ = jax.random.split(KEY, 3)
    params = {"amount": _t(jax.random.uniform(r1, (B, 1, 1, 1), minval=0.05,
                                              maxval=0.2)),
              "u": _t(jax.random.uniform(r2, (B, 16, 16, 1)))}
    want = np.asarray(JD.salt_pepper_noise(KEY, jnp.asarray(x), (0.05, 0.2),
                                           sp_ratio))
    got = D.salt_pepper_noise(_t(x), params, sp_ratio).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 1.0).any() and (got == 0.0).any()


# ---------------------------------------------------------------------------
# pixel filters
# ---------------------------------------------------------------------------


def test_unsharp_mask_matches_jax():
    """1e-5 absolute: its gaussian (k 11) through ``apply_kernels`` and the
    drawn amount."""
    x = _fractal((B, 24, 24, 3), 3)
    r1, r2 = jax.random.split(KEY)
    k1, _, _, _, _ = jax.random.split(r1, 5)
    sx = jax.random.uniform(k1, (B,), minval=1.0, maxval=2.0)
    params = {"kernel": {"sx": _t(sx), "sy": _t(sx),
                         "theta": torch.zeros(B), "support": None},
              "amount": _t(jax.random.uniform(r2, (B, 1, 1, 1), minval=0.5,
                                              maxval=1.5))}
    want = np.asarray(JD.unsharp_mask(KEY, jnp.asarray(x)))
    got = D.unsharp_mask(_t(x), params).numpy()
    assert np.abs(got - want).max() <= 1e-5
    assert np.abs(got - x).max() > 0.01


@pytest.mark.parametrize("percent", [1.0, 5.0, 0.5])
def test_auto_levels_matches_jax(percent):
    """1e-6 absolute: ``jnp.percentile``'s linear interpolation."""
    x = _fractal((B, 20, 12, 3), 4) * 0.6 + 0.1
    want = np.asarray(JD.auto_levels(jnp.asarray(x), percent))
    got = D.auto_levels(_t(x), percent).numpy()
    assert np.abs(got - want).max() <= 1e-6
    assert got.min() == 0.0 and got.max() == 1.0


def test_fringes_match_jax():
    """Exact: the red and blue channels rolled by the JAX shifts."""
    x = _fractal((8, 16, 16, 3), 5)
    shifts = jax.random.randint(KEY, (8, 2, 2), -2, 3)
    want = np.asarray(JD.fringes(KEY, jnp.asarray(x)))
    got = D.fringes(_t(x), _t(shifts).long()).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., 1], x[..., 1])


def test_max_rgb_matches_the_jax_pipeline_op():
    """Exact: the JAX pipeline's maxrgb lambda."""
    x = _fractal((B, 8, 8, 3), 6)
    want = np.asarray(jnp.max(jnp.asarray(x), axis=-1, keepdims=True
                              ).repeat(3, -1))
    np.testing.assert_array_equal(D.max_rgb(_t(x)).numpy(), want)


# ---------------------------------------------------------------------------
# quantisation and dithering
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("levels", [32, 4])
def test_quantize_colors_and_ordered_dither_match_jax(levels):
    """Exact."""
    x = _fractal((B, 12, 20, 3), 7)
    np.testing.assert_array_equal(
        D.quantize_colors(_t(x), levels).numpy(),
        np.asarray(JD.quantize_colors(jnp.asarray(x), levels)))
    bits = 1 if levels == 32 else 2
    np.testing.assert_array_equal(
        D.ordered_dither(_t(x), bits).numpy(),
        np.asarray(JD.ordered_dither(jnp.asarray(x), bits)))


def test_ign_threshold_and_luma_match_jax():
    """The threshold field within 1e-6 (f32 products, maybe fused in XLA);
    the luma within 1e-6."""
    got = D._ign_threshold(13, 29, "cpu").numpy()
    want = np.asarray(JD._ign_threshold(13, 29))
    assert np.abs(got - want).max() <= 1e-6
    x = _fractal((B, 8, 8, 3), 8)
    assert np.abs(D._luma(_t(x)).numpy()
                  - np.asarray(JD._luma(jnp.asarray(x)))).max() <= 1e-6


@pytest.mark.parametrize("kind", ["bayer", "fs", "rnd", "avg", "bin"])
@pytest.mark.parametrize("bw", [False, True])
@pytest.mark.parametrize("bits", [1, 2])
def test_dither_batch_matches_jax(kind, bw, bits):
    """Exact but for pixels whose value sits within 1e-6 of a rounding or
    threshold edge (the luma, the IGN field and the 3 x 3 mean are f32
    sums the two frameworks may order or fuse otherwise): at most 0.2 % of
    the values, each within one step ('avg' gives 0 or 1 at any depth)."""
    x = _fractal((B, 16, 24, 3), 9)
    thr = jax.random.uniform(KEY, (16, 24)) if kind == "rnd" else None
    want = np.asarray(JD.dither_batch(KEY, jnp.asarray(x), kind, bits, bw))
    got = D.dither_batch(_t(x), kind, bits, bw,
                         None if thr is None else _t(thr)).numpy()
    assert got.shape == want.shape == x.shape
    diff = np.abs(got - want)
    assert (diff > 0).mean() <= 2e-3, (diff > 0).mean()
    step = 1.0 if kind == "avg" else 1.0 / (2 ** bits - 1)
    assert diff.max() <= step + 1e-6
    if bw:
        np.testing.assert_array_equal(got[..., 0], got[..., 2])


def test_dither_draws_only_for_rnd():
    gen = torch.Generator().manual_seed(0)
    assert D.draw_dither(gen, (2, 8, 8, 3), "bayer") is None
    assert D.draw_dither(gen, (2, 8, 8, 3), "rnd").shape == (8, 8)


def _share_differing(got, want, tol=1e-5):
    return float((np.abs(got - want).max(axis=-1) > tol).mean())


@pytest.mark.parametrize("n_colors", [8, 16])
def test_kmeans_quantize_matches_jax(n_colors):
    """Pixels whose colour differs by more than 1e-5 from JAX's: printed,
    at most 1 % (argmin ties over sums in another order)."""
    x = _fractal((B, 24, 24, 3), 10)
    idx = jax.random.randint(KEY, (B, 256), 0, 24 * 24)
    want = np.asarray(JD.kmeans_quantize(KEY, jnp.asarray(x), n_colors,
                                         iters=8, sample=256))
    got = D.kmeans_quantize(_t(x), _t(idx).long(), n_colors, iters=8).numpy()
    share = _share_differing(got, want)
    print(f"k-means {n_colors}: {share:.4%} of the pixels differ")
    assert share <= 0.01
    assert len(np.unique(got[0].reshape(-1, 3), axis=0)) <= n_colors


@pytest.mark.parametrize("n_colors", [8, 16])
def test_som_quantize_matches_jax(n_colors):
    """As k-means: the share of differing pixels printed, at most 1 %."""
    x = _fractal((B, 24, 24, 3), 11)
    r_init, r_samp = jax.random.split(KEY)
    params = {"idx": _t(jax.random.randint(r_samp, (B, 256), 0, 24 * 24)
                        ).long(),
              "init_idx": _t(jax.random.randint(r_init, (B, n_colors), 0,
                                                256)).long()}
    want = np.asarray(JD.som_quantize(KEY, jnp.asarray(x), n_colors,
                                      n_iters=10, n_samples=256))
    got = D.som_quantize(_t(x), params, n_colors, n_iters=10).numpy()
    share = _share_differing(got, want)
    print(f"SOM {n_colors}: {share:.4%} of the pixels differ")
    assert share <= 0.01
    assert len(np.unique(got[0].reshape(-1, 3), axis=0)) <= n_colors


# ---------------------------------------------------------------------------
# exact nonlinear filters and CLAHE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [3, 5, 11])
def test_window_stack_and_median_blur_match_jax(k):
    """Exact: the middle of the same window values."""
    x = _fractal((3, 16, 20, 3), 12)
    np.testing.assert_array_equal(
        D._window_stack(_t(x), k).numpy(),
        np.asarray(JD._window_stack(jnp.asarray(x), k)))
    np.testing.assert_array_equal(
        D.median_blur(_t(x), k).numpy(),
        np.asarray(JD.median_blur(jnp.asarray(x), k)))


@pytest.mark.parametrize("k, sc, ss", [(9, 75.0, 75.0), (5, 20.0, 3.0),
                                       (11, 40.0, 10.0)])
def test_bilateral_blur_matches_jax(k, sc, ss):
    """1e-5 absolute: the same weights added one offset at a time (JAX
    sums the stacked window)."""
    x = _fractal((3, 16, 20, 3), 13)
    want = np.asarray(JD.bilateral_blur(jnp.asarray(x), k, sc, ss))
    got = D.bilateral_blur(_t(x), k, sc, ss).numpy()
    assert np.abs(got - want).max() <= 1e-5
    assert np.abs(got - x).max() > 1e-3


def test_rgb_to_lab_l_matches_jax():
    """1e-6 absolute (a cube root against ``jnp.cbrt``)."""
    x = _fractal((B, 16, 16, 3), 14)
    got = D._rgb_to_lab_l(_t(x)).numpy()
    want = np.asarray(JD._rgb_to_lab_l(jnp.asarray(x)))[..., 0] \
        if np.asarray(JD._rgb_to_lab_l(jnp.asarray(x))).ndim == 4 \
        else np.asarray(JD._rgb_to_lab_l(jnp.asarray(x)))
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("clip, grid, c", [(2.0, (8, 8), 3), (4.0, (4, 2), 3),
                                           (1.5, (4, 4), 1)])
def test_clahe_batch_matches_jax(clip, grid, c):
    """1e-5 absolute but for pixels whose luminance bin differs (the L
    channel within an ulp of a bin edge): at most 0.5 % of the pixels;
    reruns are bit-equal."""
    x = _fractal((3, 32, 32, 3), 15)[..., :c]
    want = np.asarray(JD.clahe_batch(jnp.asarray(x), clip, grid))
    got = D.clahe_batch(_t(x), clip, grid).numpy()
    share = _share_differing(got, want)
    print(f"clahe {clip} {grid} c={c}: {share:.4%} of the pixels differ")
    assert share <= 5e-3
    np.testing.assert_array_equal(
        got, D.clahe_batch(_t(x), torch.tensor(clip), grid).numpy())


# ---------------------------------------------------------------------------
# superpixels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_segments, shape", [(16, (2, 24, 24, 3)),
                                               (30, (2, 20, 32, 3))])
def test_slic_segment_mean_matches_jax(n_segments, shape):
    """The share of pixels whose segment colour differs by more than 1e-5
    from JAX's: printed, at most 1 %."""
    x = _fractal(shape, 16)
    want = np.asarray(JS.slic_segment_mean(jnp.asarray(x), n_segments, 5))
    got = S.slic_segment_mean(_t(x), n_segments, 5).numpy()
    share = _share_differing(got, want)
    print(f"slic {n_segments} {shape}: {share:.4%} of the pixels differ")
    assert share <= 0.01
    assert len(np.unique(got[0].reshape(-1, 3), axis=0)) <= 40


def test_superpixel_structure_matches_jax():
    """The segment means to the drawn gamma: as SLIC, at most 1 % of the
    pixels differ."""
    x = _fractal((3, 24, 24, 3), 17)
    gamma = jax.random.uniform(KEY, (3, 1, 1, 1), minval=1.0, maxval=1.2)
    want = np.asarray(JS.superpixel_structure(KEY, jnp.asarray(x), 20))
    got = S.superpixel_structure(_t(x), _t(gamma), 20).numpy()
    assert _share_differing(got, want) <= 0.01
    assert S.draw_superpixel_structure(torch.Generator().manual_seed(0),
                                       4).shape == (4, 1, 1, 1)
