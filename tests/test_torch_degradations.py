"""Each degradation op of the port (``trainner_tpu_torch/ops/
degradations.py``) against the JAX package's op of the same name. The
port's ops are split into a draw and a deterministic half; the random
streams of the two frameworks cannot match, so each test repeats the JAX
op's own ``jax.random.split`` and draws, hands those numbers to the port's
deterministic half, and compares with the JAX op called with the same key.

Tolerances are stated at each test; all compare f32 on the CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.ops import degradations as JD
from trainner_tpu_torch.ops import degradations as D

torch.set_num_threads(2)

B = 7


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _img(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _smooth(shape, seed=0):
    """A smooth random field in [0, 1] (so that JPEG keeps something)."""
    b, h, w, c = shape
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    out = np.zeros(shape, np.float32)
    for _ in range(6):
        fy, fx = rng.uniform(0.02, 0.35, 2)
        ph = rng.uniform(0, 2 * np.pi, (b, 1, 1, c))
        amp = rng.uniform(0.05, 0.2, (b, 1, 1, c))
        out += amp * np.sin(2 * np.pi * (fy * yy + fx * xx))[None, :, :, None]\
            * np.cos(ph) + amp * 0.3 * np.sin(ph)
    return np.clip(out + 0.5, 0.0, 1.0).astype(np.float32)


# ---------------------------------------------------------------------------
# kernel banks
# ---------------------------------------------------------------------------


def _jax_kernel_draws(key, k, sigma_range, iso_prob, sigma_y_range,
                      min_size, angle_range):
    r1, r2, r3, r4, r5 = jax.random.split(key, 5)
    sx = jax.random.uniform(r1, (B,), minval=sigma_range[0],
                            maxval=sigma_range[1])
    syr = sigma_y_range or sigma_range
    sy_a = jax.random.uniform(r2, (B,), minval=syr[0], maxval=syr[1])
    iso = jax.random.uniform(r3, (B,)) < iso_prob
    ar = angle_range or (-math.pi, math.pi)
    theta = jnp.where(iso, 0.0, jax.random.uniform(
        r4, (B,), minval=ar[0], maxval=ar[1]))
    support = None
    if min_size is not None and min_size < k:
        support = _t(jax.random.randint(r5, (B, 1, 1), min_size, k + 1)
                     ).long()
    return {"sx": _t(sx), "sy": _t(jnp.where(iso, sx, sy_a)),
            "theta": _t(theta), "support": support}


@pytest.mark.parametrize("name, kw", [
    ("iso", dict(k=21, sigma_range=(0.1, 2.8), iso_prob=1.0,
                 sigma_y_range=None, min_size=7, angle_range=None)),
    ("aniso", dict(k=21, sigma_range=(0.5, 8.0), iso_prob=0.0,
                   sigma_y_range=(0.5, 8.0), min_size=7,
                   angle_range=(0.0, math.pi))),
    ("mixed_full_support", dict(k=13, sigma_range=(0.2, 3.0), iso_prob=0.5,
                                sigma_y_range=None, min_size=None,
                                angle_range=None)),
    ("min_size_at_k", dict(k=9, sigma_range=(0.2, 3.0), iso_prob=0.0,
                           sigma_y_range=None, min_size=9,
                           angle_range=None)),
])
def test_gaussian_kernels_match_jax_on_its_draws(name, kw):
    """1e-6 absolute: the same f32 formula on the same parameters."""
    key = jax.random.PRNGKey(3)
    k = kw["k"]
    want = np.asarray(JD.gaussian_kernels(
        key, B, k, kw["sigma_range"], iso_prob=kw["iso_prob"],
        sigma_y_range=kw["sigma_y_range"], min_size=kw["min_size"],
        angle_range=kw["angle_range"]))
    params = _jax_kernel_draws(key, **kw)
    got = D.gaussian_kernels(params, k).numpy()
    assert got.shape == (B, k, k)
    assert np.abs(got - want).max() <= 1e-6
    assert np.abs(got.sum(axis=(1, 2)) - 1.0).max() <= 1e-5


def test_support_mask_matches_jax():
    key = jax.random.PRNGKey(5)
    want = np.asarray(JD._random_support_mask(key, B, 21, 7))
    v = _t(jax.random.randint(key, (B, 1, 1), 7, 22)).long()
    got = D._random_support_mask(v, 21, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert D.draw_support_sizes(torch.Generator().manual_seed(0), B, 9,
                                9) is None


def test_draw_gaussian_kernels_stays_in_its_ranges():
    gen = torch.Generator().manual_seed(1)
    p = D.draw_gaussian_kernels(gen, 4096, 21, (0.5, 8.0), iso_prob=0.0,
                                sigma_y_range=(1.0, 2.0), min_size=7,
                                angle_range=(0.0, math.pi))
    assert 0.5 <= float(p["sx"].min()) and float(p["sx"].max()) <= 8.0
    assert 1.0 <= float(p["sy"].min()) and float(p["sy"].max()) <= 2.0
    assert 0.0 <= float(p["theta"].min()) \
        and float(p["theta"].max()) <= math.pi
    assert set(p["support"].flatten().tolist()) == set(range(7, 22))
    iso = D.draw_gaussian_kernels(gen, 64, 21, (0.1, 2.8), iso_prob=1.0)
    assert torch.equal(iso["sx"], iso["sy"]) and not iso["theta"].any()
    assert iso["support"] is None


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gray_prob, mc_prob", [(0.4, 0.34), (0.0, 1.0),
                                                (1.0, 0.0)])
def test_gaussian_noise_matches_jax_on_its_draws(gray_prob, mc_prob):
    """1e-6 absolute: one multiply and one add on the same numbers."""
    key = jax.random.PRNGKey(11)
    x = _img((B, 12, 10, 3))
    rng_ = (1.0, 25.0)
    scale = np.linspace(0.3, 1.0, B).astype(np.float32)
    want = np.asarray(JD.gaussian_noise(
        key, jnp.asarray(x), rng_, gray_prob, mc_prob,
        sigma_scale=jnp.asarray(scale)))
    r1, r2, r3, r4, _ = jax.random.split(key, 5)
    sigma = jax.random.uniform(r1, (B, 1, 1, 1), minval=rng_[0],
                               maxval=rng_[1]) / 255.0
    sigma_mc = jnp.sqrt(jax.random.uniform(
        r4, (B, 1, 1, 3), minval=rng_[0], maxval=rng_[1])) / 255.0
    normal = jax.random.normal(r2, x.shape, jnp.float32)
    u_gray, u_mc = jax.random.split(r3)
    gray = jax.random.uniform(u_gray, (B, 1, 1, 1)) < gray_prob
    mc = jnp.logical_and(~gray,
                         jax.random.uniform(u_mc, (B, 1, 1, 1)) < mc_prob)
    params = {"sig": _t(jnp.where(mc, sigma_mc, sigma)), "gray": _t(gray),
              "normal": _t(normal)}
    got = D.gaussian_noise(_t(x), params, sigma_scale=_t(scale)).numpy()
    assert np.abs(got - want).max() <= 1e-6


def test_draw_gaussian_noise_statistics():
    gen = torch.Generator().manual_seed(2)
    p = D.draw_gaussian_noise(gen, (2048, 4, 4, 3), (1.0, 25.0),
                              gray_prob=0.4, mc_prob=0.34)
    assert p["normal"].shape == (2048, 4, 4, 3)
    assert abs(float(p["gray"].float().mean()) - 0.4) < 0.04
    per_channel = (p["sig"].shape[-1] == 3)
    assert per_channel and float(p["sig"].max()) <= 25.0 / 255.0
    assert abs(float(p["normal"].std()) - 1.0) < 0.02


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------


def test_chroma_upsample_is_jax_linear_resize():
    """``jax.image.resize(method="linear")`` at 2x equals bilinear
    interpolation with half-pixel centres: 1e-6 absolute."""
    x = (_img((B, 8, 12, 2), seed=4) - 0.5) * 200.0
    want = np.asarray(jax.image.resize(jnp.asarray(x), (B, 16, 24, 2),
                                       method="linear"))
    got = D.upsample2x_linear(_t(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * 100.0


@pytest.mark.parametrize("hw, sub", [((32, 32), "420"), ((24, 24), "444"),
                                     ((16, 48), "420")])
def test_jpeg_compress_matches_jax_at_given_quality(hw, sub):
    """2e-5 absolute, but for at most 0.1 % of the pixels, where a DCT
    coefficient within rounding of a half quantises the other way: those
    differ by at most one quantiser step of one coefficient."""
    assert (hw[0] % 16 == 0 and hw[1] % 16 == 0) == (sub == "420")
    x = _smooth((B, *hw, 3), seed=7)
    q = np.linspace(30.0, 95.0, B).astype(np.float32)
    want = np.asarray(JD.jpeg_compress(jax.random.PRNGKey(0), jnp.asarray(x),
                                       quality=jnp.asarray(q)))
    got = D.jpeg_compress(_t(x), _t(q)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    diff = np.abs(got - want)
    assert (diff > 2e-5).mean() <= 1e-3
    step = 0.25 * 1.772 * 255.0 / 255.0  # basis * YCC->RGB gain * largest q
    assert diff.max() <= step
    assert np.abs(got - x).mean() > 1e-3  # it did compress


def test_jpeg_tables_match_jax():
    for name in ("_DCT8", "_Q_LUMA", "_Q_CHROMA", "_RGB2YCC", "_YCC2RGB"):
        np.testing.assert_allclose(getattr(D, name),
                                   np.asarray(getattr(JD, name)), atol=1e-7)
    q = np.array([10.0, 49.9, 50.0, 75.0, 100.0], np.float32)
    np.testing.assert_allclose(D._quality_scale(_t(q)).numpy(),
                               np.asarray(JD._quality_scale(jnp.asarray(q))),
                               rtol=1e-6)


def test_jpeg_rejects_what_it_cannot_block():
    with pytest.raises(ValueError, match="multiples of 8"):
        D.jpeg_compress(torch.rand(2, 12, 16, 3), torch.full((2,), 50.0))


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------


def test_random_resize_down_up_and_aligned_match_jax():
    """1e-5 absolute: f32 contractions summed in another order."""
    x = _img((B, 32, 40, 3), seed=9)
    key = jax.random.PRNGKey(21)
    algos = [773, 777]
    want = np.asarray(JD.random_resize(key, jnp.asarray(x), (9, 13), algos))
    choice = _t(jax.random.randint(key, (B,), 0, 2)).long()
    got = D.random_resize(_t(x), (9, 13), algos, choice).numpy()
    assert np.abs(got - want).max() <= 1e-5

    want = np.asarray(JD.down_up(key, jnp.asarray(x), (1.0, 2.0), algos))
    r1, r2 = jax.random.split(key)
    choices = [_t(jax.random.randint(r, (B,), 0, 2)).long() for r in (r1, r2)]
    got = D.down_up(_t(x), choices, (1.0, 2.0), algos).numpy()
    assert got.shape == x.shape
    assert np.abs(got - want).max() <= 1e-5

    want = np.asarray(JD.nearest_aligned_downscale(jnp.asarray(x), 4))
    np.testing.assert_array_equal(
        D.nearest_aligned_downscale(_t(x), 4).numpy(), want)
    # one algorithm: no choice is drawn or needed
    one = D.random_resize(_t(x), (8, 10), [777], None).numpy()
    want = np.asarray(JD.resize_batch(jnp.asarray(x), (8, 10), 777))
    assert np.abs(one - want).max() <= 1e-5
    assert D.draw_resize_choice(torch.Generator().manual_seed(0), B,
                                [777]) is None


def test_resize_codes_outside_the_slice_raise():
    """The cv2-style codes 0-6 are served (``jax_resize``). Code 999 (the
    realistic kernels) raised before the realsr and combo slice; now, as in
    the JAX package, a resize stage without a kernel pool drops it, and a
    stage of 999 alone is the plain cubic resize: 1e-5 against JAX."""
    from trainner_tpu.data.pipeline import _resize_stage as jax_stage
    from trainner_tpu_torch.data.pipeline import _resize_stage

    assert D.resize_batch(torch.rand(1, 8, 8, 3), (4, 4), 2).shape \
        == (1, 4, 4, 3)
    x = _smooth((B, 16, 16, 3), seed=3)
    want = np.asarray(jax_stage([999], lambda shape: (4, 4))(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    got = _resize_stage([999], lambda shape: (4, 4))(
        torch.Generator().manual_seed(0), _t(x)).numpy()
    assert got.shape == (B, 4, 4, 3)
    assert np.abs(got - want).max() <= 1e-5


# ---------------------------------------------------------------------------
# camera noise
# ---------------------------------------------------------------------------


def test_malvar_demosaic_matches_jax():
    """1e-6 absolute: four 5x5 filters with dyadic weights."""
    bayer = _img((B, 12, 16), seed=13)
    want = JD._malvar_demosaic(jnp.asarray(bayer))
    got = D._malvar_demosaic(_t(bayer))
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-6
    for g, w in zip(D._mosaic_masks(6, 8, "cpu"), JD._mosaic_masks(6, 8)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("xyz", ["D50", "D65"])
def test_camera_noise_matches_jax_on_its_draws(xyz):
    """1e-4 relative (plus 1e-4 absolute near zero): the per-sample 3x3
    colour matrix is inverted by another routine, and two gamma curves
    follow."""
    key = jax.random.PRNGKey(17)
    x = _smooth((B, 16, 24, 3), seed=15)
    gain, bg, shot = (1.2, 2.4), (1.3, 2.2), (1e-4, 0.012)
    want = np.asarray(JD.camera_noise(key, jnp.asarray(x), shot, gain, bg,
                                      xyz_arr=xyz))
    rs = jax.random.split(key, 8)
    params = {
        "wts": _t(jax.random.uniform(rs[0], (B, 4, 1, 1), minval=1e-8,
                                     maxval=1e8)),
        "gain_normal": _t(jax.random.normal(rs[1], (B, 1, 1))),
        "rg": _t(jax.random.uniform(rs[2], (B, 1, 1), minval=gain[0],
                                    maxval=gain[1])),
        "bg": _t(jax.random.uniform(rs[3], (B, 1, 1), minval=bg[0],
                                    maxval=bg[1])),
        "log_shot": _t(jax.random.uniform(
            rs[4], (B, 1, 1), minval=math.log(shot[0]),
            maxval=math.log(shot[1]))),
        "read_normal": _t(jax.random.normal(rs[5], (B, 1, 1))),
        "normal": _t(jax.random.normal(rs[6], (B, 16, 24))),
    }
    got = D.camera_noise(_t(x), params, xyz_arr=xyz).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(got - x).mean() > 1e-3


def test_draw_camera_noise_shapes_and_ranges():
    gen = torch.Generator().manual_seed(4)
    p = D.draw_camera_noise(gen, (512, 6, 8, 3), gain_range=(1.2, 2.4),
                            bg_range=(1.5, 1.6))
    assert p["normal"].shape == (512, 6, 8) and p["wts"].shape == (512, 4,
                                                                  1, 1)
    assert 1.2 <= float(p["rg"].min()) and float(p["rg"].max()) <= 2.4
    assert 1.5 <= float(p["bg"].min()) and float(p["bg"].max()) <= 1.6
    assert math.log(1e-4) <= float(p["log_shot"].min())
    assert float(p["log_shot"].max()) <= math.log(0.012)


# ---------------------------------------------------------------------------
# choices
# ---------------------------------------------------------------------------


def test_draw_choice_and_select():
    gen = torch.Generator().manual_seed(6)
    c = D.draw_choice(gen, 4000, 3, weights=[2.0, 1.0, 1.0])
    share = np.bincount(c.numpy(), minlength=3) / 4000
    assert np.abs(share - [0.5, 0.25, 0.25]).max() < 0.04
    u = D.draw_choice(gen, 3000, 3)
    assert np.abs(np.bincount(u.numpy(), minlength=3) / 3000 - 1 / 3).max() \
        < 0.04
    cands = [torch.full((4, 2, 2, 1), float(i)) for i in range(3)]
    pick = D.select(cands, torch.tensor([2, 0, 1, 2]))
    assert pick[:, 0, 0, 0].tolist() == [2.0, 0.0, 1.0, 2.0]
    assert D.select(cands[:1], None) is cands[0]


def test_the_same_seed_gives_the_same_draws():
    a = D.draw_gaussian_noise(torch.Generator().manual_seed(9), (3, 4, 4, 3))
    b = D.draw_gaussian_noise(torch.Generator().manual_seed(9), (3, 4, 4, 3))
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("what", ["the exact webp codec",
                                  "a codec host callback"])
def test_not_ported_names_its_roadmap_item(what):
    """Every op of the JAX module runs now; what is left (the exact codec,
    a host callback) names ROADMAP Queue A 5.5."""
    err = D.not_ported(what)
    assert isinstance(err, NotImplementedError)
    assert what in str(err) and "ROADMAP Queue A 5.5" in str(err)
