"""The port's degradation pipeline (``trainner_tpu_torch/data/pipeline.py``)
against the JAX package's ``data/pipeline.py``.

The two frameworks' random streams cannot match. So: the stage functions
are compared with degenerate ranges, where nothing random is left (exact,
1e-5 absolute: f32 sums in another order); ``_size_ratio``, ``_atten_ratio``
and ``_draw_att_pair`` are compared on the JAX side's own draws, repeated
here (1e-6); and the whole fixed-order bsrgan pipeline is compared on the
statistics of 256 samples of one smooth (1/f) fixture, under the five
gates of ``tests/test_degradation_stat_parity.py::_gate``, copied here.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trainner_tpu.data import pipeline as JP
from trainner_tpu.ops.imresize import imresize_np
from trainner_tpu.options.config import parse_dict as jax_parse_dict
from trainner_tpu_torch.data import pipeline as P
from trainner_tpu_torch.options.config import parse_dict

torch.set_num_threads(2)

B = 7
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _conv_path(monkeypatch):
    """The JAX side blurs by its conv path (cross-correlation)."""
    monkeypatch.setenv("TRAINNER_BLUR_FFT", "0")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _smooth(b, h, w, seed=0):
    """Smooth random fields in [0, 1] with some fine texture."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    out = np.full((b, h, w, 3), 0.5, np.float32)
    for i in range(8):
        fy, fx = rng.uniform(-0.25, 0.25, 2) / (1 + i % 3)
        ph = rng.uniform(0, 2 * np.pi, (b, 1, 1, 3))
        amp = rng.uniform(0.03, 0.12, (b, 1, 1, 3))
        out += amp * np.sin(2 * np.pi * (fy * yy + fx * xx)[None, :, :, None]
                            + ph)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def _fractal(n, seed, alpha=1.2):
    """A random field with a 1 / f^alpha amplitude spectrum (smooth, not
    white, yet with some power at every frequency, as a photograph has:
    a fixture without it blurs to flat samples whose log spectrum is not
    a statistic), correlated channels, in [0, 1]."""
    rng = np.random.RandomState(seed)
    f = np.hypot(np.fft.fftfreq(n)[:, None], np.fft.fftfreq(n)[None, :])
    f[0, 0] = 1.0
    img = np.stack([np.real(np.fft.ifft2(np.fft.fft2(rng.randn(n, n))
                                         / f ** alpha))
                    for _ in range(3)], axis=-1)
    img = img + 0.6 * img.mean(-1, keepdims=True)
    img = (img - img.mean()) / img.std() * 0.18 + 0.5
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def _both(jax_fn, port_fn, x, **kw):
    want = np.asarray(jax_fn(KEY, jnp.asarray(x), **kw))
    got = port_fn(_gen(), _t(x), **{k: tuple(_t(a) for a in v)
                                   for k, v in kw.items()}).numpy()
    assert got.shape == want.shape
    return got, want


# ---------------------------------------------------------------------------
# the stages with nothing random left
# ---------------------------------------------------------------------------

BLUR_CFGS = {
    "iso": {"p": 1.0, "kernel_size": 7, "min_kernel_size": 7,
            "sigmaX": [1.3, 1.3]},
    "aniso": {"p": 1.0, "kernel_size": 9, "min_kernel_size": 9,
              "sigmaX": [2.0, 2.0], "sigmaY": [0.7, 0.7],
              "angle": [30, 30]},
    "aniso2": {"p": 1.0, "kernel_size": 11, "min_kernel_size": 11,
               "sigmaX": [0.6, 0.6], "sigmaY": [3.0, 3.0],
               "angle": [120, 120]},
}


@pytest.mark.parametrize("types, weights, cycle", [
    (["iso"], None, 1),
    (["aniso"], None, 1),
    (["aniso"], None, 2),                 # second cycle reads aniso2
    (["iso", "aniso"], [0.0, 1.0], 1),    # banks of k 7 and 9 padded to 9
    (["iso", "aniso"], [1.0, 0.0], 1),
])
def test_blur_stage_matches_jax(types, weights, cycle):
    x = _smooth(B, 24, 32)
    got, want = _both(
        JP._blur_stage(types, BLUR_CFGS, 1.0, weights=weights, cycle=cycle),
        P._blur_stage(types, BLUR_CFGS, 1.0, weights=weights, cycle=cycle),
        x)
    assert np.abs(got - want).max() <= 1e-5
    assert np.abs(got - x).max() > 1e-3


def test_blur_stage_miss_is_the_identity():
    cfgs = {"iso": dict(BLUR_CFGS["iso"], p=0.0)}
    x = _smooth(B, 16, 16)
    got = P._blur_stage(["iso"], cfgs, 1.0)(_gen(), _t(x)).numpy()
    assert np.abs(got - x).max() <= 1e-6
    # the stage's own probability picks between blurred and untouched
    half = P._blur_stage(["iso"], BLUR_CFGS, 0.5)(_gen(1), _t(x)).numpy()
    full = P._blur_stage(["iso"], BLUR_CFGS, 1.0)(_gen(1), _t(x)).numpy()
    same_as_x = np.abs(half - x).reshape(B, -1).max(1) == 0
    same_as_full = np.abs(half - full).reshape(B, -1).max(1) <= 1e-6
    assert np.all(same_as_x | same_as_full)


JPEG_CFGS = {"jpeg": {"p": 1.0, "min_quality": 60, "max_quality": 60}}


@pytest.mark.parametrize("v", [None, 0.35, 1.0])
def test_noise_stage_jpeg_matches_jax(v):
    """With ``atten`` and a given pair, the residual is scaled, low-passed
    and renormalised as in the JAX package."""
    x = _smooth(B, 16, 32, seed=1)
    atten = None if v is None else {"res_cfg": {}, "scale": 4}
    kw = {}
    if v is not None:
        col = np.linspace(v, 1.0, B).astype(np.float32).reshape(B, 1, 1, 1)
        kw = {"att": (col, col * 0.5)}
    got, want = _both(JP._noise_stage(["jpeg"], JPEG_CFGS, 1.0, atten=atten),
                      P._noise_stage(["jpeg"], JPEG_CFGS, 1.0, atten=atten),
                      x, **kw)
    # as in the op's own test: a DCT coefficient within rounding of a half
    # may quantise the other way in at most 0.1 % of the pixels
    diff = np.abs(got - want)
    assert (diff > 2e-5).mean() <= 1e-3 and diff.max() <= 0.45


def test_noise_stage_second_cycle_reads_its_own_config():
    assert P._cfg_for({"camera": {"p": 1}, "camera2": {"p": 0.25}},
                      "camera", 2) == {"p": 0.25}
    assert P._cfg_for({"camera": {"p": 1}, "camera2": {"p": 0.25}},
                      "camera", 1) == {"p": 1}
    assert P._cfg_for({"aniso2": {"p": 0.5}}, "aniso", 1) == {"p": 0.5}


def test_noise_stage_gaussian_has_the_drawn_strength():
    """Not exact (the normal field is drawn): sigma in [10, 10] / 255."""
    cfgs = {"gaussian": {"p": 1.0, "var_limit": [10, 10], "prob_color": 1.0,
                         "multi": False}}
    x = np.full((64, 16, 16, 3), 0.5, np.float32)
    got = P._noise_stage(["gaussian"], cfgs, 1.0)(_gen(), _t(x)).numpy()
    want = np.asarray(JP._noise_stage(["gaussian"], cfgs, 1.0)(
        KEY, jnp.asarray(x)))
    assert abs((got - x).std() - 10 / 255) < 5e-4
    assert abs((got - x).std() - (want - x).std()) < 5e-4


def test_blur3_and_q8_match_jax():
    x = _smooth(B, 9, 13, seed=2) * 1.2 - 0.1
    assert np.abs(P._blur3(_t(x)).numpy()
                  - np.asarray(JP._blur3(jnp.asarray(x)))).max() <= 1e-6
    got, want = P._q8(_t(x)).numpy(), np.asarray(JP._q8(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    halves = (np.arange(0, 255, dtype=np.float32) + 0.5) / 255.0
    np.testing.assert_array_equal(P._q8(_t(halves)).numpy(),
                                  np.asarray(JP._q8(jnp.asarray(halves))))


def _lr_size(shape):
    return (shape[1] // 4, shape[2] // 4)


def _same_size(shape):
    return (shape[1], shape[2])


RESIZE_CASES = {
    "direct_cubic": dict(types=[777], out="lr"),
    "direct_linear_same_size": dict(types=[773], out="same"),
    "aligned_997": dict(types=[997], out="lr"),
    "down_up_998_to_lr": dict(types=[998], out="lr", down_up_types=[777]),
    "down_up_998_same_size": dict(types=[998], out="same",
                                  down_up_types=[773]),
    "keep_branch_is_direct": dict(
        types=[777], out="lr",
        res_cfg={"resize_prob": {"keep": 1.0, "down": 0.0}}),
    "bucket_0.8": dict(
        types=[777], out="lr",
        res_cfg={"resize_prob": {"down": 1.0},
                 "resize_range_down": [0.2, 0.2]}),
    "bucket_2.0_odd_sizes": dict(
        types=[773], out="lr",
        res_cfg={"resize_prob": {"down": 1.0},
                 "resize_range_down": [0.5, 0.5]}),
    "up_branch_last_bucket": dict(
        types=[777], out="lr",
        res_cfg={"resize_prob": {"up": 1.0, "down": 0.0},
                 "resize_range_up": [1.125, 1.125]}),
    "keep_rerouted_by_post_cfg": dict(
        types=[777], out="lr",
        res_cfg={"resize_prob": {"keep": 1.0, "down": 0.0}},
        post_cfg={"resize_prob": {"down": 1.0}}),
    "up_rerouted_to_the_triple": dict(
        types=[777], out="lr",
        res_cfg={"resize_prob": {"up": 1.0, "down": 0.0},
                 "resize_range_up": [1.125, 1.125]},
        post_cfg={"resize_prob": {"down": 1.0}}),
    "lr_canvas_sub_lr_bucket": dict(
        types=[777], out="same", in_over_out=1.0,
        res_cfg={"resize_prob": {"down": 1.0},
                 "resize_range_down": [0.7, 0.7]},
        chain_cfg={"resize_prob": {"keep": 1.0, "down": 0.0}, "_scale": 1}),
    "lr_canvas_above_1.35_is_direct": dict(
        types=[777], out="same", in_over_out=1.0,
        res_cfg={"resize_prob": {"up": 1.0, "down": 0.0},
                 "resize_range_up": [1.5, 1.5]}),
}


@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_resize_stage_matches_jax(case):
    kw = dict(RESIZE_CASES[case])
    out_fn = _lr_size if kw.pop("out") == "lr" else _same_size
    types = kw.pop("types")
    x = _smooth(B, 32, 40, seed=3)
    got, want = _both(JP._resize_stage(types, out_fn, **kw),
                      P._resize_stage(types, out_fn, **kw), x)
    assert got.shape[1:3] == out_fn(x.shape)
    assert np.abs(got - want).max() <= 1e-5


def test_mid_sizes_are_off_the_lattice():
    for o in (8, 16, 32):
        for f in (0.5, 0.6, 0.8, 1.25, 1.5, 2.0, 3.0, 4.5):
            m = P._mid(o, f)
            assert m % o != 0 and o % m != 0
    assert (P._mid(32, 1.125), P._mid(32, 1.25), P._mid(32, 1.6)) \
        == (36, 40, 51)


# ---------------------------------------------------------------------------
# the attenuation draws, fed from the JAX side
# ---------------------------------------------------------------------------

RES_CFG = {"resize_prob": {"up": 0.2, "down": 0.7, "keep": 0.1},
           "resize_range_up": [1, 1.5], "resize_range_down": [0.15, 1],
           "down_up_min": 0.5}
N = 64


def _jax_size_draws(key, res_cfg, in_over_out):
    r1, r2, r3 = jax.random.split(key, 3)
    rd, ru, _, _, _ = P._size_ranges(res_cfg, in_over_out)
    return {"sc_d": _t(jax.random.uniform(r1, (N,), minval=rd[0],
                                          maxval=rd[1])),
            "sc_u": _t(jax.random.uniform(r2, (N,), minval=ru[0],
                                          maxval=ru[1])),
            "u": _t(jax.random.uniform(r3, (N,)))}


def _jax_atten_draws(key, res_cfg, scale, res_types):
    r1, r4, r5, r6, r7 = jax.random.split(key, 5)
    algos = [t for t in res_types if isinstance(t, int)]
    n = max(P._n_plain(algos), 1) + int(997 in algos) + int(998 in algos) \
        + int(999 in algos)
    half = -(-scale // 2)
    return {"plain": _jax_size_draws(r1, res_cfg, float(scale)),
            "coin": _t(jax.random.uniform(r4, (N,)) < 0.5),
            "sp": _t(jax.random.uniform(r5, (N,), minval=float(half),
                                        maxval=float(scale))),
            "a_u": _t(jax.random.uniform(r7, (N,))),
            "choice": _t(jax.random.randint(r6, (N,), 0, n)).long()
            if n > 1 else None}


@pytest.mark.parametrize("res_cfg, io", [(RES_CFG, 4.0), (RES_CFG, 1.0),
                                         ({}, 4.0), ({}, 1.0)])
def test_size_ratio_on_fed_draws(res_cfg, io):
    want = np.asarray(JP._size_ratio(KEY, N, res_cfg, io))
    got = P._size_ratio(_jax_size_draws(KEY, res_cfg, io), res_cfg,
                        io).numpy()
    assert np.abs(got - want).max() <= 1e-6
    if res_cfg:  # all three branches were taken
        assert len(np.unique(np.round(want / io, 6))) > 3


@pytest.mark.parametrize("res_types", [(997, 773, 777, 998), (777,),
                                       (998,), (773, 999), ()])
def test_atten_ratio_on_fed_draws(res_types):
    want = np.asarray(JP._atten_ratio(KEY, N, RES_CFG, 4, res_types))
    got = P._atten_ratio(_jax_atten_draws(KEY, RES_CFG, 4, res_types),
                         RES_CFG, 4, res_types).numpy()
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("chain", [None, {"resize_prob": {"down": 1.0},
                                          "resize_range_down": [0.3, 1]}])
def test_att_pair_on_fed_draws(chain):
    att_cfg = {"res_cfg": RES_CFG, "scale": 4,
               "res_types": (997, 773, 777, 998), "chain_cfg2": chain}
    v1, v2 = JP._draw_att_pair(KEY, N, att_cfg)
    r1k, f2k = jax.random.split(KEY)
    draws = {"ratio": _jax_atten_draws(r1k, RES_CFG, 4,
                                       att_cfg["res_types"]),
             "chain": _jax_size_draws(f2k, chain, 1.0) if chain else None}
    g1, g2 = P._att_pair(draws, att_cfg)
    assert g1.shape == g2.shape == (N, 1, 1, 1)
    assert np.abs(g1.numpy() - np.asarray(v1)).max() <= 1e-6
    assert np.abs(g2.numpy() - np.asarray(v2)).max() <= 1e-6
    assert 0.0 < float(g1.min()) and float(g1.max()) <= 1.0
    if chain is None:
        assert torch.equal(g1, g2)


def test_att_pair_draws_follow_the_jax_distribution():
    """The port's own draws: the mean attenuation over many samples agrees
    with the JAX side's (0.01: 4096 samples of a value in (0, 1])."""
    att_cfg = {"res_cfg": RES_CFG, "scale": 4,
               "res_types": (997, 773, 777, 998), "chain_cfg2": None}
    v_jax, _ = JP._draw_att_pair(KEY, 4096, att_cfg)
    v, _ = P._draw_att_pair(_gen(3), 4096, att_cfg)
    assert abs(float(v.mean()) - float(np.asarray(v_jax).mean())) < 0.01
    f = P._atten_factor(_gen(4), 4096, RES_CFG, 4, (997, 773, 777, 998))
    assert abs(float(f.mean()) - float(v.mean())) < 0.015


def test_att_wrap_scales_the_residual():
    x = _smooth(B, 16, 16)
    fn = P._att_wrap(lambda gen, t: t + 0.1, {"scale": 4}, square=True)
    v = torch.linspace(0.2, 1.0, B).reshape(B, 1, 1, 1)
    got = fn(_gen(), _t(x), att=(v, v * 0))
    assert torch.allclose(got - _t(x), 0.1 * v * v * torch.ones(1),
                          atol=1e-6)
    assert fn._wants_att


# ---------------------------------------------------------------------------
# the whole fixed-order bsrgan pipeline
# ---------------------------------------------------------------------------

SCALE, CROP, N_STAT, BS = 4, 64, 256, 64


def _bsrgan_opt():
    return {"scale": SCALE, "model": "sr", "datasets": {"train": {
        "name": "p", "mode": "aligned", "dataroot_HR": "/nonexistent",
        "augs_strategy": "bsrgan", "crop_size": CROP, "batch_size": BS,
        "resize_strat": "in", "shuffle_degradations": False}}}


@pytest.fixture(scope="module")
def degraders():
    ds_j = jax_parse_dict(_bsrgan_opt(), is_train=True)["datasets"]["train"]
    ds_p = parse_dict(_bsrgan_opt(), is_train=True)["datasets"]["train"]
    return JP.BatchDegrader(ds_j, "lr"), P.BatchDegrader(ds_p, "lr")


def _psnr_set(outs, clean):
    mse = np.mean((outs - clean[None]) ** 2, axis=(1, 2, 3))
    return 10 * np.log10(1.0 / np.maximum(mse, 1e-10))


def _radial_spectrum(outs):
    f = np.fft.fftshift(np.abs(np.fft.fft2(
        outs.mean(-1), axes=(1, 2))) ** 2, axes=(1, 2))
    h, w = f.shape[1:3]
    yy, xx = np.mgrid[:h, :w]
    r = np.hypot(yy - h / 2, xx - w / 2).astype(int)
    prof = np.stack([f[:, r == b].mean(axis=1)
                     for b in range(r.max() + 1)], axis=1)
    return np.log10(prof + 1e-12).mean(0)  # the mean of per-sample logs


def _gate(tag, ref, ours, clean):
    p_r, p_o = _psnr_set(ref, clean), _psnr_set(ours, clean)
    s_r, s_o = _radial_spectrum(ref), _radial_spectrum(ours)
    d_mean = abs(p_r.mean() - p_o.mean())
    d_std = abs(p_r.std() - p_o.std())
    d_pix = abs(ref.mean() - ours.mean())
    d_pixstd = abs(ref.std() - ours.std())
    d_spec = np.abs(s_r - s_o).mean()
    msg = (f"[{tag}] psnr jax {p_r.mean():.2f}±{p_r.std():.2f} vs port "
           f"{p_o.mean():.2f}±{p_o.std():.2f}; pixmean d={d_pix:.4f}; "
           f"pixstd d={d_pixstd:.4f}; spec L1={d_spec:.3f}")
    assert d_mean < 0.75, msg
    assert d_std < 1.25, msg
    assert d_pix < 0.02, msg
    assert d_pixstd < 0.015, msg
    assert d_spec < 0.15, msg
    return msg


def test_stage_and_final_names_match_jax(degraders):
    jax_deg, port_deg = degraders
    assert [n for n, _ in port_deg.stages] == [n for n, _ in jax_deg.stages] \
        == ["blur", "resize", "noise", "compression", "blur2", "noise2"]
    assert [n for n, _ in port_deg.finals] == [n for n, _ in jax_deg.finals] \
        == ["final_scale", "final_compression"]
    assert not port_deg.is_noop and port_deg._att_cfg == jax_deg._att_cfg


def test_bsrgan_pipeline_statistics_match_jax(degraders):
    jax_deg, port_deg = degraders
    crop = _fractal(CROP, seed=11)
    crop = np.round(crop * 255.0).astype(np.float32) / 255.0
    clean = np.clip(imresize_np(crop, 1.0 / SCALE, kernel="cubic"), 0, 1)
    x = np.repeat(crop[None], BS, 0)
    gen = _gen(5)
    ref, ours = [], []
    for i in range(N_STAT // BS):
        ref.append(np.asarray(jax_deg(jax.random.PRNGKey(i),
                                      jnp.asarray(x))))
        ours.append(port_deg(gen, _t(x)).numpy())
    ref, ours = np.concatenate(ref), np.concatenate(ours)
    lr = CROP // SCALE
    assert ours.shape == ref.shape == (N_STAT, lr, lr, 3)
    assert ours.dtype == np.float32
    assert 0.0 <= ours.min() and ours.max() <= 1.0
    # every output value lies on the 1/255 lattice
    assert np.abs(ours * 255.0 - np.round(ours * 255.0)).max() <= 1e-4
    # the samples of a batch differ from one another and from the
    # strided placeholder
    assert np.abs(ours[0] - ours[1]).max() > 0
    assert np.abs(ours - crop[None, ::SCALE, ::SCALE]).mean() > 1e-3
    print(_gate("bsrgan fixed order", ref, ours, clean))


def test_uint8_wire_and_the_same_seed_twice(degraders):
    _, port_deg = degraders
    x = _smooth(B, CROP, CROP, seed=12)
    x_u8 = torch.from_numpy(np.round(x * 255).astype(np.uint8))
    a = port_deg(_gen(7), x_u8)
    b = port_deg(_gen(7), x_u8)
    c = port_deg(_gen(8), x_u8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    f = port_deg(_gen(7), x_u8.float() / 255.0)
    assert torch.equal(a, f)  # the uint8 wire is normalised on the device
    assert not a.requires_grad


def test_hr_degrader_and_noop():
    ds = parse_dict(_bsrgan_opt(), is_train=True)["datasets"]["train"]
    lr_p, hr_p = P.get_unpaired_params(ds)
    assert hr_p == {} and lr_p["kind"] == "lr"
    assert P.BatchDegrader(ds, "hr").is_noop
    x = torch.rand(2, 8, 8, 3)
    assert P.BatchDegrader(ds, "hr")(_gen(), x) is x
    ds2 = copy.deepcopy(dict(ds))
    ds2.update(hr_noise=True, hr_noise_types=["gaussian"])
    hr_deg = P.BatchDegrader(ds2, "hr")
    assert [n for n, _ in hr_deg.stages] == ["noise"] and not hr_deg.finals
    y = hr_deg(_gen(), x)
    assert y.shape == x.shape and not torch.equal(y, x)


def test_resize_strat_pre_keeps_the_size():
    opt = _bsrgan_opt()
    opt["datasets"]["train"]["resize_strat"] = "pre"
    ds = parse_dict(opt, is_train=True)["datasets"]["train"]
    ds_j = jax_parse_dict(opt, is_train=True)["datasets"]["train"]
    assert P.get_unpaired_params(ds) == JP.get_unpaired_params(ds_j)
    deg = P.BatchDegrader(ds, "lr")
    assert "resize" not in [n for n, _ in deg.stages]
    assert deg._att_cfg is None
    y = deg(_gen(), torch.rand(3, 32, 32, 3))
    assert y.shape == (3, 32, 32, 3)


@pytest.mark.parametrize("extra, item", [
    ({"lr_blur_types": ["motion"]}, "Queue A 5.2"),
    ({"lr_noise_types": ["speckle"]}, "Queue A 5.2"),
    ({"lr_unsharp_mask": True}, "Queue A 5.2"),
    ({"dataroot_kernels": "/nonexistent"}, "Queue A 5.2"),
    ({"lr_downscale_types": [999]}, "Queue A 5.2"),
    ({"lr_auto_levels": True}, "Queue A 5.2"),
])
def test_options_outside_the_slice_raise(extra, item):
    opt = _bsrgan_opt()
    opt["datasets"]["train"].update(extra)
    ds = parse_dict(opt, is_train=True)["datasets"]["train"]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        P.BatchDegrader(ds, "lr")
