"""The resrgan degradations of the port against the JAX package's: sinc
kernels and Poisson noise on the JAX side's own draws, ``resize_batch`` at
the cv2-style codes 0-6 (``jax.image.resize``), the new stages (sinc in
``_blur_stage`` in both cycles, poisson in ``_noise_stage``, the
``final_blur`` final) with nothing random left or with deterministic
stand-ins, and the whole fixed-order resrgan ``BatchDegrader`` under the
statistical gates of ``test_torch_pipeline.py`` on its 1/f fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import _both, _fractal, _gate, _gen, _smooth, _t
from trainner_tpu.data import pipeline as JP
from trainner_tpu.ops import degradations as JD
from trainner_tpu.ops.imresize import imresize_np
from trainner_tpu.options.config import parse_dict as jax_parse_dict
from trainner_tpu_torch.data import pipeline as P
from trainner_tpu_torch.ops import degradations as D
from trainner_tpu_torch.options.config import parse_dict

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _conv_path(monkeypatch):
    """The JAX side blurs by its conv path (cross-correlation)."""
    monkeypatch.setenv("TRAINNER_BLUR_FFT", "0")


# ---------------------------------------------------------------------------
# the ops on the JAX side's draws
# ---------------------------------------------------------------------------


def test_sinc_kernels_match_jax_on_its_draws():
    """64 kernels of k 21 with random odd supports (7 to 21: 7, 11, 13 and
    21 among them, either side of the pi/3 | pi/5 cutoff floor), on the
    JAX side's draws: 1e-6."""
    b, k = 64, 21
    key = jax.random.PRNGKey(4)
    r1, r2, _ = jax.random.split(key, 3)
    v = np.asarray(jax.random.randint(r2, (b, 1, 1), 7, k + 1))
    u = np.asarray(jax.random.uniform(r1, (b,)))
    sizes = set((v + (v % 2 == 0)).ravel().tolist())
    assert {7, 11, 13, 21} <= sizes
    want = np.asarray(JD.sinc_kernels(key, b, k, None, 7))
    got = D.sinc_kernels({"u": _t(u), "support": _t(v).long()}, k).numpy()
    assert np.abs(got - want).max() <= 1e-6
    np.testing.assert_allclose(got.sum(axis=(1, 2)), 1.0, atol=1e-6)


@pytest.mark.parametrize("cutoff", [0.6, 1.5, 3.0])
def test_sinc_kernels_fixed_cutoff_match_jax(cutoff):
    """A ``min_cutoff`` fixes the cutoff and keeps the full support."""
    want = np.asarray(JD.sinc_kernels(jax.random.PRNGKey(0), 3, 21,
                                      (cutoff, cutoff), 7))
    params = D.draw_sinc_kernels(_gen(), 3, 21, (cutoff, cutoff), 7)
    got = D.sinc_kernels(params, 21).numpy()
    assert np.abs(got - want).max() <= 1e-6


def test_sinc_and_gaussian_kernels_are_centrosymmetric():
    """Both kernel families equal their 180-degree turn, so the JAX FFT
    path's flip of the kernel does not change what they blur."""
    gen = _gen(3)
    for kern in (D.sinc_kernels(D.draw_sinc_kernels(gen, 8, 21), 21),
                 D.gaussian_kernels(D.draw_gaussian_kernels(
                     gen, 8, 21, (0.2, 3.0), 0.0, (0.2, 3.0), 7), 21)):
        torch.testing.assert_close(kern, kern.flip(1, 2), atol=1e-7, rtol=0)


def test_poisson_noise_matches_jax_on_its_draws():
    x = _smooth(5, 16, 24)
    key = jax.random.PRNGKey(2)
    r1, r2 = jax.random.split(key)
    scale = np.asarray(jax.random.uniform(r1, (5, 1, 1, 1), minval=0.05,
                                          maxval=3.0))
    normal = np.asarray(jax.random.normal(r2, x.shape, jnp.float32))
    want = np.asarray(JD.poisson_noise(key, jnp.asarray(x), (0.05, 3.0)))
    got = D.poisson_noise(_t(x), {"scale": _t(scale),
                                  "normal": _t(normal)}).numpy()
    assert np.abs(got - want).max() <= 1e-6
    drawn = D.draw_poisson_noise(_gen(), x.shape, (0.05, 3.0))
    assert drawn["scale"].shape == (5, 1, 1, 1)
    assert 0.05 <= float(drawn["scale"].min()) <= float(
        drawn["scale"].max()) < 3.0


RESIZES = [((32, 32), (8, 8)), ((40, 24), (13, 11)), ((16, 16), (24, 24)),
           ((12, 20), (30, 26)), ((20, 16), (20, 9)), ((128, 128), (32, 32))]


@pytest.mark.parametrize("code", range(7))
@pytest.mark.parametrize("hw, out", RESIZES)
def test_resize_batch_cv2_codes_match_jax(code, hw, out):
    """Codes 0-6 down and up, square and not, an axis kept: 1e-5."""
    x = np.random.RandomState(code).rand(2, *hw, 3).astype(np.float32)
    want = np.asarray(JD.resize_batch(jnp.asarray(x), out, code))
    got = D.resize_batch(_t(x), out, code).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5


# ---------------------------------------------------------------------------
# the stages
# ---------------------------------------------------------------------------

SINC_CFGS = {"sinc": {"p": 1.0, "kernel_size": 21, "min_kernel_size": 7,
                      "min_cutoff": 1.1},
             "sinc2": {"p": 1.0, "kernel_size": 13, "min_kernel_size": 7,
                       "min_cutoff": 2.2}}


@pytest.mark.parametrize("cycle", [1, 2])
def test_sinc_blur_stage_matches_jax(cycle):
    """A fixed cutoff leaves nothing random: the stage against JAX's, the
    second cycle reading ``sinc2``."""
    x = _smooth(4, 24, 32)
    got, want = _both(JP._blur_stage(["sinc"], SINC_CFGS, 1.0, cycle=cycle),
                      P._blur_stage(["sinc"], SINC_CFGS, 1.0, cycle=cycle),
                      x)
    assert np.abs(got - want).max() <= 1e-5
    assert np.abs(got - x).max() > 1e-3


def _poisson_stand_ins(monkeypatch):
    """Poisson noise made deterministic on both sides: y = x + 0.01 scale
    (x - 0.5) with the scale range's low end."""
    monkeypatch.setattr(JD, "poisson_noise", lambda rng, x, scale_range: (
        x + 0.01 * scale_range[0] * (x - 0.5)))
    monkeypatch.setattr(D, "draw_poisson_noise", lambda gen, shape, sr: {
        "s": sr[0]})
    monkeypatch.setattr(D, "poisson_noise", lambda x, params: (
        x + 0.01 * params["s"] * (x - 0.5)))


@pytest.mark.parametrize("v", [None, 0.35, 1.0])
def test_poisson_noise_stage_matches_jax(v, monkeypatch):
    """The stage's config reading (``scale_range``, the second cycle's
    ``poisson2``) and its attenuation, on stand-ins for the draws."""
    _poisson_stand_ins(monkeypatch)
    cfgs = {"poisson": {"p": 1.0, "scale_range": [2.0, 3.0]},
            "poisson2": {"p": 1.0, "scale_range": [4.0, 5.0]}}
    x = _smooth(4, 16, 16)
    atten = None if v is None else {"chain_cfg": None}
    kw = {} if v is None else {"att": (np.full((4, 1, 1, 1), v, np.float32),
                                       np.full((4, 1, 1, 1), v, np.float32))}
    for cycle in (1, 2):
        got, want = _both(
            JP._noise_stage(["poisson"], cfgs, 1.0, atten=atten,
                            cycle=cycle),
            P._noise_stage(["poisson"], cfgs, 1.0, atten=atten,
                           cycle=cycle), x, **kw)
        assert np.abs(got - want).max() <= 1e-5, cycle
        assert np.abs(got - x).max() > 1e-4


def _resrgan_opt(crop=64, b=64, **extra):
    return {"scale": 4, "model": "sr", "datasets": {"train": {
        "name": "p", "mode": "aligned", "dataroot_HR": "/nonexistent",
        "augs_strategy": "resrgan", "crop_size": crop, "batch_size": b,
        **extra}}}


@pytest.fixture(scope="module")
def degraders():
    ds_j = jax_parse_dict(_resrgan_opt(), is_train=True)["datasets"]["train"]
    ds_p = parse_dict(_resrgan_opt(), is_train=True)["datasets"]["train"]
    return JP.BatchDegrader(ds_j, "lr"), P.BatchDegrader(ds_p, "lr")


def test_resrgan_stage_and_final_names_match_jax(degraders):
    jax_deg, port_deg = degraders
    assert [n for n, _ in port_deg.stages] == [n for n, _ in jax_deg.stages] \
        == ["blur", "resize", "noise", "compression", "blur2", "resize2",
            "noise2"]
    assert [n for n, _ in port_deg.finals] == [n for n, _ in jax_deg.finals] \
        == ["final_scale", "final_blur", "final_compression"]
    assert port_deg._att_cfg == jax_deg._att_cfg
    assert P.get_unpaired_params(port_deg.opt) == \
        JP.get_unpaired_params(jax_deg.opt)


def test_final_blur_stage_matches_jax():
    """The ``final_blur`` final of a resrgan degrader, its sinc at a fixed
    cutoff, against JAX's, on the LR canvas."""
    extra = {"aug_configs": {"sinc": {"min_cutoff": 1.4}},
             "final_blur_prob": 1.0}
    ds_j = jax_parse_dict(_resrgan_opt(**extra), is_train=True)[
        "datasets"]["train"]
    ds_p = parse_dict(_resrgan_opt(**extra), is_train=True)[
        "datasets"]["train"]
    (jn, jfb), (pn, pfb) = (JP.BatchDegrader(ds_j, "lr")._resize_finals[1],
                            P.BatchDegrader(ds_p, "lr")._resize_finals[1])
    assert jn == pn == "final_blur"
    x = _smooth(4, 16, 16)
    got, want = _both(jfb, pfb, x)
    assert np.abs(got - want).max() <= 1e-5
    assert np.abs(got - x).max() > 1e-3


def test_finals_orders_on_stand_ins(degraders):
    """The finals with deterministic stand-ins for the three stages: each
    sample of the port's output is one of JAX's two orders,
    [final_scale + final_blur] then [final_compression] or the other way
    round, each stage's output on the 1/255 lattice; both orders occur."""
    jax_deg, port_deg = degraders
    fns = {"final_scale": lambda x: 0.9 * x, "final_blur": lambda x:
           x + 0.05, "final_compression": lambda x: x * x}
    x = _smooth(32, 8, 8)
    orders = []
    for order in ((("final_scale", "final_blur"), ("final_compression",)),
                  (("final_compression",), ("final_scale", "final_blur"))):
        y = jnp.asarray(x)
        for seg in order:
            for name in seg:
                y = JP._q8(fns[name](y))
        orders.append(np.asarray(JP._q8(y)))
    stand = [(n, (lambda f: lambda gen, x: f(x))(fns[n]))
             for n, _ in port_deg.finals]
    saved = port_deg._resize_finals, port_deg._comp_finals
    try:
        port_deg._resize_finals, port_deg._comp_finals = stand[:2], stand[2:]
        got = P._q8(port_deg._finals(_gen(3), _t(x))).numpy()
    finally:
        port_deg._resize_finals, port_deg._comp_finals = saved
    err = np.stack([np.abs(got - o).reshape(32, -1).max(1) for o in orders])
    assert np.all(err.min(0) <= 1e-6)
    assert (err[0] <= 1e-6).any() and (err[1] <= 1e-6).any()


def test_resrgan_pipeline_statistics_match_jax(degraders):
    """256 samples of one 1/f crop through the whole fixed-order resrgan
    program on each side: in [0, 1] on the 1/255 lattice, and within the
    five statistical gates of ``test_torch_pipeline.py``."""
    jax_deg, port_deg = degraders
    crop = _fractal(64, seed=11)
    crop = np.round(crop * 255.0).astype(np.float32) / 255.0
    clean = np.clip(imresize_np(crop, 0.25, kernel="cubic"), 0, 1)
    x = np.repeat(crop[None], 64, 0)
    gen = _gen(5)
    ref, ours = [], []
    for i in range(4):
        ref.append(np.asarray(jax_deg(jax.random.PRNGKey(i),
                                      jnp.asarray(x))))
        ours.append(port_deg(gen, _t(x)).numpy())
    ref, ours = np.concatenate(ref), np.concatenate(ours)
    assert ours.shape == ref.shape == (256, 16, 16, 3)
    assert 0.0 <= ours.min() and ours.max() <= 1.0
    assert np.abs(ours * 255.0 - np.round(ours * 255.0)).max() <= 1e-4
    print(_gate("resrgan fixed order", ref, ours, clean))


def test_resrgan_shuffled_program_runs():
    """``shuffle_degradations: true`` with the resrgan stages: the routed
    program of the per-sample shuffle takes the new stages as they are."""
    ds = parse_dict(_resrgan_opt(b=6, shuffle_degradations=True),
                    is_train=True)["datasets"]["train"]
    deg = P.BatchDegrader(ds, "lr")
    assert deg.program()[0] == "routing"
    y = deg(_gen(), _t(_smooth(6, 64, 64)))
    assert y.shape == (6, 16, 16, 3) and torch.isfinite(y).all()
