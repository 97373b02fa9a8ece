"""The realsr and combo strategies of the port against the JAX package's:
the realistic assets (``trainner_tpu_torch/data/kernels.py``: a KernelGAN
pool of ``.npy`` and ``.mat`` kernels, noise patches cut from PNGs, all
written from seeds under a temporary directory), the preset merges, the
``BatchDegrader`` stage lists with and without the assets, every option of
the slice building a degrader, the webp refusal, both strategies under the
statistical gates of ``test_torch_pipeline.py``, and two steps of the
training CLI on the debug config with combo and its assets.

Tolerances are stated at each test; banks and stage lists are exact.
"""

import copy
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import _fractal, _gate, _gen, _smooth, _t
from trainner_tpu.data import kernels as JK
from trainner_tpu.data import pipeline as JP
from trainner_tpu.options.config import parse_dict as jax_parse_dict
from trainner_tpu_torch.data import kernels as K
from trainner_tpu_torch.data import pipeline as P
from trainner_tpu_torch.data.common import save_img
from trainner_tpu_torch.ops import degradations as D
from trainner_tpu_torch.options.config import parse_dict

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCALE, CROP = 4, 64


@pytest.fixture(autouse=True)
def _conv_path(monkeypatch):
    """The JAX side blurs by its conv path (cross-correlation)."""
    monkeypatch.setenv("TRAINNER_BLUR_FFT", "0")


def write_assets(root, seed=0, n_kernels=6, noise_px=40):
    """A seeded KernelGAN-style pool under ``root/kernels`` (anisotropic
    gaussians: ``n_kernels`` ``.npy`` of 21 x 21, one of 25 x 25 that the
    loader crops, one ``.mat``, one that sums to 0 and one text file, both
    skipped) and 4 noise PNGs under ``root/noise`` (0.5 plus a little 1/f
    noise). Returns (kernels dir, noise dir)."""
    from scipy.io import savemat

    rng = np.random.RandomState(seed)
    kdir, ndir = pathlib.Path(root) / "kernels", pathlib.Path(root) / "noise"
    kdir.mkdir(parents=True)
    ndir.mkdir(parents=True)

    def gauss(size):
        ax = np.arange(size) - (size - 1) / 2
        xx, yy = np.meshgrid(ax, ax)
        t = rng.uniform(0, np.pi)
        sx, sy = rng.uniform(0.6, 3.0, 2)
        xr = np.cos(t) * xx + np.sin(t) * yy
        yr = -np.sin(t) * xx + np.cos(t) * yy
        k = np.exp(-0.5 * ((xr / sx) ** 2 + (yr / sy) ** 2))
        return k * rng.uniform(0.5, 2.0)  # the loader normalises

    for i in range(n_kernels):
        np.save(kdir / f"k{i:02d}.npy", gauss(21).astype(np.float32))
    np.save(kdir / "k_big.npy", gauss(25))
    savemat(str(kdir / "k_mat.mat"), {"Kernel": gauss(19)})
    np.save(kdir / "k_zero.npy", np.zeros((21, 21)))
    (kdir / "notes.txt").write_text("not a kernel")
    for i in range(4):
        noise = _fractal(noise_px, seed=100 + i, alpha=0.3)
        img = 0.5 + (noise - noise.mean()) * 0.15
        save_img(np.round(np.clip(img, 0, 1) * 255).astype(np.uint8),
                 str(ndir / f"n{i}.png"))
    return str(kdir), str(ndir)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return write_assets(tmp_path_factory.mktemp("assets"))


def _opt(strategy, assets=None, **ds):
    train = {"name": "s", "mode": "aligned", "dataroot_HR": "/nonexistent",
             "augs_strategy": strategy, "crop_size": CROP, "batch_size": 8,
             **ds}
    if assets is not None:
        train.update(dataroot_kernels=assets[0], noise_data=assets[1])
    return {"scale": SCALE, "model": "sr", "datasets": {"train": train}}


def _both_ds(opt):
    return (parse_dict(copy.deepcopy(opt), is_train=True)["datasets"]
            ["train"],
            jax_parse_dict(copy.deepcopy(opt), is_train=True)["datasets"]
            ["train"])


# ---------------------------------------------------------------------------
# the assets
# ---------------------------------------------------------------------------


def test_kernel_pool_equals_jax_bit_for_bit(assets):
    got, want = K.load_kernel_pool(assets[0]), JK.load_kernel_pool(assets[0])
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (8, 21, 21)  # 6 + the big + the .mat
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(axis=(1, 2)), 1.0, atol=1e-5)
    np.testing.assert_array_equal(K.load_kernel_pool(assets[0], 15, 3),
                                  JK.load_kernel_pool(assets[0], 15, 3))
    assert K.load_kernel_pool(assets[1]) is None  # no kernel there
    assert K.load_kernel_pool("/nonexistent") is None


@pytest.mark.parametrize("h, w, size", [(25, 25, 21), (19, 23, 21),
                                        (21, 21, 21), (8, 30, 11)])
def test_center_fit_equals_jax(h, w, size):
    k = np.random.RandomState(h * w).rand(h, w)
    np.testing.assert_array_equal(K._center_fit(k, size),
                                  JK._center_fit(k, size))


@pytest.mark.parametrize("patch, n, gray", [(16, 256, False), (32, 10, True),
                                            (64, 8, False)])
def test_noise_patches_equal_jax_bit_for_bit(assets, patch, n, gray):
    got = K.load_noise_patches(assets[1], patch, n, gray, seed=3)
    want = JK.load_noise_patches(assets[1], patch, n, gray, seed=3)
    if patch > 40:  # larger than every image
        assert got is None and want is None
        return
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert np.abs(got.mean(axis=(1, 2))).max() < 1e-6


def test_apply_kernel_pool_matches_jax(assets):
    """1e-5 absolute: the pool kernels of the JAX draws, the blur, the
    aligned subsample."""
    bank = JK.load_kernel_pool(assets[0])
    x = _smooth(6, 32, 32, seed=3)
    key = jax.random.PRNGKey(5)
    idx = jax.random.randint(key, (6,), 0, bank.shape[0])
    want = np.asarray(JK.apply_kernel_pool(key, jnp.asarray(x), bank, 4))
    got = K.apply_kernel_pool(_t(x), torch.from_numpy(bank), _t(idx),
                              4).numpy()
    assert got.shape == (6, 8, 8, 3)
    assert np.abs(got - want).max() <= 1e-5
    same = K.apply_kernel_pool(_t(x), torch.from_numpy(bank), _t(idx))
    assert same.shape == (6, 32, 32, 3)


@pytest.mark.parametrize("shape", [(5, 16, 16, 3), (5, 40, 24, 3),
                                   (5, 16, 16, 1)])
def test_apply_noise_patches_matches_jax(assets, shape):
    """1e-6 absolute: the JAX draws' patches, tiled, flipped where drawn,
    clipped; a one-channel bank repeats on every channel."""
    gray = shape[-1] == 1 or shape[1] == 40
    bank = JK.load_noise_patches(assets[1], 16, 32, gray)
    x = _smooth(5, shape[1], shape[2], seed=4)[..., :shape[-1]]
    key = jax.random.PRNGKey(6)
    r1, r2 = jax.random.split(key)
    params = {"idx": _t(jax.random.randint(r1, (5,), 0, bank.shape[0])),
              "flip": _t(jax.random.uniform(r2, (5, 1, 1, 1)) < 0.5)}
    want = np.asarray(JK.apply_noise_patches(key, jnp.asarray(x), bank))
    got = K.apply_noise_patches(_t(x), torch.from_numpy(bank),
                                params).numpy()
    assert got.shape == x.shape
    assert np.abs(got - want).max() <= 1e-6
    drawn = K.draw_noise_patches(_gen(), 5, bank.shape[0])
    assert drawn["idx"].shape == (5,) and drawn["flip"].dtype == torch.bool


# ---------------------------------------------------------------------------
# presets and stage lists
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["realsr", "combo"])
def test_preset_merges_equal_jax(strategy):
    """The resolved train dataset equals the JAX package's key for key
    (realsr has no blur preset: both skip the axis)."""
    got, want = _both_ds(_opt(strategy))
    assert got == want
    if strategy == "realsr":
        assert got["resize_strat"] == "pre" and "lr_blur" not in got
        assert got["lr_noise_types"] == ["patches"]
        assert got["lr_downscale_types"] == [999]
    else:
        assert got["lr_blur_types"] == {"aniso": 0.3, "iso": 0.56,
                                        "median": 0.02, "motion": 0.02,
                                        "sinc": 0.1}
        assert 999 in got["lr_downscale_types"]
        assert got["shuffle_degradations"] is True


# strategy -> its stages and finals, with or without the assets
STAGE_LISTS = {
    "combo": (["blur", "resize", "noise", "compression", "blur2", "resize2",
               "noise2"], ["final_scale", "final_blur", "final_compression"]),
    "realsr": (["noise"], []),
}


@pytest.mark.parametrize("strategy", ["combo", "realsr"])
@pytest.mark.parametrize("with_assets", [False, True])
def test_stage_lists_equal_jax(assets, strategy, with_assets):
    ds_p, ds_j = _both_ds(_opt(strategy, assets if with_assets else None))
    port, ref = P.BatchDegrader(ds_p, "lr"), JP.BatchDegrader(ds_j, "lr")
    names, finals = STAGE_LISTS[strategy]
    assert [n for n, _ in port.stages] == [n for n, _ in ref.stages] == names
    assert [n for n, _ in port.finals] == [n for n, _ in ref.finals] \
        == finals
    # which stages carry a plain and an attenuated variant
    assert [n for n, f in port.stages if isinstance(f, dict)] \
        == [n for n, f in ref.stages if isinstance(f, dict)]
    assert port._att_cfg == ref._att_cfg
    for mine, theirs in ((port.kernel_bank, ref.kernel_bank),
                         (port.patch_bank, ref.patch_bank)):
        assert (mine is None) == (theirs is None)
        if mine is not None:
            np.testing.assert_array_equal(mine, theirs)
    stages = dict(port.stages)
    if with_assets:
        assert port.kernel_bank is not None and port.patch_bank is not None
        assert port.patch_bank.shape[1:] == (16, 16, 3)  # the LR crop size
        if strategy == "combo":
            # the pool replaces the whole first resize (the other listed
            # types too), and the patches the whole noise stage
            assert stages["resize"] == port._pool_stage
            assert stages["noise"] == port._patches_stage
            assert isinstance(stages["noise2"], dict)
        else:
            assert stages["noise"] == port._patches_stage
    else:
        assert port.kernel_bank is None and port.patch_bank is None
        if strategy == "combo":
            assert stages["resize"] != port._pool_stage
            assert isinstance(stages["noise"], dict)


def test_a_kernel_root_that_is_no_directory_gives_no_pool(assets, tmp_path):
    ds_p, ds_j = _both_ds(_opt("combo", (str(tmp_path / "none"), assets[1])))
    assert P.BatchDegrader(ds_p, "lr").kernel_bank is None
    assert JP.BatchDegrader(ds_j, "lr").kernel_bank is None


# every option of the slice without a preset: each builds a degrader on
# the CPU and degrades a batch
SLICE_OPTIONS = {
    "motion blur": {"lr_blur_types": ["motion"]},
    "complex motion and box blur": {"lr_blur_types": ["complexmotion",
                                                      "box"]},
    "median and bilateral blur": {"lr_blur_types": ["median", "bilateral",
                                                    "iso"]},
    "speckle noise": {"lr_noise_types": ["speckle"]},
    "s&p noise": {"lr_noise_types": ["s&p", "sp"]},
    "quantize": {"lr_noise_types": ["quantize", "km_quantize",
                                    "simple_quantize"]},
    "dither": {"lr_noise_types": ["dither", "bayer_dither", "bwdither",
                                  "avgbw_dither", "bin_dither", "rnd_dither",
                                  "fs_dither"]},
    "clahe, superpixels, maxrgb": {"lr_noise_types": ["clahe",
                                                      "superpixels",
                                                      "maxrgb"]},
    "unsharp": {"lr_unsharp_mask": True, "lr_rand_unsharp": 0.7},
    "fringes": {"lr_fringes": True, "lr_fringes_chance": 0.6},
    "auto levels": {"lr_auto_levels": True, "lr_rand_auto_levels": 0.5},
    "resize 999 without a pool": {"lr_downscale_types": [999, 777]},
    "resize 999 with a pool": {"lr_downscale_types": [999], "pool": True},
    "webp approximation": {"compression": ["webp"], "webp": "approx"},
    "an unknown noise type": {"lr_noise_types": ["unknown_noise"]},
}


@pytest.mark.parametrize("case", sorted(SLICE_OPTIONS))
def test_every_option_of_the_slice_builds_and_runs(assets, monkeypatch, case):
    extra = dict(SLICE_OPTIONS[case])
    if extra.pop("webp", None):
        monkeypatch.setenv("TRAINNER_DEVICE_WEBP", "approx")
    pool = extra.pop("pool", False)
    opt = _opt("bsrgan", assets if pool else None, resize_strat="in",
               shuffle_degradations=False, **extra)
    ds_p, ds_j = _both_ds(opt)
    deg = P.BatchDegrader(ds_p, "lr")
    ref = JP.BatchDegrader(ds_j, "lr")
    assert [n for n, _ in deg.stages] == [n for n, _ in ref.stages]
    y = deg(_gen(), _t(_smooth(4, CROP, CROP, seed=1)))
    assert y.shape == (4, CROP // SCALE, CROP // SCALE, 3)
    assert torch.isfinite(y).all() and 0 <= y.min() and y.max() <= 1


def test_webp_without_the_approximation_names_its_item(monkeypatch):
    """The exact codec is a host callback through OpenCV, which a CUDA
    graph cannot hold: without ``TRAINNER_DEVICE_WEBP=approx`` the port
    refuses and names ROADMAP Queue A 5.5 (no quiet fallback)."""
    monkeypatch.delenv("TRAINNER_DEVICE_WEBP", raising=False)
    ds = parse_dict(_opt("bsrgan", compression=["webp"]),
                    is_train=True)["datasets"]["train"]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A 5.5"):
        P.BatchDegrader(ds, "lr")


def test_webp_approximation_is_the_jpeg_approximation(monkeypatch):
    monkeypatch.setenv("TRAINNER_DEVICE_WEBP", "approx")
    x = _t(_smooth(3, 16, 16, seed=2))
    webp = P._noise_op("webp", {"min_quality": 40, "max_quality": 60})
    jpeg = P._noise_op("jpeg", {"min_quality": 40, "max_quality": 60})
    assert torch.equal(webp(_gen(3), x), jpeg(_gen(3), x))


@pytest.mark.parametrize("types, nonlinear", [(["median"], "median"),
                                              (["bilateral", "iso"],
                                               "bilateral")])
def test_blur_stage_nonlinear_candidates_match_jax(types, nonlinear):
    """With p 1 and one type (or the nonlinear type drawn for every
    sample) the stage is the exact filter: 1e-5 absolute."""
    cfgs = {"median": {"p": 1.0, "kernel_size": 4},
            "bilateral": {"p": 1.0, "kernel_size": 7, "sigmaColor": 30,
                          "sigmaSpace": 5}, "iso": {"p": 1.0}}
    x = _smooth(4, 24, 24, seed=5)
    weights = [1.0] + [0.0] * (len(types) - 1)
    want = np.asarray(JP._blur_stage(types, cfgs, 1.0, weights)(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    got = P._blur_stage(types, cfgs, 1.0, weights)(_gen(), _t(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5
    direct = (D.median_blur(_t(x), 5) if nonlinear == "median"
              else D.bilateral_blur(_t(x), 7, 30.0, 5.0)).numpy()
    assert np.abs(got - direct).max() <= 1e-6


# ---------------------------------------------------------------------------
# the strategies end to end
# ---------------------------------------------------------------------------


N_STAT, BS = 192, 64


def _run_both(ds_p, ds_j, x):
    jax_deg, port_deg = JP.BatchDegrader(ds_j, "lr"), P.BatchDegrader(ds_p,
                                                                      "lr")
    gen = _gen(5)
    ref, ours = [], []
    for i in range(N_STAT // BS):
        ref.append(np.asarray(jax_deg(jax.random.PRNGKey(i),
                                      jnp.asarray(x))))
        ours.append(port_deg(gen, _t(x)).numpy())
    ref, ours = np.concatenate(ref), np.concatenate(ours)
    assert ours.shape == ref.shape
    assert 0.0 <= ours.min() and ours.max() <= 1.0
    assert np.abs(ours * 255.0 - np.round(ours * 255.0)).max() <= 1e-4
    return ref, ours


def test_combo_statistics_match_jax(assets):
    """combo with its kernel pool and noise patches, in the fixed order
    (the stages of the shuffled program are the same): 192 samples of one
    1/f crop on each side, within the five gates of
    ``test_torch_pipeline.py``."""
    from trainner_tpu.ops.imresize import imresize_np

    ds_p, ds_j = _both_ds(_opt("combo", assets, batch_size=BS,
                               shuffle_degradations=False))
    crop = np.round(_fractal(CROP, seed=11) * 255.0).astype(np.float32) / 255
    clean = np.clip(imresize_np(crop, 1.0 / SCALE, kernel="cubic"), 0, 1)
    ref, ours = _run_both(ds_p, ds_j, np.repeat(crop[None], BS, 0))
    assert ours.shape == (N_STAT, CROP // SCALE, CROP // SCALE, 3)
    print(_gate("combo fixed order, with assets", ref, ours, clean))


def test_realsr_statistics_match_jax(assets):
    """realsr: the LR crop (the dataset's bicubic; ``resize_strat: pre``)
    plus a real-noise patch per sample, within the five gates."""
    ds_p, ds_j = _both_ds(_opt("realsr", assets, batch_size=BS))
    lr = np.round(_fractal(CROP // SCALE, seed=12) * 255.0).astype(
        np.float32) / 255
    ref, ours = _run_both(ds_p, ds_j, np.repeat(lr[None], BS, 0))
    assert np.abs(ours - lr[None]).mean() > 1e-3
    print(_gate("realsr, with patches", ref, ours, lr))


def test_combo_shuffled_program_runs(assets):
    """The routed per-sample shuffle over combo's seven stages, the pool
    as its resize."""
    ds = parse_dict(_opt("combo", assets, batch_size=7),
                    is_train=True)["datasets"]["train"]
    deg = P.BatchDegrader(ds, "lr")
    assert deg.program()[0] == "routing"
    y = deg(_gen(), _t(_smooth(7, CROP, CROP, seed=6)))
    assert y.shape == (7, CROP // SCALE, CROP // SCALE, 3)
    assert torch.isfinite(y).all()


def test_cli_trains_two_steps_with_combo_and_its_assets(assets, tmp_path):
    """``python -m trainner_tpu_torch.train`` on the debug config with
    ``augs_strategy: combo``, the pool and the patches: two steps."""
    from trainner_tpu_torch.train import main
    from trainner_tpu_torch.utils.logging_utils import close_logger

    text = (ROOT / "options" / "sr" / "train_sr_debug.yml").read_text()
    text = text.replace("root: /tmp/trainner_tpu_debug",
                        f"root: {tmp_path / 'run'}")
    text = text.replace("    use_shuffle: true\n", (
        "    use_shuffle: true\n    augs_strategy: combo\n"
        f"    dataroot_kernels: {assets[0]}\n"
        f"    noise_data: {assets[1]}\n"))
    text = text.replace("  niter: 12\n", "  niter: 2\n")
    path = tmp_path / "combo.yml"
    path.write_text(text)
    for name in ("base", "val"):
        close_logger(name)
    try:
        state = main(["-opt", str(path)], device="cpu")
    finally:
        for name in ("base", "val"):
            close_logger(name)
    assert state.step == 2
    assert all(torch.isfinite(p).all() for p in state.g.net.parameters())
