"""The host's exact degradations of the port
(``trainner_tpu_torch/data/host_degradations.py``,
``data/host_superpixels.py``, ``AlignedDataset._host_degrade`` and
``otf_mode: host``) against the JAX package's on the CPU: every op bit for
bit on one seeded image; ``_host_degrade`` on the same draws for each
branch of its options; ``otf_mode: host`` samples bit for bit with the JAX
dataset's under one patched generator; the superpixel transform in each
algorithm, colouring and reduction with equal outputs (both packages run
the same numpy segmenters, so the labels agree exactly and no pixel share
needs a bound); and without OpenCV each op of it raises an error that
names the op, while the gaussian noise and a superpixel path that needs
no OpenCV still run.
"""

import builtins

import numpy as np
import pytest

from trainner_tpu.data import datasets as jax_datasets
from trainner_tpu.data import host_degradations as JH
from trainner_tpu.data import host_superpixels as JS
from trainner_tpu_torch.data import datasets
from trainner_tpu_torch.data import host_degradations as H
from trainner_tpu_torch.data import host_superpixels as S
from trainner_tpu_torch.data.common import save_img


def _img(shape=(24, 28, 3), seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


OPS = {
    "jpeg": lambda m, x: m.jpeg_compress_exact(x, 40),
    "webp": lambda m, x: m.webp_compress_exact(x, 60),
    "gaussian_blur": lambda m, x: m.gaussian_blur_exact(x, 11, 1.3),
    "motion_blur": lambda m, x: m.motion_blur_exact(x, 7, 33.0),
    "gaussian_noise": lambda m, x: m.gaussian_noise_exact(
        x, 12.0, np.random.default_rng(3)),
    "gaussian_noise_gray": lambda m, x: m.gaussian_noise_exact(
        x, 12.0, np.random.default_rng(3), gray=True),
    "clahe": lambda m, x: m.clahe_exact(x),
}


@pytest.mark.parametrize("op", list(OPS))
def test_each_op_bit_for_bit(op):
    x = _img()
    want, got = OPS[op](JH, x), OPS[op](H, x)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


HOST_OPTS = {
    "gaussian-blur-noise": {"lr_blur": True, "lr_blur_types": ["gaussian"],
                            "lr_noise": True,
                            "lr_noise_types": ["gaussian"]},
    "motion-jpeg": {"lr_blur": True, "lr_blur_types": ["motion"],
                    "blur_prob": 0.7, "lr_noise": True,
                    "lr_noise_types": ["JPEG", "webp"]},
    "clahe-compression": {"lr_noise": True, "lr_noise_types": ["clahe"],
                          "compression": ["jpeg"]},
    "superpixels": {"lr_noise": True, "lr_noise_types": ["superpixels"],
                    "sp_n_segments": 12, "sp_algo": "sk_slic",
                    "sp_kind": "avg", "sp_p_replace": 0.5},
}


@pytest.mark.parametrize("name", list(HOST_OPTS))
def test_host_degrade_on_shared_draws(name):
    opt = {"phase": "val", "dataroot_HR": "/unused", **HOST_OPTS[name]}
    jds = jax_datasets.AlignedDataset.__new__(jax_datasets.AlignedDataset)
    pds = datasets.AlignedDataset.__new__(datasets.AlignedDataset)
    jds.opt = pds.opt = opt
    for seed in range(4):
        x = _img((16, 20, 3), seed)
        want = jds._host_degrade(x, np.random.default_rng(seed))
        got = pds._host_degrade(x, np.random.default_rng(seed))
        assert got.dtype == np.float32
        assert np.array_equal(got, want), seed


def test_otf_mode_host_samples_match_jax(tmp_path, monkeypatch):
    """A train dataset with ``otf_mode: host``: no strided placeholder (the
    host's LR is the bicubic one, then degraded), no uint8 fast path, and
    the JAX samples bit for bit."""
    rng = np.random.default_rng(1)
    for i in range(3):
        save_img((rng.random((40, 44, 3)) * 255).astype(np.uint8),
                 str(tmp_path / f"im{i}.png"))
    opt = {"phase": "train", "scale": 4, "crop_size": 16,
           "dataroot_HR": str(tmp_path), "otf_mode": "host",
           "wire_dtype": "uint8", "lr_blur": True, "lr_noise": True,
           "lr_noise_types": ["gaussian", "jpeg"]}
    jds = jax_datasets.AlignedDataset(dict(opt))
    pds = datasets.AlignedDataset(dict(opt))
    assert pds.host_otf and not pds.skip_host_lr and not pds._fast_u8
    real = np.random.default_rng
    for i in range(3):
        out = []
        for ds in (jds, pds):
            monkeypatch.setattr(np.random, "default_rng",
                                lambda s=None, i=i: real(40 + i))
            out.append(ds[i])
        monkeypatch.setattr(np.random, "default_rng", real)
        for k in ("LR", "HR"):
            assert np.array_equal(out[0][k], out[1][k]), (i, k)


SP_CASES = [(algo, kind, red) for algo in ("slic", "sk_slic",
                                           "sk_felzenszwalb")
            for kind in ("avg", "median", "mix")
            for red in (None, "selective", "cluster", "rag")]


@pytest.mark.parametrize("algo, kind, reduction", SP_CASES)
def test_superpixels_match_jax(algo, kind, reduction):
    import cv2

    x = _img((40, 36, 3), 2)
    out = []
    for mod in (JS, S):
        cv2.setRNGSeed(0)  # the cluster reduction's k-means draws
        out.append(mod.superpixels(x, n_segments=10, algo=algo, kind=kind,
                                   reduction=reduction, max_size=32))
    assert out[1].dtype == np.float32 and out[1].shape == x.shape
    assert np.array_equal(out[0], out[1])


def test_segmenters_and_partial_replace_match_jax():
    x = _img((20, 18, 3), 4)
    assert np.array_equal(S.felzenszwalb(x, 10.0, 0.8, 7),
                          JS.felzenszwalb(x, 10.0, 0.8, 7))
    labels = S.slic(x, 9, 10.0, 5, 1.0)
    assert np.array_equal(labels, JS.slic(x, 9, 10.0, 5, 1.0))
    samples = [True, False, True]
    assert np.array_equal(S.label2rgb(labels, x, "mix", samples),
                          JS.label2rgb(labels, x, "mix", samples))
    assert np.array_equal(S.rag_merge(x, labels), JS.rag_merge(x, labels))
    assert S.superpixels(x, replace_samples=[False]) is x


@pytest.fixture
def no_cv2(monkeypatch):
    real_import = builtins.__import__

    def refuse(name, *args, **kw):
        if name == "cv2":
            raise ImportError("no cv2 here")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", refuse)


@pytest.mark.parametrize("op", [o for o in OPS if "noise" not in o])
def test_without_opencv_each_op_raises_its_name(no_cv2, op):
    with pytest.raises(H.HostOpUnavailable,
                       match=rf"\[{op}.*OpenCV.*ROADMAP C 20"):
        OPS[op](H, _img())


def test_without_opencv_what_needs_none_still_runs(no_cv2):
    x = _img((20, 18, 3), 4)
    want = JH.gaussian_noise_exact(x, 9.0, np.random.default_rng(1))
    got = H.gaussian_noise_exact(x, 9.0, np.random.default_rng(1))
    assert np.array_equal(got, want)
    y = S.superpixels(x, n_segments=6, algo="sk_felzenszwalb", cs="rgb",
                      reduction="rag")
    assert y.shape == x.shape
    for kw, what in (({"algo": "slic"}, "pre-blur"),
                     ({"algo": "sk_slic"}, "colour space lab"),
                     ({"algo": "sk_slic", "cs": "rgb", "max_size": 8},
                      "resize to max_size"),
                     ({"algo": "sk_felzenszwalb", "cs": "rgb",
                       "reduction": "cluster", "n_segments": 1},
                      "cluster")):
        with pytest.raises(H.HostOpUnavailable, match=what):
            S.superpixels(x, **kw)
