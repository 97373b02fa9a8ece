"""The video datasets (``trainner_tpu_torch/data/video_datasets.py``), the
dataset factory's video modes and synthetic ``video`` kind, and the loader
on (t, h, w, c) clips, against the JAX package on the CPU: given the same
draws (numpy's ``default_rng`` seeded alike in both), every clip equal to
the JAX one (the bicubic downscale within 1e-6), with and without
``y_only``, ``srcolors``, frame skips and reversal; the sliding windows of
a test folder, LR-only and LR + HR.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_video_cli import write_videos
from trainner_tpu.data import datasets as JD
from trainner_tpu.data import video_datasets as JV
from trainner_tpu_torch.data import create_dataloader, create_dataset
from trainner_tpu_torch.data import datasets as PD
from trainner_tpu_torch.data import video_datasets as PV
from trainner_tpu_torch.data.loader import device_prefetch

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    write_videos(str(root / "hr"), n_videos=3, n_frames=9, px=48)
    return str(root)


def _same_draws(monkeypatch, seed):
    """Every ``np.random.default_rng()`` of both packages' datasets starts
    from ``seed``."""
    orig = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda s=None: orig(seed if s is None else s))


def _equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
            np.testing.assert_allclose(got[k], w, atol=1e-6)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("extra", [
    {}, {"max_frameskip": 3, "random_reverse": True},
    {"y_only": True}, {"y_only": True, "srcolors": True, "num_frames": 5},
    {"crop_size": 40}])
def test_train_clips_match_jax_given_the_same_draws(videos, monkeypatch,
                                                    extra):
    opt = {"name": "v", "mode": "video", "phase": "train", "scale": 4,
           "dataroot_HR": os.path.join(videos, "hr"), "crop_size": 32,
           "num_frames": 3, **extra}
    jds, pds = JV.VidTrainDataset(dict(opt)), PV.VidTrainDataset(dict(opt))
    assert len(pds) == len(jds)
    for seed in range(4):
        _same_draws(monkeypatch, seed)
        _equal(pds[seed], jds[seed])


@pytest.mark.parametrize("roots", ["lr_only", "hr_only", "lr_hr", "y_only"])
def test_test_windows_match_jax(videos, roots):
    video = os.path.join(videos, "hr", "video1")
    opt = {"name": "v", "mode": "video", "phase": "test", "scale": 4,
           "num_frames": 3}
    if roots in ("lr_only", "y_only"):
        opt["dataroot_LR"] = video
    if roots == "hr_only":
        opt["dataroot_HR"] = video
    if roots == "lr_hr":
        opt.update(dataroot_LR=video, dataroot_HR=video)
    if roots == "y_only":
        opt["y_only"] = True
    jds, pds = JV.VidTestDataset(dict(opt)), PV.VidTestDataset(dict(opt))
    assert len(pds) == len(jds) == 7
    for i in (0, 3, 6):
        _equal(pds[i], jds[i])


def test_factory_modes_synthetic_video_and_loader(videos):
    hr = os.path.join(videos, "hr")
    for mode in ("video", "vlrhr"):
        train = create_dataset({"mode": mode, "phase": "train",
                                "dataroot_HR": hr, "scale": 4})
        test = create_dataset({"mode": mode, "phase": "val",
                               "dataroot_HR": os.path.join(hr, "video0"),
                               "scale": 4})
        assert type(train).__name__ == "VidTrainDataset"
        assert type(test).__name__ == "VidTestDataset"
    # the deinterlacing mode, once refused here (ROADMAP Queue A 10.6):
    # its frames' pairs (test_torch_dvd.py holds it against JAX's)
    assert type(create_dataset({"mode": "dvd", "dataroot_HR": hr})
                ).__name__ == "DVDDataset"
    opt = {"mode": "synthetic", "kind": "video", "crop_size": 32,
           "n_samples": 3, "num_frames": 5, "scale": 4}
    _equal(PD.SyntheticDataset(dict(opt))[2],
           JD.SyntheticDataset(dict(opt))[2])
    loader = create_dataloader(
        create_dataset({"mode": "video", "phase": "train", "dataroot_HR": hr,
                        "scale": 4, "crop_size": 32, "n_samples": 4,
                        "batch_size": 2, "n_workers": 2}),
        {"phase": "train", "batch_size": 2, "n_workers": 2})
    batches = list(device_prefetch(iter(loader), device="cpu"))
    assert len(batches) == 2
    for b in batches:
        assert b["LR"].shape == (2, 3, 8, 8, 3)
        assert b["HR"].shape == (2, 3, 32, 32, 3)
        assert b["LR"].dtype == torch.float32
