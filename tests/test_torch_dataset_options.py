"""The other train-dataset options of the port's ``AlignedDataset`` and
loader (``trainner_tpu_torch/data/datasets.py``, ``data/loader.py``)
against the JAX package's on the CPU: ``aug_downscale``, ``color`` (``y``,
``gray``, ``RGB``) and ``subset_file`` give the JAX samples bit for bit
under one patched generator (the train phase draws from an unseeded
``default_rng`` in both packages); the weighted loader over a list of
datasets takes its datasets in the JAX order for a seed and tags each
batch with ``dataset_index``; ``ConcatDataset`` and a list in the
evaluation phase."""

import numpy as np
import pytest
import torch

from trainner_tpu.data import datasets as jax_datasets
from trainner_tpu.data import loader as jax_loader
from trainner_tpu_torch.data import datasets, loader
from trainner_tpu_torch.data.common import save_img

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("options")
    rng = np.random.default_rng(0)
    for i in range(6):
        h, w = int(rng.integers(44, 60)), int(rng.integers(44, 60))
        save_img((rng.random((h, w, 3)) * 255).astype(np.uint8),
                 str(root / "hr" / f"im{i}.png"))
    return root


def _pair(opt):
    return jax_datasets.AlignedDataset(dict(opt)), \
        datasets.AlignedDataset(dict(opt))


def _same_samples(monkeypatch, jds, pds, indices, seed=0):
    real = np.random.default_rng
    for i in indices:
        out = []
        for ds in (jds, pds):
            monkeypatch.setattr(np.random, "default_rng",
                                lambda s=None, i=i: real(seed + 31 * i))
            out.append(ds[i])
        monkeypatch.setattr(np.random, "default_rng", real)
        (j, p) = out
        assert set(j) == set(p)
        for k in ("LR", "HR"):
            assert j[k].dtype == p[k].dtype and j[k].shape == p[k].shape, k
            assert np.array_equal(j[k], p[k]), (i, k)
        assert j["HR_path"] == p["HR_path"]


@pytest.mark.parametrize("extra", [
    {"aug_downscale": 1.0},
    {"aug_downscale": 0.5},
    {"aug_downscale": 0.5, "wire_dtype": "uint8"},
    {"color": "y"},
    {"color": "gray"},
    {"color": "RGB"},
    {"color": "y", "aug_downscale": 1.0},
], ids=["downscale-always", "downscale-half", "downscale-u8", "y", "gray",
        "rgb", "y-downscale"])
def test_train_samples_match_jax(folder, monkeypatch, extra):
    opt = {"phase": "train", "scale": 4, "crop_size": 16,
           "dataroot_HR": str(folder / "hr"), **extra}
    jds, pds = _pair(opt)
    assert jds._fast_u8 == pds._fast_u8 is False
    _same_samples(monkeypatch, jds, pds, range(6))
    c = {"y": 1, "gray": 1}.get(extra.get("color"), 3)
    assert pds[0]["HR"].shape == (16, 16, c)


def test_color_in_the_evaluation_phase_matches_jax(folder):
    opt = {"phase": "val", "scale": 4, "dataroot_HR": str(folder / "hr"),
           "color": "y"}
    jds, pds = _pair(opt)
    for i in range(2):
        for k in ("LR", "HR"):
            assert np.array_equal(jds[i][k], pds[i][k]), (i, k)
        assert pds[i]["HR"].shape[2] == 1


def test_subset_file_keeps_base_names_and_whole_paths(folder, tmp_path,
                                                      monkeypatch):
    """Lines naming a base name or a whole path keep those HR images; a
    line that names neither keeps nothing; a missing file keeps all."""
    paths = datasets.AlignedDataset(
        {"phase": "train", "dataroot_HR": str(folder / "hr")}).hr_paths
    subset = tmp_path / "subset.txt"
    subset.write_text(f"im1.png\n\n  {paths[4]}  \nnot_there.png\n")
    opt = {"phase": "train", "scale": 4, "crop_size": 16,
           "dataroot_HR": str(folder / "hr"), "subset_file": str(subset)}
    jds, pds = _pair(opt)
    assert pds.hr_paths == jds.hr_paths == [paths[1], paths[4]]
    _same_samples(monkeypatch, jds, pds, range(2), seed=5)
    missing = datasets.AlignedDataset(
        {**opt, "subset_file": str(tmp_path / "none.txt")})
    assert missing.hr_paths == paths


def _synthetic(n, crop):
    opt = {"mode": "synthetic", "n_samples": n, "crop_size": crop,
           "scale": 4}
    return jax_datasets.create_dataset(opt), datasets.create_dataset(opt)


@pytest.mark.parametrize("weights, seed", [([3, 1], 0), ([1, 1, 2], 7)])
def test_the_weighted_loader_follows_jax(weights, seed):
    """Each batch comes whole from one dataset, in the order JAX draws for
    the seed, over two epochs; the batches hold the JAX pixels."""
    pairs = [_synthetic(8 + 4 * k, 16) for k in range(len(weights))]
    opt = {"phase": "train", "batch_size": 2, "seed": seed, "n_workers": 1,
           "sampler_weights": weights}
    jl = jax_loader.create_dataloader([j for j, _ in pairs], opt)
    pl = loader.create_dataloader([p for _, p in pairs], opt)
    assert isinstance(pl, loader.WeightedMultiLoader)
    assert len(pl) == len(jl)
    for epoch in range(2):
        jb, pb = list(jl), list(pl)
        assert [b["dataset_index"] for b in pb] == \
            [b["dataset_index"] for b in jb]
        assert len({b["dataset_index"] for b in pb}) == len(weights)
        for j, p in zip(jb, pb):
            assert isinstance(p["dataset_index"], int)
            assert isinstance(p["LR"], torch.Tensor)
            assert np.array_equal(p["LR"].numpy(), j["LR"]), epoch
            assert p["LR_path"] == j["LR_path"]


def test_concat_dataset_and_a_list_in_evaluation():
    pairs = [_synthetic(3, 16), _synthetic(2, 16)]
    jc = jax_loader.ConcatDataset([j for j, _ in pairs])
    pc = loader.ConcatDataset([p for _, p in pairs])
    assert len(pc) == len(jc) == 5
    for i in range(5):
        assert np.array_equal(pc[i]["HR"], jc[i]["HR"])
    with pytest.raises(IndexError):
        pc[5]
    val = loader.create_dataloader([p for _, p in pairs], {"phase": "val"})
    assert isinstance(val, loader.DataLoader)
    assert isinstance(val.dataset, loader.ConcatDataset)
    assert [b["LR_path"][0] for b in val] == ["0", "1", "2", "0", "1"]


def test_dataset_index_passes_the_prefetch():
    """``device_prefetch`` hands on what is not a tensor, the weighted
    loader's ``dataset_index`` too."""
    batches = [{"LR": torch.zeros(1, 2, 2, 3), "dataset_index": 1}]
    out = list(loader.device_prefetch(iter(batches), device="cpu"))
    assert out[0]["dataset_index"] == 1


def test_ycbcr_both_ways_match_jax():
    """``rgb2ycbcr`` (full and Y only) and its inverse ``ycbcr2rgb``, which
    ``color`` and the metrics' Y channel rest on, bit for bit with JAX's."""
    from trainner_tpu.data import common as jax_common
    from trainner_tpu_torch.data import common

    x = np.random.default_rng(1).random((5, 7, 3)).astype(np.float32)
    for only_y in (True, False):
        assert np.array_equal(common.rgb2ycbcr(x, only_y),
                              jax_common.rgb2ycbcr(x, only_y))
    y = common.rgb2ycbcr(x, only_y=False)
    assert np.array_equal(common.ycbcr2rgb(y), jax_common.ycbcr2rgb(y))
    assert np.abs(common.ycbcr2rgb(y) - x).max() < 1e-5
