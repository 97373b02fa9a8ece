"""The image-to-image and SFTGAN datasets of the port against the JAX
package's on the CPU, with ``numpy.random.default_rng`` patched to one
seeded generator per sample in both (ROADMAP C 20): ``UnalignedDataset``
(random or serial B, the reflect pad of an image smaller than the crop,
the flip, ``znorm``, the uint8 wire, the eval phase), ``SyntheticDataset``
kind ``ab``, ``SegDataset`` (maps from ``.npy`` probabilities, from
``.npy`` class ids, from a category image, or uniform; the crop; LR by
``imresize_np``; ``category``) and the mode aliases ``unaligned``,
``lrhrseg_bg`` and ``seg``. ``dataroot_HR_bg`` is not read (ROADMAP
C 22).
"""

import os

import numpy as np
import pytest

from trainner_tpu.data import datasets as jax_datasets
from trainner_tpu.data import seg_dataset as jax_seg
from trainner_tpu_torch.data import datasets
from trainner_tpu_torch.data import seg_dataset
from trainner_tpu_torch.data.common import save_img


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """A (5 images of 40-70 px) and B (4 images, one smaller than the
    crop) as PNGs; HR images of 64-80 px with maps in four forms."""
    root = tmp_path_factory.mktemp("i2i_data")
    rng = np.random.default_rng(0)
    for side, n in (("A", 5), ("B", 4)):
        for i in range(n):
            h, w = (int(rng.integers(40, 70)) for _ in range(2))
            if side == "B" and i == 0:
                h, w = 20, 28
            save_img((rng.random((h, w, 3)) * 255).astype(np.uint8),
                     str(root / side / f"{side}{i}.png"))
    os.makedirs(root / "seg")
    for i in range(4):
        h, w = int(rng.integers(64, 81)), int(rng.integers(64, 81))
        save_img((rng.random((h, w, 3)) * 255).astype(np.uint8),
                 str(root / "hr" / f"im{i}.png"))
        if i == 0:
            p = rng.random((h, w, 8)).astype(np.float32)
            np.save(root / "seg" / f"im{i}.npy", p / p.sum(-1,
                                                           keepdims=True))
        elif i == 1:
            np.save(root / "seg" / f"im{i}.npy",
                    rng.integers(0, 8, (h - 3, w)).astype(np.int64))
        elif i == 2:
            save_img(rng.integers(0, 8, (h, w, 3)).astype(np.uint8),
                     str(root / "seg" / f"im{i}.png"))
    return root


def _same(monkeypatch, jds, pds, indices, keys, seed=0):
    real = np.random.default_rng
    for i in indices:
        out = []
        for ds in (jds, pds):
            monkeypatch.setattr(np.random, "default_rng",
                                lambda s=None, i=i: real(seed + 31 * i))
            out.append(ds[i])
        monkeypatch.setattr(np.random, "default_rng", real)
        j, p = out
        assert set(j) == set(p)
        for k in keys:
            assert j[k].dtype == p[k].dtype and j[k].shape == p[k].shape, k
            assert np.array_equal(j[k], p[k]), (i, k)
        for k in set(j) - set(keys):
            assert np.array_equal(np.asarray(j[k]), np.asarray(p[k])), k


@pytest.mark.parametrize("extra", [
    {}, {"serial_batches": True}, {"use_flip": False},
    {"znorm": False}, {"wire_dtype": "uint8"}, {"crop_size": 48},
    {"phase": "val"},
])
def test_unaligned_samples_match_jax(folder, monkeypatch, extra):
    opt = {"mode": "unaligned", "dataroot_A": str(folder / "A"),
           "dataroot_B": str(folder / "B"), "crop_size": 32, **extra}
    jds = jax_datasets.create_dataset(dict(opt))
    pds = datasets.create_dataset(dict(opt))
    assert isinstance(pds, datasets.UnalignedDataset) and len(pds) == 5
    _same(monkeypatch, jds, pds, range(5), ("A", "B"))


def test_unaligned_reflect_pads_a_small_image(folder, monkeypatch):
    """B0 is 20 x 28: it is reflect-padded at its bottom and right to the
    crop before the crop."""
    opt = {"mode": "unaligned", "dataroot_A": str(folder / "A"),
           "dataroot_B": str(folder / "B"), "crop_size": 32,
           "serial_batches": True, "use_flip": False, "znorm": False}
    s = datasets.create_dataset(opt)[0]
    assert s["B"].shape == (32, 32, 3) and s["B_path"].endswith("B0.png")
    src = datasets.read_img(s["B_path"])
    assert np.array_equal(s["B"][:20, :28], src)
    assert np.array_equal(s["B"][20:, :28], src[-2:-14:-1])


def test_synthetic_ab_matches_jax():
    opt = {"mode": "synthetic", "kind": "ab", "crop_size": 24,
           "n_samples": 3}
    jds, pds = (m.create_dataset(dict(opt)) for m in (jax_datasets,
                                                       datasets))
    for i in range(3):
        for k in ("A", "B"):
            assert np.array_equal(jds[i][k], pds[i][k])


@pytest.mark.parametrize("mode", ["LRHRseg_bg", "seg"])
@pytest.mark.parametrize("phase", ["train", "val"])
@pytest.mark.parametrize("crop", [48, 96])
def test_seg_samples_match_jax(folder, monkeypatch, mode, phase, crop):
    opt = {"mode": mode, "dataroot_HR": str(folder / "hr"),
           "dataroot_seg": str(folder / "seg"),
           "dataroot_HR_bg": "/nonexistent", "crop_size": crop,
           "phase": phase, "scale": 4}
    jds = jax_datasets.create_dataset(dict(opt))
    pds = datasets.create_dataset(dict(opt))
    assert isinstance(pds, seg_dataset.SegDataset) and len(pds) == 4
    _same(monkeypatch, jds, pds, range(4), ("LR", "HR", "seg"))


def test_seg_maps_in_every_form(folder):
    """The four images' maps: probabilities as stored, one-hot class ids
    (edge-padded where the map is short), one-hot category-image classes,
    uniform 1/8; ``category`` is the argmax of the mean map."""
    pds = seg_dataset.SegDataset({"dataroot_HR": str(folder / "hr"),
                                  "dataroot_seg": str(folder / "seg"),
                                  "phase": "val"})
    segs = [pds[i]["seg"] for i in range(4)]
    assert np.allclose(segs[0].sum(-1), 1.0, atol=1e-5)
    assert set(np.unique(segs[1])) == {0.0, 1.0}
    assert np.array_equal(segs[1][-1], segs[1][-4])
    assert set(np.unique(segs[2])) <= {0.0, 1.0}
    assert np.all(segs[3] == 1.0 / 8)
    for i in range(4):
        s = pds[i]
        assert s["category"] == np.argmax(s["seg"].mean((0, 1)))
        assert s["LR"].shape[0] * 4 == s["HR"].shape[0]
    assert jax_seg.N_CLASSES == seg_dataset.N_CLASSES == 8


def test_seg_without_maps_is_uniform(folder):
    pds = datasets.create_dataset({"mode": "seg",
                                   "dataroot_HR": str(folder / "hr"),
                                   "phase": "val"})
    assert np.all(pds[0]["seg"] == 1.0 / 8)
