"""LMDB datasets in the port (``trainner_tpu_torch/data/lmdb_io.py``,
``data/common.py``'s ``root.lmdb::key`` paths,
``trainner_tpu_torch/scripts/create_lmdb.py``) against the JAX package's
``trainner_tpu/data/lmdb_io.py`` on the CPU: an environment written by one
package reads in the other with every key and value bit for bit, with
enough keys for branch pages and values longer than a page for overflow
pages; ``meta_info.txt`` and the key listing without it; ``read_img`` of
an LMDB value bit for bit with the JAX one, with OpenCV and with the
standard-library PNG reader forced; both ``create_lmdb`` scripts on one
folder; and an ``AlignedDataset`` over the LMDB gives the folder's
samples."""

import builtins
import os
import sys

import numpy as np
import pytest

from trainner_tpu.data import common as jax_common
from trainner_tpu.data import lmdb_io as jax_lmdb
from trainner_tpu_torch.data import common, lmdb_io
from trainner_tpu_torch.data.common import encode_png, save_img

PSIZE = 4096


def _items(n_small=400, n_big=5, seed=0):
    """Keys in no sorted order; small values (about 90 per leaf page, so
    five leaves under a branch page) and values of 1-3 pages (overflow
    pages)."""
    rng = np.random.default_rng(seed)
    items = {}
    for i in rng.permutation(n_small):
        items[f"img_{i:05d}".encode()] = rng.bytes(int(rng.integers(8, 40)))
    for i in range(n_big):
        items[f"big_{i}".encode()] = rng.bytes(PSIZE * (i % 3 + 1) + 17 * i)
    return items


@pytest.mark.parametrize("writer, reader", [
    (jax_lmdb.write_lmdb, lmdb_io.LmdbReader),
    (lmdb_io.write_lmdb, jax_lmdb.LmdbReader),
    (lmdb_io.write_lmdb, lmdb_io.LmdbReader),
], ids=["jax-to-port", "port-to-jax", "port-to-port"])
def test_environments_read_across_packages(tmp_path, writer, reader):
    items = _items()
    writer(str(tmp_path / "db.lmdb"), items)
    r = reader(str(tmp_path / "db.lmdb"))
    try:
        assert r.entries == len(items)
        got = [(bytes(k), bytes(v)) for k, v in r.items()]
        assert got == sorted(items.items())
        for k in list(items)[::37] + [b"big_4", b"big_0"]:
            assert bytes(r.get(k)) == items[k]
        assert r.get(b"img_99999") is None and r.get(b"a") is None
        # the tree has branch pages over several leaves, and overflow pages
        off, flags = r._page(r.root)
        assert flags & lmdb_io.P_BRANCH
        assert len(r._branch_children(off)) >= 4
    finally:
        r.close()


def test_the_port_writes_the_jax_file_byte_for_byte(tmp_path):
    items = _items(n_small=120, n_big=2, seed=1)
    jax_lmdb.write_lmdb(str(tmp_path / "a.lmdb"), items)
    lmdb_io.write_lmdb(str(tmp_path / "b.lmdb"), items)
    a = (tmp_path / "a.lmdb" / "data.mdb").read_bytes()
    b = (tmp_path / "b.lmdb" / "data.mdb").read_bytes()
    assert a == b


def _folder(tmp_path, n=6):
    rng = np.random.default_rng(3)
    src = tmp_path / "src"
    for i in range(n):
        h, w = int(rng.integers(20, 40)), int(rng.integers(20, 40))
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        save_img(img, str(src / f"im{i}.png"))
    gray = (rng.random((24, 30)) * 255).astype(np.uint8)
    save_img(gray, str(src / "sub" / "gray.png"))
    return src


def _jax_create(src, dst, level):
    import scripts.create_lmdb as jax_script

    argv = sys.argv
    sys.argv = ["create_lmdb.py", str(src), str(dst), "--level", str(level)]
    try:
        jax_script.main()
    finally:
        sys.argv = argv


def _without_cv2(monkeypatch):
    real_import = builtins.__import__

    def refuse(name, *args, **kw):
        if name == "cv2":
            raise ImportError("no cv2 here")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", refuse)


@pytest.mark.parametrize("cv2_on", [True, False], ids=["cv2", "no-cv2"])
def test_create_lmdb_and_read_img_as_the_jax_package(tmp_path, monkeypatch,
                                                     cv2_on):
    """Both scripts on one folder: the same keys and ``meta_info.txt``; with
    OpenCV the same value bytes (each is OpenCV's PNG), without it the
    port's own PNG, which decodes to the same pixels. ``read_img`` of each
    ``root.lmdb::key`` equals the JAX one bit for bit, and equals the
    image file's."""
    from trainner_tpu_torch.scripts.create_lmdb import create_lmdb

    src = _folder(tmp_path)
    _jax_create(src, tmp_path / "jax.lmdb", 1)
    if not cv2_on:
        _without_cv2(monkeypatch)
    create_lmdb(str(src), str(tmp_path / "port"), 1)
    port_db, jax_db = tmp_path / "port.lmdb", tmp_path / "jax.lmdb"
    assert (port_db / "meta_info.txt").read_text() == \
        (jax_db / "meta_info.txt").read_text()
    jr, pr = jax_lmdb.LmdbReader(str(jax_db)), lmdb_io.LmdbReader(str(port_db))
    try:
        assert [k for k, _ in jr.items()] == [k for k, _ in pr.items()]
        same = all(bytes(a) == bytes(b) for (_, a), (_, b)
                   in zip(jr.items(), pr.items()))
        assert same == cv2_on
    finally:
        jr.close()
        pr.close()
    paths = common.scan_images(str(port_db))
    assert paths == jax_common.scan_images(str(port_db))
    assert len(paths) == 7 and all("::" in p for p in paths)
    for p in paths:
        key = p.split("::")[1]
        got = common.read_img(p)
        want = jax_common.read_img(p)
        assert got.dtype == np.float32 and np.array_equal(got, want), key
        name = "sub/gray.png" if key == "gray" else f"{key}.png"
        assert np.array_equal(got, common.read_img(str(src / name))), key
        u8 = lmdb_io.read_lmdb_img(lmdb_io.LmdbReader(str(port_db)), key)
        assert np.array_equal(u8[:, :, ::-1],
                              np.clip(got * 255 + 0.5, 0, 255)
                              .astype(np.uint8)), key
    common._LMDB_READERS.clear()
    jax_common._LMDB_READERS.clear()


def test_meta_info_and_the_listing_without_it(tmp_path):
    """``lmdb_paths`` keeps each ``meta_info.txt`` line's text before its
    first ``.`` (a key with a dot is cut there, as in JAX); without the
    file it lists every key in key order."""
    db = tmp_path / "d.lmdb"
    items = {b"b.x": b"1", b"a": b"2", b"c": b"3"}
    lmdb_io.write_lmdb(str(db), items)
    assert lmdb_io.lmdb_paths(str(db)) == jax_lmdb.lmdb_paths(str(db)) \
        == ["a", "b.x", "c"]
    (db / "meta_info.txt").write_text("c.png (1,1,3) 1\nb.x.png (1,1,3) 1\n")
    assert lmdb_io.lmdb_paths(str(db)) == jax_lmdb.lmdb_paths(str(db)) \
        == ["c", "b"]


def test_paeth_values_decode_without_cv2(tmp_path, monkeypatch):
    """An LMDB value filtered with Paeth on every row (as OpenCV's encoder
    writes most rows) decodes through the standard-library reader to the
    pixels OpenCV decodes."""
    import cv2

    rng = np.random.default_rng(5)
    img = (rng.random((33, 47, 3)) * 255).astype(np.uint8)
    items = {b"p": encode_png(img, 1, row_filter=4),
             b"c": cv2.imencode(".png", img[:, :, ::-1])[1].tobytes()}
    lmdb_io.write_lmdb(str(tmp_path / "f.lmdb"), items)
    root = str(tmp_path / "f.lmdb")
    want = jax_common.read_img(f"{root}::c")
    _without_cv2(monkeypatch)
    for key in ("p", "c"):
        got = common.read_img(f"{root}::{key}")
        assert np.array_equal(got, want), key
    common._LMDB_READERS.clear()
    jax_common._LMDB_READERS.clear()


def test_an_lmdb_dataset_gives_the_folders_samples(tmp_path, monkeypatch):
    """``AlignedDataset`` in the train phase over the folder and over its
    LMDB, under one seeded generator per sample: the same crops (the LMDB
    skips the decoded-image cache and the uint8 fast path, as in JAX). LR
    is the strided placeholder that the device pipeline replaces, taken
    before the flips on the fast path and after them on the other: only
    its shape is held."""
    from trainner_tpu_torch.data.datasets import AlignedDataset
    from trainner_tpu_torch.scripts.create_lmdb import create_lmdb

    src = tmp_path / "flat"
    rng = np.random.default_rng(4)
    for i in range(3):
        save_img((rng.random((40, 36, 3)) * 255).astype(np.uint8),
                 str(src / f"im{i}.png"))
    db = create_lmdb(str(src), str(tmp_path / "flat.lmdb"), 1)
    from trainner_tpu_torch.options.config import parse_dict

    def dataset_opt(root):
        opt = parse_dict({"is_train": True, "scale": 4, "model": "sr",
                          "datasets": {"train": {
                              "name": "t", "mode": "aligned",
                              "dataroot_HR": root, "crop_size": 16,
                              "augs_strategy": "bsrgan", "resize_strat": "in",
                              "wire_dtype": "uint8"}},
                          "network_G": {"type": "rrdb_net", "nf": 8,
                                        "nb": 1, "gc": 8}}, is_train=True)
        return opt["datasets"]["train"]

    folder = AlignedDataset(dataset_opt(str(src)))
    lmdb = AlignedDataset(dataset_opt(db))
    assert [os.path.basename(p) for p in folder.hr_paths] == \
        [p.split("::")[1] + ".png" for p in lmdb.hr_paths]
    assert folder.skip_host_lr and folder._fast_u8 and lmdb._fast_u8
    real = np.random.default_rng
    for i in range(3):
        out = []
        for ds in (folder, lmdb):
            monkeypatch.setattr(np.random, "default_rng",
                                lambda seed=None, i=i: real(100 + i))
            out.append(ds[i])
        monkeypatch.setattr(np.random, "default_rng", real)
        for k in ("LR", "HR"):
            assert out[0][k].dtype == out[1][k].dtype == np.uint8
            assert out[0][k].shape == out[1][k].shape
        assert np.array_equal(out[0]["HR"], out[1]["HR"]), i
    assert lmdb._cache == {}
    common._LMDB_READERS.clear()
