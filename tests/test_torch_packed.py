"""The packed format and the native loader of the port
(``trainner_tpu_torch/data/packed.py``, ``data/native_loader.py``,
``scripts/create_pack.py``) against the JAX package's: ``.tpak`` files
written by either package read in the other to the same pixels, and with
OpenCV installed the two writers' files are the same bytes; without
OpenCV the port's own PNG coder keeps the pixels. The native decoder,
built by the port from ``native/tpuloader.cpp`` into ``build/native``,
decodes as the JAX package's does.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from trainner_tpu.data import native_loader as jax_native
from trainner_tpu.data import packed as J
from trainner_tpu_torch.data import native_loader as N
from trainner_tpu_torch.data import packed as P
from trainner_tpu_torch.scripts.create_pack import main as create_pack

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Seeded images: RGB PNGs of two sizes in a nested folder, a gray
    PNG and a JPEG."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    (d / "sub").mkdir()
    for i, (h, w) in enumerate([(24, 20), (17, 31), (8, 8)]):
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        cv2.imwrite(str(d / ("sub" if i == 2 else "") / f"{i}.png"), img)
    cv2.imwrite(str(d / "gray.png"), rng.integers(0, 256, (12, 9),
                                                  np.uint8))
    cv2.imwrite(str(d / "photo.jpg"), rng.integers(0, 256, (16, 16, 3),
                                                   np.uint8),
                [cv2.IMWRITE_JPEG_QUALITY, 95])
    return str(d)


@pytest.fixture(scope="module")
def packs(folder, tmp_path_factory):
    out = tmp_path_factory.mktemp("packs")
    jax_path, port_path = str(out / "jax.tpak"), str(out / "port.tpak")
    n_jax = J.pack_folder(folder, jax_path)
    n_port = P.pack_folder(folder, port_path)
    assert n_jax == n_port == 5
    return jax_path, port_path


def _read_all(reader_cls, path):
    r = reader_cls(path)
    try:
        return {k: r.read(k) for k in r.keys}
    finally:
        r.close()


def test_both_writers_write_the_same_bytes(packs):
    jax_path, port_path = packs
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()


def test_each_reader_reads_the_others_file(packs):
    """Each reader on each file: the same keys and the same float32
    pixels, bit for bit."""
    jax_path, port_path = packs
    ref = _read_all(J.PackedReader, jax_path)
    assert sorted(ref) == ["0", "1", "gray", "photo", "sub/2"]
    for reader, path in ((P.PackedReader, jax_path),
                         (P.PackedReader, port_path),
                         (J.PackedReader, port_path)):
        got = _read_all(reader, path)
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_without_opencv_the_pixels_stay(packs, folder, tmp_path,
                                        monkeypatch):
    """With OpenCV hidden the port's reader decodes the JAX file to the
    same pixels, and its writer's file (the port's PNG encoder) reads in
    the JAX package to the pixels of the JAX file."""
    jax_path, _ = packs
    ref = _read_all(J.PackedReader, jax_path)
    monkeypatch.setattr(P, "_cv2", lambda: None)
    got = _read_all(P.PackedReader, jax_path)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    path = str(tmp_path / "plain.tpak")
    w = P.PackedWriter(path)
    for k, v in ref.items():
        w.add_image(k, (v * 255.0 + 0.5).astype(np.uint8))
    w.close()
    monkeypatch.undo()
    back = _read_all(J.PackedReader, path)
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_create_pack_script(folder, packs, tmp_path):
    out = create_pack([folder, str(tmp_path / "made")])
    assert out.endswith("made.tpak")
    with open(out, "rb") as a, open(packs[0], "rb") as b:
        assert a.read() == b.read()


def test_native_library_is_built_from_source():
    """The port compiles native/tpuloader.cpp into build/native (ignored
    by git), not the committed native/libtpuloader.so."""
    assert N.available(), N.unavailable_reason()
    assert os.path.exists(N.SO_PATH)
    assert os.sep + os.path.join("build", "native") + os.sep in N.SO_PATH
    assert os.path.getmtime(N.SO_PATH) >= os.path.getmtime(N.SOURCE)


@pytest.mark.parametrize("name", ["0.png", "photo.jpg", "gray.png"])
def test_native_decode_matches_jax(folder, name):
    """The port's native decode equals the JAX package's (the same
    source) bit for bit, and a PNG OpenCV's within 1e-6 (the native code
    multiplies by 1/255 where this divides by 255), as
    ``tests/test_native_loader.py`` holds it."""
    path = os.path.join(folder, name)
    got = N.decode_image(path)
    assert got is not None and got.dtype == np.float32
    if jax_native.available():
        np.testing.assert_array_equal(got, jax_native.decode_image(path))
    if name.endswith(".png") and name != "gray.png":
        ref = cv2.imread(path)[..., ::-1].astype(np.float32) / 255.0
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_native_crop_loader(folder):
    paths = [os.path.join(folder, f) for f in ("0.png", "1.png")]
    ld = N.NativeCropLoader(paths, crop=8, batch_size=3, n_threads=2,
                            seed=0)
    try:
        a, b = ld.next(), ld.next()
        assert a.shape == (3, 8, 8, 3) and a.dtype == np.float32
        assert 0.0 <= a.min() and a.max() <= 1.0 and a.std() > 0.1
        assert not np.array_equal(a, b)
    finally:
        ld.close()


def test_unavailable_where_it_cannot_build(monkeypatch, tmp_path):
    """No compiler: ``available()`` is False and the reason is logged on
    the ``base`` logger."""
    import logging

    class Records(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    monkeypatch.setattr(N, "_LIB", None)
    monkeypatch.setattr(N, "_ERROR", None)
    monkeypatch.setattr(N, "SO_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(N, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    records = Records()
    base = logging.getLogger("base")
    base.addHandler(records)
    try:
        assert not N.available()
    finally:
        base.removeHandler(records)
    assert "no-such-compiler" in N.unavailable_reason()
    assert any("native loader unavailable" in m for m in records.messages)
    assert N.decode_image("x.png") is None
    with pytest.raises(RuntimeError, match="unavailable"):
        N.NativeCropLoader(["x.png"])
