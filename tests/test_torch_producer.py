"""The port's producer in front of the training step: PNG reader and
writer, paired crop and flips, the train ``AlignedDataset``, the loader,
``device_prefetch``, ``make_otf_degradation`` and the slice as a whole on
the CPU at a small size (corpus -> loader -> degradations -> three
``train_step``s). The host-side functions are compared with the JAX
package's under the same numpy generator: exact.
"""

import math
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from trainner_tpu.data import common as jax_common
from trainner_tpu.data.datasets import AlignedDataset as JaxAlignedDataset
from trainner_tpu.data.loader import DataLoader as JaxDataLoader
from trainner_tpu.options.config import parse_dict as jax_parse_dict
from trainner_tpu_torch.data import (AlignedDataset, DataLoader, common,
                                     create_dataloader, create_dataset,
                                     device_prefetch)
from trainner_tpu_torch.options.config import parse_dict
from trainner_tpu_torch.train import (batches, create_trainer,
                                      make_otf_degradation)

torch.set_num_threads(2)


def _field(h, w, c=3, seed=0):
    """A smooth uint8 image with a little grain."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    img = np.zeros((h, w, c), np.float32)
    for ch in range(c):
        fy, fx = rng.uniform(0.02, 0.2, 2)
        img[..., ch] = 128 + 90 * np.sin(
            2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 6))
    img += rng.uniform(-6, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Ten 48x56 PNGs written by the port's own writer."""
    root = tmp_path_factory.mktemp("corpus")
    for i in range(10):
        common.save_img(_field(48, 56, seed=i), str(root / f"{i:02d}.png"))
    return str(root)


def _options(root, **dataset):
    return {
        "is_train": True, "scale": 4, "model": "sr",
        "datasets": {"train": {
            "name": "small", "mode": "aligned", "dataroot_HR": root,
            "crop_size": 32, "batch_size": 7, "use_flip": True,
            "use_rot": True, "augs_strategy": "bsrgan",
            "resize_strat": "in", "n_workers": 2, "wire_dtype": "uint8",
            "shuffle_degradations": False,
            # the LR canvas is 8x8 here: kernels of 7 fit it
            "aug_configs": {"iso": {"kernel_size": 7, "min_kernel_size": 3},
                            "aniso2": {"kernel_size": 7,
                                       "min_kernel_size": 3}},
            **dataset}},
        "network_G": {"type": "rrdb_net", "nf": 16, "nb": 1, "gc": 8,
                      "upscale": 4},
        "network_D": {"type": "discriminator_vgg", "size": 32,
                      "base_nf": 8},
        "train": {"lr_G": 1e-4, "lr_D": 1e-4, "pixel_criterion": "l1",
                  "pixel_weight": 1e-2, "feature_criterion": "l1",
                  "feature_weight": 1.0, "gan_type": "vanilla",
                  "gan_weight": 5e-3, "lr_scheme": "MultiStepLR",
                  "lr_steps": [50000]},
    }


def _train_ds(root, **dataset):
    return parse_dict(_options(root, **dataset),
                      is_train=True)["datasets"]["train"]


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _cv2_rgb(path):
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert ref is not None
    if ref.ndim == 3:
        ref = ref[:, :, [2, 1, 0] + ([3] if ref.shape[2] == 4 else [])]
    return ref


@pytest.mark.parametrize("shape", [(17, 23, 3), (9, 31), (12, 7, 4),
                                   (5, 5, 1)])
def test_png_written_by_the_port_reads_back_bit_for_bit(tmp_path, shape):
    img = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "a.png")
    common.save_img(img, path)
    got = common.read_png(path)
    want = img[:, :, 0] if img.ndim == 3 and img.shape[2] == 1 else img
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _cv2_rgb(path))


def _png_chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png_with_filter(img, ft):
    """A PNG of ``img`` (HWC uint8) with every row under row filter ``ft``
    and the compressed stream cut into two IDAT chunks."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    left = np.concatenate([np.zeros((h, c), np.int32), rows[:, :-c]], axis=1)
    up = np.concatenate([np.zeros((1, w * c), np.int32), rows[:-1]], axis=0)
    upleft = np.concatenate([np.zeros((h, c), np.int32), up[:, :-c]], axis=1)
    p = left + up - upleft
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    pred = [0, left, up, (left + up) // 2, paeth][ft]
    body = ((rows - pred) % 256).astype(np.uint8)
    raw = np.concatenate([np.full((h, 1), ft, np.uint8), body], axis=1)
    stream = zlib.compress(raw.tobytes())
    cut = len(stream) // 2
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"tEXt", b"Comment\x00skipped")
            + _png_chunk(b"IDAT", stream[:cut])
            + _png_chunk(b"IDAT", stream[cut:]) + _png_chunk(b"IEND", b""))


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_png_reader_undoes_every_row_filter(tmp_path, ft, c):
    img = _field(13, 19, c=c, seed=ft)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png_with_filter(img, ft))
    got = common.read_png(path)
    np.testing.assert_array_equal(got, img[:, :, 0] if c == 1 else img)
    np.testing.assert_array_equal(got, _cv2_rgb(path))


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "deep.png")
    cv2.imwrite(path, np.zeros((4, 4, 3), np.uint16))
    with pytest.raises(NotImplementedError, match="depth 16"):
        common.read_png(path)
    with open(path, "wb") as f:
        f.write(b"not a png at all")
    with pytest.raises(IOError, match="not a PNG"):
        common.read_png(path)


def test_read_img_without_opencv_uses_the_png_reader(tmp_path, monkeypatch):
    img = _field(10, 14, seed=3)
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img[:, :, ::-1])  # adaptive row filters
    want = common.read_img(path)
    np.testing.assert_array_equal(want, jax_common.read_img(path))
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    got = common.read_img(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img.astype(np.float32) / 255.0)
    with pytest.raises(ImportError, match="OpenCV"):
        common.read_img(str(tmp_path / "a.jpg"))


# ---------------------------------------------------------------------------
# crop, flips, wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_augment_pair_and_crop_match_jax_under_the_same_generator(seed):
    hr = _field(40, 52, seed=seed)
    lr = np.ascontiguousarray(hr[::4, ::4])
    g_c, g_l = common.paired_random_crop(hr, lr, 32, 4,
                                         np.random.default_rng(seed))
    w_c, w_l = jax_common.paired_random_crop(hr, lr, 32, 4,
                                             np.random.default_rng(seed))
    np.testing.assert_array_equal(g_c, w_c)
    np.testing.assert_array_equal(g_l, w_l)
    assert g_c.shape == (32, 32, 3) and g_l.shape == (8, 8, 3)
    np.testing.assert_array_equal(g_l, g_c[::4, ::4])
    got = common.augment_pair([g_c, g_l], True, True,
                              np.random.default_rng(seed))
    want = jax_common.augment_pair([w_c, w_l], True, True,
                                   np.random.default_rng(seed))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.flags["C_CONTIGUOUS"]


def test_crop_pads_an_image_smaller_than_the_crop():
    hr = _field(24, 28, seed=1)
    lr = np.ascontiguousarray(hr[::4, ::4])
    got = common.paired_random_crop(hr, lr, 32, 4, np.random.default_rng(0))
    want = jax_common.paired_random_crop(hr, lr, 32, 4,
                                         np.random.default_rng(0))
    assert got[0].shape == (32, 32, 3) and got[1].shape == (8, 8, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_uint8_wire_round_trips_8_bit_sources():
    u8 = _field(9, 11, seed=2)
    f = u8.astype(np.float32) / 255.0
    np.testing.assert_array_equal(common.img2tensor(f, wire_u8=True), u8)
    np.testing.assert_array_equal(common.img2tensor(f, wire_u8=True),
                                  jax_common.img2tensor(f, wire_u8=True))
    np.testing.assert_array_equal(common.img2tensor(f, znorm=True),
                                  jax_common.img2tensor(f, znorm=True))


# ---------------------------------------------------------------------------
# the train dataset
# ---------------------------------------------------------------------------


def test_train_items_on_the_fast_path(corpus):
    ds = create_dataset(_train_ds(corpus))
    assert isinstance(ds, AlignedDataset) and len(ds) == 10
    assert ds.skip_host_lr and ds._fast_u8
    jax_ds = JaxAlignedDataset(jax_parse_dict(
        _options(corpus), is_train=True)["datasets"]["train"])
    assert jax_ds.skip_host_lr and jax_ds._fast_u8
    seen = set()
    for i in range(len(ds)):
        item = ds[i]
        hr, lr = item["HR"], item["LR"]
        assert hr.dtype == lr.dtype == np.uint8
        assert hr.shape == (32, 32, 3) and lr.shape == (8, 8, 3)
        assert hr.flags["C_CONTIGUOUS"] and lr.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(lr, hr[::4, ::4])
        assert item["HR_path"] == item["LR_path"] == ds.hr_paths[i]
        seen.add(hr.tobytes())
    assert len(seen) == 10
    assert len(ds._cache) == 10  # every decoded image was kept
    # the crop is a window of the file, flipped and transposed or not
    full = common.read_png(ds.hr_paths[0])
    crop = ds[0]["HR"]
    views = [crop, crop[:, ::-1], crop[::-1], crop[::-1, ::-1]]
    views += [v.transpose(1, 0, 2) for v in views]
    assert any(_is_window(full, v) for v in views)


def _is_window(full, crop):
    h, w = crop.shape[:2]
    for y in range(full.shape[0] - h + 1):
        for x in range(full.shape[1] - w + 1):
            if np.array_equal(full[y:y + h, x:x + w], crop):
                return True
    return False


def test_train_items_on_the_general_path(corpus):
    """f32 wire: bicubic LR when the pipeline holds no resize, the strided
    placeholder when it does."""
    ds = AlignedDataset(_train_ds(corpus, wire_dtype=None,
                                  resize_strat="pre"))
    assert not ds._fast_u8 and not ds.skip_host_lr
    item = ds[3]
    assert item["HR"].dtype == item["LR"].dtype == np.float32
    assert item["HR"].shape == (32, 32, 3) and item["LR"].shape == (8, 8, 3)
    assert 0.0 <= item["LR"].min() and item["HR"].max() <= 1.0
    assert np.abs(item["LR"] - item["HR"][::4, ::4]).max() > 1e-3
    ds = AlignedDataset(_train_ds(corpus, wire_dtype=None, use_flip=False,
                                  use_rot=False))
    assert ds.skip_host_lr and not ds._fast_u8
    item = ds[3]  # unflipped, the placeholder is the crop's own stride
    np.testing.assert_array_equal(item["LR"], item["HR"][::4, ::4])
    # uint8 wire on the general path (no cache): the same bytes as the file
    ds = AlignedDataset(_train_ds(corpus, resize_strat="pre",
                                  img_cache_mb=0, use_flip=False,
                                  use_rot=False))
    item = ds[0]
    assert item["HR"].dtype == np.uint8 and not ds._cache
    assert _is_window(common.read_png(ds.hr_paths[0]), item["HR"])


def test_tile_cache_holds_under_many_threads(corpus):
    """More threads than cores reading the same files at a short switch
    interval: every image is counted once and the limit holds."""
    import sys

    one = common.read_png(create_dataset(_train_ds(corpus)).hr_paths[0])
    limit_mb = 6.5 * one.nbytes / 2 ** 20  # room for six of the ten
    ds = AlignedDataset(_train_ds(corpus, img_cache_mb=limit_mb))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            loader = DataLoader(ds, batch_size=10, num_workers=16)
            assert sum(len(b["HR"]) for b in loader) == 10
    finally:
        sys.setswitchinterval(interval)
    assert len(ds._cache) == 6
    assert ds._cache_bytes == sum(v.nbytes for v in ds._cache.values())
    assert ds._cache_bytes <= limit_mb * 2 ** 20


def test_eval_phase_is_unchanged(corpus):
    opt = _train_ds(corpus)
    opt["phase"] = "val"
    item = AlignedDataset(opt)[0]
    assert item["HR"].shape == (48, 56, 3) and item["LR"].shape == (12, 14, 3)
    assert item["HR"].dtype == np.float32


# ---------------------------------------------------------------------------
# the loader and the prefetch
# ---------------------------------------------------------------------------


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"HR": np.full((2, 2, 3), i, np.uint8), "HR_path": str(i)}


@pytest.mark.parametrize("workers", [0, 1, 4])
def test_loader_order_is_seeded_and_the_last_short_batch_is_dropped(workers):
    ld = DataLoader(_Indexed(23), batch_size=5, shuffle=True, drop_last=True,
                    num_workers=workers, seed=3)
    ref = JaxDataLoader(_Indexed(23), batch_size=5, shuffle=True,
                        drop_last=True, num_workers=1, seed=3)
    assert len(ld) == len(ref) == 4
    for _ in range(2):  # the second epoch is shuffled anew, as in JAX
        got = [b["HR"][:, 0, 0, 0].tolist() for b in ld]
        want = [b["HR"][:, 0, 0, 0].tolist() for b in ref]
        assert got == want and len(got) == 4
    first = [b["HR_path"] for b in DataLoader(
        _Indexed(23), batch_size=5, shuffle=True, drop_last=True, seed=3)]
    again = [b["HR_path"] for b in DataLoader(
        _Indexed(23), batch_size=5, shuffle=True, drop_last=True, seed=3)]
    other = [b["HR_path"] for b in DataLoader(
        _Indexed(23), batch_size=5, shuffle=True, drop_last=True, seed=4)]
    assert first == again != other
    keep = DataLoader(_Indexed(23), batch_size=5, num_workers=workers)
    sizes = [len(b["HR_path"]) for b in keep]
    assert len(keep) == 5 and sizes == [5, 5, 5, 5, 3]


def test_loader_collates_tensors_and_hands_on_a_failure():
    batch = next(iter(DataLoader(_Indexed(8), batch_size=4)))
    assert isinstance(batch["HR"], torch.Tensor)
    assert batch["HR"].dtype == torch.uint8 and batch["HR"].shape == (4, 2, 2,
                                                                     3)
    assert batch["HR_path"] == ["0", "1", "2", "3"]

    class Broken(_Indexed):
        def __getitem__(self, i):
            if i == 5:
                raise OSError("unreadable file")
            return super().__getitem__(i)

    with pytest.raises(OSError, match="unreadable"):
        list(DataLoader(Broken(8), batch_size=2, num_workers=3))


def test_pinned_collate_when_asked():
    from trainner_tpu_torch.data import loader as loader_mod

    samples = [_Indexed(2)[i] for i in range(2)]
    assert not loader_mod._collate(samples, pin=False)["HR"].is_pinned()
    pinned = []
    real = torch.Tensor.pin_memory
    try:  # this image has no card to pin for: watch the call instead
        torch.Tensor.pin_memory = lambda t: pinned.append(t.shape) or t
        loader_mod._collate(samples, pin=True)
    finally:
        torch.Tensor.pin_memory = real
    assert pinned == [(2, 2, 2, 3)]


def test_create_dataloader_reads_the_train_options(corpus):
    opt = _train_ds(corpus)
    ld = create_dataloader(create_dataset(opt), opt)
    assert (ld.batch_size, ld.shuffle, ld.drop_last, ld.num_workers) \
        == (7, True, True, 2)
    assert len(ld) == 1 and not ld.pin_memory
    val = dict(opt, phase="val")
    ev = create_dataloader(create_dataset(val), val)
    assert (ev.batch_size, ev.shuffle, ev.drop_last) == (1, False, False)


@pytest.mark.parametrize("size", [1, 2, 5])
def test_device_prefetch_yields_every_batch_once_in_order(size):
    ld = DataLoader(_Indexed(12), batch_size=4, num_workers=1)
    got = [b["HR"][:, 0, 0, 0].tolist()
           for b in device_prefetch(iter(ld), size=size, device="cpu")]
    assert got == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]


def test_device_prefetch_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(device_prefetch(iter([{"HR": torch.zeros(1)}])))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_otf_degradation(_options("/nonexistent"))


def test_batches_go_on_past_the_epoch():
    ld = DataLoader(_Indexed(6), batch_size=3, shuffle=True, drop_last=True,
                    seed=1)
    it = batches(ld, "cpu")
    got = [next(it) for _ in range(5)]
    assert all(set(b) == {"HR"} for b in got)  # tensors only
    assert all(b["HR"].shape == (3, 2, 2, 3) for b in got)
    for a, b in ((0, 1), (2, 3)):  # an epoch holds every sample once
        assert sorted(got[a]["HR"][:, 0, 0, 0].tolist()
                      + got[b]["HR"][:, 0, 0, 0].tolist()) == list(range(6))


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def test_make_otf_degradation(corpus):
    opt = parse_dict(_options(corpus), is_train=True)
    ds_opt = opt["datasets"]["train"]
    degrade = make_otf_degradation(opt, device="cpu")
    batch = next(iter(create_dataloader(create_dataset(ds_opt), ds_opt)))
    out = degrade(batch)
    assert out is not batch and out["HR"] is batch["HR"]
    lr = out["LR"]
    assert lr.shape == (7, 8, 8, 3) and lr.dtype == torch.float32
    assert 0.0 <= float(lr.min()) and float(lr.max()) <= 1.0
    assert float((lr * 255 - (lr * 255).round()).abs().max()) <= 1e-4
    placeholder = batch["LR"].float() / 255.0
    assert float((lr - placeholder).abs().mean()) > 1e-3
    # a generator of the caller's: the same seed, the same batch
    one = make_otf_degradation(
        opt, "cpu", torch.Generator().manual_seed(5))(batch)["LR"]
    two = make_otf_degradation(
        opt, "cpu", torch.Generator().manual_seed(5))(batch)["LR"]
    assert torch.equal(one, two) and not torch.equal(one, lr)
    # no degradation asked for: no step
    plain = _options(corpus, augs_strategy=None)
    assert make_otf_degradation(parse_dict(plain, is_train=True),
                                "cpu") is None
    assert make_otf_degradation({"datasets": {}}, "cpu") is None


def test_the_slice_end_to_end_on_the_cpu(corpus):
    """Corpus -> dataset -> loader -> prefetch -> degradations -> three
    train steps of a narrow model: finite logs, G moves."""
    opt = parse_dict(_options(corpus), is_train=True)
    ds_opt = opt["datasets"]["train"]
    loader = create_dataloader(create_dataset(ds_opt), ds_opt)
    degrade = make_otf_degradation(opt, device="cpu")
    trainer = create_trainer({**opt, "use_amp": False}, device="cpu")
    state = trainer.init_state(0)
    before = {k: v.clone() for k, v in state.g.net.state_dict().items()}
    stream = batches(loader, "cpu")
    for _ in range(3):
        batch = degrade(next(stream))
        assert batch["HR"].dtype == torch.uint8
        assert batch["LR"].shape == (7, 8, 8, 3)
        state, logs = trainer.train_step(state, batch)
        vals = {k: float(v) for k, v in logs.items()}
        assert {"l_g_pix", "l_g_fea", "l_g_gan", "l_g_total",
                "l_d_total"} <= set(vals)
        assert all(math.isfinite(v) for v in vals.values()), vals
    assert state.step == 3
    after = state.g.net.state_dict()
    moved = sum(int(not torch.equal(after[k], before[k])) for k in before)
    assert moved == len(before)


@pytest.mark.parametrize("extra, item", [
    ({"compression": ["webp"]}, "Queue A 5.5"),
    ({"dataroot_HR": "/nonexistent/train.lmdb"}, "Queue A 5.3"),
    ({"aug_downscale": 0.2}, "Queue A 5.4"),
    ({"color": "y"}, "Queue A 5.4"),
    ({"subset_file": "subset.txt"}, "Queue A 5.4"),
    ({"otf_mode": "host"}, "Queue A 5.5"),
])
def test_options_outside_the_slice_raise_and_name_their_item(corpus, extra,
                                                             item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        opt = parse_dict(_options(corpus, **extra), is_train=True)
        create_dataset(opt["datasets"]["train"])
        make_otf_degradation(opt, device="cpu")
