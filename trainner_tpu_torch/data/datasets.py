"""Datasets: host-side sample producers (numpy HWC arrays).

Counterpart of ``trainner_tpu/data/datasets.py``: ``AlignedDataset:44`` in
both phases with every option (LMDB roots, ``aug_downscale``, ``color``,
``subset_file``, ``otf_mode: host`` and its ``_host_degrade:229``),
``SingleDataset:277``, ``UnalignedDataset:300`` (CycleGAN's and
pix2pix's A/B), ``SyntheticDataset:349`` (kinds ``sr``, ``ab``,
``video`` and ``dvd``) and ``create_dataset:431`` for these modes,
SFTGAN's ``seg`` (``data/seg_dataset.py``), the video modes ``video`` /
``vlrhr`` (``data/video_datasets.py``: training clips in the train phase,
sliding windows otherwise), the deinterlacing modes ``dvd`` / ``dvdi``
(``DVDDataset``) and the material modes ``pbr`` / ``lrhrpbr``
(``data/pbr_dataset.py``). The datasets read, crop and flip; the
degradations run batched on the device (``data/pipeline.py``), after the
host's with ``otf_mode: host`` (ROADMAP C 20).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np

from ..ops.imresize import imresize_np
from .common import augment_pair, channel_convert, decode_image, \
    img2tensor, is_lmdb_path, modcrop, paired_random_crop, read_img, \
    scan_images
from .video_datasets import interlace


def _dataroot(dataset_opt: dict, *keys: str) -> Optional[str]:
    for k in keys:
        v = dataset_opt.get(k)
        if v:
            return v if isinstance(v, str) else v[0]
    return None


class AlignedDataset:
    """Paired LR/HR images. Without an LR root (or with a different number
    of LR images), LR is made from HR: the bicubic downscale, or, when the
    on-device pipeline regenerates LR from the HR batch anyway (its
    options hold an in-pipeline resize), a strided placeholder of the right
    shape.

    In the train phase a sample is a random aligned crop with random flips
    and transpose, drawn from an unseeded generator as in the JAX package;
    before the crop, with probability ``aug_downscale``, HR is shrunk by a
    factor in [0.5, 0.95) and LR made from it anew. ``color`` (``y``,
    ``gray`` or ``RGB``) converts HR and a read LR. ``subset_file`` keeps
    the HR paths whose base name or whole path one of its lines names
    (LR paths are matched before it, ROADMAP C 20). With ``otf_mode: host``
    each train LR passes ``_host_degrade``. With ``wire_dtype: uint8``, the
    placeholder LR and none of these options the whole path stays uint8
    (decode, crop, flip); decoded image files (not LMDB values) are kept in
    a cache of ``img_cache_mb`` megabytes."""

    def __init__(self, dataset_opt: dict):
        self.opt = dataset_opt
        self.scale = int(dataset_opt.get("scale", 4) or 4)
        self.hr_crop = int(dataset_opt.get("crop_size",
                                           dataset_opt.get("HR_size", 128))
                           or 128)
        self.phase = dataset_opt.get("phase", "train")
        train = self.phase == "train"
        hr_root = _dataroot(dataset_opt, "dataroot_HR", "dataroot_B",
                            "dataroot_gt")
        lr_root = _dataroot(dataset_opt, "dataroot_LR", "dataroot_A",
                            "dataroot_lq")
        if not hr_root:
            raise ValueError("AlignedDataset needs dataroot_HR/B/gt")
        self.hr_paths = scan_images(hr_root)
        if not self.hr_paths:
            raise ValueError(f"no images found under [{hr_root}]")
        self.lr_paths: Optional[List[str]] = None
        if lr_root and os.path.isdir(lr_root):
            lr = scan_images(lr_root)
            if len(lr) == len(self.hr_paths):
                self.lr_paths = lr
        self.znorm = bool(dataset_opt.get("znorm"))
        self.wire_u8 = str(dataset_opt.get("wire_dtype", "")
                           ).lower() in ("u8", "uint8")
        self.color = dataset_opt.get("color")
        self.use_flip = bool(dataset_opt.get("use_flip", True))
        self.use_rot = bool(dataset_opt.get("use_rot", True))
        self.aug_downscale = float(dataset_opt.get("aug_downscale", 0)
                                   or 0)
        self.host_otf = dataset_opt.get("otf_mode") == "host"
        # the same condition by which the producer decides that LR is
        # regenerated from the HR batch (train/producer.py)
        self.skip_host_lr = False
        if train and self.lr_paths is None and not self.host_otf:
            from .pipeline import get_unpaired_params

            self.skip_host_lr = "resize" in get_unpaired_params(
                dataset_opt)[0]
        subset = dataset_opt.get("subset_file")
        if subset and os.path.isfile(subset):
            with open(subset) as f:
                wanted = {ln.strip() for ln in f if ln.strip()}
            self.hr_paths = [p for p in self.hr_paths
                             if os.path.basename(p) in wanted or p in wanted]
        self.cache_mb = float(dataset_opt.get("img_cache_mb", 512) or 0)
        self._cache: Dict[int, np.ndarray] = {}
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()  # the loader's threads share it
        self._fast_u8 = (train and self.wire_u8 and self.lr_paths is None
                         and self.skip_host_lr and not self.color
                         and not self.aug_downscale and not self.host_otf)

    def __len__(self) -> int:
        return len(self.hr_paths)

    def _read_u8(self, index: int) -> Optional[np.ndarray]:
        """The HR file as uint8 RGB HWC, from the cache when it is there;
        None when the file is not an 8-bit image or is an LMDB value."""
        img = self._cache.get(index)
        if img is not None:
            return img
        if is_lmdb_path(self.hr_paths[index]):
            return None
        raw = decode_image(self.hr_paths[index])
        if raw.dtype != np.uint8:
            return None
        if raw.ndim == 2:
            raw = np.repeat(raw[:, :, None], 3, axis=2)
        img = np.ascontiguousarray(raw[:, :, :3])
        with self._cache_lock:
            if index not in self._cache and \
                    self._cache_bytes + img.nbytes <= self.cache_mb * 2 ** 20:
                self._cache[index] = img
                self._cache_bytes += img.nbytes
        return img

    def _eval_item(self, index: int):
        hr = channel_convert(read_img(self.hr_paths[index]), self.color)
        if self.lr_paths is not None:
            lr = channel_convert(read_img(self.lr_paths[index]), self.color)
        else:
            hr = modcrop(hr, self.scale)
            lr = imresize_np(hr, 1.0 / self.scale, kernel="cubic")
        hr = modcrop(hr, self.scale)
        lr = lr[: hr.shape[0] // self.scale, : hr.shape[1] // self.scale]
        return hr, lr

    def _train_item(self, index: int, rng):
        s = self.scale
        u8 = self._read_u8(index) if self.cache_mb or self._fast_u8 \
            else None
        if self._fast_u8 and u8 is not None:
            hr = modcrop(u8, s)
            hr, _ = paired_random_crop(hr, hr[::s, ::s], self.hr_crop, s,
                                       rng)
            hr = augment_pair([hr], self.use_flip, self.use_rot, rng)[0]
            return hr, np.ascontiguousarray(hr[::s, ::s])
        hr = (u8.astype(np.float32) / 255.0) if u8 is not None \
            else read_img(self.hr_paths[index])
        hr = channel_convert(hr, self.color)
        if self.lr_paths is not None:
            lr = channel_convert(read_img(self.lr_paths[index]), self.color)
        else:
            hr = modcrop(hr, s)
            lr = self._lr_from(hr, kernel="cubic")
        if self.aug_downscale and rng.random() < self.aug_downscale:
            f = float(rng.uniform(0.5, 0.95))
            new_h = max(int(hr.shape[0] * f) // s * s, self.hr_crop)
            new_w = max(int(hr.shape[1] * f) // s * s, self.hr_crop)
            if new_h < hr.shape[0] and new_w < hr.shape[1]:
                hr = imresize_np(hr, out_shape=(new_h, new_w))
                lr = self._lr_from(hr)
        hr, lr = paired_random_crop(hr, lr, self.hr_crop, s, rng)
        hr, lr = augment_pair([hr, lr], self.use_flip, self.use_rot, rng)
        if self.host_otf:
            lr = self._host_degrade(lr, rng)
        return (img2tensor(hr, self.znorm, self.wire_u8),
                img2tensor(lr, self.znorm, self.wire_u8))

    def _lr_from(self, hr: np.ndarray, **kw) -> np.ndarray:
        """LR made from HR: the strided placeholder where the device
        pipeline makes LR anew, else the bicubic downscale."""
        s = self.scale
        return (np.ascontiguousarray(hr[::s, ::s]) if self.skip_host_lr
                else imresize_np(hr, 1.0 / s, **kw))

    def _host_degrade(self, lr: np.ndarray, rng) -> np.ndarray:
        """The host's exact degradations, driven by the keys of the device
        pipeline (``data/host_degradations.py``): a blur with ``lr_blur``
        (motion for a ``motion`` / ``complexmotion`` type, else gaussian),
        one noise of ``lr_noise_types`` with ``lr_noise`` (jpeg, webp,
        clahe, superpixels or gaussian), then jpeg with ``compression``.
        The ops of OpenCV raise where it is not installed."""
        from . import host_degradations as H

        o = self.opt
        if o.get("lr_blur") and rng.random() < float(
                o.get("blur_prob", 1) or 1):
            types = [str(t) for t in (o.get("lr_blur_types") or
                                      ["gaussian"])]
            t = types[int(rng.integers(0, len(types)))]
            if t in ("motion", "complexmotion"):
                lr = H.motion_blur_exact(lr, 7, float(rng.uniform(0, 180)))
            else:
                lr = H.gaussian_blur_exact(lr, 11,
                                           float(rng.uniform(0.2, 2.8)))
        if o.get("lr_noise"):
            types = [str(t).lower() for t in (o.get("lr_noise_types") or
                                              ["gaussian"])]
            t = types[int(rng.integers(0, len(types)))]
            if t in ("jpeg", "webp"):
                q = int(rng.integers(30, 96))
                lr = (H.jpeg_compress_exact(lr, q) if t == "jpeg"
                      else H.webp_compress_exact(lr, q))
            elif t == "clahe":
                lr = H.clahe_exact(lr)
            elif t == "superpixels":
                from .host_superpixels import superpixels

                n_seg = int(o.get("sp_n_segments", 200))
                p_rep = float(o.get("sp_p_replace", 1.0))
                lr = superpixels(lr, n_segments=n_seg,
                                 algo=str(o.get("sp_algo", "slic")),
                                 kind=str(o.get("sp_kind", "mix")),
                                 reduction=o.get("sp_reduction"),
                                 replace_samples=(rng.random(n_seg) < p_rep
                                                  ).tolist())
            else:
                lr = H.gaussian_noise_exact(lr, float(rng.uniform(1, 25)),
                                            rng)
        if o.get("compression"):
            lr = H.jpeg_compress_exact(lr, int(rng.integers(30, 96)))
        return lr.astype(np.float32)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if self.phase == "train":
            hr, lr = self._train_item(index, np.random.default_rng())
        else:
            hr, lr = self._eval_item(index)
            hr, lr = img2tensor(hr, self.znorm), img2tensor(lr, self.znorm)
        return {"LR": lr, "HR": hr,
                "LR_path": self.lr_paths[index] if self.lr_paths
                else self.hr_paths[index],
                "HR_path": self.hr_paths[index]}


class SingleDataset:
    """LR images only, for inference without ground truth."""

    def __init__(self, dataset_opt: dict):
        root = _dataroot(dataset_opt, "dataroot_LR", "dataroot_A",
                         "dataroot_lq", "dataroot_HR")
        if not root:
            raise ValueError("SingleDataset needs dataroot_LR/A/lq")
        self.paths = scan_images(root)
        self.znorm = bool(dataset_opt.get("znorm"))
        self.color = dataset_opt.get("color")

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        img = channel_convert(read_img(self.paths[index]), self.color)
        return {"LR": img2tensor(img, self.znorm),
                "LR_path": self.paths[index]}


class UnalignedDataset:
    """Unpaired A/B images (CycleGAN's, and pix2pix's ``unaligned``): A
    by index, B by index with ``serial_batches``, else a random one. In
    the train phase each image is reflect-padded at its bottom and right
    up to ``crop_size`` where smaller, randomly cropped to it and, with
    ``use_flip`` (on by default), flipped left-right with probability
    0.5; A's draws, then B's, from one unseeded generator. ``znorm`` (on
    by default) maps to [-1, 1]; ``wire_dtype: uint8`` keeps the wire
    uint8."""

    def __init__(self, dataset_opt: dict):
        self.opt = dataset_opt
        a_root = _dataroot(dataset_opt, "dataroot_A", "dataroot_LR")
        b_root = _dataroot(dataset_opt, "dataroot_B", "dataroot_HR")
        if not a_root or not b_root:
            raise ValueError("UnalignedDataset needs dataroot_A and _B")
        self.a_paths = scan_images(a_root)
        self.b_paths = scan_images(b_root)
        self.serial = bool(dataset_opt.get("serial_batches"))
        self.crop = int(dataset_opt.get("crop_size", 256) or 256)
        self.phase = dataset_opt.get("phase", "train")
        self.znorm = bool(dataset_opt.get("znorm", True))
        self.wire_u8 = str(dataset_opt.get("wire_dtype", "")
                           ).lower() in ("u8", "uint8")
        self.use_flip = bool(dataset_opt.get("use_flip", True))

    def __len__(self) -> int:
        return max(len(self.a_paths), len(self.b_paths))

    def _load(self, path: str, rng) -> np.ndarray:
        img = read_img(path)
        if self.phase == "train":
            h, w = img.shape[:2]
            if h < self.crop or w < self.crop:
                img = np.pad(img, ((0, max(0, self.crop - h)),
                                   (0, max(0, self.crop - w)), (0, 0)),
                             "reflect")
                h, w = img.shape[:2]
            y = int(rng.integers(0, h - self.crop + 1))
            x = int(rng.integers(0, w - self.crop + 1))
            img = img[y: y + self.crop, x: x + self.crop]
            if self.use_flip and rng.random() < 0.5:
                img = np.ascontiguousarray(img[:, ::-1])
        return img2tensor(img, self.znorm, self.wire_u8)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng()
        a = self.a_paths[index % len(self.a_paths)]
        if self.serial:
            b = self.b_paths[index % len(self.b_paths)]
        else:
            b = self.b_paths[int(rng.integers(0, len(self.b_paths)))]
        return {"A": self._load(a, rng), "B": self._load(b, rng),
                "A_path": a, "B_path": b}


class SyntheticDataset:
    """Random images seeded by index: kind ``sr``, HR and its bicubic LR;
    kind ``ab``, an A and a B of ``crop_size``; kind ``video``, a clip of
    ``num_frames`` HR frames and their bicubic LRs; kind ``dvd``, two
    frames (``top``, ``bottom``) and their interlace (``in``)."""

    def __init__(self, dataset_opt: dict):
        self.scale = int(dataset_opt.get("scale", 4) or 4)
        self.hr = int(dataset_opt.get("crop_size", 128) or 128)
        self.n = int(dataset_opt.get("n_samples", 64) or 64)
        self.kind = dataset_opt.get("kind", "sr")
        self.num_frames = int(dataset_opt.get("num_frames", 3) or 3)

    def __len__(self):
        return self.n

    def __getitem__(self, index: int):
        rng = np.random.default_rng(index)
        if self.kind == "ab":
            return {"A": rng.random((self.hr, self.hr, 3), np.float32),
                    "B": rng.random((self.hr, self.hr, 3), np.float32),
                    "A_path": str(index), "B_path": str(index)}
        if self.kind == "video":
            hr = rng.random((self.num_frames, self.hr, self.hr, 3),
                            np.float32)
            lr = np.stack([imresize_np(f, 1.0 / self.scale) for f in hr])
            return {"LR": lr.astype(np.float32), "HR": hr,
                    "LR_path": str(index)}
        if self.kind == "dvd":
            a = rng.random((self.hr, self.hr, 3), np.float32)
            b = rng.random((self.hr, self.hr, 3), np.float32)
            return {"in": interlace(a, b), "top": a, "bottom": b,
                    "LR_path": str(index)}
        hr = rng.random((self.hr, self.hr, 3), np.float32)
        lr = imresize_np(hr, 1.0 / self.scale)
        return {"LR": lr, "HR": hr, "LR_path": str(index),
                "HR_path": str(index)}


def _seg_dataset(dataset_opt: dict):
    from .seg_dataset import SegDataset

    return SegDataset(dataset_opt)


def _video_dataset(dataset_opt: dict):
    from .video_datasets import VidTestDataset, VidTrainDataset

    if dataset_opt.get("phase", "train") == "train":
        return VidTrainDataset(dataset_opt)
    return VidTestDataset(dataset_opt)


def _dvd_dataset(dataset_opt: dict):
    from .video_datasets import DVDDataset

    return DVDDataset(dataset_opt)


def _pbr_dataset(dataset_opt: dict):
    from .pbr_dataset import PBRDataset

    return PBRDataset(dataset_opt)


_DATASETS = {"aligned": AlignedDataset, "single": SingleDataset,
             "unaligned": UnalignedDataset, "synthetic": SyntheticDataset,
             "seg": _seg_dataset, "video": _video_dataset,
             "dvd": _dvd_dataset, "pbr": _pbr_dataset}
_ALIASES = {"lrhr": "aligned", "lrhroft": "aligned", "lrhrc": "aligned",
            "lr": "single", "lrhrseg_bg": "seg", "vlrhr": "video",
            "dvdi": "dvd", "lrhrpbr": "pbr"}


def create_dataset(dataset_opt: dict):
    """Dataset factory: every mode of the JAX package's
    (``trainner_tpu/data/datasets.py::create_dataset``)."""
    mode = (dataset_opt.get("mode") or "aligned").lower()
    key = _ALIASES.get(mode, mode)
    if key not in _DATASETS:
        raise NotImplementedError(f"dataset mode [{mode}] not recognized")
    return _DATASETS[key](dataset_opt)
