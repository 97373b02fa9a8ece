"""Datasets: host-side sample producers (numpy HWC arrays).

Counterpart of ``trainner_tpu/data/datasets.py``: ``AlignedDataset:44`` in
both phases, ``SingleDataset:277``, ``SyntheticDataset:349`` (kind ``sr``)
and ``create_dataset:431`` for these modes. The datasets read, crop and
flip; the degradations run batched on the device (``data/pipeline.py``).

Not ported yet, each raising with its ROADMAP item: LMDB roots,
``aug_downscale``, ``color`` and ``subset_file`` when training,
``otf_mode: host``, and the other dataset modes.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np

from ..ops.imresize import imresize_np
from .common import augment_pair, channel_convert, decode_image, \
    img2tensor, modcrop, paired_random_crop, read_img, scan_images

# train-dataset option -> its ROADMAP item
_NOT_PORTED = {
    "aug_downscale": "Queue A 5.4, the other train-dataset options",
    "color": "Queue A 5.4, the other train-dataset options",
    "subset_file": "Queue A 5.4, the other train-dataset options",
}


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
    and transpose. With ``wire_dtype: uint8`` and the placeholder LR the
    whole path stays uint8 (decode, crop, flip), and decoded images are
    kept in a cache of ``img_cache_mb`` megabytes."""

    def __init__(self, dataset_opt: dict):
        self.opt = dataset_opt
        self.scale = int(dataset_opt.get("scale", 4) or 4)
        self.hr_crop = int(dataset_opt.get("crop_size",
                                           dataset_opt.get("HR_size", 128))
                           or 128)
        self.phase = dataset_opt.get("phase", "train")
        train = self.phase == "train"
        if train:
            for key, item in _NOT_PORTED.items():
                if dataset_opt.get(key):
                    raise NotImplementedError(
                        f"train-dataset option [{key}] is not ported yet "
                        f"(ROADMAP {item})")
            if dataset_opt.get("otf_mode") == "host":
                raise NotImplementedError(
                    "otf_mode [host] is not ported yet (ROADMAP Queue A "
                    "5.5, host-side OTF degradations)")
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
        # the same condition by which the producer decides that LR is
        # regenerated from the HR batch (train/producer.py)
        self.skip_host_lr = False
        if train and self.lr_paths is None:
            from .pipeline import get_unpaired_params

            self.skip_host_lr = "resize" in get_unpaired_params(
                dataset_opt)[0]
        self.cache_mb = float(dataset_opt.get("img_cache_mb", 512) or 0)
        self._cache: Dict[int, np.ndarray] = {}
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()  # the loader's threads share it
        self._fast_u8 = (train and self.wire_u8 and self.lr_paths is None
                         and self.skip_host_lr)

    def __len__(self) -> int:
        return len(self.hr_paths)

    def _read_u8(self, index: int) -> Optional[np.ndarray]:
        """The HR file as uint8 RGB HWC, from the cache when it is there;
        None when the file is not an 8-bit image."""
        img = self._cache.get(index)
        if img is not None:
            return img
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
        if self.lr_paths is not None:
            lr = read_img(self.lr_paths[index])
        else:
            hr = modcrop(hr, s)
            lr = (np.ascontiguousarray(hr[::s, ::s]) if self.skip_host_lr
                  else imresize_np(hr, 1.0 / s, kernel="cubic"))
        hr, lr = paired_random_crop(hr, lr, self.hr_crop, s, rng)
        hr, lr = augment_pair([hr, lr], self.use_flip, self.use_rot, rng)
        return (img2tensor(hr, self.znorm, self.wire_u8),
                img2tensor(lr, self.znorm, self.wire_u8))

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


class SyntheticDataset:
    """Random HR images (seeded by index) and their bicubic LR: kind 'sr'."""

    def __init__(self, dataset_opt: dict):
        self.scale = int(dataset_opt.get("scale", 4) or 4)
        self.hr = int(dataset_opt.get("crop_size", 128) or 128)
        self.n = int(dataset_opt.get("n_samples", 64) or 64)
        self.kind = dataset_opt.get("kind", "sr")
        if self.kind != "sr":
            raise NotImplementedError(
                f"synthetic kind [{self.kind}] is not ported yet (ROADMAP "
                "Queue A 10.2-10.6, the other models)")

    def __len__(self):
        return self.n

    def __getitem__(self, index: int):
        rng = np.random.default_rng(index)
        hr = rng.random((self.hr, self.hr, 3), np.float32)
        lr = imresize_np(hr, 1.0 / self.scale)
        return {"LR": lr, "HR": hr, "LR_path": str(index),
                "HR_path": str(index)}


_DATASETS = {"aligned": AlignedDataset, "single": SingleDataset,
             "synthetic": SyntheticDataset}
_ALIASES = {"lrhr": "aligned", "lrhroft": "aligned", "lrhrc": "aligned",
            "lr": "single"}


def create_dataset(dataset_opt: dict):
    """Dataset factory for the ported modes."""
    mode = (dataset_opt.get("mode") or "aligned").lower()
    key = _ALIASES.get(mode, mode)
    if key not in _DATASETS:
        raise NotImplementedError(
            f"dataset mode [{mode}] is not ported yet (ROADMAP Queue A 10, "
            "the rest of the zoo)")
    return _DATASETS[key](dataset_opt)
