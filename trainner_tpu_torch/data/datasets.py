"""Datasets for inference: host-side sample producers (numpy HWC float32).

Counterpart of ``trainner_tpu/data/datasets.py``: ``SyntheticDataset:349``
(kind ``sr``), ``SingleDataset:277``, the inference branch of
``AlignedDataset:44`` and ``create_dataset:431`` for these modes. Training
datasets and the other modes are not ported yet and raise.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..ops.imresize import imresize_np
from .common import channel_convert, img2tensor, modcrop, read_img, \
    scan_images


def _dataroot(dataset_opt: dict, *keys: str) -> Optional[str]:
    for k in keys:
        v = dataset_opt.get(k)
        if v:
            return v if isinstance(v, str) else v[0]
    return None


class AlignedDataset:
    """Paired LR/HR images for evaluation. Without an LR root (or with a
    different number of LR images), LR is the bicubic downscale of HR."""

    def __init__(self, dataset_opt: dict):
        if dataset_opt.get("phase", "train") == "train":
            raise NotImplementedError(
                "training datasets are not ported yet (ROADMAP Queue A, "
                "end-to-end producer)")
        self.scale = int(dataset_opt.get("scale", 4) or 4)
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
        self.color = dataset_opt.get("color")

    def __len__(self) -> int:
        return len(self.hr_paths)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        hr = channel_convert(read_img(self.hr_paths[index]), self.color)
        if self.lr_paths is not None:
            lr = channel_convert(read_img(self.lr_paths[index]), self.color)
        else:
            hr = modcrop(hr, self.scale)
            lr = imresize_np(hr, 1.0 / self.scale, kernel="cubic")
        hr = modcrop(hr, self.scale)
        lr = lr[: hr.shape[0] // self.scale, : hr.shape[1] // self.scale]
        return {"LR": img2tensor(lr, self.znorm),
                "HR": img2tensor(hr, self.znorm),
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
                "Queue A, other generator types)")

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
    """Dataset factory for the inference modes."""
    mode = (dataset_opt.get("mode") or "aligned").lower()
    key = _ALIASES.get(mode, mode)
    if key not in _DATASETS:
        raise NotImplementedError(
            f"dataset mode [{mode}] is not ported yet (ROADMAP Queue A, "
            "end-to-end producer)")
    return _DATASETS[key](dataset_opt)
