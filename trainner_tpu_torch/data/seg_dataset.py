"""SFTGAN's dataset: counterpart of ``trainner_tpu/data/seg_dataset.py``
(``_load_seg:25``, ``SegDataset:43``).

Each sample is an HR image cropped to a multiple of the scale
(``modcrop``), the 8-class segmentation probabilities at its size, its
bicubic LR (``imresize_np``) and ``category``, the argmax of the
probabilities' mean over the image. The probabilities come from
``dataroot_seg``, by the HR file's stem: an ``(h, w, 8)`` ``.npy`` (an
``(h, w)`` one of class ids is one-hot coded), or a category image (its
first channel times 255, modulo 8, one-hot); without either they are
uniform, 1/8. A map smaller than HR is edge-padded at its bottom and
right. In the train phase HR and the map are cropped together at one
random place to ``crop_size`` (at most the image's smaller side, a
multiple of the scale) from an unseeded generator; no flip.
``dataroot_HR_bg`` is not read (ROADMAP C 22). ``category`` is a numpy
scalar, so the loaders leave it out of the batch's tensors, as the JAX
CLI's do: the trainer then derives it from the maps.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..ops.imresize import imresize_np
from .common import modcrop, read_img, scan_images

N_CLASSES = 8


def load_seg(path: Optional[str], hr_shape) -> np.ndarray:
    """(h, w, 8) f32 probabilities from ``path`` (``.npy`` or a category
    image), else uniform at ``hr_shape``'s size."""
    h, w = hr_shape[:2]
    if path and path.endswith(".npy") and os.path.exists(path):
        seg = np.load(path)
        if seg.ndim == 3 and seg.shape[-1] == N_CLASSES:
            return seg.astype(np.float32)
        if seg.ndim == 2:
            return np.eye(N_CLASSES, dtype=np.float32)[
                np.clip(seg, 0, N_CLASSES - 1).astype(int)]
    if path and os.path.exists(path):
        cat = (read_img(path)[..., 0] * 255).astype(int) % N_CLASSES
        return np.eye(N_CLASSES, dtype=np.float32)[cat]
    return np.full((h, w, N_CLASSES), 1.0 / N_CLASSES, np.float32)


class SegDataset:
    """HR images (``dataroot_HR``) with their segmentation maps
    (``dataroot_seg``, optional)."""

    def __init__(self, dataset_opt: dict):
        self.opt = dataset_opt
        self.scale = int(dataset_opt.get("scale", 4) or 4)
        self.crop = int(dataset_opt.get("crop_size",
                                        dataset_opt.get("HR_size", 96))
                        or 96)
        self.phase = dataset_opt.get("phase", "train")
        hr_root = dataset_opt.get("dataroot_HR")
        if not hr_root:
            raise ValueError("SegDataset needs dataroot_HR")
        self.hr_paths = scan_images(
            hr_root if isinstance(hr_root, str) else hr_root[0])
        self.seg_root = dataset_opt.get("dataroot_seg")

    def __len__(self) -> int:
        return len(self.hr_paths)

    def _seg_path(self, hr_path: str) -> Optional[str]:
        if not self.seg_root:
            return None
        stem = os.path.splitext(os.path.basename(hr_path))[0]
        for ext in (".npy", ".png", ".bmp"):
            p = os.path.join(self.seg_root, stem + ext)
            if os.path.exists(p):
                return p
        return None

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            None if self.phase == "train" else index)
        hr = modcrop(read_img(self.hr_paths[index]), self.scale)
        seg = load_seg(self._seg_path(self.hr_paths[index]), hr.shape)
        seg = seg[:hr.shape[0], :hr.shape[1]]
        if seg.shape[:2] != hr.shape[:2]:
            pad = ((0, hr.shape[0] - seg.shape[0]),
                   (0, hr.shape[1] - seg.shape[1]), (0, 0))
            seg = np.pad(seg, pad, mode="edge")
        if self.phase == "train":
            cs = min(self.crop, *hr.shape[:2]) // self.scale * self.scale
            y0 = int(rng.integers(0, hr.shape[0] - cs + 1))
            x0 = int(rng.integers(0, hr.shape[1] - cs + 1))
            hr = hr[y0:y0 + cs, x0:x0 + cs]
            seg = seg[y0:y0 + cs, x0:x0 + cs]
        lr = imresize_np(hr, 1.0 / self.scale)
        category = int(np.argmax(seg.mean(axis=(0, 1))))
        return {"LR": lr.astype(np.float32),
                "HR": hr.astype(np.float32),
                "seg": seg.astype(np.float32),
                "category": np.int32(category),
                "HR_path": self.hr_paths[index],
                "LR_path": self.hr_paths[index]}
