"""The PBR material-map dataset: counterpart of
``trainner_tpu/data/pbr_dataset.py`` (``_MAP_SUFFIXES:22``,
``_find_maps:34``, ``PBRDataset:44``), for the modes ``pbr`` and
``lrhrpbr``.

Each directory under ``dataroot_HR`` is one material whose maps are named
by suffix: ``_diffuse.`` / ``_color.``, ``_albedo.`` and ``_normal.``
(three channels), ``_ao.`` / ``_occlusion.`` / ``_ambientocclusion.``,
``_height.`` / ``_displacement.`` / ``_bump.``, ``_metalness.``,
``_reflection.`` and ``_roughness.`` / ``_glossiness.`` / ``_gloss.``
(one channel: the first of the file's channels; a glossiness map is read
as roughness as it is, not inverted). The first file by name that matches
a map's suffixes is that map. All maps are cropped together, to
``min(crop_size, h, w)`` rounded down to a multiple of the scale (at a
random place from one unseeded generator per sample in training, the
top left corner otherwise); each LR map is its HR crop's bicubic
downscale (``imresize_np``): ``dataroot_LR`` is not read (ROADMAP C 27).
A sample holds ``HR_{map}`` and ``LR_{map}`` for each map, and ``LR`` /
``HR``, the diffuse pair or else the first map's by name.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..ops.imresize import imresize_np
from .common import read_img

_MAP_SUFFIXES = {
    "diffuse": (("_diffuse.", "_color."), 3),
    "albedo": (("_albedo.",), 3),
    "normal": (("_normal.",), 3),
    "ao": (("_ao.", "_occlusion.", "_ambientocclusion."), 1),
    "height": (("_height.", "_displacement.", "_bump."), 1),
    "metalness": (("_metalness.",), 1),
    "reflection": (("_reflection.",), 1),
    "roughness": (("_roughness.", "_glossiness.", "_gloss."), 1),
}


def _find_maps(d: str) -> Dict[str, str]:
    """Map name -> the first file of ``d`` by name whose lower-cased name
    holds one of its suffixes."""
    found = {}
    for f in sorted(os.listdir(d)):
        low = f.lower()
        for name, (sufs, _) in _MAP_SUFFIXES.items():
            if any(s in low for s in sufs) and name not in found:
                found[name] = os.path.join(d, f)
    return found


class PBRDataset:
    """Every map of one material per sample, cropped together."""

    def __init__(self, dataset_opt: dict):
        self.opt = dataset_opt
        self.scale = int(dataset_opt.get("scale", 4) or 4)
        self.crop = int(dataset_opt.get("crop_size",
                                        dataset_opt.get("HR_size", 128))
                        or 128)
        self.phase = dataset_opt.get("phase", "train")
        hr_root = dataset_opt.get("dataroot_HR")
        if not hr_root:
            raise ValueError("PBRDataset needs dataroot_HR")
        hr_root = hr_root if isinstance(hr_root, str) else hr_root[0]
        self.sample_dirs = sorted(
            os.path.join(hr_root, d) for d in os.listdir(hr_root)
            if os.path.isdir(os.path.join(hr_root, d)))
        if not self.sample_dirs:
            raise ValueError(f"no material dirs under [{hr_root}]")

    def __len__(self) -> int:
        return len(self.sample_dirs)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            None if self.phase == "train" else index)
        hr_imgs = {}
        for name, path in _find_maps(self.sample_dirs[index]).items():
            img = read_img(path, out_nc=3)
            hr_imgs[name] = img[..., :1] if _MAP_SUFFIXES[name][1] == 1 \
                else img
        if not hr_imgs:
            raise ValueError(f"no PBR maps in {self.sample_dirs[index]}")
        h = min(m.shape[0] for m in hr_imgs.values())
        w = min(m.shape[1] for m in hr_imgs.values())
        cs = min(self.crop, h, w) // self.scale * self.scale
        if self.phase == "train":
            y0 = int(rng.integers(0, h - cs + 1))
            x0 = int(rng.integers(0, w - cs + 1))
        else:
            y0 = x0 = 0
        out: Dict[str, np.ndarray] = {}
        for name, img in hr_imgs.items():
            crop = img[y0:y0 + cs, x0:x0 + cs]
            out[f"HR_{name}"] = crop.astype(np.float32)
            out[f"LR_{name}"] = imresize_np(
                crop, 1.0 / self.scale).astype(np.float32)
        primary = "diffuse" if "diffuse" in hr_imgs else sorted(hr_imgs)[0]
        out["LR"] = out[f"LR_{primary}"]
        out["HR"] = out[f"HR_{primary}"]
        out["HR_path"] = self.sample_dirs[index]
        out["LR_path"] = self.sample_dirs[index]
        return out
