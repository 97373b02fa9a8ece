"""Video datasets (host side, numpy, frames NHWC with the frame axis
leading): counterpart of ``trainner_tpu/data/video_datasets.py``
(``_list_videos:27``, ``VidTrainDataset:32``, ``VidTestDataset:107``).

``VidTrainDataset``: a clip of ``num_frames`` frames from a random video
folder of ``dataroot_HR``, frames ``frameskip`` apart (a random skip up to
``max_frameskip``), reversed with probability 0.5 under
``random_reverse``, cropped at one random place (``crop_size``, a multiple
of the scale) and flipped left-right together with probability 0.5; LR is
each frame's bicubic downscale (``imresize_np``). With ``y_only`` the
frames are the Y of YCbCr (one channel), and ``srcolors`` adds
``LR_bicubic`` (the centre LR frame's bicubic upscale in YCbCr) and
``HR_center`` (the centre HR frame in RGB). The draws come from one
unseeded generator per sample, in the JAX package's order.

``VidTestDataset``: the sliding windows of ``num_frames`` over one folder
of frames, with ``LR_path`` the centre frame's path. With both roots, LR
is read from ``dataroot_LR``; with one root alone (either one: the JAX
dataset reads ``dataroot_LR`` first), its frames are the HR and LR is
their bicubic downscale, so ``test_video.yml``, which names only
``dataroot_LR``, serves those frames at 1/scale (ROADMAP C 25).
``srcolors`` is read by the train dataset alone.

``DVDDataset`` (counterpart of ``interlace:166``, ``DVDDataset:174``):
the pairs of consecutive frames of ``dataroot_HR`` (else
``dataroot_B``), ``__len__`` one less than the frames; both cut to the
smaller height (made even) and width; in training a crop of
``min(crop_size, h, w)`` made even, at an even row and any column, from
one unseeded generator per sample (the test phase keeps the whole
frames). ``in`` is the interlaced frame (the first frame's even rows, the
second's odd rows), ``top`` and ``bottom`` the two frames. A dataset that
names only ``dataroot_LR`` raises, as the JAX one does: so
``options/video/test_deinterlace.yml`` as shipped cannot be served
(ROADMAP C 27).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..ops.imresize import imresize_np
from .common import modcrop, read_img, rgb2ycbcr, scan_images


def _list_videos(root: str) -> List[str]:
    return sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d)))


class VidTrainDataset:
    """Training clips: LR (t, h, w, c) and HR (t, h s, w s, c), f32."""

    def __init__(self, dataset_opt: dict):
        self.opt = dataset_opt
        self.scale = int(dataset_opt.get("scale", 4) or 4)
        self.num_frames = int(dataset_opt.get("num_frames", 3) or 3)
        if self.num_frames % 2 != 1:
            raise ValueError("num_frames must be odd")
        self.hr_size = int(dataset_opt.get("crop_size",
                                           dataset_opt.get("HR_size", 128))
                           or 128)
        self.y_only = bool(dataset_opt.get("y_only", False))
        self.random_reverse = bool(dataset_opt.get("random_reverse", False))
        self.max_frameskip = int(dataset_opt.get("max_frameskip", 0) or 0)
        self.srcolors = bool(dataset_opt.get("srcolors", False))
        hr_root = dataset_opt.get("dataroot_HR")
        if not hr_root:
            raise ValueError("VidTrainDataset needs dataroot_HR")
        self.hr_root = hr_root if isinstance(hr_root, str) else hr_root[0]
        self.videos = _list_videos(self.hr_root)
        if not self.videos:
            raise ValueError(f"no video dirs under [{self.hr_root}]")
        self.frames = {v: scan_images(os.path.join(self.hr_root, v))
                       for v in self.videos}
        self.n_samples = int(dataset_opt.get("n_samples", 1000) or 1000)

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng()
        video = self.videos[int(rng.integers(0, len(self.videos)))]
        paths = self.frames[video]
        n = self.num_frames

        frameskip = 1
        if self.max_frameskip > 0:
            mfs = min(self.max_frameskip, max(1, len(paths) // max(n - 1, 1)))
            frameskip = int(rng.integers(1, mfs + 1))
        max_start = len(paths) - 1 - (n - 1) * frameskip
        start = int(rng.integers(0, max(max_start, 0) + 1))
        idxs = [start + i * frameskip for i in range(n)]
        if self.random_reverse and rng.random() < 0.5:
            idxs = idxs[::-1]

        hrs = [modcrop(read_img(paths[i]), self.scale) for i in idxs]
        h, w = hrs[0].shape[:2]
        cs = min(self.hr_size, h, w)
        cs -= cs % self.scale
        y0 = int(rng.integers(0, h - cs + 1))
        x0 = int(rng.integers(0, w - cs + 1))
        hrs = [f[y0:y0 + cs, x0:x0 + cs] for f in hrs]
        if rng.random() < 0.5:
            hrs = [np.ascontiguousarray(f[:, ::-1]) for f in hrs]

        lrs = [imresize_np(f, 1.0 / self.scale) for f in hrs]
        if not self.y_only:
            return {"LR": np.stack(lrs).astype(np.float32),
                    "HR": np.stack(hrs).astype(np.float32)}
        center = (n - 1) // 2
        lr_bic = imresize_np(lrs[center], self.scale)
        hr_center_rgb = hrs[center]
        hrs = [rgb2ycbcr(f, only_y=True)[..., None] for f in hrs]
        lrs = [rgb2ycbcr(f, only_y=False)[..., :1] for f in lrs]
        out = {"LR": np.stack(lrs).astype(np.float32),
               "HR": np.stack(hrs).astype(np.float32)}
        if self.srcolors:
            out["LR_bicubic"] = rgb2ycbcr(lr_bic,
                                          only_y=False).astype(np.float32)
            out["HR_center"] = hr_center_rgb.astype(np.float32)
        return out


class VidTestDataset:
    """Sliding-window clips over one folder of frames."""

    def __init__(self, dataset_opt: dict):
        self.opt = dataset_opt
        self.scale = int(dataset_opt.get("scale", 4) or 4)
        self.num_frames = int(dataset_opt.get("num_frames", 3) or 3)
        self.y_only = bool(dataset_opt.get("y_only", False))
        root = dataset_opt.get("dataroot_LR") or \
            dataset_opt.get("dataroot_HR")
        self.paths = scan_images(root if isinstance(root, str) else root[0])
        self.has_hr = bool(dataset_opt.get("dataroot_HR"))
        self.hr_paths = scan_images(dataset_opt["dataroot_HR"]) \
            if self.has_hr and dataset_opt.get("dataroot_LR") else None

    def __len__(self) -> int:
        return max(0, len(self.paths) - self.num_frames + 1)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        n = self.num_frames
        frames = [modcrop(read_img(self.paths[index + i]), self.scale)
                  for i in range(n)]
        if self.hr_paths:
            hrs = [modcrop(read_img(self.hr_paths[index + i]), self.scale)
                   for i in range(n)]
            lrs = frames
        else:
            hrs = frames
            lrs = [imresize_np(f, 1.0 / self.scale) for f in frames]
        if self.y_only:
            hrs = [rgb2ycbcr(f, only_y=True)[..., None] for f in hrs]
            lrs = [rgb2ycbcr(f, only_y=True)[..., None] for f in lrs]
        return {"LR": np.stack(lrs).astype(np.float32),
                "HR": np.stack(hrs).astype(np.float32),
                "LR_path": self.paths[index + (n - 1) // 2]}


def interlace(top_frame: np.ndarray, bottom_frame: np.ndarray
              ) -> np.ndarray:
    """The even rows of ``top_frame`` with the odd rows of
    ``bottom_frame``."""
    out = top_frame.copy()
    out[1::2] = bottom_frame[1::2]
    return out


class DVDDataset:
    """Deinterlacing pairs: the interlaced input of two consecutive frames
    and both frames as the field targets."""

    def __init__(self, dataset_opt: dict):
        self.opt = dataset_opt
        root = dataset_opt.get("dataroot_HR") or \
            dataset_opt.get("dataroot_B")
        if not root:
            raise ValueError("DVDDataset needs dataroot_HR")
        self.paths = scan_images(root if isinstance(root, str) else root[0])
        self.crop = int(dataset_opt.get("crop_size", 128) or 128)
        self.phase = dataset_opt.get("phase", "train")

    def __len__(self) -> int:
        return max(0, len(self.paths) - 1)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            None if self.phase == "train" else index)
        a = read_img(self.paths[index])
        b = read_img(self.paths[index + 1])
        h = min(a.shape[0], b.shape[0]) // 2 * 2
        w = min(a.shape[1], b.shape[1])
        a, b = a[:h, :w], b[:h, :w]
        if self.phase == "train":
            cs = min(self.crop, h, w) // 2 * 2
            y0 = int(rng.integers(0, h - cs + 1)) // 2 * 2
            x0 = int(rng.integers(0, w - cs + 1))
            a = a[y0:y0 + cs, x0:x0 + cs]
            b = b[y0:y0 + cs, x0:x0 + cs]
        return {"in": interlace(a, b).astype(np.float32),
                "top": a.astype(np.float32),
                "bottom": b.astype(np.float32),
                "LR_path": self.paths[index]}
