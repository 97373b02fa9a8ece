"""Evaluation metrics: MATLAB-style PSNR and SSIM on the host, LPIPS on
the device.

Counterpart of ``trainner_tpu/utils/metrics.py`` (``calculate_psnr:52``,
``_ssim_single:63``, ``calculate_ssim:86``, ``crop_border:101``,
``MetricsDict:114``, ``Timer:197``). SSIM's 11x11 Gaussian window (sigma
1.5) is applied with scipy as two 1-D passes in place of ``cv2.filter2D``;
the map is cut to the valid region ``[5:-5]``, so the border mode does not
enter the result.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
from scipy.ndimage import correlate1d


def rgb2ycbcr_np(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """MATLAB rgb2ycbcr for RGB images in [0, 1] or uint8 [0, 255]."""
    in_dtype = img.dtype
    img = img.astype(np.float64)
    if in_dtype != np.uint8:
        img *= 255.0
    if only_y:
        out = np.dot(img, [65.481, 128.553, 24.966]) / 255.0 + 16.0
    else:
        out = img @ np.array([[65.481, -37.797, 112.0],
                              [128.553, -74.203, -93.786],
                              [24.966, 112.0, -18.214]]) / 255.0
        out += [16, 128, 128]
    if in_dtype == np.uint8:
        out = out.round()
    else:
        out /= 255.0
    return out.astype(in_dtype)


def calculate_psnr(img1: np.ndarray, img2: np.ndarray,
                   max_val: float = 255.0) -> float:
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(max_val / math.sqrt(mse))


def _gaussian_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-x * x / (2 * sigma * sigma))
    return k / k.sum()


def _filter_valid(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    out = correlate1d(correlate1d(img, k, axis=0, mode="mirror"), k,
                      axis=1, mode="mirror")
    r = len(k) // 2
    return out[r:-r, r:-r]


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    """SSIM of two 2-D planes in the [0, 255] range."""
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    k = _gaussian_1d()
    mu1 = _filter_valid(img1, k)
    mu2 = _filter_valid(img2, k)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter_valid(img1 ** 2, k) - mu1_sq
    sigma2_sq = _filter_valid(img2 ** 2, k) - mu2_sq
    sigma12 = _filter_valid(img1 * img2, k) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / \
        ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """SSIM over HxW or HxWxC (channel-averaged), images in [0, 255]."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2:
        return _ssim_single(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 3:
            return float(np.mean([_ssim_single(img1[..., i], img2[..., i])
                                  for i in range(3)]))
        return _ssim_single(np.squeeze(img1), np.squeeze(img2))
    raise ValueError("Wrong input image dimensions.")


def crop_border(img: np.ndarray, border: int) -> np.ndarray:
    """Shave ``border`` pixels (the scale) before computing a metric."""
    if border == 0:
        return img
    return img[border:-border, border:-border, ...]


class MetricsDict:
    """Accumulates 'psnr', 'ssim' and 'lpips' over an evaluation run.
    Images are HWC RGB float [0, 1] or uint8 [0, 255]. 'lpips' builds
    ``losses/lpips.py::LPIPSMetric(net="squeeze")`` on ``device`` (the card
    unless the caller names the CPU) from ``lpips_weights`` unless
    ``lpips_model`` is given; without weights it raises here, at setup."""

    def __init__(self, metrics: str = "psnr", lpips_model=None,
                 lpips_weights: Optional[str] = None, device=None):
        self.names = [m.strip().lower() for m in metrics.split(",")
                      if m.strip()]
        self.results: List[Dict[str, float]] = []
        if lpips_model is None and "lpips" in self.names:
            from ..losses.lpips import LPIPSMetric

            lpips_model = LPIPSMetric(net="squeeze",
                                      weights_path=lpips_weights,
                                      device=device)
        self._lpips = lpips_model

    def calculate_metrics(self, sr: np.ndarray, gt: np.ndarray,
                          crop_size: int = 0, only_y: bool = False) -> Dict:
        sr = np.asarray(sr)
        gt = np.asarray(gt)
        if sr.dtype != np.uint8 and sr.max() <= 1.5:
            sr255, gt255 = sr * 255.0, gt * 255.0
        else:
            sr255, gt255 = sr.astype(np.float64), gt.astype(np.float64)
        if only_y and sr255.ndim == 3 and sr255.shape[2] == 3:
            sr255 = rgb2ycbcr_np(sr255 / 255.0, True) * 255.0
            gt255 = rgb2ycbcr_np(gt255 / 255.0, True) * 255.0
        sr_c = crop_border(sr255, crop_size)
        gt_c = crop_border(gt255, crop_size)
        entry: Dict[str, float] = {}
        for m in self.names:
            if m == "psnr":
                entry["psnr"] = calculate_psnr(sr_c, gt_c)
            elif m == "ssim":
                entry["ssim"] = calculate_ssim(sr_c, gt_c)
            elif m == "lpips" and self._lpips is not None:
                entry["lpips"] = float(self._lpips(sr, gt))
        self.results.append(entry)
        return entry

    def get_averages(self) -> List[Dict]:
        if not self.results:
            return []
        avgs = []
        for m in self.names:
            vals = [r[m] for r in self.results if m in r]
            if vals:
                avgs.append({"name": m, "average": float(np.mean(vals))})
        return avgs


class Timer:
    """Per-iteration wall time on the host clock, with a running mean."""

    def __init__(self):
        self.calls = 0
        self.start_time = 0.0
        self.total_time = 0.0
        self.diff = 0.0

    def tic(self) -> None:
        self.start_time = time.time()

    def toc(self) -> float:
        """Ends an iteration (its time is ``diff``); returns the mean time
        of the iterations so far, which the log line reports."""
        self.diff = time.time() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        return self.get_average_time()

    def get_average_time(self) -> float:
        """The mean time of the iterations ended so far (the JAX package's
        ends one more iteration here, at the time of the call)."""
        return self.total_time / max(self.calls, 1)
