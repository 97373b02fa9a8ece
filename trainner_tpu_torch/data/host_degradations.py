"""The host's exact degradations, one function per op, on HWC float32
images in [0, 1]: the port's copy of ``trainner_tpu/data/host_degradations.py``
(``jpeg_compress_exact``, ``webp_compress_exact``, ``gaussian_blur_exact``,
``motion_blur_exact``, ``gaussian_noise_exact``, ``clahe_exact``).

``otf_mode: host`` runs them per sample in the loader's threads
(``data/datasets.py::AlignedDataset._host_degrade``): the real JPEG and
WebP codecs and OpenCV's blurs and CLAHE, which the device pipeline only
approximates. Every op but the gaussian noise is OpenCV's; where OpenCV is
not installed (the card's machine has none) such an op raises
``HostOpUnavailable``, which names it, and runs nothing in its place.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class HostOpUnavailable(ImportError):
    """A host op that needs OpenCV, called where it is not installed."""


def cv2_for(op: str):
    """The ``cv2`` module, imported for ``op``; raises
    ``HostOpUnavailable`` naming ``op`` where OpenCV is missing."""
    try:
        import cv2
    except ImportError as e:
        raise HostOpUnavailable(
            f"the host op [{op}] needs OpenCV (cv2), which is not installed "
            "here; nothing replaces it (ROADMAP C 20)") from e
    return cv2


def _to_u8(img: np.ndarray) -> np.ndarray:
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _to_f32(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) / 255.0


def _codec_round_trip(img: np.ndarray, op: str, ext: str, flag: str,
                      quality: int) -> np.ndarray:
    cv2 = cv2_for(op)
    ok, enc = cv2.imencode(ext, _to_u8(img)[..., ::-1],
                           [getattr(cv2, flag), int(quality)])
    if not ok:
        raise IOError(f"{op}: OpenCV could not encode the image")
    return _to_f32(cv2.imdecode(enc, cv2.IMREAD_UNCHANGED)[..., ::-1])


def jpeg_compress_exact(img: np.ndarray, quality: int) -> np.ndarray:
    """A real libjpeg encode and decode at ``quality``."""
    return _codec_round_trip(img, "jpeg_compress_exact", ".jpg",
                             "IMWRITE_JPEG_QUALITY", quality)


def webp_compress_exact(img: np.ndarray, quality: int) -> np.ndarray:
    """A real libwebp encode and decode at ``quality``."""
    return _codec_round_trip(img, "webp_compress_exact", ".webp",
                             "IMWRITE_WEBP_QUALITY", quality)


def gaussian_blur_exact(img: np.ndarray, kernel_size: int,
                        sigma: float) -> np.ndarray:
    return cv2_for("gaussian_blur_exact").GaussianBlur(
        img, (kernel_size, kernel_size), sigma)


def motion_blur_exact(img: np.ndarray, kernel_size: int,
                      angle: float) -> np.ndarray:
    """A horizontal line kernel turned by ``angle`` degrees, normalised."""
    cv2 = cv2_for("motion_blur_exact")
    k = np.zeros((kernel_size, kernel_size), np.float32)
    k[kernel_size // 2, :] = 1.0
    m = cv2.getRotationMatrix2D((kernel_size / 2 - 0.5,
                                 kernel_size / 2 - 0.5), angle, 1.0)
    k = cv2.warpAffine(k, m, (kernel_size, kernel_size))
    k = k / max(k.sum(), 1e-8)
    return cv2.filter2D(img, -1, k)


def gaussian_noise_exact(img: np.ndarray, sigma255: float,
                         rng: Optional[np.random.Generator] = None,
                         gray: bool = False) -> np.ndarray:
    """Additive gaussian noise of ``sigma255`` / 255, one map per channel
    (or one shared with ``gray``), clipped to [0, 1]; numpy alone."""
    rng = rng or np.random.default_rng()
    shape = img.shape[:2] + ((1,) if gray else (img.shape[2],))
    noise = rng.normal(0.0, sigma255 / 255.0, shape).astype(np.float32)
    return np.clip(img + noise, 0.0, 1.0)


def clahe_exact(img: np.ndarray, clip_limit: float = 2.0,
                tile_grid: Tuple[int, int] = (8, 8)) -> np.ndarray:
    """CLAHE on the L channel of Lab."""
    cv2 = cv2_for("clahe_exact")
    lab = cv2.cvtColor(_to_u8(img), cv2.COLOR_RGB2LAB)
    clahe = cv2.createCLAHE(clipLimit=clip_limit, tileGridSize=tile_grid)
    lab[..., 0] = clahe.apply(lab[..., 0])
    return _to_f32(cv2.cvtColor(lab, cv2.COLOR_LAB2RGB))
