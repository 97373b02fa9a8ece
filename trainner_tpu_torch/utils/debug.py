"""NaN checks for a training run and the batch introspection of the
data tools: counterpart of ``trainner_tpu/utils/debug.py``
(``enable_nan_checks:95`` for ``debug_nans``, ``describe_array:22``,
``tmp_vis:36``).

``enable_nan_checks`` turns on autograd's anomaly detection, which raises
in the backward pass at the first operation whose gradient is not finite
and names the forward operation that made it; ``check_finite`` raises
``FloatingPointError`` on a training log that is not finite. Reading a log
waits for the device, so the training loop calls it only with
``debug_nans`` on.
"""

from __future__ import annotations

import math
import os
from typing import Mapping

import numpy as np
import torch


def enable_nan_checks(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


def check_finite(logs: Mapping[str, torch.Tensor], step: int) -> None:
    """Raises ``FloatingPointError`` naming the first log entry of
    ``step`` that is NaN or infinite."""
    for k, v in logs.items():
        value = float(v)
        if not math.isfinite(value):
            raise FloatingPointError(
                f"training log {k} is {value} at iteration {step}")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def describe_array(x, name: str = "array") -> str:
    """A one-line summary of an array or tensor: shape, dtype, min, max,
    mean and std of its finite values, and how many are not finite, in
    the JAX package's format."""
    a = _host(x)
    finite = a[np.isfinite(a)] if a.size else a
    stats = (f"min={finite.min():.4g} max={finite.max():.4g} "
             f"mean={finite.mean():.4g} std={finite.std():.4g}"
             if finite.size else "all-nonfinite")
    n_bad = int(a.size - np.isfinite(a).sum())
    bad = f" NONFINITE={n_bad}" if n_bad else ""
    return f"{name}: shape={tuple(a.shape)} dtype={a.dtype} {stats}{bad}"


def tmp_vis(x, save_dir: str, name: str = "vis") -> str:
    """An NHWC (or HWC) batch as ``{save_dir}/{name}_{i}.png``, each
    image through ``tensor2img``; returns ``save_dir``."""
    from ..data.common import save_img, tensor2img

    os.makedirs(save_dir, exist_ok=True)
    a = _host(x)
    if a.ndim == 3:
        a = a[None]
    for i, img in enumerate(a):
        save_img(tensor2img(img), os.path.join(save_dir, f"{name}_{i}.png"))
    return save_dir
