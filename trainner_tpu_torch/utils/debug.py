"""NaN checks for a training run: counterpart of
``trainner_tpu/utils/debug.py::enable_nan_checks:95`` (``debug_nans``).

``enable_nan_checks`` turns on autograd's anomaly detection, which raises
in the backward pass at the first operation whose gradient is not finite
and names the forward operation that made it; ``check_finite`` raises
``FloatingPointError`` on a training log that is not finite. Reading a log
waits for the device, so the training loop calls it only with
``debug_nans`` on.
"""

from __future__ import annotations

import math
from typing import Mapping

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
