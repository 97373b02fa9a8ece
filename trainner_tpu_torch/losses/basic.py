"""Pixel criteria: counterpart of ``trainner_tpu/losses/basic.py`` for l1
and l2/mse. The other criteria are not ported yet."""

from __future__ import annotations

from typing import Callable

import torch


def l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().mean()


def mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((x - y) ** 2).mean()


PIXEL_CRITERIA = {"l1": l1, "l2": mse, "mse": mse}


def get_pixel_criterion(name: str) -> Callable:
    key = (name or "l1").lower().replace("-", "").replace("_", "")
    if key not in PIXEL_CRITERIA:
        raise NotImplementedError(
            f"pixel criterion [{name}] is not ported yet (ROADMAP Queue A "
            "10.7, the other losses)")
    return PIXEL_CRITERIA[key]
