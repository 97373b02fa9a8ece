"""The producer in front of the training step: the on-device degradation
of a batch and the endless stream of batches on the device.

Counterpart of ``train.py::make_otf_degradation:156`` and of the batch
stream of ``bench.py::bench_train_e2e:188``. The command-line trainer
around them (validation, logging, checkpoints, resume) is not ported yet
(ROADMAP Queue A 8).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Union

import torch

from ..data.loader import device_prefetch
from ..data.pipeline import BatchDegrader, get_unpaired_params
from ..utils.device import resolve_device

Batch = Dict[str, Any]


def make_otf_degradation(opt: dict,
                         device: Union[str, torch.device, None] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> Optional[Callable[[Batch], Batch]]:
    """The degradation step of the train dataset's options, or None when
    they ask for none. The step takes a batch whose tensors lie on
    ``device`` (``cuda`` unless the caller names the CPU) and returns it
    with the HR degrader applied to ``HR`` (where the options have one)
    and ``LR`` made anew by the LR degrader: from ``HR`` when the pipeline
    holds the in-pipeline resize, else from ``LR``. The random numbers
    come from ``generator`` (on ``device``; seeded with 0 when none is
    given). Nothing here records gradients."""
    train_ds = None
    for phase_key, ds in (opt.get("datasets") or {}).items():
        if phase_key.split("_")[0] == "train":
            train_ds = ds
            break
    if train_ds is None:
        return None
    dev = resolve_device(device)
    lr_p, hr_p = get_unpaired_params(train_ds)
    lr_deg = BatchDegrader(train_ds, "lr", lr_p) if lr_p else None
    hr_deg = BatchDegrader(train_ds, "hr", hr_p) if hr_p else None
    if (lr_deg is None or lr_deg.is_noop) and \
            (hr_deg is None or hr_deg.is_noop):
        return None
    lr_from_hr = lr_deg is not None and \
        any(n == "resize" for n, _ in lr_deg.stages)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    elif gen.device.type != dev.type:
        raise ValueError(f"the generator lies on {gen.device}, the "
                         f"producer runs on {dev}")

    def apply(batch: Batch) -> Batch:
        batch = dict(batch)
        if hr_deg is not None and not hr_deg.is_noop and "HR" in batch:
            batch["HR"] = hr_deg(gen, batch["HR"].to(dev))
        if lr_deg is not None and not lr_deg.is_noop:
            src = batch["HR"] if lr_from_hr else batch["LR"]
            batch["LR"] = lr_deg(gen, src.to(dev))
        return batch

    return apply


def batches(loader, device: Union[str, torch.device, None] = None,
            size: int = 2) -> Iterator[Batch]:
    """Endless stream of the loader's batches, epoch after epoch, tensors
    only, ``size`` of them ahead on ``device``."""
    def tensors_only(it):
        for b in it:
            yield {k: v for k, v in b.items() if isinstance(v, torch.Tensor)}

    while True:
        yield from device_prefetch(tensors_only(iter(loader)), size=size,
                                   device=device)
