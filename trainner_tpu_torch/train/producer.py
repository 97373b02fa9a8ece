"""The producer in front of the training step: the on-device degradation
of a batch and the endless stream of batches on the device.

Counterpart of ``train.py::make_otf_degradation:156`` and of the batch
stream of ``bench.py::bench_train_e2e:188``, with the JAX
``BatchDegrader``'s compiled programs as CUDA graphs on the card
(``utils/graphs.py``). The training CLI (``train/cli.py``) runs the same
degradation step in its loop.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Union

import torch

from ..data.loader import device_prefetch
from ..data.pipeline import (BatchDegrader, PlanBuffer, get_unpaired_params,
                             plan_to_device, split_plan)
from ..utils.device import resolve_device
from ..utils.graphs import Captured, signature, warm_up

Batch = Dict[str, Any]


def make_otf_degradation(opt: dict,
                         device: Union[str, torch.device, None] = None,
                         generator: Optional[torch.Generator] = None,
                         graphs: Optional[bool] = None
                         ) -> Optional[Callable[[Batch], Batch]]:
    """The degradation step of the train dataset's options, or None when
    they ask for none. The step takes a batch whose tensors lie on
    ``device`` (``cuda`` unless the caller names the CPU) and returns it
    with the HR degrader applied to ``HR`` (where the options have one)
    and ``LR`` made anew by the LR degrader: from ``HR`` when the pipeline
    holds the in-pipeline resize, else from ``LR``. The random numbers
    come from ``generator`` (on ``device``; seeded with 0 when none is
    given). Nothing here records gradients. ``graphs`` (default: on for
    ``cuda``) runs both degraders as one CUDA graph per batch signature
    (``GraphedDegradation``); ``False`` runs them eagerly."""
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
    if lr_deg is not None and lr_deg.is_noop:
        lr_deg = None
    if hr_deg is not None and hr_deg.is_noop:
        hr_deg = None
    if lr_deg is None and hr_deg is None:
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
    use_graphs = dev.type == "cuda" if graphs is None else bool(graphs)
    if use_graphs and dev.type != "cuda":
        raise ValueError(f"CUDA graphs run on cuda, not {dev}")
    step = GraphedDegradation if use_graphs else EagerDegradation
    return step(hr_deg, lr_deg, lr_from_hr, gen, dev)


class EagerDegradation:
    """The degradation step, run eagerly: the HR degrader, then the LR
    degrader, each drawing its routed plan on the host."""

    def __init__(self, hr_deg: Optional[BatchDegrader],
                 lr_deg: Optional[BatchDegrader], lr_from_hr: bool,
                 gen: torch.Generator, dev: torch.device):
        self.hr_deg, self.lr_deg = hr_deg, lr_deg
        self.lr_from_hr = lr_from_hr
        self.gen, self.dev = gen, dev

    def _plans(self, batch: Batch):
        """The next host plan of each degrader that will run (None for the
        others), in the order the eager program draws them."""
        hr = self.hr_deg.next_plan(int(batch["HR"].shape[0])) \
            if self.hr_deg is not None and "HR" in batch else None
        lr = None
        if self.lr_deg is not None:
            src = batch["HR"] if self.lr_from_hr else batch["LR"]
            lr = self.lr_deg.next_plan(int(src.shape[0]))
        return hr, lr

    def _body(self, hr, lr, hr_plan, lr_plan):
        """The device program of both degraders."""
        if self.hr_deg is not None and hr is not None:
            hr = self.hr_deg.run(self.gen, hr, hr_plan)
        if self.lr_deg is not None:
            lr = self.lr_deg.run(self.gen, hr if self.lr_from_hr else lr,
                                 lr_plan)
        return hr, lr

    def _run(self, batch: Batch, plans, put) -> Batch:
        batch = dict(batch)
        hr = batch["HR"].to(self.dev) if "HR" in batch else None
        lr = batch["LR"].to(self.dev) if "LR" in batch else None
        hr, lr = self._body(hr, lr, *[None if p is None else put(p)
                                      for p in plans])
        if self.hr_deg is not None and hr is not None:
            batch["HR"] = hr
        if self.lr_deg is not None:
            batch["LR"] = lr
        return batch

    def __call__(self, batch: Batch) -> Batch:
        return self._run(batch, self._plans(batch),
                         lambda p: plan_to_device(p, self.dev))


class GraphedDegradation(EagerDegradation):
    """The degradation step as CUDA graphs, one per batch signature, with
    the generator registered (a replay from one generator state and plan
    equals the eager program). The first batch of a signature runs eagerly
    (the warm-up, a real degradation) and then captures the program into
    static buffers: the images, and a ``PlanBuffer`` per routed degrader,
    which the host fills before every replay. The step returns clones of
    the static outputs. ``graphs`` holds the captures by signature."""

    def __init__(self, *args):
        super().__init__(*args)
        self.graphs: Dict[tuple, Captured] = {}
        self._static: Dict[tuple, tuple] = {}
        self._pool = torch.cuda.graph_pool_handle()

    def __call__(self, batch: Batch) -> Batch:
        sig = signature(batch, ("HR", "LR"))
        plans = self._plans(batch)
        if sig not in self.graphs:
            out = warm_up(lambda: self._run(
                batch, plans, lambda p: plan_to_device(p, self.dev)))
            self._capture(sig, batch, plans)
            return out
        inputs, buffers = self._static[sig]
        for k, buf in inputs.items():
            buf.copy_(batch[k], non_blocking=True)
        for buf, plan in zip(buffers, plans):
            if buf is not None:
                buf.upload(plan)
        hr, lr = self.graphs[sig].replay()
        batch = dict(batch)
        if self.hr_deg is not None and hr is not None:
            batch["HR"] = hr.clone()
        if lr is not None and self.lr_deg is not None:
            batch["LR"] = lr.clone()
        return batch

    def _capture(self, sig, batch: Batch, plans) -> None:
        inputs = {k: torch.empty(batch[k].shape, dtype=batch[k].dtype,
                                 device=self.dev) for k, _, _ in sig}
        buffers = [None if p is None else PlanBuffer(p[0].shape, self.dev)
                   for p in plans]

        def body():
            return self._body(
                inputs.get("HR"), inputs.get("LR"),
                *[None if b is None else split_plan(b.dev) for b in buffers])

        self._static[sig] = (inputs, buffers)
        self.graphs[sig] = Captured(body, pool=self._pool,
                                    generators=[self.gen])


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
