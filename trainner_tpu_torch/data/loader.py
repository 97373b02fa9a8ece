"""DataLoader: batches in order from a background thread, as torch
tensors.

Counterpart of ``trainner_tpu/data/loader.py`` (``DataLoader:36``,
``create_dataloader:159``). A worker thread overlaps image IO with the
card's work. With ``pin_memory`` the worker pins each batch, so that the
copy to the card can run with ``non_blocking=True``.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List

import numpy as np
import torch


def _collate(samples: List[Dict[str, Any]], pin: bool) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            t = torch.from_numpy(np.stack(vals))
            out[k] = t.pin_memory() if pin else t
        else:
            out[k] = vals
    return out


class DataLoader:
    """Iterates a dataset in order, in batches, produced by a background
    thread (``num_workers`` > 0) or inline."""

    def __init__(self, dataset, batch_size: int = 1, num_workers: int = 1,
                 prefetch: int = 4, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(0, num_workers)
        self.prefetch = prefetch
        self.pin_memory = pin_memory

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _batch(self, start: int) -> Dict[str, Any]:
        stop = min(start + self.batch_size, len(self.dataset))
        return _collate([self.dataset[i] for i in range(start, stop)],
                        self.pin_memory)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        starts = range(0, len(self.dataset), self.batch_size)
        if self.num_workers == 0:
            for s in starts:
                yield self._batch(s)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure: List[BaseException] = []

        def worker():
            try:
                for s in starts:
                    if stop.is_set():
                        break
                    q.put(self._batch(s))
            except Exception as e:  # handed to the consumer below
                failure.append(e)
            finally:
                q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
            if failure:
                raise failure[0]
        finally:
            stop.set()
            while t.is_alive():  # unblock a worker waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(0.01)


def create_dataloader(dataset, dataset_opt: dict,
                      pin_memory: bool = False) -> DataLoader:
    """Evaluation loaders are sequential, batch 1, one worker thread."""
    if dataset_opt.get("phase", "train") == "train":
        raise NotImplementedError(
            "training loaders are not ported yet (ROADMAP Queue A, "
            "end-to-end producer)")
    return DataLoader(dataset, batch_size=1, num_workers=1,
                      pin_memory=pin_memory)
