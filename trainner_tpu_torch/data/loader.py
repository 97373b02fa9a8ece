"""DataLoader: batches from background threads as torch tensors, and the
prefetch that keeps batches on the card ahead of the step.

Counterpart of ``trainner_tpu/data/loader.py`` (``DataLoader:36``,
``WeightedMultiLoader:100``, ``device_prefetch:136``,
``create_dataloader:159``, ``ConcatDataset:188``). A coordinator thread
builds the batches in order, reading the samples of a batch with a pool of
``num_workers`` threads, so that image IO overlaps the card's work. With
``pin_memory`` each batch is collated into pinned memory, so that
``device_prefetch`` can copy it to the card with ``non_blocking=True`` on a
stream of its own.
"""

from __future__ import annotations

import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.graphs import host_alloc_lock


def _collate(samples: List[Dict[str, Any]], pin: bool) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            t = torch.from_numpy(np.stack(vals))
            if pin:
                # a pinned allocation may synchronise the card, which would
                # break a graph being captured on the main thread
                with host_alloc_lock:
                    t = t.pin_memory()
            out[k] = t
        else:
            out[k] = vals
    return out


class DataLoader:
    """Iterates a dataset in batches: in order, or in an order shuffled
    anew every epoch from ``seed`` plus the epoch's number. Batches are
    produced by background threads (``num_workers`` > 0) or inline.
    ``part`` (a slice of ``range(batch_size)``, a rank's
    ``parallel.local_batch_slice``) reads only those samples of each
    batch, in the one-process order: the ranks' parts put together are
    the one-process batch."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 1,
                 seed: int = 0, prefetch: int = 4, pin_memory: bool = False,
                 part: Optional[slice] = None):
        self.dataset = dataset
        self.part = part
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(0, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[List[int]]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        batches = [idx[i: i + self.batch_size].tolist()
                   for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and \
                len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.part is not None:
            batches = [b[self.part] for b in batches]
        return batches

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._index_batches()
        self._epoch += 1
        if self.num_workers == 0:
            for b in batches:
                yield _collate([self.dataset[i] for i in b], self.pin_memory)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure: List[BaseException] = []

        def coordinator():
            pool = ThreadPoolExecutor(self.num_workers) \
                if self.num_workers > 1 else None
            try:
                for b in batches:
                    if stop.is_set():
                        break
                    samples = list(pool.map(self.dataset.__getitem__, b)) \
                        if pool else [self.dataset[i] for i in b]
                    q.put(_collate(samples, self.pin_memory))
            except Exception as e:  # handed to the consumer below
                failure.append(e)
            finally:
                if pool:
                    pool.shutdown(wait=True)
                q.put(None)

        t = threading.Thread(target=coordinator, daemon=True)
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
            while t.is_alive():  # unblock a thread waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(0.01)


class WeightedMultiLoader:
    """Batches from several datasets: each batch comes whole from one
    dataset, drawn with probabilities proportional to ``weights`` from
    ``default_rng(seed + epoch)``, and carries that dataset's index as the
    integer ``dataset_index``. Each dataset has its own shuffled loader
    that drops its last short batch; an epoch ends when every loader is
    spent (a draw of a spent one is skipped). ``part``: this rank's slice
    of each batch (``DataLoader``); every rank draws the same dataset for
    a batch, so the ranks' parts put together are the one-process
    batch."""

    def __init__(self, datasets: Sequence, weights: Sequence[float],
                 batch_size: int = 1, seed: int = 0, num_workers: int = 2,
                 pin_memory: bool = False, part: Optional[slice] = None):
        if len(datasets) != len(weights):
            raise ValueError(f"{len(datasets)} datasets and {len(weights)} "
                             "weights")
        self.loaders = [DataLoader(d, batch_size, shuffle=True, seed=seed,
                                   drop_last=True, num_workers=num_workers,
                                   pin_memory=pin_memory, part=part)
                        for d in datasets]
        w = np.asarray(weights, np.float64)
        self.probs = w / w.sum()
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return sum(len(ld) for ld in self.loaders)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        iters = [iter(ld) for ld in self.loaders]
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        alive = [True] * len(iters)
        try:
            while any(alive):
                k = int(rng.choice(len(iters), p=self.probs))
                if not alive[k]:
                    continue
                try:
                    batch = next(iters[k])
                except StopIteration:
                    alive[k] = False
                    continue
                batch["dataset_index"] = k
                yield batch
        finally:
            for it in iters:
                it.close()


class ConcatDataset:
    """The datasets one after another, indexed as one."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.cumulative_sizes = list(itertools.accumulate(
            len(d) for d in self.datasets))

    def __len__(self) -> int:
        return self.cumulative_sizes[-1] if self.cumulative_sizes else 0

    def __getitem__(self, idx: int):
        for k, cum in enumerate(self.cumulative_sizes):
            if idx < cum:
                prev = self.cumulative_sizes[k - 1] if k else 0
                return self.datasets[k][idx - prev]
        raise IndexError(idx)


def device_prefetch(iterator: Iterator[Dict[str, Any]], size: int = 2,
                    device: Union[str, torch.device, None] = None
                    ) -> Iterator[Dict[str, Any]]:
    """Keeps ``size`` batches on the device ahead of the consumer.

    On the card every tensor of a batch is copied with
    ``non_blocking=True`` on a side stream (from pinned memory the copy
    overlaps the step). When a batch is handed out, the consumer's current
    stream waits on the copy's event, and ``record_stream`` tells the
    allocator that the buffers are in use there. On the CPU the tensors
    are yielded as they are. Entries that are not tensors pass through."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        yield from iterator
        return
    side = torch.cuda.Stream(device=dev)

    def put(batch):
        with torch.cuda.stream(side):
            moved = {k: v.to(dev, non_blocking=True)
                     if isinstance(v, torch.Tensor) else v
                     for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(side)
        # the host batch stays referenced until its copy has been waited on
        return moved, done, batch

    def take(entry):
        moved, done, _ = entry
        current = torch.cuda.current_stream(dev)
        current.wait_event(done)
        for v in moved.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(current)
        return moved

    buf: List[Any] = []
    for batch in iterator:
        buf.append(put(batch))
        if len(buf) >= size:
            yield take(buf.pop(0))
    while buf:
        yield take(buf.pop(0))


def create_dataloader(dataset, dataset_opt: dict, pin_memory: bool = False,
                      part: Optional[slice] = None):
    """Train loaders shuffle (unless ``use_shuffle`` is off) and drop the
    last short batch; evaluation loaders are sequential, batch 1, one
    thread. A list of datasets trains through a ``WeightedMultiLoader``
    with ``sampler_weights`` (equal weights without them) and evaluates as
    one ``ConcatDataset``. The training CLI builds one dataset per phase,
    as the JAX one does: a list comes only from Python. ``part``: this
    rank's slice of each train batch (``DataLoader``,
    ``WeightedMultiLoader``)."""
    train = dataset_opt.get("phase", "train") == "train"
    if isinstance(dataset, (list, tuple)):
        if train:
            weights = dataset_opt.get("sampler_weights") or \
                [1.0] * len(dataset)
            return WeightedMultiLoader(
                dataset, weights,
                batch_size=int(dataset_opt.get("batch_size", 16) or 16),
                seed=int(dataset_opt.get("seed", 0) or 0),
                num_workers=int(dataset_opt.get("n_workers", 2) or 2),
                pin_memory=pin_memory, part=part)
        dataset = ConcatDataset(dataset)
    if train:
        return DataLoader(
            dataset,
            batch_size=int(dataset_opt.get("batch_size", 16) or 16),
            shuffle=bool(dataset_opt.get("use_shuffle", True)),
            drop_last=True,
            num_workers=int(dataset_opt.get("n_workers", 2) or 2),
            seed=int(dataset_opt.get("seed", 0) or 0),
            pin_memory=pin_memory, part=part)
    return DataLoader(dataset, batch_size=1, num_workers=1,
                      pin_memory=pin_memory)
