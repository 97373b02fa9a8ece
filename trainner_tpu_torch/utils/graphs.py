"""CUDA graphs: what stands in the port where ``jax.jit`` stands in the JAX
package. A captured graph replays every launch it recorded with one call
from the host, so a program of thousands of small launches costs the host
one call.

The train step and ``eval_step`` (``train/sr_trainer.py``) and the degrader
(``train/producer.py``) run as graphs on the card. Each follows the same
rule: the first call of a signature (input shapes and types) runs the
program eagerly on a side stream, as a real call whose result is returned
(the warm-up: it fills every lazy cache and constant); then the program is
captured into static buffers, which records and runs nothing; every later
call copies its inputs into the static buffers and replays. A capture that
fails raises; nothing falls back to the eager program.

Random draws in a graph come from ``torch.Generator`` objects registered
with it (``register_generator_state``): a replay advances the generator as
the eager program would, so from one generator state both draw the same
numbers, and every replay draws fresh ones.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Callable, Dict, Iterable, Optional

import torch


def kernel_launches() -> Dict[str, int]:
    """The launch counts of the port's kernel wrappers. A wrapper counts
    when it puts its kernel on the stream: eagerly, or into a graph being
    captured (a replay runs no Python and counts nothing)."""
    from ..ops import blur, rdb5c

    return {"rdb5c": rdb5c.launches, "rdb5c_bwd": rdb5c.backward_launches,
            "blur": blur.launches}


# Held for the length of a capture and around every pinned host allocation
# of the loader's threads: ``cudaHostAlloc`` may synchronise the card, which
# breaks a capture under way in another thread.
host_alloc_lock = threading.Lock()

_constants: Dict[tuple, torch.Tensor] = {}


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant tensor on ``device``, made once. A tensor made from
    host values copies them to the card and waits for the copy, which a
    capture refuses; the warm-up makes every constant first. It is made
    outside inference mode, so that autograd may use it too."""
    key = (repr(values), dtype, str(device))
    t = _constants.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = torch.tensor(values, dtype=dtype, device=device)
        _constants[key] = t
    return t


def warm_up(fn: Callable):
    """Runs ``fn()`` eagerly on a side stream, ordered after the current
    stream's work and before its later work, and returns its result: a
    tensor, or a dict, list or tuple of them, marked as in use on the
    current stream (the caller's)."""
    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn()
    current.wait_stream(side)
    values = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (list, tuple)) else [out])
    for t in values:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.record_stream(current)
    return out


class Captured:
    """``fn()`` captured into one CUDA graph, in the memory pool ``pool``,
    drawing from ``generators``. ``outputs`` are the static tensors that
    ``fn`` returned: a replay overwrites them. Carries what the capture
    recorded: ``launches`` (per kernel wrapper, see ``kernel_launches``),
    ``capture_s`` and ``pool_bytes`` (the memory the card reserved for it).
    ``capture_error_mode`` is ``torch.cuda.graph``'s: a step with NCCL
    collectives captures ``thread_local``, so that the process group's
    watchdog thread may query its events meanwhile."""

    def __init__(self, fn: Callable, pool=None,
                 generators: Iterable[Optional[torch.Generator]] = (),
                 capture_error_mode: str = "global"):
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            if gen is not None:
                self.graph.register_generator_state(gen)
        before = kernel_launches()
        t0 = time.perf_counter()
        # The loader's threads go on working while the main thread
        # captures; only their pinned allocations wait for it. The garbage
        # collector waits too: an object it frees may hold memory or a
        # graph whose release synchronises the card.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with host_alloc_lock, torch.cuda.graph(
                    self.graph, pool=pool,
                    capture_error_mode=capture_error_mode):
                reserved = torch.cuda.memory_reserved()
                self.outputs = fn()
        finally:
            if collecting:
                gc.enable()
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.capture_s = time.perf_counter() - t0
        after = kernel_launches()
        self.launches = {k: after[k] - before[k] for k in after}
        self.replays = 0

    def replay(self):
        """Replays the graph on the current stream; returns ``outputs``."""
        self.graph.replay()
        self.replays += 1
        return self.outputs


def signature(batch: Dict[str, torch.Tensor], keys) -> tuple:
    """(key, shape, dtype) of each of ``keys`` in ``batch``: one graph per
    signature, as ``jax.jit`` compiles one program per shape and type."""
    return tuple((k, tuple(batch[k].shape), batch[k].dtype)
                 for k in keys if k in batch)
