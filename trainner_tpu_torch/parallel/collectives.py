"""The collectives of a training step on a data (and fsdp) axis, used
from the op, loss and trainer layers: they read the mesh of the step that
is running (``running``, which ``mesh.Mesh.active`` opens) and are the
identity without one, or with a mesh of one rank without a process
group. Imports only torch.

* ``batch_mean``: a mean over the local batch becomes the global batch's
  (an all-reduce that autograd runs backwards too): batch norms'
  statistics, the relativistic GAN's batch means;
* ``sample_draw``: a per-sample random draw is made for the global batch
  (every rank's generator holds the same state) and this rank's rows
  are kept, so each sample sees the draw it would in one process;
* ``gather_batch`` / ``local_rows``: a batch augmentation that mixes
  samples, or a virtual batch, sees the global batch; each microbatch of
  it is split over the ranks;
* ``average_grads``: gradients averaged over the group in one
  all-reduce per net, inside the step (and its CUDA graph), before the
  global-norm clip, the auto clip and the optimizer read them;
* ``mean_logs``: the logged losses averaged over the group.

A mesh here is any object with ``distributed``, ``group``, ``rank`` and
``world`` (``mesh.Mesh``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

_ACTIVE = None
# collectives issued by the functions below, eagerly or into a graph
# being captured (a replay issues none from Python)
issued = 0


@contextlib.contextmanager
def running(mesh):
    """The step's program sees ``mesh`` while the context is open."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def _all_reduce(t: torch.Tensor, group) -> None:
    global issued
    issued += 1
    dist.all_reduce(t, group=group)


def _live():
    m = _ACTIVE
    return m if m is not None and m.distributed else None


def batch_world() -> int:
    """How many ranks share the running step's batch (1 without a mesh)."""
    m = _live()
    return m.world if m is not None else 1


class _AllReduce(torch.autograd.Function):
    """Sum over the group; the backward sums the gradients the same way
    (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        _all_reduce(y, group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        _all_reduce(g, ctx.group)
        return g, None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x``, a mean over this rank's part of the batch, as the mean over
    the global batch (the ranks' parts are of one size); the identity
    without a running mesh."""
    m = _live()
    if m is None:
        return x
    return _AllReduce.apply(x, m.group) / float(m.world)


def sample_draw(draw, n: int) -> torch.Tensor:
    """``draw(rows)`` for a per-sample draw over ``n`` local samples: under
    a running mesh drawn for the ``n * world`` samples of the global
    (micro)batch, this rank's rows kept."""
    w = batch_world()
    if w == 1:
        return draw(n)
    return local_rows(draw(n * w), 1)


def local_rows(t: torch.Tensor, microbatches: int = 1) -> torch.Tensor:
    """This rank's rows of a tensor over the global batch, in the step's
    local order: each of the ``microbatches`` consecutive chunks of the
    global batch split over the ranks, this rank's part of each, one after
    another (with one microbatch, the rank's contiguous slice)."""
    m = _live()
    if m is None:
        return t
    a, w = microbatches, m.world
    rest = t.shape[1:]
    return t.reshape(a, w, -1, *rest)[:, m.rank].reshape(-1, *rest)


def gather_batch(t: torch.Tensor) -> torch.Tensor:
    """The global batch from every rank's contiguous slice ``t`` (rank
    order), on every rank: an all-reduce over a zeroed buffer. No
    gradient."""
    m = _live()
    if m is None:
        return t
    full = torch.zeros((m.world, *t.shape), dtype=t.dtype, device=t.device)
    full[m.rank].copy_(t)
    _all_reduce(full, m.group)
    return full.reshape(-1, *t.shape[1:])


def flat_all_reduce(tensors: List[torch.Tensor], group,
                     divide: Optional[float] = None) -> None:
    """Sums ``tensors`` over ``group`` in place as one flat buffer (one
    collective), divided by ``divide`` when given."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _all_reduce(flat, group)
    if divide is not None:
        flat.div_(divide)
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


def average_grads(params: Sequence[torch.Tensor]) -> None:
    """The parameters' gradients averaged over the running mesh's ranks,
    in place, one all-reduce for all of them (the sum over the world)."""
    m = _live()
    if m is not None:
        flat_all_reduce([p.grad for p in params if p.grad is not None],
                         m.group, float(m.world))


def mean_logs(logs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each 0-d log averaged over the running mesh's ranks."""
    m = _live()
    if m is None or not logs:
        return logs
    keys = sorted(logs)
    vals = torch.stack([logs[k].detach().float().reshape(()) for k in keys])
    _all_reduce(vals, m.group)
    vals = vals / float(m.world)
    return {k: vals[i] for i, k in enumerate(keys)}
