"""The collectives of a training step on the data, fsdp and tensor axes,
used from the op, loss and trainer layers: they read the mesh of the
step that is running (``running``, which ``mesh.Mesh.active`` opens) and
are the identity without one, or with a mesh of one rank without a
process group. Imports only torch. The batch is split over the batch
group (the data x fsdp ranks of one tensor index), so every function
below but the tensor axis's reads that group:

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
  global-norm clip, the auto clip and the optimizer read them; a leaf
  computed by column on the tensor axis (``tensor.py``) has its parts
  summed over the tensor group first;
* ``mean_logs``: the logged losses averaged over the group;
* ``tensor_all_reduce``, ``tensor_input`` and ``tensor_join``: the
  tensor axis's pair around a column-parallel layer (its input's gradient
  summed over the tensor group; its columns joined by an all-reduce over
  a zeroed buffer, the rank's own columns of the gradient kept).

A mesh here is any object with ``distributed``, ``batch_group``,
``batch_index``, ``batch_world``, ``tensor``, ``tensor_index`` and
``tensor_group`` (``mesh.Mesh``).
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
    """How many ranks split the running step's batch (1 without a
    mesh)."""
    m = _live()
    return m.batch_world if m is not None else 1


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
    return _AllReduce.apply(x, m.batch_group) / float(m.batch_world)


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
    a, w = microbatches, m.batch_world
    rest = t.shape[1:]
    return t.reshape(a, w, -1, *rest)[:, m.batch_index].reshape(-1, *rest)


def gather_batch(t: torch.Tensor) -> torch.Tensor:
    """The global batch from every rank's contiguous slice ``t`` (rank
    order), on every rank: an all-reduce over a zeroed buffer. No
    gradient."""
    m = _live()
    if m is None:
        return t
    full = torch.zeros((m.batch_world, *t.shape), dtype=t.dtype,
                       device=t.device)
    full[m.batch_index].copy_(t)
    _all_reduce(full, m.batch_group)
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
    """The parameters' gradients averaged over the running mesh's batch
    group, in place, one all-reduce for all of them. A leaf computed by
    column (``tensor_summed``) holds its own columns' share on each tensor
    rank: those shares are summed over the tensor group first (one more
    all-reduce); every other gradient is already equal on the tensor
    ranks."""
    m = _live()
    if m is None:
        return
    if m.tensor > 1:
        flat_all_reduce([p.grad for p in params if p.grad is not None
                         and getattr(p, "tensor_summed", False)],
                        m.tensor_group)
    flat_all_reduce([p.grad for p in params if p.grad is not None],
                     m.batch_group, float(m.batch_world))


def mean_logs(logs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each 0-d log averaged over the running mesh's ranks."""
    m = _live()
    if m is None or not logs:
        return logs
    keys = sorted(logs)
    vals = torch.stack([logs[k].detach().float().reshape(()) for k in keys])
    _all_reduce(vals, m.batch_group)
    vals = vals / float(m.batch_world)
    return {k: vals[i] for i, k in enumerate(keys)}


# -- the tensor axis ----------------------------------------------------------

def tensor_rank() -> tuple:
    """(this rank's tensor index, the tensor axis's size) of the running
    step: (0, 1) without a mesh or without a tensor axis."""
    m = _live()
    if m is None or m.tensor <= 1:
        return 0, 1
    return m.tensor_index, m.tensor


def tensor_all_reduce(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the running mesh's tensor group, in place (the
    identity without a tensor axis); returns ``t``."""
    m = _live()
    if m is not None and m.tensor > 1:
        _all_reduce(t, m.tensor_group)
    return t


# The tensor axis's autograd pairs. Every tensor rank computes the same
# loss from its replicated tensors, which counts once: the adjoint of a sum
# over the ranks (of their columns' shares) is the identity, and that of
# keeping this rank's columns of a replicated tensor is the join. Each
# backward is itself one of these functions, so a double backward (the
# wgan-gp penalty) is exact too.

def _memory_format(t: torch.Tensor):
    """``channels_last`` for a 4-d tensor laid out so (the nets keep their
    maps in it, and a conv's algorithm, so its rounding, follows it), else
    the contiguous format."""
    if t.dim() == 4 and not t.is_contiguous() and \
            t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


class _TensorReduce(torch.autograd.Function):
    """The ranks' shares summed (an all-reduce); the backward is the
    identity."""

    @staticmethod
    def forward(ctx, x):
        return tensor_all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g


class _TensorInput(torch.autograd.Function):
    """The identity on a replicated tensor that a column-parallel layer
    reads; the backward sums the ranks' shares of its gradient
    (``_TensorReduce``)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _TensorReduce.apply(g)


class _TensorJoin(torch.autograd.Function):
    """A column-parallel layer's output: this rank's columns ``part``
    (``lo`` on along ``dim``) joined with the other ranks' into the whole
    ``size``-wide tensor, an all-reduce over a zeroed buffer; the backward
    keeps this rank's columns of the gradient (``_TensorSplit``)."""

    @staticmethod
    def forward(ctx, part, dim, lo, size):
        ctx.dim, ctx.lo, ctx.n = dim, lo, part.shape[dim]
        shape = list(part.shape)
        shape[dim] = size
        full = part.new_zeros(shape).contiguous(
            memory_format=_memory_format(part))
        full.narrow(dim, lo, ctx.n).copy_(part)
        return tensor_all_reduce(full)

    @staticmethod
    def backward(ctx, g):
        return _TensorSplit.apply(g, ctx.dim, ctx.lo, ctx.n), None, None, \
            None


class _TensorSplit(torch.autograd.Function):
    """This rank's ``n`` columns (``lo`` on along ``dim``) of a replicated
    tensor; the backward joins the ranks' column gradients
    (``_TensorJoin``)."""

    @staticmethod
    def forward(ctx, x, dim, lo, n):
        ctx.dim, ctx.lo, ctx.size = dim, lo, x.shape[dim]
        return x.narrow(dim, lo, n).contiguous(
            memory_format=_memory_format(x))

    @staticmethod
    def backward(ctx, g):
        return _TensorJoin.apply(g, ctx.dim, ctx.lo, ctx.size), None, \
            None, None


def tensor_input(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel layer (see ``_TensorInput``)."""
    return _TensorInput.apply(x)


def tensor_join(part: torch.Tensor, dim: int, lo: int,
                size: int) -> torch.Tensor:
    """A column-parallel layer's joined output (see ``_TensorJoin``)."""
    return _TensorJoin.apply(part, dim % part.dim(), lo, size)
