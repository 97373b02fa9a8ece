"""The device mesh of the port: counterpart of
``trainner_tpu/parallel/mesh.py`` (``MeshConfig:43``, ``make_mesh:55``,
``shard_batch:86``, ``replicate:92``,
``_param_spec:98``, ``param_sharding:145``, ``local_batch_slice:166``) in
PyTorch's own idiom: one process per card (``torchrun`` sets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``), ``torch.distributed`` with NCCL on
the card and gloo on the CPU, and a ``DeviceMesh`` with the axes ``data``
and ``fsdp``.

Where the JAX package lets GSPMD partition one program over a global
batch, the port runs the same program on every rank over that rank's
slice of the batch, and makes explicit what couples the samples. The
batch is split over all ``data x fsdp`` ranks, each its own slice in
rank order (``local_batch_slice``), as FSDP splits it. While a trainer's
step runs inside ``Mesh.active``, the functions of ``collectives.py``
see the group (batch means, per-sample draws, the gathered batch, the
gradients' and the logs' averages).

On the fsdp axis the optimizer state and the update are split by JAX's
rule (``_param_spec``: a leaf of fewer than 2^16 elements stays whole,
a larger one is split along its largest dimension that the axis divides,
in the JAX layout of the weight): ``ShardedOptimizer`` runs the rule on
this rank's part, then the parts are put together on every rank of the
fsdp group. Every collective is an all-reduce or a broadcast, which both
backends take for tensors on the card (gloo stages them through the
host), so two ranks may share one card over gloo.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import collectives

# the fsdp rule's smallest split leaf (JAX ``_param_spec``'s min_size)
MIN_SHARD_SIZE = 2 ** 16
# the rules that read a whole weight (AdamP's and SGDP's projection per
# row of its first axis, ranger's gradient centralisation): on a part of
# one they would compute another update
WHOLE_WEIGHT_RULES = ("adamp", "sgdp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh layout. ``data * fsdp * tensor`` must equal the world size."""

    data: int = -1          # -1 = all remaining ranks
    fsdp: int = 1
    tensor: int = 1


def init_distributed(device: torch.device, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None,
                     backend: Optional[str] = None) -> Tuple[int, int]:
    """Starts the default process group unless one runs: NCCL for a card,
    gloo for the CPU (or ``backend``). Rank and world size come from the
    arguments, else from ``RANK`` / ``WORLD_SIZE`` (``torchrun``), else a
    world of one in this process (an in-process store). ``init_method``
    (``tcp://localhost:<port>`` or ``file://<path>``) defaults to
    ``env://`` under ``torchrun``. Returns (rank, world size)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank, world_size = 0, 1
    if init_method is None and world_size == 1 and \
            "MASTER_ADDR" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
    return rank, world_size


class Mesh:
    """The ranks of this run laid out as ``(data, fsdp)``, rank = d *
    fsdp + f. ``group`` holds every rank (the batch is split over all of
    them); ``fsdp_group`` the ranks that share this rank's data index,
    over which the optimizer state is split. Without a process group
    (``group`` None) it is a mesh of one rank and nothing is exchanged."""

    def __init__(self, data: int, fsdp: int, device_mesh=None,
                 min_shard_size: int = MIN_SHARD_SIZE):
        self.data, self.fsdp = data, fsdp
        self.min_shard_size = min_shard_size
        self.device_mesh = device_mesh
        if device_mesh is not None:
            self.group = dist.group.WORLD
            self.fsdp_group = device_mesh.get_group("fsdp")
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
            self.backend = dist.get_backend()
        else:
            self.group = self.fsdp_group = None
            self.rank, self.world = 0, 1
            self.backend = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "fsdp": self.fsdp}

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def fsdp_index(self) -> int:
        return self.rank % self.fsdp

    def active(self):
        """A context in which the step's program sees this mesh
        (``collectives.batch_mean`` and the others)."""
        return collectives.running(self)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} of {self.world}, "
                f"{self.backend or 'one process'})")


def make_mesh(cfg: Optional[MeshConfig] = None,
              world_size: Optional[int] = None,
              device: Optional[torch.device] = None,
              min_shard_size: int = MIN_SHARD_SIZE) -> Mesh:
    """The ``(data, fsdp)`` mesh over the process group's ranks (or
    ``world_size`` of them, for checking a layout; one rank without a
    group). ``min_shard_size``: the fsdp rule's smallest split leaf (as
    the JAX ``param_sharding``'s ``min_size``). Raises where the JAX
    ``make_mesh`` raises, when the axes do not tile the ranks; a
    ``tensor`` axis above 1 raises too, as the port does not split the
    block kernels' output channels yet (ROADMAP Queue A 9 e). The group's
    first collective runs here, outside any CUDA graph capture."""
    cfg = cfg or MeshConfig()
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    fsdp = max(1, cfg.fsdp)
    tensor = max(1, cfg.tensor)
    data = cfg.data if cfg.data > 0 else world_size // (fsdp * tensor)
    if data * fsdp * tensor != world_size:
        raise ValueError(
            f"mesh {data}x{fsdp}x{tensor} != {world_size} devices; "
            "set MeshConfig explicitly")
    if tensor > 1:
        raise NotImplementedError(
            f"a tensor axis of {tensor}: the port does not split the block "
            "kernels' output channels over cards yet (ROADMAP Queue A 9 e, "
            "the tensor axis)")
    device = torch.device(device) if device is not None else \
        torch.device("cpu")
    if not dist.is_initialized():
        if world_size != 1:
            raise RuntimeError(f"a mesh of {world_size} ranks needs a "
                               "process group (init_distributed)")
        return Mesh(data, fsdp, min_shard_size=min_shard_size)
    from torch.distributed.device_mesh import init_device_mesh

    # a DeviceMesh of type cuda would set each rank's card from its rank;
    # the caller has set it (several ranks may share one card over gloo)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = Mesh(data, fsdp, init_device_mesh(
        kind, (data, fsdp), mesh_dim_names=("data", "fsdp")),
        min_shard_size=min_shard_size)
    for group in (mesh.group, mesh.fsdp_group):
        warm = torch.zeros(1, device=device)
        dist.all_reduce(warm, group=group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return mesh


def local_batch_slice(global_batch: int, mesh: Mesh) -> slice:
    """This rank's slice of a global batch: ``global_batch / world``
    samples in rank order (the whole batch for one rank): the batch is
    split over every rank, data x fsdp."""
    per = global_batch // max(mesh.world, 1)
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's part of a global batch: every tensor or array cut to
    ``local_batch_slice`` on its leading axis; other entries as they are
    (a list of paths is cut too)."""
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape") and len(v.shape) > 0:
            out[k] = v[local_batch_slice(v.shape[0], mesh)]
        elif isinstance(v, list):
            out[k] = v[local_batch_slice(len(v), mesh)]
        else:
            out[k] = v
    return out


def replicate(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Every tensor broadcast from rank 0, in place."""
    if not mesh.distributed:
        return
    for t in tensors:
        dist.broadcast(t.data, src=0, group=mesh.group)


def replicate_state(state, mesh: Mesh) -> None:
    """A training state's nets (parameters and buffers) broadcast from
    rank 0: G, D, the LocNet and the Ds a model keeps in fields of its
    own (``D_FIELDS``: CycleGAN's D_A and D_B, WBC's D_S and D_T)."""
    nets = [getattr(state, w).net for w in net_fields(state)
            if getattr(state, w, None) is not None]
    nets += [m for m in (getattr(state, "ema", None),
                         getattr(state, "swa", None)) if m is not None]
    with torch.no_grad():
        for net in nets:
            replicate(list(net.parameters()) + list(net.buffers()), mesh)


def _param_spec(x, fsdp_size: int, fsdp_axis: str = "fsdp",
                tp_size: int = 1, tp_axis: str = "tensor",
                min_size: int = MIN_SHARD_SIZE,
                is_kernel: bool = True) -> tuple:
    """The JAX rule for one leaf, on its shape in the JAX layout (a tensor
    or a shape): the spec as a tuple, one axis name or None per dimension,
    ``()`` for a leaf that stays whole. ``tensor`` takes the last
    dimension of a kernel of two or more dimensions; else ``fsdp`` takes
    the largest dimension it divides (the first of equal ones)."""
    shape = tuple(x.shape) if hasattr(x, "shape") else tuple(x)
    size = 1
    for n in shape:
        size *= n
    if len(shape) == 0 or size < min_size:
        return ()
    spec: List[Optional[str]] = [None] * len(shape)
    if tp_size > 1 and is_kernel and len(shape) >= 2 and \
            shape[-1] % tp_size == 0:
        spec[-1] = tp_axis
        return tuple(spec)
    if fsdp_size > 1:
        order = sorted(range(len(shape)), key=lambda i: shape[i],
                       reverse=True)
        for i in order:
            if shape[i] % fsdp_size == 0:
                spec[i] = fsdp_axis
                break
    if all(s is None for s in spec):
        return ()
    return tuple(spec)


def shard_dim(p: torch.Tensor, view: Sequence[int], fsdp_size: int,
              min_size: int = MIN_SHARD_SIZE) -> Optional[int]:
    """The dimension of the port's tensor ``p`` that the fsdp rule splits,
    or None: the rule runs on the JAX layout (``view``, the permutation
    ``optimizers.jax_view`` gives) and its dimension is mapped back."""
    jshape = tuple(p.shape[i] for i in view)
    spec = _param_spec(jshape, fsdp_size, min_size=min_size)
    for j, ax in enumerate(spec):
        if ax == "fsdp":
            return view[j]
    return None


def param_sharding(net: torch.nn.Module, mesh: Mesh,
                   min_size: int = MIN_SHARD_SIZE) -> Dict[str, tuple]:
    """Each parameter's spec in the JAX layout over the mesh's fsdp axis,
    by name (``()``: whole on every rank)."""
    from ..train.optimizers import jax_view

    return {name: _param_spec(tuple(p.shape[i] for i in jax_view(p)),
                              mesh.fsdp, min_size=min_size)
            for name, p in net.named_parameters()}


# -- the fsdp axis ------------------------------------------------------------

class ShardedOptimizer:
    """An ``optimizers.Optimizer`` whose state and update are split over
    the mesh's fsdp axis: for each parameter that the JAX rule splits
    (``shard_dim``), this rank keeps the moments of its part alone and
    updates that part, then the parts are put together on every rank of
    its fsdp group (an all-reduce over a zeroed buffer, one for all
    parameters); a parameter the rule keeps whole is updated whole on
    every rank. The gradients it reads are the averaged whole ones. Its
    ``state_dict`` gives whole tensors (a collective: every rank of the
    group calls it) and ``load_state_dict`` takes whole ones, so a
    checkpoint is the one-process format."""

    def __init__(self, opt, mesh: Mesh):
        from ..train.optimizers import Optimizer

        self.params = list(opt.params)
        self.name = opt.name
        self.weight_decay = opt.weight_decay
        self.use_gc = opt.use_gc
        self.mesh = mesh
        f, n = mesh.fsdp_index, mesh.fsdp
        self.dims = [shard_dim(p, v, n, mesh.min_shard_size)
                     for p, v in zip(self.params, opt.views)]
        if any(d is not None for d in self.dims) and (
                opt.name in WHOLE_WEIGHT_RULES
                or (opt.name == "ranger" and opt.use_gc)):
            raise NotImplementedError(
                f"optimizer [{opt.name}]{' with use_gc' if opt.use_gc else ''}"
                " reads whole weights (a projection or a centralisation per "
                "row), so its update on an fsdp part would differ from the "
                "one-process update; take fsdp: 1 for it (ROADMAP C 28)")
        self.parts = [p.detach() if d is None else
                      p.detach().narrow(d, f * (p.shape[d] // n),
                                        p.shape[d] // n)
                      for p, d in zip(self.params, self.dims)]
        self.inner = Optimizer(self.parts, opt.name, opt.beta1, opt.beta2,
                               opt.eps, opt.weight_decay, opt.momentum,
                               views=opt.views, use_gc=opt.use_gc)

    @property
    def lists(self) -> Tuple[str, ...]:
        return self.inner.lists

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
        for q in self.parts:
            q.grad = None

    def _sharded(self) -> List[int]:
        return [i for i, d in enumerate(self.dims) if d is not None]

    def _whole(self, parts: List[torch.Tensor], idx: List[int]
               ) -> List[torch.Tensor]:
        """Whole tensors from this rank's parts of parameters ``idx``, put
        together over the fsdp group."""
        f, n = self.mesh.fsdp_index, self.mesh.fsdp
        out = []
        for q, i in zip(parts, idx):
            p, d = self.params[i], self.dims[i]
            full = torch.zeros(p.shape, dtype=q.dtype, device=q.device)
            full.narrow(d, f * (p.shape[d] // n), p.shape[d] // n).copy_(q)
            out.append(full)
        if self.mesh.distributed:
            collectives.flat_all_reduce(out, self.mesh.fsdp_group)
        return out

    @torch.no_grad()
    def step(self, lr) -> None:
        for p, q, d in zip(self.params, self.parts, self.dims):
            if p.grad is None:
                q.grad = None
            else:
                q.grad = p.grad if d is None else \
                    self._part_of(p.grad, p, d)
        self.inner.step(lr)
        idx = self._sharded()
        if idx:  # a net of small leaves alone keeps every one whole
            whole = self._whole([self.parts[i] for i in idx], idx)
            torch._foreach_copy_([self.params[i].data for i in idx], whole)

    def _part_of(self, t: torch.Tensor, p: torch.Tensor, d: int
                 ) -> torch.Tensor:
        n = self.mesh.fsdp
        s = p.shape[d] // n
        return t.narrow(d, self.mesh.fsdp_index * s, s)

    def state_dict(self) -> Dict:
        inner = self.inner.state_dict()
        idx = self._sharded()
        for key in self.lists:
            lst = inner[key]
            whole = self._whole([lst[i] for i in idx], idx)
            for i, t in zip(idx, whole):
                lst[i] = t
        return inner

    def load_state_dict(self, state: Dict) -> None:
        parts = dict(state)
        for key in self.lists:
            if key in parts:
                parts[key] = [t if d is None else self._part_of(t, p, d)
                              for t, p, d in zip(parts[key], self.params,
                                                 self.dims)]
        self.inner.load_state_dict(parts)


def net_fields(state) -> Tuple[str, ...]:
    """The fields of a training state that hold a ``NetState``."""
    return ("g", "d", "loc") + tuple(getattr(state, "D_FIELDS", ()))


def shard_optimizers(state, mesh: Mesh) -> None:
    """Each of the state's optimizers split over the fsdp axis
    (``ShardedOptimizer``); nothing with an fsdp axis of 1."""
    if mesh.fsdp <= 1:
        return
    for which in net_fields(state):
        ns = getattr(state, which, None)
        if ns is not None and ns.opt is not None and \
                not isinstance(ns.opt, ShardedOptimizer):
            ns.opt = ShardedOptimizer(ns.opt, mesh)
