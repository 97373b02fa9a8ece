"""The device mesh of the port: counterpart of
``trainner_tpu/parallel/mesh.py`` (``MeshConfig:43``, ``make_mesh:55``,
``shard_batch:86``, ``replicate:92``,
``_param_spec:98``, ``param_sharding:145``, ``local_batch_slice:166``) in
PyTorch's own idiom: one process per card (``torchrun`` sets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``), ``torch.distributed`` with NCCL on
the card and gloo on the CPU, and the axes ``data``, ``fsdp`` and
``tensor``, tensor innermost as in JAX: rank = (d * fsdp + f) * tensor +
t.

Where the JAX package lets GSPMD partition one program over a global
batch, the port runs the same program on every rank over that rank's
slice of the batch, and makes explicit what couples the samples. The
batch is split over the ``data x fsdp`` ranks of the batch group (the
ranks of one tensor index), each its own slice in the order of its batch
index, rank // tensor (``local_batch_slice``); the ``tensor`` ranks of
one slice read the same samples. While a trainer's step runs inside
``Mesh.active``, the functions of ``collectives.py`` see the groups
(batch means, per-sample draws, the gathered batch, the gradients' and
the logs' averages, the tensor axis's joins).

On the tensor axis a leaf that JAX's rule splits (a ``kernel`` of at
least 2^16 elements whose output channels the axis divides) is computed
by column where its module routes it (``tensor.py``): each tensor rank
computes its own output columns and the ranks join them. Every rank holds
whole weights.

On the fsdp and tensor axes the optimizer state and the update are split
by JAX's rule (``_param_spec``: a leaf of fewer than 2^16 elements stays
whole; a kernel the tensor axis divides is split by its output channels
over the tensor group; else a larger leaf is split along its largest
dimension that the fsdp axis divides, in the JAX layout of the weight):
``ShardedOptimizer`` runs the rule on this rank's part, then the parts
are put together on every rank of the group. Every collective is an
all-reduce or a broadcast, which both backends take for tensors on the
card (gloo stages them through the host), so two ranks may share one
card over gloo.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import collectives

# the rule's smallest split leaf (JAX ``_param_spec``'s min_size)
MIN_SHARD_SIZE = 2 ** 16
# the rules that read a whole weight (AdamP's and SGDP's projection per
# row of its first axis, ranger's gradient centralisation): a leaf under
# one of them is updated whole on every rank, its moments whole
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
    """The ranks of this run laid out as ``(data, fsdp, tensor)``, rank =
    (d * fsdp + f) * tensor + t. ``group`` holds every rank;
    ``batch_group`` the ranks of this rank's tensor index, over which the
    batch is split (every rank when the tensor axis is 1); ``fsdp_group``
    the ranks that share this rank's data and tensor indices, over which
    the optimizer state is split; ``tensor_group`` the ranks that share
    its data and fsdp indices, which compute a split leaf's columns and
    read the same samples. Without a process group (``group`` None) it is
    a mesh of one rank and nothing is exchanged."""

    def __init__(self, data: int, fsdp: int,
                 min_shard_size: int = MIN_SHARD_SIZE, tensor: int = 1,
                 groups: Optional[Dict[str, Any]] = None):
        self.data, self.fsdp, self.tensor = data, fsdp, tensor
        self.min_shard_size = min_shard_size
        if groups is not None:
            self.group = dist.group.WORLD
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
            self.backend = dist.get_backend()
            self.fsdp_group = groups["fsdp"]
            self.tensor_group = groups.get("tensor")
            self.batch_group = groups.get("batch", self.group)
        else:
            self.group = self.fsdp_group = self.tensor_group = None
            self.batch_group = None
            self.rank, self.world = 0, 1
            self.backend = None

    @property
    def shape(self) -> Dict[str, int]:
        if self.tensor > 1:
            return {"data": self.data, "fsdp": self.fsdp,
                    "tensor": self.tensor}
        return {"data": self.data, "fsdp": self.fsdp}

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def batch_index(self) -> int:
        """This rank's slice of the batch: d * fsdp + f."""
        return self.rank // self.tensor

    @property
    def batch_world(self) -> int:
        """How many slices the batch is split into: data x fsdp."""
        return max(self.world // self.tensor, 1)

    @property
    def fsdp_index(self) -> int:
        return self.batch_index % self.fsdp

    @property
    def tensor_index(self) -> int:
        return self.rank % self.tensor

    def active(self):
        """A context in which the step's program sees this mesh
        (``collectives.batch_mean`` and the others)."""
        return collectives.running(self)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} of {self.world}, "
                f"{self.backend or 'one process'})")


def _layout(cfg: Optional[MeshConfig], world_size: int
            ) -> Tuple[int, int, int]:
    """(data, fsdp, tensor) of ``cfg`` over ``world_size`` ranks; raises
    where the JAX ``make_mesh`` raises, when the axes do not tile them."""
    cfg = cfg or MeshConfig()
    fsdp = max(1, cfg.fsdp)
    tensor = max(1, cfg.tensor)
    data = cfg.data if cfg.data > 0 else world_size // (fsdp * tensor)
    if data * fsdp * tensor != world_size:
        raise ValueError(
            f"mesh {data}x{fsdp}x{tensor} != {world_size} devices; "
            "set MeshConfig explicitly")
    return data, fsdp, tensor


def _groups(data: int, fsdp: int, tensor: int) -> Dict[str, Any]:
    """This rank's fsdp group, and with a tensor axis its tensor and batch
    groups (without one the batch group is every rank): every rank
    creates every group, in one order."""
    rank = dist.get_rank()
    at = lambda d, f, t: (d * fsdp + f) * tensor + t  # noqa: E731
    lists = {"fsdp": [[at(d, f, t) for f in range(fsdp)]
                      for d in range(data) for t in range(tensor)]}
    if tensor > 1:
        lists["tensor"] = [[at(d, f, t) for t in range(tensor)]
                           for d in range(data) for f in range(fsdp)]
        lists["batch"] = [[at(d, f, t) for d in range(data)
                           for f in range(fsdp)] for t in range(tensor)]
    out = {}
    for name, members in lists.items():
        for ranks in members:
            g = dist.new_group(ranks)
            if rank in ranks:
                out[name] = g
    return out


def make_mesh(cfg: Optional[MeshConfig] = None,
              world_size: Optional[int] = None,
              device: Optional[torch.device] = None,
              min_shard_size: int = MIN_SHARD_SIZE) -> Mesh:
    """The ``(data, fsdp, tensor)`` mesh over the process group's ranks
    (or ``world_size`` of them, for checking a layout, which then needs
    no group; one rank without a group). ``min_shard_size``: the rule's
    smallest split leaf (as the JAX ``param_sharding``'s ``min_size``).
    Raises where the JAX ``make_mesh`` raises, when the axes do not tile
    the ranks. The groups' first collectives run here, outside any CUDA
    graph capture."""
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    data, fsdp, tensor = _layout(cfg, world_size)
    device = torch.device(device) if device is not None else \
        torch.device("cpu")
    if not dist.is_initialized():
        if world_size != 1:
            raise RuntimeError(f"a mesh of {world_size} ranks needs a "
                               "process group (init_distributed)")
        return Mesh(data, fsdp, min_shard_size=min_shard_size)
    mesh = Mesh(data, fsdp, min_shard_size, tensor,
                _groups(data, fsdp, tensor))
    for group in (mesh.group, mesh.fsdp_group, mesh.tensor_group,
                  mesh.batch_group):
        if group is not None:
            warm = torch.zeros(1, device=device)
            dist.all_reduce(warm, group=group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return mesh


def local_batch_slice(global_batch: int, mesh: Mesh) -> slice:
    """This rank's slice of a global batch: ``global_batch / (world /
    tensor)`` samples in the order of the batch index (the whole batch
    for one rank): the batch is split over data x fsdp, and the tensor
    ranks of one slice read the same samples. ``mesh`` may be any object
    with ``rank`` and ``world`` (and ``tensor``, 1 when it has none)."""
    tensor = getattr(mesh, "tensor", 1)
    slices = max(mesh.world // tensor, 1)
    index = mesh.rank // tensor
    per = global_batch // slices
    return slice(index * per, (index + 1) * per)


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


def _jax_perm(p: torch.Tensor, kind: Optional[str]) -> Tuple[int, ...]:
    """The permutation from ``p``'s layout to the JAX one: by its flax
    kind for a kernel (``tensor.JAX_LAYOUT``), else
    ``optimizers.jax_view``."""
    from ..train.optimizers import jax_view
    from .tensor import JAX_LAYOUT

    return JAX_LAYOUT[kind] if kind in JAX_LAYOUT else jax_view(p)


def leaf_split(p: torch.Tensor, kind: Optional[str], mesh: Mesh,
               min_size: Optional[int] = None
               ) -> Optional[Tuple[str, int]]:
    """(axis, dimension of the port's tensor ``p``) that the rule splits,
    or None: the rule runs on the JAX layout and its dimension is mapped
    back. ``kind``: the flax kind of a ``kernel`` leaf (``tensor.
    kernel_kinds``), None for any other leaf, which the tensor axis never
    takes."""
    perm = _jax_perm(p, kind)
    jshape = tuple(p.shape[i] for i in perm)
    spec = _param_spec(jshape, mesh.fsdp, "fsdp", mesh.tensor, "tensor",
                       mesh.min_shard_size if min_size is None else min_size,
                       is_kernel=kind is not None)
    for j, ax in enumerate(spec):
        if ax is not None:
            return ax, perm[j]
    return None


def param_sharding(net: torch.nn.Module, mesh: Mesh,
                   min_size: int = MIN_SHARD_SIZE) -> Dict[str, tuple]:
    """Each parameter's spec in the JAX layout over the mesh's fsdp and
    tensor axes, by name (``()``: whole on every rank): a ``kernel`` leaf
    (``tensor.kernel_kinds``) in its flax kind's layout, any other in
    ``optimizers.jax_view``'s."""
    from .tensor import kernel_kinds

    kinds = kernel_kinds(net)
    out = {}
    for name, p in net.named_parameters():
        kind = kinds.get(name)
        perm = _jax_perm(p, kind)
        out[name] = _param_spec(tuple(p.shape[i] for i in perm), mesh.fsdp,
                                "fsdp", mesh.tensor, "tensor", min_size,
                                is_kernel=kind is not None)
    return out


# -- the fsdp and tensor axes of the optimizer --------------------------------

class ShardedOptimizer:
    """An ``optimizers.Optimizer`` whose state and update are split over
    the mesh's fsdp and tensor axes: for each parameter that the JAX rule
    splits (``leaf_split``: a kernel's output channels over the tensor
    group, else its largest dimension over the fsdp group, never both),
    this rank keeps the moments of its part alone and updates that part,
    then the parts are put together on every rank of the group (an
    all-reduce over a zeroed buffer, one per axis for all parameters); a
    parameter the rule keeps whole is updated whole on every rank. Under
    a rule that reads a whole weight (``WHOLE_WEIGHT_RULES``, ranger with
    ``use_gc``) every parameter is updated whole, its moments whole: the
    one-process update. The gradients it reads are the averaged whole
    ones. Its ``state_dict`` gives whole tensors (a collective: every rank
    calls it) and ``load_state_dict`` takes whole ones, so a checkpoint is
    the one-process format."""

    def __init__(self, opt, mesh: Mesh,
                 kinds: Optional[Sequence[Optional[str]]] = None):
        from ..train.optimizers import Optimizer

        self.params = list(opt.params)
        self.name = opt.name
        self.weight_decay = opt.weight_decay
        self.use_gc = opt.use_gc
        self.mesh = mesh
        kinds = list(kinds) if kinds is not None else [None] * len(
            self.params)
        whole = opt.name in WHOLE_WEIGHT_RULES or (
            opt.name == "ranger" and opt.use_gc)
        self.splits = [None if whole else leaf_split(p, k, mesh)
                       for p, k in zip(self.params, kinds)]
        self.parts = [p.detach() if s is None else
                      self._part_of(p.detach(), p, s)
                      for p, s in zip(self.params, self.splits)]
        self.inner = Optimizer(self.parts, opt.name, opt.beta1, opt.beta2,
                               opt.eps, opt.weight_decay, opt.momentum,
                               views=opt.views, use_gc=opt.use_gc)

    @property
    def dims(self) -> List[Optional[int]]:
        """The split dimension of each parameter (None: whole)."""
        return [None if s is None else s[1] for s in self.splits]

    @property
    def lists(self) -> Tuple[str, ...]:
        return self.inner.lists

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
        for q in self.parts:
            q.grad = None

    def _axis(self, axis: str) -> Tuple[int, int, Any]:
        """(this rank's index, size, group) of an axis."""
        m = self.mesh
        if axis == "tensor":
            return m.tensor_index, m.tensor, m.tensor_group
        return m.fsdp_index, m.fsdp, m.fsdp_group

    def _sharded(self) -> List[int]:
        return [i for i, s in enumerate(self.splits) if s is not None]

    def _whole(self, parts: List[torch.Tensor], idx: List[int]
               ) -> List[torch.Tensor]:
        """Whole tensors from this rank's parts of parameters ``idx``, put
        together over each one's group."""
        out = []
        for q, i in zip(parts, idx):
            p = self.params[i]
            full = torch.zeros(p.shape, dtype=q.dtype, device=q.device)
            self._part_of(full, p, self.splits[i]).copy_(q)
            out.append(full)
        if self.mesh.distributed:
            for axis in ("fsdp", "tensor"):
                mine = [t for t, i in zip(out, idx)
                        if self.splits[i][0] == axis]
                if mine:
                    collectives.flat_all_reduce(mine, self._axis(axis)[2])
        return out

    @torch.no_grad()
    def step(self, lr) -> None:
        for p, q, s in zip(self.params, self.parts, self.splits):
            if p.grad is None:
                q.grad = None
            else:
                q.grad = p.grad if s is None else \
                    self._part_of(p.grad, p, s)
        self.inner.step(lr)
        idx = self._sharded()
        if idx:  # a net of small leaves alone keeps every one whole
            whole = self._whole([self.parts[i] for i in idx], idx)
            torch._foreach_copy_([self.params[i].data for i in idx], whole)

    def _part_of(self, t: torch.Tensor, p: torch.Tensor,
                 split: Tuple[str, int]) -> torch.Tensor:
        index, n, _ = self._axis(split[0])
        d = split[1]
        s = p.shape[d] // n
        return t.narrow(d, index * s, s)

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
                parts[key] = [t if s is None else self._part_of(t, p, s)
                              for t, p, s in zip(parts[key], self.params,
                                                 self.splits)]
        self.inner.load_state_dict(parts)


def net_fields(state) -> Tuple[str, ...]:
    """The fields of a training state that hold a ``NetState``."""
    return ("g", "d", "loc") + tuple(getattr(state, "D_FIELDS", ()))


def place_tensor(state, mesh: Mesh) -> List[str]:
    """Each of the state's nets marked for the tensor axis
    (``tensor.place``: its split leaves computed by column); returns the
    split leaves computed whole on every rank, as ``field.name``."""
    from . import tensor

    whole = []
    for which in net_fields(state):
        ns = getattr(state, which, None)
        if ns is not None:
            whole += [f"{which}.{k}" for k in tensor.place(ns.net, mesh)]
    return whole


def shard_optimizers(state, mesh: Mesh) -> None:
    """Each of the state's optimizers split over the fsdp and tensor axes
    (``ShardedOptimizer``); nothing where both are 1."""
    if mesh.fsdp <= 1 and mesh.tensor <= 1:
        return
    from .tensor import kernel_kinds

    for which in net_fields(state):
        ns = getattr(state, which, None)
        if ns is not None and ns.opt is not None and \
                not isinstance(ns.opt, ShardedOptimizer):
            kinds = kernel_kinds(ns.net)
            by_id = {id(p): kinds.get(name)
                     for name, p in ns.net.named_parameters()}
            ns.opt = ShardedOptimizer(
                ns.opt, mesh, [by_id.get(id(p)) for p in ns.opt.params])
