"""The tensor axis of the port: the column-parallel route of a leaf that
the JAX rule splits over ``tensor`` (``trainner_tpu/parallel/mesh.py::
_param_spec:98``: a ``kernel`` of at least 2^16 elements whose output
channels the axis divides).

The JAX package lets GSPMD partition the program from that sharding; the
port computes it explicitly. Every rank holds whole weights. For a split
leaf, each of the T tensor ranks computes its own n / T output columns
(``columns``) from the whole input, and the ranks join them
(``collectives.tensor_join``: an all-reduce over a zeroed buffer); in the
backward each rank keeps its own columns of the output's gradient, so its
input gradient is its columns' share, summed over the tensor group
(``collectives.tensor_input``), and its weight gradient holds its own
columns alone (summed over the tensor group by ``average_grads``, as the
leaf is marked ``tensor_summed``). A layer's bias is split with it (the
rank's columns added by its own conv, which sums their gradient as the
whole conv does), so the bias is marked ``tensor_summed`` too; a
spectral norm's sigma is taken from the whole weight on every rank, as
JAX's is, and where it couples the columns the sum of the ranks'
gradients is exact too. The join keeps the maps' ``channels_last``
layout, so the layer after it runs the algorithm it runs on one rank.

``place(net, mesh)`` marks the modules whose weight is split and routed:
the shared conv modules of ``ops/blocks.py`` (``_Conv._conv``, a
``ConvBlock`` with its norm and activation run whole after the join,
``Conv``, ``Dense``, ``TorchDeconv``), the linear layers of the
discriminators, the model files' own conv sites that call ``apply``,
and the residual dense block's kernels (``ops/rdb5c.py``: a split conv
runs as a column-range stage, its backward as the split backward). A
module that convolves a split leaf without ``apply`` (a partial conv, a
grouped conv, the deformable conv) computes it whole on every rank,
which is correct, since every rank holds whole weights: ``place``
returns those leaves, and the trainer logs them (ROADMAP A 9 g). With no
mesh running (validation, saves, serving) a split leaf computes whole
and issues no collective.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from . import collectives

# the output-channel dimension of each kind of kernel in the port's layout
# (``ops/blocks.py::conv_paths``: conv OIHW, conv3d OIDHW, deconv (in, out,
# kh, kw), dense (out, in))
SPLIT_DIM = {"conv": 0, "conv3d": 0, "deconv": 1, "dense": 0}
# the permutation from the port's layout to flax's, by kind
JAX_LAYOUT = {"conv": (2, 3, 1, 0), "conv3d": (2, 3, 4, 1, 0),
              "deconv": (2, 3, 0, 1), "dense": (1, 0)}


def _module_kind(m: nn.Module) -> Optional[str]:
    """The flax kind of a module's ``weight`` where flax names it
    ``kernel`` (a conv, a deconv, a dense layer), else None."""
    from ..ops.blocks import Dense, TorchDeconv, _Conv

    if isinstance(m, TorchDeconv):
        return "deconv"
    if isinstance(m, (Dense, nn.Linear)):
        return "dense"
    if isinstance(m, _Conv):
        return "conv3d" if m.weight.dim() == 5 else "conv"
    return None


def kernel_kinds(net: nn.Module) -> Dict[str, str]:
    """Every parameter of ``net`` that the JAX package holds as a
    ``kernel`` leaf of ``params``, by name -> its kind (``conv``,
    ``conv3d``, ``deconv``, ``dense``): from the net's ``flax_paths``
    where it names its tensors, else from the modules (each conv-like
    module's ``weight``, as ``utils/torch_interop.py::g_flax_paths`` and
    ``discriminator_to_jax`` name them)."""
    if hasattr(net, "flax_paths"):
        out = {}
        for key, entry in net.flax_paths().items():
            coll, path = entry[0], entry[1]
            kind = entry[2] if len(entry) > 2 else None
            if coll == "params" and path[-1] == "kernel":
                if kind not in SPLIT_DIM:
                    kind = _module_kind(net.get_submodule(
                        key.rsplit(".", 1)[0])) if "." in key else None
                if kind in SPLIT_DIM:
                    out[key] = kind
        return out
    out = {}
    for name, m in net.named_modules():
        kind = _module_kind(m)
        if kind is not None:
            out[f"{name}.weight" if name else "weight"] = kind
    return out


def routed(m: nn.Module) -> bool:
    """Whether ``m`` computes its weight through ``apply`` (its class's
    or its own ``tensor_routed``; a ``ConvBlock``'s partial conv does
    not)."""
    if getattr(m, "partial", False) or getattr(m, "groups", 1) != 1:
        return False
    return bool(getattr(m, "tensor_routed", False))


def place(net: nn.Module, mesh) -> List[str]:
    """Marks the modules of ``net`` whose weight the rule splits over the
    mesh's tensor axis and that route it by column (``tensor_dim`` on the
    module, ``tensor_summed`` on the weight); returns the names of the
    split leaves that ``net`` computes whole on every rank (ROADMAP A 9
    g). Nothing with a tensor axis of 1."""
    from .mesh import leaf_split

    if mesh.tensor <= 1:
        return []
    if hasattr(net, "route_linears"):
        net.route_linears()
    kinds = kernel_kinds(net)
    whole = []
    for name, m in net.named_modules():
        w = getattr(m, "weight", None)
        key = f"{name}.weight" if name else "weight"
        if not isinstance(w, nn.Parameter) or key not in kinds:
            continue
        split = leaf_split(w, kinds[key], mesh)
        if split is None or split[0] != "tensor":
            continue
        if routed(m):
            m.tensor_dim = split[1]
            w.tensor_summed = True
            if isinstance(getattr(m, "bias", None), nn.Parameter):
                m.bias.tensor_summed = True
        else:
            whole.append(key)
    for name, p in net.named_parameters():
        if name in kinds and name not in whole and \
                not getattr(p, "tensor_summed", False):
            split = leaf_split(p, kinds[name], mesh)
            if split is not None and split[0] == "tensor":
                whole.append(name)
    return sorted(set(whole))


def columns(m: nn.Module, size: Optional[int] = None
            ) -> Optional[Tuple[int, int]]:
    """(first, count) of this rank's output columns of module ``m``'s
    split weight (of ``size`` columns, default the weight's split
    dimension) while a step runs on a tensor axis; None when ``m`` is not
    split or no tensor axis runs."""
    dim = getattr(m, "tensor_dim", None)
    if dim is None:
        return None
    t, n_ranks = collectives.tensor_rank()
    if n_ranks == 1:
        return None
    size = m.weight.shape[dim] if size is None else size
    n = size // n_ranks
    return t * n, n


def apply(m: nn.Module, x: torch.Tensor,
          run: Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
                        torch.Tensor],
          weight: Optional[torch.Tensor] = None,
          bias: Optional[torch.Tensor] = None, out_dim: int = 1
          ) -> torch.Tensor:
    """``run(x, weight, bias)`` of module ``m`` (``weight`` and ``bias``
    default to ``m``'s, in x's type; a weight derived from ``m``'s whose
    split dimension holds the output channels in contiguous blocks per
    channel, as the upconv's LR-space form, is split the same way). While
    a step runs on a tensor axis and ``m`` is split: ``run`` on this
    rank's columns of the weight and the bias, the output joined along
    ``out_dim``."""
    weight = m.weight if weight is None else weight
    if bias is None:
        bias = getattr(m, "bias", None)
    dim = getattr(m, "tensor_dim", None)
    cols = None if dim is None else columns(m, weight.shape[dim])
    if cols is None:
        return run(x, weight.to(x.dtype),
                   None if bias is None else bias.to(x.dtype))
    lo, n = cols
    part = run(collectives.tensor_input(x),
               weight.narrow(dim, lo, n).to(x.dtype),
               None if bias is None else bias.narrow(0, lo, n).to(x.dtype))
    return collectives.tensor_join(part, out_dim, lo, weight.shape[dim])
