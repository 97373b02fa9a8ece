"""Several cards: the data and fsdp axes of the training step
(``mesh.py``) and band-parallel serving (``spatial.py``), counterpart of
``trainner_tpu/parallel``."""

from .mesh import (MeshConfig, init_distributed, local_batch_slice,
                   make_mesh, param_sharding, replicate, shard_batch)
from .spatial import effective_radius, receptive_radius, spatial_infer

__all__ = [
    "MeshConfig", "init_distributed", "local_batch_slice",
    "make_mesh", "param_sharding", "replicate", "shard_batch",
    "effective_radius", "receptive_radius", "spatial_infer",
]
