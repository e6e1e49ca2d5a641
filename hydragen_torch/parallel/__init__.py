"""Tensor, data and sequence parallelism for hydragen_torch over
``torch.distributed`` (one process a rank). Port of ``hydragen_tpu.parallel``:
the same shardings, with the collectives made explicit (``mesh``)."""

from hydragen_torch.parallel.mesh import COLLECTIVES, Mesh, launch, make_mesh
from hydragen_torch.parallel.sharding import (
    cache_pspecs,
    param_pspecs,
    shard_cache,
    shard_params,
)

__all__ = [
    "make_mesh",
    "param_pspecs",
    "cache_pspecs",
    "shard_params",
    "shard_cache",
    "Mesh",
    "launch",
    "COLLECTIVES",
]
