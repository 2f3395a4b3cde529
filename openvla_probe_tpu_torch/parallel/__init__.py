"""Sharded serving over a rank mesh (counterpart of ``openvla_probe_tpu/parallel``):
the mesh (`mesh`), the placement rules (`sharding`), the process group and its
collectives (`distributed`) and the sharded forward's collectives by each
leaf's placement (`tensor_parallel`)."""

from .mesh import data_sharding, make_mesh, replicated
from .sharding import param_spec, place_params, shard_params, shard_train_state

__all__ = [
    "data_sharding",
    "make_mesh",
    "param_spec",
    "place_params",
    "replicated",
    "shard_params",
    "shard_train_state",
]
