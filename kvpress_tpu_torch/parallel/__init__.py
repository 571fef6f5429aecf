"""Tensor parallelism over ``torch.distributed`` (port of
``kvpress_tpu/parallel/mesh.py``): meshes, the rank's shards of weights,
caches and batches, and which presses run under a mesh."""

from .mesh import (ModelShard, data_shard, gather_batch, gather_heads, make_mesh,
                   make_mesh_hybrid, repack_int4_rows, shard_cache, shard_params, validate_tp)
from .presses import MESH_ITEMS, MESH_PRESSES, check_press

__all__ = ["ModelShard", "data_shard", "gather_batch", "gather_heads", "make_mesh",
           "make_mesh_hybrid", "repack_int4_rows", "shard_cache", "shard_params", "validate_tp",
           "MESH_ITEMS", "MESH_PRESSES", "check_press"]
