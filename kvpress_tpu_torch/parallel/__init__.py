"""Tensor and context parallelism over ``torch.distributed`` (port of
``kvpress_tpu/parallel/``): meshes, the rank's shards of weights, caches and
batches, the ring attention and context-parallel prefill and decode over a
``"seq"`` axis, and which presses run under a mesh."""

from .context_prefill import context_parallel_kvcompose, context_parallel_prefill
from .decode import (context_parallel_decode_step, context_parallel_generate,
                     context_parallel_generate_fused, ensure_tail_capacity, grow_shards)
from .mesh import (ModelShard, SeqShard, data_shard, gather_batch, gather_heads, gather_seq,
                   make_mesh, make_mesh_hybrid, make_seq_mesh, repack_int4_rows, seq_block,
                   seq_shard, shard_cache, shard_params, validate_tp)
from .presses import (MESH_ITEMS, MESH_PRESSES, SEQ_DECODE_PRESSES, SEQ_PRESSES, check_press,
                      check_seq_press)
from .ring import (context_parallel_attention, ring_colagg, ring_flash_self_attention,
                   ring_self_attention, ring_self_attention_lse)

__all__ = ["ModelShard", "SeqShard", "data_shard", "gather_batch", "gather_heads", "gather_seq",
           "make_mesh", "make_mesh_hybrid", "make_seq_mesh", "repack_int4_rows", "seq_block",
           "seq_shard", "shard_cache", "shard_params", "validate_tp", "MESH_ITEMS",
           "MESH_PRESSES", "SEQ_DECODE_PRESSES", "SEQ_PRESSES", "check_press", "check_seq_press",
           "context_parallel_attention", "ring_colagg", "ring_flash_self_attention",
           "ring_self_attention", "ring_self_attention_lse", "context_parallel_kvcompose",
           "context_parallel_prefill", "context_parallel_decode_step",
           "context_parallel_generate", "context_parallel_generate_fused",
           "ensure_tail_capacity", "grow_shards"]
