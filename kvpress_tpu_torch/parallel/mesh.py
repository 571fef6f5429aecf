"""Device meshes and tensor-parallel shards over ``torch.distributed``
(port of ``kvpress_tpu/parallel/mesh.py``).

The design is SPMD: one process per rank, each holding its own shards. The
caller initializes ``torch.distributed`` (NCCL on cards, gloo on the CPU)
and builds the mesh, as in JAX the caller makes the ``Mesh``. A mesh has
the dims ``("data", "model")`` or ``("dcn", "data", "model")``.

The layout is the JAX package's ``param_shardings`` / ``cache_shardings``:

- column-parallel ``wq``, ``wk``, ``wv``, ``wg``, ``wu``: a rank holds its
  block of output columns (its query and kv heads, its slice of the MLP
  hidden), with the biases and the per-output scales of int8 / int4
  payloads;
- row-parallel ``wo`` and ``wd``: a rank holds its block of input rows; the
  int8 scales are replicated. An int4 payload packs the first half of the
  input axis into the low nibbles and the second half into the high ones,
  so a block of rows cannot be sliced from it: ``shard_params`` unpacks the
  two planes, takes the rank's rows and repacks them into the rank's own two
  halves, each with the scale of the global half it came from (the codes do
  not change, so the partial products have the single-device terms);
- norms replicated; the embedding replicated (a lookup needs no
  collective); ``lm_head`` (or the tied embedding used as the head) over
  the vocabulary when the vocabulary divides by the model size, else
  replicated;
- a cache: batch over the batch axes (``"dcn"`` x ``"data"``), kv heads over
  ``"model"``.

The collectives are the pair that GSPMD inserts in JAX: each layer
all-reduces over ``"model"`` after ``wo`` and after ``wd`` (before Gemma3's
post-norms, which are not linear), and the head's logits are all-gathered
over the vocabulary before the softcap. A sharded ``Runner`` (built with
``mesh=``) carries the rank's ``ModelShard`` and the local head counts; a
press that decides across heads (``AdaKVPress``, ``TOVAPress``, ...)
all-gathers what it reduces over ``"model"`` (``presses.base.all_heads``)
and keeps its own heads' part.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..cache import KVCache
from ..config import ModelConfig

COLUMN = ("wq", "wk", "wv", "wg", "wu", "bq", "bk", "bv")
ROW = ("wo", "wd")


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(data: int = 1, model: int = 1, device_type: Optional[str] = None):
    """A ``("data", "model")`` mesh over the caller's process group, whose
    world size must be ``data * model``. ``device_type`` defaults to
    ``"cuda"`` under NCCL and ``"cpu"`` otherwise (a gloo group takes tensors
    of either device)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(device_type), (data, model),
                            mesh_dim_names=("data", "model"))


def make_mesh_hybrid(dcn: int = 1, data: int = 1, model: int = 1,
                     device_type: Optional[str] = None):
    """A ``("dcn", "data", "model")`` mesh: the outermost axis carries only
    data parallelism, so the per-layer all-reduces stay on ``"model"``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(device_type), (dcn, data, model),
                            mesh_dim_names=("dcn", "data", "model"))


def make_seq_mesh(seq: int, model: int = 1, order: tuple[str, str] = ("model", "seq"),
                  device_type: Optional[str] = None):
    """A mesh with a ``"seq"`` axis for context parallelism: ``("seq",)``
    when ``model`` is 1, else the two axes in ``order``. Ranks fill the mesh
    in row-major order, as JAX's ``devices.reshape`` does, so rank ``r`` of
    a ``("model", "seq")`` mesh is model ``r // seq``, seq ``r % seq``."""
    from torch.distributed.device_mesh import init_device_mesh

    if model == 1:
        return init_device_mesh(_device_type(device_type), (seq,), mesh_dim_names=("seq",))
    if sorted(order) != ["model", "seq"]:
        raise ValueError(f"order must hold 'model' and 'seq', got {order}")
    sizes = {"model": model, "seq": seq}
    return init_device_mesh(_device_type(device_type), tuple(sizes[a] for a in order),
                            mesh_dim_names=tuple(order))


def _batch_axes(mesh) -> tuple[str, ...]:
    """The data-like axes of ``mesh``, ``"dcn"`` outermost."""
    return tuple(a for a in ("dcn", "data") if a in mesh.mesh_dim_names)


def axis_size(mesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)] if name in mesh.mesh_dim_names else 1


def batch_coord(mesh) -> tuple[int, int]:
    """(this rank's index, the count) over the flattened batch axes."""
    index, count = 0, 1
    for a in _batch_axes(mesh):
        index = index * axis_size(mesh, a) + mesh.get_local_rank(a)
        count *= axis_size(mesh, a)
    return index, count


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """A rank's place on the ``"model"`` axis: its process group, its
    coordinate and the axis size; ``device`` is where the scalars of its
    collectives live."""
    group: Any
    rank: int
    size: int
    device: torch.device

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in model order."""
        return _all_gather(x, self.group, self.size, dim)

    def max(self, value: int) -> int:
        """The largest of every rank's host int."""
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        return int(self.all_reduce(t, dist.ReduceOp.MAX).item())


def _all_gather(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def model_shard(mesh, device) -> ModelShard:
    return ModelShard(group=mesh.get_group("model"), rank=mesh.get_local_rank("model"),
                      size=axis_size(mesh, "model"), device=torch.device(device))


def _stage_through_host(group, device) -> bool:
    # gloo's send and recv read and write the tensor's memory from the host:
    # a CUDA pointer aborts the rank ("writev: Bad address", torch 2.11, one
    # H100), while its collectives take CUDA tensors.
    return torch.device(device).type == "cuda" and dist.get_backend(group) == "gloo"


@dataclasses.dataclass(frozen=True)
class SeqShard(ModelShard):
    """A rank's place on the ``"seq"`` axis (context parallelism): its block
    of the sequence is ``rank``, of ``size``. Besides the collectives of
    ``ModelShard`` it has the ring's rotation (``rotate``), the counterpart
    of ``jax.lax.ppermute`` with the permutation ``i -> i + 1``.

    ``staged``: the rotation moves each block through host memory (a gloo
    group and CUDA tensors), counted in ``SeqShard.staged_blocks``."""
    staged: bool = False

    staged_blocks = 0        # blocks a staged rotation moved, over the process

    def rotate(self, *tensors: torch.Tensor) -> list[torch.Tensor]:
        """Each tensor sent to seq rank ``rank + 1`` and replaced by the one
        that seq rank ``rank - 1`` sent (mod ``size``). A world of one
        returns them as they are."""
        if self.size == 1:
            return list(tensors)
        nxt = dist.get_global_rank(self.group, (self.rank + 1) % self.size)
        prv = dist.get_global_rank(self.group, (self.rank - 1) % self.size)
        send = [t.contiguous() for t in tensors]
        if self.staged:
            send = [t.cpu() for t in send]
            SeqShard.staged_blocks += len(send)
        recv = [torch.empty_like(t) for t in send]
        ops = [op for s, r in zip(send, recv)
               for op in (dist.P2POp(dist.isend, s, nxt, self.group),
                          dist.P2POp(dist.irecv, r, prv, self.group))]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if self.staged:
            recv = [r.to(t.device, non_blocking=True) for r, t in zip(recv, tensors)]
        return recv


def seq_shard(mesh, device) -> SeqShard:
    """The rank's ``SeqShard`` of ``mesh``'s ``"seq"`` axis."""
    group = mesh.get_group("seq")
    return SeqShard(group=group, rank=mesh.get_local_rank("seq"), size=axis_size(mesh, "seq"),
                    device=torch.device(device), staged=_stage_through_host(group, device))


def seq_block(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """This rank's block of ``x`` along the sequence dimension ``dim`` (ids
    (B, S) by default): the counterpart of sharding over ``P(None, "seq")``."""
    size, rank = axis_size(mesh, "seq"), mesh.get_local_rank("seq")
    if x.shape[dim] % size:
        raise ValueError(f"a sequence of {x.shape[dim]} does not split over {size} seq shards")
    return _block(x, dim, rank, size)


def gather_seq(x: torch.Tensor, mesh, dim: int = 3) -> torch.Tensor:
    """Every seq shard's block of ``x`` along ``dim`` (the slot axis of a
    cache block ``(L, B, H, Sl, D)`` by default), in seq order: the global
    array of a tensor sharded over ``"seq"``."""
    return _all_gather(x, mesh.get_group("seq"), axis_size(mesh, "seq"), dim)


def validate_tp(cfg: ModelConfig, model_parallel: int) -> None:
    if cfg.num_kv_heads % model_parallel:
        raise ValueError(f"num_kv_heads={cfg.num_kv_heads} must divide by model="
                         f"{model_parallel} (replicate KV or lower TP degree otherwise)")
    if cfg.intermediate_size % model_parallel:
        raise ValueError(f"intermediate_size={cfg.intermediate_size} must divide by model="
                         f"{model_parallel}")


def local_config(cfg: ModelConfig, model_parallel: int) -> ModelConfig:
    """The config a rank runs: its query and kv heads and its MLP slice (the
    group size G is unchanged)."""
    validate_tp(cfg, model_parallel)
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // model_parallel,
                               num_kv_heads=cfg.num_kv_heads // model_parallel,
                               intermediate_size=cfg.intermediate_size // model_parallel)


def vocab_sharded(vocab_size: int, shard: Optional[ModelShard]) -> bool:
    return shard is not None and vocab_size % shard.size == 0


# --------------------------------------------------------------------- #
# Weights


def _block(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n).clone()


def repack_int4_rows(payload: torch.Tensor, scale: torch.Tensor, rank: int, size: int):
    """A row-parallel block of an int4 payload (in/2, out) with its (2, out)
    scales: rows ``rank * in/size ..`` of the global input axis, repacked
    into the block's own two halves; each local half takes the scale of the
    global half its rows come from."""
    half = payload.shape[0]                       # in / 2
    codes = torch.cat([payload & 0xF, payload >> 4], dim=0)          # (in, out)
    n = 2 * half // size                                             # rows a rank
    if n % 2:
        raise ValueError(f"an int4 row-parallel block of {n} rows cannot be split in halves")
    rows = codes[rank * n:(rank + 1) * n]
    local = rows[:n // 2] | (rows[n // 2:] << 4)
    lo, hi = rank * n, rank * n + n // 2                             # first row of each half
    local_scale = torch.stack([scale[lo // half], scale[hi // half]])
    return local.contiguous(), local_scale.contiguous()


def shard_layer(tensors: dict, rank: int, size: int) -> dict:
    """One layer's tensors (the ``DecoderLayer`` names) cut to model rank
    ``rank`` of ``size``."""
    out = {}
    for name, t in tensors.items():
        base = name[:-6] if name.endswith("_scale") else name
        if base in COLUMN:
            out[name] = _block(t, t.dim() - 1, rank, size)
        elif base in ROW and name.endswith("_scale"):
            if tensors[base].dtype == torch.uint8:
                continue                          # repacked with its payload below
            out[name] = t
        elif base in ROW:
            if t.dtype == torch.uint8:
                out[name], out[name + "_scale"] = repack_int4_rows(
                    t, tensors[name + "_scale"], rank, size)
            else:
                out[name] = _block(t, 0, rank, size)
        else:
            out[name] = t
    return out


def shard_params(params, mesh):
    """This rank's ``LlamaModel``: the layers cut by ``shard_layer``, the
    embedding and norms replicated, an untied ``lm_head`` (E, V) and its
    ``lm_head_scale`` cut over the vocabulary when it divides. The module
    carries its ``ModelShard`` as ``shard``; a tied head is cut at use
    (``lm_head_logits``)."""
    from ..models.llama import LlamaModel

    shard = model_shard(mesh, params.device)
    layers = [shard_layer({n: p.data for n, p in layer.named_parameters(recurse=False)},
                          shard.rank, shard.size) for layer in params.layers]
    head = params.get("lm_head")
    extra = {n: params.get(n).data for n in ("embed_scale", "lm_head_scale")
             if params.get(n) is not None}
    if head is not None:
        head = head.data
        if vocab_sharded(head.shape[1], shard):
            head = _block(head, 1, shard.rank, shard.size)
            if "lm_head_scale" in extra:
                extra["lm_head_scale"] = _block(extra["lm_head_scale"], 1, shard.rank,
                                                shard.size)
    model = LlamaModel(params.embed.data, layers, params.ln_f.data, head, extra)
    model.shard = shard
    return model


# --------------------------------------------------------------------- #
# Caches and batches


def _rows(t: torch.Tensor, dim: int, index: int, count: int) -> torch.Tensor:
    if t.shape[dim] % count:
        raise ValueError(f"a batch of {t.shape[dim]} rows does not split over {count} "
                         "data shards")
    return _block(t, dim, index, count)


def shard_cache(cache: KVCache, mesh) -> KVCache:
    """This rank's part of ``cache``: batch rows over the batch axes, kv heads
    over ``"model"`` (``(L, B/dp, H_kv/tp, S, D)``); length and offset as
    they are."""
    index, count = batch_coord(mesh)
    rank, size = mesh.get_local_rank("model"), axis_size(mesh, "model")

    def cut(t):
        return None if t is None else _block(_rows(t, 1, index, count), 2, rank, size)

    return dataclasses.replace(cache, keys=cut(cache.keys), values=cut(cache.values),
                               mask=cut(cache.mask), key_scales=cut(cache.key_scales),
                               value_scales=cut(cache.value_scales))


def data_shard(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """This rank's rows of a batch ``x`` (counterpart of ``data_sharding``)."""
    index, count = batch_coord(mesh)
    return _rows(x, dim, index, count)


def gather_batch(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Every batch shard's rows of ``x`` along ``dim``, in batch order: the
    inverse of ``data_shard``."""
    for a in reversed(_batch_axes(mesh)):            # "data" first, then "dcn"
        x = _all_gather(x, mesh.get_group(a), axis_size(mesh, a), dim)
    return x


def gather_heads(x: torch.Tensor, mesh, dim: int = 2) -> torch.Tensor:
    """Every model shard's heads of ``x`` along ``dim`` (the kv-head axis of a
    cache tensor by default)."""
    return _all_gather(x, mesh.get_group("model"), axis_size(mesh, "model"), dim)
