"""Context-parallel prefill (port of ``kvpress_tpu/parallel/context_prefill.py``):
the whole model forward with the sequence sharded over the mesh's ``"seq"``
axis, ring attention across the shards and shard-local compression.

Compression runs per sequence shard: the math of the single-device
``ChunkPress(press, chunk_length=S / N)``. The dense layers are
shard-local; the only communication along ``"seq"`` is the ring's rotation
of key/value blocks inside attention. On a 2D ``("model", "seq")`` mesh each
rank also holds its heads and MLP slice, with the two all-reduces a layer
over ``"model"`` (the sharded runner's ``_finish_layer``).

The rank's shard is a tuple, as JAX's global arrays are: ``(keys, values,
lengths, masks)``, or with ``quantized=True`` ``(payload_k, payload_v,
lengths, masks, key_scales, value_scales)``, where keys and values are the
rank's ``(L, B, H_local, Sl, D)`` block (int8, or packed int4 ``D / 2``),
``lengths`` its per-layer valid lengths ``(L,)`` int32 on the host, and
``masks`` its ``(L, B, H_local, Sl)`` keep-bits. ``gather_seq`` (and
``gather_heads`` over ``"model"``) gives JAX's ``(L, B, H, N * Sl, D)``.

Callers pass what a rank runs: on a mesh with a ``"model"`` axis the sharded
runner (``Runner.create(cfg, mesh=mesh)``) and ``shard_params(params,
mesh)``, else the plain runner and the whole params; and the whole context
``ids`` (B, S), the same on every rank.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..cache import quantize_kv
from ..rope import apply_rope
from .mesh import axis_size, gather_seq, seq_block, seq_shard
from .presses import check_seq_press
from .ring import (ring_colagg, ring_flash_self_attention, ring_self_attention,
                   ring_self_attention_lse)


def check_rank_runner(runner, params, mesh) -> None:
    """The runner is sharded exactly when the mesh has a ``"model"`` axis,
    and takes ``params`` (see ``Runner._check_params``)."""
    has_model = "model" in mesh.mesh_dim_names
    if (runner.shard is not None) != has_model:
        raise ValueError("over a mesh with a 'model' axis pass Runner.create(cfg, mesh=mesh) and "
                         "shard_params(params, mesh); over a seq-only mesh the plain runner and "
                         "the whole params")
    runner._check_params(params)


def refuse_rerotation(press) -> None:
    if press is not None and getattr(press, "rerotates", False):
        raise ValueError(
            "key-rerotating presses (KeyRerotation/Finch) renumber kept keys to contiguous "
            "positions per shard: every shard would claim the same position range, which the "
            "split-KV decode combine cannot reconcile. Use them on the single-device pipeline "
            "or a (data, model) mesh.")


@torch.no_grad()
def context_parallel_prefill(params, ids: torch.Tensor, *, runner, mesh, press=None,
                             quantized: bool = False, kv_bits: int = 8):
    """The rank's shard (see the module docstring) of the prefill of ``ids``
    (B, S), S divisible by the ``"seq"`` axis: positions ``rank * Sl ..``,
    Gemma3's local RoPE on sliding layers, ring attention (the flash ring on
    a ``attn_impl="flash"`` runner, the plain ring else), then
    ``press.layer_compress`` on the rank's block of every layer that is not
    sliding. ``quantized=True`` stores int8 (``kv_bits=8``) or packed int4
    payloads with per-token scales; attention runs on the fresh projections
    all the same."""
    from ..models.llama import (_finish_layer, _project_qkv, _rope_of, _sm_scale,
                                embed_tokens, rms_norm)
    from ..presses.base import LayerCtx

    refuse_rerotation(press)
    if press is not None:
        check_seq_press(press)
    check_rank_runner(runner, params, mesh)
    cfg = runner.cfg
    seq = seq_shard(mesh, runner.device)
    ids_local = seq_block(ids.to(runner.device), mesh)
    B, Sl = ids_local.shape
    positions = (seq.rank * Sl + torch.arange(Sl, device=runner.device))[None].expand(B, Sl)
    rope, rope_local = runner._ropes(positions)
    scale = _sm_scale(cfg)
    ring = ring_flash_self_attention if runner.attn_impl == "flash" else ring_self_attention
    ring_kw = dict(softcap=cfg.logit_softcap) if runner.attn_impl == "flash" else {}

    x = embed_tokens(params, ids_local, cfg)
    L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    width = D if not quantized or kv_bits == 8 else D // 2
    store = x.dtype if not quantized else (torch.int8 if kv_bits == 8 else torch.uint8)
    keys = torch.empty((L, B, H, Sl, width), dtype=store, device=runner.device)
    values = torch.empty_like(keys)
    masks = torch.ones((L, B, H, Sl), dtype=torch.bool, device=runner.device)
    scales = None
    if quantized:
        scales = tuple(torch.empty((L, B, H, Sl, 1), dtype=torch.float32, device=runner.device)
                       for _ in range(2))
    lengths = torch.full((L,), Sl, dtype=torch.int32)
    for l, (layer, sliding) in enumerate(zip(params.layers, cfg.sliding_flags())):
        h = rms_norm(x, layer.ln1, cfg.rms_norm_eps, cfg.rms_one_offset)
        q_pre, k_pre, v = _project_qkv(layer, cfg, h)
        cos, sin = _rope_of(rope, rope_local, sliding)
        q = apply_rope(q_pre, cos, sin).contiguous()
        k = apply_rope(k_pre, cos, sin).contiguous()
        v = v.contiguous()
        window = cfg.sliding_window if sliding else None
        attn_out = ring(q, k, v, seq=seq, sm_scale=scale, window=window, **ring_kw)
        kk, vv, n, m = k, v, Sl, masks[l]
        if press is not None and not sliding:
            # Sliding layers are never compressed: the distributed decode's
            # window test reads slot == position there.
            ctx = LayerCtx(layer_idx=l, hidden=h, queries=q, queries_prerope=q_pre,
                           keys_prerope=k_pre, positions=positions, attn_probs=None,
                           layer_params=layer, inv_freq=runner.inv_freq, cfg=cfg,
                           attention_scaling=runner.attention_scaling,
                           last_position=int(positions[0, -1]), shard=runner.shard)
            kk, vv, n, m, _ = press.layer_compress(ctx, k, v, Sl, m, None)
            masks[l] = m
        lengths[l] = int(n)
        if quantized:
            (keys[l], scales[0][l]), (values[l], scales[1][l]) = (quantize_kv(kk, kv_bits),
                                                                  quantize_kv(vv, kv_bits))
        else:
            keys[l], values[l] = kk, vv
        x = _finish_layer(x, attn_out, layer, cfg, runner.shard)
    out = (keys, values, lengths, masks)
    return out + scales if quantized else out


@torch.no_grad()
def context_parallel_kvcompose(params, ids: torch.Tensor, *, runner, press, mesh):
    """KVCompose over a ``"seq"`` mesh: one ring pass over the doubled
    sequence ``[ctx | ctx]`` (the re-fed copy at positions S .. 2S - 1, so
    causal attention gives it the single-device re-feed's view), with
    ``ring_self_attention_lse`` and ``ring_colagg`` per layer; then
    ``press.budgets_and_masks`` on the host over the gathered (L, H, S)
    scores, as on one device. Returns the rank's shard in
    ``context_parallel_prefill``'s layout over the context alone (rank r
    holds context positions ``r * S / N ..``), masked by the keep: ready for
    ``context_parallel_decode_step``.

    Unstructured mode only (a rebuilt cache would repack slots across
    shards, breaking the decode's slot == position map); no ``add_v_norm``,
    no sliding-window model, batch 1, an even seq axis dividing S. The
    keys and values of the doubled pass are all-gathered to take the
    context's blocks."""
    from ..models.llama import (_finish_layer, _project_qkv, _sm_scale, embed_tokens,
                                rms_norm)

    cfg = runner.cfg
    if press.structured:
        raise ValueError("context_parallel_kvcompose supports unstructured mode only (a "
                         "structured rebuild would repack slots across shards, breaking the "
                         "distributed decode's slot==position map)")
    if press.add_v_norm:
        raise ValueError("add_v_norm unsupported on the mesh path")
    if cfg.sliding_window is not None:
        raise ValueError("KVCompose does not run on sliding-window models")
    if "model" in mesh.mesh_dim_names:
        raise ValueError("context_parallel_kvcompose runs over a seq-only mesh")
    check_rank_runner(runner, params, mesh)
    N = axis_size(mesh, "seq")
    B, S = ids.shape
    if B != 1:
        raise ValueError("the scoring pass is per-request (B=1), like the pipeline")
    if N % 2 or S % N:
        raise ValueError(f"need an even axis ({N}) dividing both S ({S}) and 2S")
    seq = seq_shard(mesh, runner.device)
    ids2 = seq_block(torch.cat([ids, ids], dim=1).to(runner.device), mesh)
    Sl = ids2.shape[1]
    positions = (seq.rank * Sl + torch.arange(Sl, device=runner.device))[None]
    cos, sin = runner._ropes(positions)[0]
    scale = _sm_scale(cfg)
    x = embed_tokens(params, ids2, cfg)
    keys, values, scores = [], [], []
    for layer in params.layers:
        h = rms_norm(x, layer.ln1, cfg.rms_norm_eps, cfg.rms_one_offset)
        q_pre, k_pre, v = _project_qkv(layer, cfg, h)
        q, k = apply_rope(q_pre, cos, sin), apply_rope(k_pre, cos, sin)
        attn_out, lse = ring_self_attention_lse(q, k, v, seq=seq, sm_scale=scale)
        scores.append(ring_colagg(q, k, lse, seq=seq, sm_scale=scale, ctx_len=S,
                                  agg=press.agg_task))
        keys.append(k)
        values.append(v)
        x = _finish_layer(x, attn_out, layer, cfg)

    # Host: group aggregation and the global budgets, the single-device code.
    sc = gather_seq(torch.stack(scores), mesh).cpu().numpy()[..., :S]   # (L, B, Hq, S)
    task = sc if press.agg_task == "max" else sc / S
    L, _, Hq, _ = task.shape
    Hkv = cfg.num_kv_heads
    grouped = task.reshape(L, 1, Hkv, Hq // Hkv, S)
    sc_h = (grouped.max(axis=3) if press.agg_group == "max" else grouped.mean(axis=3))[:, 0]
    _, keep = press.budgets_and_masks(sc_h, None)                        # (L, Hkv, S)

    def context_block(t):
        return seq_block(gather_seq(t, mesh)[:, :, :, :S], mesh, dim=3)

    keys_ctx = context_block(torch.stack(keys))
    values_ctx = context_block(torch.stack(values))
    masks = seq_block(torch.from_numpy(np.ascontiguousarray(keep))[:, None].expand(
        L, B, Hkv, S).to(runner.device), mesh, dim=3)
    lengths = torch.full((L,), S // N, dtype=torch.int32)
    return keys_ctx, values_ctx, lengths, masks
