"""KVzipPress: query-agnostic scoring by context reconstruction (reference
kvzip_press.py, arXiv:2505.23416; port of ``kvpress_tpu/presses/kvzip.py``).

The prefill stays whole. The pipeline then re-feeds the context in
``chunk_size``-token "repeat" prompts ("Repeat the previous context
exactly."), each scored against the cache (``KVPressPipeline._run_kvzip``):
a cached key's score is the largest softmax probability any repeat query
gives it over the ``[sink | chunk | repeat]`` key subset. Eviction is a
global (or layerwise) bottom-k over every layer's and head's scores, applied
as keep-mask bits.

Plain KVzip scores in ``Runner.kvzip_repeat_pass`` (the lean chunk forward,
which never moves the cache's length or offset); KVzip+ needs each layer's
values and ``Wo`` and scores through ``KVzipChunkScorer``, a decode-phase
press of ``Runner.forward`` that writes nothing back (``writes_cache``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.attention import NEG_INF
from .base import BasePress, LayerCtx


@dataclasses.dataclass(frozen=True)
class KVzipPress(BasePress):
    compression_ratio: float = 0.0
    layerwise: bool = False
    n_sink: int = 4
    kvzip_plus_normalization: bool = False
    chunk_size: int = 2048
    prev_postfix_size: int = 8
    # Head-wise compaction after the eviction mask (cache.compact_masked, by
    # the pipeline): each head's kept entries to the front of its buffer.
    compact: bool = False

    # Pipeline routing: run the repeat passes after an uncompressed prefill.
    multi_pass = True
    compresses_prefill = False

    @property
    def host_compact(self) -> bool:
        return self.compact

    def __post_init__(self):
        if not 0 <= self.compression_ratio < 1:
            raise ValueError(f"compression_ratio must be in [0, 1): {self.compression_ratio}")

    def repeat_room(self) -> int:
        """An upper bound on one repeat prompt's length (chunk, repeat
        question, chat suffix, the previous chunk's tail) plus RestoreKV's
        restore tokens: the buffer room the pipeline presizes without a
        tokenizer to probe."""
        return (self.chunk_size + self.prev_postfix_size + 64
                + getattr(self, "num_restore_tokens", 0))

    def chunk_pairs(self, context_ids: list[int], prefix_length: int,
                    suffix_ids: list[int], tokenizer) -> list[tuple[list, list]]:
        """[(chunk_ids, repeat_ids)] (reference prepare(), :225-264)."""
        ctx = context_ids[prefix_length:]
        chunks = [ctx[i:i + self.chunk_size]
                  for i in range(0, max(len(ctx), 1), self.chunk_size)]
        chunks = [c for c in chunks if c]
        pairs = []
        for i, chunk in enumerate(chunks):
            if i == 0:
                q = tokenizer.encode("\n\nRepeat the previous context exactly.",
                                     add_special_tokens=False)
            else:
                q = tokenizer.encode(
                    "\n\nRepeat the part of the previous context exactly, starting with",
                    add_special_tokens=False)
                q = q + chunks[i - 1][-self.prev_postfix_size:]
            pairs.append((chunk, q + list(suffix_ids) + chunk))
        return pairs

    def head_mask_from_scores(self, score_val: np.ndarray) -> np.ndarray:
        """Global (or layerwise) bottom-k eviction mask from (L, B, H, S)
        float32 scores (reference compress_post, :360-394). True = keep.
        numpy's default (unstable) argsort, as the JAX package calls it: the
        same float32 array gives the same ties."""
        L, B, H, S = score_val.shape
        if self.compression_ratio <= 0:
            return np.ones_like(score_val, dtype=bool)
        per_layer = B * H * S
        if self.layerwise:
            n_pruned_layers = np.full(L, int(per_layer * self.compression_ratio))
        else:
            n_total = int(score_val.size * self.compression_ratio)
            order = np.argsort(score_val.reshape(-1))[:n_total]
            n_pruned_layers = np.bincount(order // per_layer, minlength=L)
        keep = np.ones((L, B, H, S), dtype=bool)
        for layer in range(L):
            n = int(n_pruned_layers[layer])
            if n == 0:
                continue
            flat = score_val[layer].reshape(B, -1)
            idx = np.argsort(flat, axis=1)[:, :n]
            for b in range(B):
                keep[layer, b, idx[b] // S, idx[b] % S] = False
        return keep


def _subset_logits(q: torch.Tensor, ks_sub: torch.Tensor) -> torch.Tensor:
    """(B, Hkv, G, T, n_sub) float32 logits of the repeat queries over the key
    subset, 1/sqrt(D) scaled (the reference's, whatever the model's scale),
    causal inside the trailing T repeat keys."""
    B, Hkv, n_sub, D = ks_sub.shape
    T = q.shape[2]
    q5 = q.reshape(B, Hkv, -1, T, D)
    attn = torch.einsum("bhgtd,bhsd->bhgts", q5.float(), ks_sub.float()) / math.sqrt(D)
    rows = torch.arange(T, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    attn[..., n_sub - T:] += torch.where(cols <= rows, 0.0, NEG_INF)
    return attn


def subset_max_scores(q: torch.Tensor, ks_sub: torch.Tensor, sink: int, cl: int) -> torch.Tensor:
    """Max softmax probability of the repeat queries onto the chunk columns,
    over the ``[sink | chunk | repeat]`` key subset (reference score_kvzip,
    :287-358; the logsumexp is over the subset).

    q: (B, Hq, T, D) post-RoPE repeat queries; ks_sub: (B, Hkv, sink + cl +
    T, D) with the T repeat keys last. Returns (B, Hkv, cl) float32. exp is
    monotone, so the max is taken over the log-probabilities first."""
    attn = _subset_logits(q, ks_sub)
    lse = torch.logsumexp(attn, dim=-1, keepdim=True)
    logp_chunk = attn[..., sink:sink + cl] - lse
    return torch.exp(logp_chunk.amax(dim=(2, 3)))


@dataclasses.dataclass(frozen=True)
class KVzipChunkScorer(BasePress):
    """One repeat chunk's scores in a decode-phase ``Runner.forward`` (the
    KVzip+ route): the largest attention of the repeat queries onto the
    cached chunk keys (reference score_kvzip, :287-358). With ``plus``, each
    probability is divided by its query's hidden-state norm and weighted by
    the key's ``||Wo . v||``. State per layer: {"scores": (B, H_kv,
    end_idx - start_idx)}. It only reads the layer: the runner writes
    nothing back, so the cache's slots stay as they were."""

    start_idx: int = 0
    end_idx: int = 0
    context_length: int = 0
    n_sink: int = 4
    plus: bool = False

    compresses_prefill = False
    compresses_decode = True
    writes_cache = False

    def init_state(self, cfg, batch, seq_len, dtype=None, device=None):
        n = self.end_idx - self.start_idx
        return [{"scores": torch.zeros((batch, cfg.num_kv_heads, n), dtype=torch.float32,
                                       device=device)} for _ in range(cfg.num_layers)]

    def decode_compress(self, ctx: LayerCtx, keys, values, length, mask, state=None):
        from ..models.llama import dequant_weight

        cfg = ctx.cfg
        B, Hkv, _, D = keys.shape
        G = cfg.num_heads // Hkv
        T = ctx.queries.shape[2]
        sink = min(self.n_sink, self.start_idx)
        cl = self.end_idx - self.start_idx
        ctx_len = self.context_length

        def sub(x):
            return torch.cat([x[:, :, :sink], x[:, :, self.start_idx:self.end_idx],
                              x[:, :, ctx_len:ctx_len + T]], dim=2)

        ks = sub(keys)
        if not self.plus:
            return keys, values, length, mask, {
                "scores": subset_max_scores(ctx.queries, ks, sink, cl)}
        attn = torch.softmax(_subset_logits(ctx.queries, ks), dim=-1)
        h_norm = torch.linalg.vector_norm(ctx.hidden.float(), dim=-1)         # (B, T)
        attn = attn / h_norm[:, None, None, :, None]
        wo = dequant_weight(ctx.layer_params, "wo", torch.float32).reshape(
            Hkv, G, D, cfg.hidden_size)
        wov = torch.einsum("hgij,bhsi->bhgsj", wo, sub(values).float())       # (B,Hkv,G,n,E)
        attn = attn * torch.linalg.vector_norm(wov, dim=-1)[:, :, :, None, :]
        scores = attn[..., sink:sink + cl].amax(dim=(2, 3))                   # (B, Hkv, cl)
        return keys, values, length, mask, {"scores": scores}
