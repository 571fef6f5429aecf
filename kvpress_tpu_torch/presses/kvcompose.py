"""KVComposePress (reference kvcompose_press.py, arXiv:2509.05165; port of
``kvpress_tpu/presses/kvcompose.py``): attention-guided composite-token
eviction. The pipeline re-feeds the context once against its own cache and
aggregates that pass's attention onto the context's columns
(``KVPressPipeline._run_kvcompose``: the ``KVComposeCollector`` over
materialized probabilities one-shot, or ``ops.attention.refeed_colagg`` in
chunks); per-layer composite budgets then come from a global top-k over the
heads' descending score curves. Structured mode rebuilds each layer to its
budget; unstructured mode clears keep-mask bits head by head (reference
:315-357). The re-feed holds about twice the context's KV, as in the
reference (:377-379)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .base import BasePress, LayerCtx


@dataclasses.dataclass(frozen=True)
class KVComposeCollector(BasePress):
    """The one-shot re-feed's scorer: this pass's attention probabilities
    onto the first ``context_len`` columns, aggregated over the queries
    (``agg_task``) and then over each kv head's query heads (``agg_group``)
    (reference forward_hook + compute_scores). State per layer: {"scores":
    (B, H_kv, context_len)}. It only reads the layer."""

    context_len: int = 0
    agg_task: str = "max"
    agg_group: str = "mean"

    needs_attn_probs = True
    compresses_prefill = False
    compresses_decode = True
    writes_cache = False

    def init_state(self, cfg, batch, seq_len, dtype=None, device=None):
        return [{"scores": torch.zeros((batch, cfg.num_kv_heads, self.context_len),
                                       dtype=torch.float32, device=device)}
                for _ in range(cfg.num_layers)]

    def decode_compress(self, ctx: LayerCtx, keys, values, length, mask, state=None):
        B, Hkv = keys.shape[:2]
        attn = ctx.attn_probs[..., :self.context_len].float()
        task = attn.amax(dim=2) if self.agg_task == "max" else attn.mean(dim=2)
        grouped = task.reshape(B, Hkv, -1, self.context_len)
        scores = grouped.amax(dim=2) if self.agg_group == "max" else grouped.mean(dim=2)
        return keys, values, length, mask, {"scores": scores}


@dataclasses.dataclass(frozen=True)
class KVComposePress(BasePress):
    structured: bool = True
    compression_ratio: float = 0.0
    agg_task: str = "max"
    agg_group: str = "mean"
    agg_head: str = "mean"
    add_v_norm: bool = False
    add_mean_across_heads: bool = True
    keep_token_lower_bound: int = 0

    multi_pass = "kvcompose"
    compresses_prefill = False

    def __post_init__(self):
        if not 0 <= self.compression_ratio < 1:
            raise ValueError(f"compression_ratio must be in [0, 1): {self.compression_ratio}")

    def budgets_and_masks(self, scores: np.ndarray, values: Optional[np.ndarray]):
        """scores (L, H, S) float32 -> (important_per_layer (L,), keep_mask
        (L, H, S)); ``values`` (L, H, S, D) float32 for ``add_v_norm``.

        Mirrors enhance_scores / compute_composite_scores /
        compute_important_per_layer / prepare_important_masks, on the host in
        numpy with stable sorts, as the JAX package computes them."""
        L, H, S = scores.shape
        scores = scores.copy()
        if self.add_v_norm and values is not None:
            scores *= np.linalg.norm(values, axis=-1)         # (L, H, S)
        if self.add_mean_across_heads:
            scores += scores.mean(axis=1, keepdims=True)

        desc = -np.sort(-scores, axis=-1)                     # (L, H, S) descending
        per_head = desc.copy()
        per_head[..., :self.keep_token_lower_bound] += 1e9

        if self.agg_head == "max":
            per_layer = desc.max(axis=1)
        else:
            per_layer = desc.mean(axis=1)                     # (L, S)
        per_layer[..., :self.keep_token_lower_bound] += 1e9
        per_layer[0] = per_layer.max(axis=0)                  # the first layer largest

        n_kept = int(per_head.size * (1 - self.compression_ratio))
        kept = np.argsort(-per_head.reshape(-1), kind="stable")[:n_kept] // S
        important_per_head = np.bincount(kept, minlength=L * H).reshape(L, H)

        n_kept = int(per_layer.size * (1 - self.compression_ratio))
        kept = np.argsort(-per_layer.reshape(-1), kind="stable")[:n_kept] // S
        important_per_layer = np.bincount(kept, minlength=L)

        keep = np.zeros((L, H, S), dtype=bool)
        for layer in range(L):
            for h in range(H):
                count = (important_per_layer[layer] if self.structured
                         else important_per_head[layer, h])
                idx = np.argsort(-scores[layer, h], kind="stable")[:count]
                keep[layer, h, idx] = True
        return important_per_layer, keep
