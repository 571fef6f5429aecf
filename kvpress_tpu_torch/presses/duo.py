"""DuoAttentionPress (reference duo_attention_press.py, arXiv:2410.10819;
port of ``kvpress_tpu/presses/duo.py``): kv heads split into retrieval heads
(the whole cache) and streaming heads (sink + recent only) by per-(layer,
head) scores.

The scores come from the DuoAttention artifact files (the reference fetches
them over HTTP, :120-141), given as an (L, H_kv) array. The streaming heads'
middle slots are cleared in the cache keep-mask; ``ops.duo_decode`` splits
such a cache into two dense buffers for decode."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..rope import apply_rope, rope_cos_sin
from .base import BasePress, LayerCtx
from .wrappers import _refuse_bucket


def load_duo_head_scores(path: str) -> tuple[int, int, np.ndarray]:
    """(sink_size, recent_size, head_scores (L, H_kv)) from a local copy of a
    DuoAttention ``full_attention_heads.tsv`` artifact (sink 128, recent 256),
    or an ``.npz`` with keys sink_size, recent_size and head_scores."""
    if path.endswith(".npz"):
        d = np.load(path)
        return int(d["sink_size"]), int(d["recent_size"]), d["head_scores"]
    return 128, 256, np.loadtxt(path, delimiter="\t")


@dataclasses.dataclass(frozen=True)
class _MeanQKCollector(BasePress):
    """Each layer's mean pre-RoPE queries (Hq, D) and keys (Hkv, D) over the
    batch and the sequence (after the q/k-norm), as float32."""

    def init_state(self, cfg, batch: int, seq_len: int):
        return [None] * cfg.num_layers

    def layer_compress(self, ctx, keys, values, length, mask, state=None):
        state = {"q": ctx.queries_prerope.to(torch.float32).mean(dim=(0, 2)),
                 "k": ctx.keys_prerope.to(torch.float32).mean(dim=(0, 2))}
        return keys, values, length, mask, state


def duo_attention_on_the_fly(runner, params, samples, q_len: int = 500) -> np.ndarray:
    """Head scores without the artifact (reference duo_attention_on_the_fly,
    :144-210): each layer's mean pre-RoPE query and key over calibration
    samples, repeated ``q_len`` times with RoPE; the last query's attention
    over those keys; the area under its cumulative curve, averaged over each
    GQA group. Returns (L, H_kv) float64 (higher = retrieval head). The
    prefills keep the parameters' dtype (the JAX function's float32 cache
    would not reach the card's bf16 kernels)."""
    cfg = runner.cfg
    Hkv, D = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // Hkv
    scores = np.zeros((cfg.num_layers, Hkv), np.float64)
    positions = torch.arange(q_len, device=runner.device)[None]
    cos, sin = rope_cos_sin(runner.inv_freq, positions, runner.attention_scaling)
    cos, sin = cos[:, None], sin[:, None]                    # (1, 1, q_len, D)
    for ids in samples:
        _, _, state = runner.prefill(params, ids, press=_MeanQKCollector(),
                                     compute_logits=False)
        # the per-layer list, stacked: (L, Hq, D) and (L, Hkv, D)
        mq = torch.stack([s["q"] for s in state])
        mk = torch.stack([s["k"] for s in state])
        q = apply_rope(mq[:, :, None].expand(*mq.shape[:2], q_len, D), cos, sin)
        k = apply_rope(mk[:, :, None].expand(*mk.shape[:2], q_len, D), cos, sin)
        k_rep = k.repeat_interleave(G, dim=1)                 # (L, Hq, q_len, D)
        attn = torch.einsum("lhd,lhsd->lhs", q[:, :, -1], k_rep) / D ** 0.5
        attn = torch.softmax(attn.to(torch.float32), dim=-1)
        s = torch.cumsum(attn, dim=-1).mean(dim=-1)           # (L, Hq)
        s = s.reshape(cfg.num_layers, Hkv, G).mean(dim=-1)
        scores += s.cpu().numpy() / len(samples)
    return scores


@dataclasses.dataclass(frozen=True)
class DuoAttentionPress(BasePress):
    head_compression_ratio: float = 0.0
    sink_size: int = 128
    recent_size: int = 256
    head_scores: Optional[np.ndarray] = None     # (L, H_kv), lower = prunable

    headwise_mask = True      # the cache must carry a materialized keep-mask

    # The scores are an array: presses compare and hash by identity.
    __eq__ = object.__eq__
    __hash__ = object.__hash__

    def streaming_mask(self) -> np.ndarray:
        """(L, H_kv) bool, True for streaming heads (reference :88-94): the
        ``round(L * H_kv * ratio)`` lowest scores. numpy's default argsort,
        as the JAX package's, so tied scores prune the same heads."""
        if self.head_scores is None:
            raise ValueError("head scores not loaded; pass head_scores=load_duo_head_scores(path)")
        scores = np.asarray(self.head_scores)
        mask = np.zeros(scores.shape, dtype=bool)
        n_pruned = round(scores.size * self.head_compression_ratio)
        if n_pruned > 0:
            idx = np.argsort(scores, axis=None)[:n_pruned]
            mask[np.unravel_index(idx, scores.shape)] = True
        return mask

    @property
    def compression_ratio(self):
        return 0.0   # measured (cache.masked_fraction), not set

    def _keep(self, layer_idx: int, length: int, S: int, device) -> torch.Tensor:
        """(1, H, S) bool: False on a streaming head's slots from sink_size to
        ``length - recent_size`` (nothing when length is at most sink +
        recent)."""
        streaming = torch.as_tensor(self.streaming_mask()[layer_idx], device=device)
        pos = torch.arange(S, device=device)
        middle = (pos >= self.sink_size) & (pos < length - self.recent_size)
        if length <= self.sink_size + self.recent_size:
            middle = torch.zeros_like(middle)
        return ~(streaming[None, :, None] & middle)

    def layer_compress(self, ctx: LayerCtx, keys, values, length, mask, state=None):
        _refuse_bucket(self, ctx)
        S = keys.shape[2]
        return keys, values, length, mask & self._keep(ctx.layer_idx, S, S, keys.device), state

    # -- chunked prefill: eviction by position alone, so the one-shot mask
    # with S replaced by the valid length.

    def chunked_compress(self, ctx, keys, values, length: int, mask):
        return keys, values, length, mask & self._keep(ctx.layer_idx, length, keys.shape[2],
                                                       keys.device)

    def chunked_compress_quantized(self, ctx, keys, values, key_scales, value_scales,
                                   bits: int, length: int, mask):
        return (keys, values, key_scales, value_scales, length,
                mask & self._keep(ctx.layer_idx, length, keys.shape[2], keys.device))
