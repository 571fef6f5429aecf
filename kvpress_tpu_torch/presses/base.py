"""Press API (port of ``kvpress_tpu/presses/base.py``).

A press is a frozen dataclass. The runner calls ``press.layer_compress`` once
per layer inside the prefill, with a ``LayerCtx`` carrying everything a press
may need. Compression never reshapes: kept entries are gathered to the front
of the buffer and ``length`` drops; head-wise eviction clears keep-mask bits.

The JAX package's content hashing exists only to make presses static jit
arguments; eager PyTorch needs none of it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..config import ModelConfig


@dataclasses.dataclass(frozen=True)
class LayerCtx:
    """Everything a press may need, computed in the layer body."""
    layer_idx: int
    hidden: torch.Tensor                 # (B, S, E) post-input-layernorm
    queries: torch.Tensor                # (B, Hq, S, D) post-RoPE
    queries_prerope: torch.Tensor        # (B, Hq, S, D)
    keys_prerope: torch.Tensor           # (B, Hkv, S, D)
    positions: torch.Tensor              # (B, S)
    attn_probs: Optional[torch.Tensor]   # (B, Hq, S, S) if the press wants them
    layer_params: Any                    # this layer's weights (DecoderLayer)
    inv_freq: torch.Tensor               # (D/2,) f32
    cfg: ModelConfig = None
    attention_scaling: float = 1.0
    kv_len: Optional[int] = None         # valid length under bucketed prefill
    attn_lse: Optional[torch.Tensor] = None   # (B, Hq, S) f32 row logsumexp of
    # the flash prefill (press.wants_lse): column-sum scoring then skips its
    # own LSE pass (ops/observed_colsum.py)

    @property
    def scale(self) -> float:
        if self.cfg.query_pre_attn_scalar is not None:
            return self.cfg.query_pre_attn_scalar ** -0.5
        return self.cfg.head_dim ** -0.5


@dataclasses.dataclass(frozen=True)
class BasePress:
    """No-op base."""

    # Runner routing signals (class attributes, not dataclass fields).
    needs_attn_probs = False
    compresses_prefill = True
    compresses_decode = False

    def wants_probs(self, q_len: int) -> bool:
        """Whether the runner should take the attention path that
        materializes probabilities (O(S^2) memory) for a ``q_len``-token call."""
        return self.needs_attn_probs

    def wants_lse(self, q_len: int) -> bool:
        """Whether the flash prefill should also give the per-row logsumexp
        (``ctx.attn_lse``)."""
        return False

    def init_state(self, cfg: ModelConfig, batch: int, seq_len: int):
        """Per-layer press state (a list over layers), or None if stateless."""
        return None

    def max_kept(self, seq_len: int, cfg: ModelConfig) -> int:
        """Upper bound on kept entries per layer after compression."""
        return seq_len

    def layer_compress(self, ctx: LayerCtx, keys, values, length, mask, state=None):
        return keys, values, length, mask, state


def float32_budget(length: int, ratio: float) -> int:
    """Kept count for ``length`` valid slots at ``ratio``: the product taken
    in float32 and floored, at least 1, as the JAX package computes it."""
    return max(int(np.float32(length) * np.float32(1 - ratio)), 1)


def topk_keep(
    scores: torch.Tensor,            # (B, H, S), higher = keep
    keys: torch.Tensor,              # (B, H, S, D)
    values: torch.Tensor,
    n_kept: int,
):
    """Keep the top-``n_kept`` scored entries per (batch, kv-head), gathered to
    the buffer front in descending score order (the order of
    ``jax.lax.top_k``). Returns new (keys, values, idx); tail slots keep
    their old contents."""
    _, idx = torch.topk(scores, n_kept, dim=-1)
    gather = idx[..., None].expand(*idx.shape, keys.shape[-1])
    new_keys = keys.clone()
    new_values = values.clone()
    new_keys[:, :, :n_kept] = torch.gather(keys, 2, gather)
    new_values[:, :, :n_kept] = torch.gather(values, 2, gather)
    return new_keys, new_values, idx


@dataclasses.dataclass(frozen=True)
class ScorerPress(BasePress):
    """Score, then keep the top k (reference scorer_press.py:17-102).
    ``n_kept`` uses the reference's int() floor so kept lengths match."""
    compression_ratio: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.compression_ratio < 1.0:
            raise ValueError(f"compression_ratio must be in [0, 1): {self.compression_ratio}")

    def score(self, ctx: LayerCtx, keys, values) -> torch.Tensor:
        raise NotImplementedError

    def n_kept(self, seq_len: int) -> int:
        return max(1, int(seq_len * (1 - self.compression_ratio)))

    def max_kept(self, seq_len: int, cfg: ModelConfig) -> int:
        return self.n_kept(seq_len)

    def exact_kept(self, seq_len: int) -> Optional[int]:
        """The kept length where it is known without the data or the layer,
        else None."""
        return self.n_kept(seq_len)

    def budget(self, ctx: LayerCtx, seq_len: int) -> int:
        """Per-layer kept count; budget-shaping presses (PyramidKV) override."""
        return self.n_kept(seq_len)

    def dynamic_score(self, ctx: LayerCtx, keys, values, length: int) -> torch.Tensor:
        """Scores of a buffer whose first ``length`` slots are valid (the
        compression pass of chunked prefill; the caller masks the rest).
        Default: ``score``, right for per-token content scorers; window
        scorers override it."""
        return self.score(ctx, keys, values)

    def dynamic_budget(self, ctx: LayerCtx, length: int) -> int:
        """Kept count for ``length`` valid slots; budget-shaping presses
        (PyramidKV) override."""
        return float32_budget(length, self.compression_ratio)

    def layer_compress(self, ctx, keys, values, length, mask, state=None):
        if self.compression_ratio == 0.0:
            return keys, values, length, mask, state
        if ctx.kv_len is not None:
            raise NotImplementedError("bucketed prefill comes with ROADMAP Queue A item 10")
        B, H, S, _ = keys.shape
        n_top = self.max_kept(S, ctx.cfg)
        scores = self.score(ctx, keys, values).to(torch.float32)
        keys, values, _ = topk_keep(scores, keys, values, n_top)
        new_length = min(self.budget(ctx, S), n_top)
        new_mask = torch.ones((B, H, S), dtype=torch.bool, device=keys.device)
        return keys, values, new_length, new_mask, state
