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
    last_position: Optional[int] = None  # positions[:, -1] as a host int (the
    # runner's offset + T - 1): a decode press reads it without a device sync
    shard: Any = None                    # the runner's parallel.mesh.ModelShard
    # under a mesh: the heads above are the rank's, from kv head
    # ``shard.rank * H_kv`` on; a press that decides across heads gathers
    # its scores over ``shard``

    @property
    def seq_len(self) -> int:
        return self.hidden.shape[1]

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
    # Per-token chunk scoring, for DMSPress through chunked prefill: a
    # press whose score of a token reads only that token's (hidden, k, v)
    # sets a module-level ``(arg, layer_idx, hidden (B, T, E), keys
    # (B, H, T, D), values) -> (B, H, T)`` and gives its arrays as
    # ``chunk_score_arg``.
    chunk_score_fn = None
    # False for a press that only scores (its state carries the scores): the
    # runner calls it on sliding layers too, as the JAX runner does, and
    # writes nothing of the layer back (no requantization of a quantized
    # layer either), so a scoring pass leaves the cache's slots as they were.
    writes_cache = True

    @property
    def chunk_score_arg(self):
        return None

    def chunk_score_arg_local(self, shard, n_local: int):
        """``chunk_score_arg`` for a rank of a tensor-parallel mesh that
        holds ``n_local`` kv heads (``shard``: its ``ModelShard``)."""
        return self.chunk_score_arg

    def wants_probs(self, q_len: int) -> bool:
        """Whether the runner should take the attention path that
        materializes probabilities (O(S^2) memory) for a ``q_len``-token call."""
        return self.needs_attn_probs

    def wants_lse(self, q_len: int) -> bool:
        """Whether the flash prefill should also give the per-row logsumexp
        (``ctx.attn_lse``)."""
        return False

    def init_state(self, cfg: ModelConfig, batch: int, seq_len: int,
                   dtype: Optional[torch.dtype] = None, device=None):
        """Per-layer press state (a list over layers) on ``device``, its
        buffers of hidden states in ``dtype`` (the cache's), or None if
        stateless."""
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


def layer_tensor(a, layer_idx: int, device) -> torch.Tensor:
    """Layer ``layer_idx`` of a stacked per-layer artifact (a numpy array or
    a tensor; filter banks, query statistics, surrogate weights) as a float32
    tensor on ``device``: only that layer is copied."""
    return torch.as_tensor(a[layer_idx], dtype=torch.float32, device=device)


def layer_generator(seed: int, layer_idx: int, device, *streams: int) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, layer_idx, *streams): the
    same tuple always draws the same numbers (not those of the JAX package's
    ``fold_in(PRNGKey(seed), layer_idx)``, which torch cannot draw)."""
    state = np.random.SeedSequence((seed, layer_idx, *streams)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def order_desc(scores: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of the ``n`` highest scores of each row, highest first, equal
    scores by slot: the order of ``jax.lax.top_k``."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :n]


def topk_keep(
    scores: torch.Tensor,            # (B, H, S), higher = keep
    keys: torch.Tensor,              # (B, H, S, D)
    values: torch.Tensor,
    n_kept: int,
):
    """Keep the top-``n_kept`` scored entries per (batch, kv-head), gathered to
    the buffer front in ``order_desc`` order (LagKV's rank scores tie across
    blocks). Returns new (keys, values, idx); tail slots keep their old
    contents."""
    idx = order_desc(scores, n_kept)
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

    # Whether the press scores right over a bucket-padded prefill with the
    # pad slots masked out (per-token scorers; the pooling presses override
    # dynamic_score so that pads take no part).
    supports_padding = True

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
        B, H, S, _ = keys.shape
        n_top = self.max_kept(S, ctx.cfg)
        if ctx.kv_len is None:
            scores = self.score(ctx, keys, values).to(torch.float32)
            budget = self.budget(ctx, S)
        else:
            # Bucketed prefill: the slots from kv_len on are pads. They score
            # -inf, and the budget comes from the valid length.
            if not self.supports_padding:
                raise ValueError(f"{type(self).__name__} does not support bucketed prefill")
            kv_len = int(ctx.kv_len)
            scores = self.dynamic_score(ctx, keys, values, kv_len).to(torch.float32)
            pad = torch.arange(S, device=scores.device) >= kv_len
            scores = scores.masked_fill(pad, float("-inf"))
            budget = self.dynamic_budget(ctx, kv_len)
        keys, values, _ = topk_keep(scores, keys, values, n_top)
        new_length = min(budget, n_top)
        new_mask = torch.ones((B, H, S), dtype=torch.bool, device=keys.device)
        return keys, values, new_length, new_mask, state
