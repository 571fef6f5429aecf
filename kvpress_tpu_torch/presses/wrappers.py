"""Wrapper presses (port of ``kvpress_tpu/presses/wrappers.py``): AdaKV and
the compaction helpers. The other wrappers are not ported yet (ROADMAP Queue
A item 11).

Head-wise eviction clears bits of the cache keep-mask, which the attention
paths read as a bias; ``compact=True`` then moves each head's kept entries
to the front of its buffer, so the buffer can shrink to the longest head.
Sorts are stable wherever the JAX package's are, so ties fall alike.

Chunked prefill (``Runner.prefill_chunked``) calls ``chunked_compress`` /
``chunked_compress_quantized`` once per layer on the whole buffer with a
valid ``length``, scored from the trailing window (the press's
``dynamic_score``). The quantized form scores a dequantized transient and
gathers the kept entries at payload width, scales alongside.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cache import dequantize_kv
from ..ops.attention import NEG_INF
from .base import BasePress, ScorerPress, float32_budget

BIG = torch.finfo(torch.float32).max


def _rank_desc(scores: torch.Tensor) -> torch.Tensor:
    """Rank of each element of a row in descending-score order (0 = highest;
    ties keep their order). ``rank < k`` selects what a top-k of k would."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def _window_scores(press: ScorerPress, ctx, keys, values, length: int) -> torch.Tensor:
    """The press's scores from the trailing-window ctx, slots past
    ``length`` at NEG_INF."""
    dctx = dataclasses.replace(ctx, kv_len=length)
    scores = press.dynamic_score(dctx, keys, values, length).to(torch.float32)
    valid = torch.arange(keys.shape[2], device=keys.device) < length
    return torch.where(valid, scores, torch.full_like(scores, NEG_INF))


def _compact_order(keep: torch.Tensor) -> torch.Tensor:
    """Each row's kept slots first, in their order, then the others."""
    return torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)


def _gather_seq(arrays, order: torch.Tensor):
    """Each (B, H, S, C) array gathered along the slot axis by ``order``."""
    return tuple(torch.gather(a, 2, order[..., None].expand(*order.shape, a.shape[-1]))
                 for a in arrays)


def _gather_front(keys, values, keep):
    """K/V with each (batch, head) row's kept entries first, in their order."""
    return _gather_seq((keys, values), _compact_order(keep))


def _prefix_mask(keep: torch.Tensor):
    """(each head's kept count as a prefix mask, the longest count)."""
    counts = keep.sum(dim=-1)                               # (B, H)
    return (torch.arange(keep.shape[-1], device=keep.device) < counts[..., None],
            int(counts.max()))


def compact_by_mask(keys, values, keep: torch.Tensor):
    """Move kept (True) entries to the buffer front. keep: (B, H, S) bool.
    Returns (keys, values, length): length is the least kept count of any
    head (callers keep the same number per head)."""
    k2, v2 = _gather_front(keys, values, keep)
    return k2, v2, int(keep.sum(dim=-1).min())


def compact_headwise(keys, values, keep: torch.Tensor):
    """Per-head compaction of a head-wise keep-mask: each (batch, head) row's
    kept entries move to the buffer front, the returned mask marks each
    head's valid prefix, and ``length`` is the longest prefix (a shrink to it
    then frees the memory). Returns (keys, values, length, mask)."""
    k2, v2 = _gather_front(keys, values, keep)
    new_mask, length = _prefix_mask(keep)
    return k2, v2, length, new_mask


@dataclasses.dataclass(frozen=True)
class AdaKVPress(BasePress):
    """Head-wise budget allocation (reference adakv_press.py:53-78): the top
    ``alpha_safeguard * n_kept`` of each head are pinned, then the lowest
    scores across heads x seq are pruned: their mask bits become False."""

    press: ScorerPress = None
    alpha_safeguard: float = 0.20
    # Per-head compaction after masking (see compact_headwise). Off by
    # default, which keeps the reference's mask layout.
    compact: bool = False

    headwise_mask = True      # the cache must carry a materialized keep-mask

    def __post_init__(self):
        if not isinstance(self.press, ScorerPress):
            raise TypeError("AdaKVPress requires a ScorerPress")
        if not 0 <= self.alpha_safeguard <= 1:
            raise ValueError(f"alpha_safeguard must be in [0, 1]: {self.alpha_safeguard}")

    @property
    def compression_ratio(self):
        return self.press.compression_ratio

    def masked_scores(self, ctx, keys, values) -> torch.Tensor:
        """Scores with each head's safeguarded entries set above all others."""
        scores = self.press.score(ctx, keys, values).to(torch.float32)
        n_kept = int(keys.shape[2] * (1 - self.compression_ratio))
        n_safe = int(n_kept * self.alpha_safeguard)
        if n_safe > 0:
            scores = torch.where(_rank_desc(scores) < n_safe, BIG, scores)
        return scores

    def layer_compress(self, ctx, keys, values, length, mask, state=None):
        if self.compression_ratio == 0.0:
            return keys, values, length, mask, state
        if ctx.kv_len is not None:
            # The JAX press scores the pads and sizes its budget from the
            # padded length: its bucketed keep is not its exact one.
            raise ValueError("AdaKVPress does not support bucketed prefill (context_bucket)")
        B, H, S, _ = keys.shape
        scores = self.masked_scores(ctx, keys, values)
        n_kept = int(S * (1 - self.compression_ratio))
        # Keep the top n_kept * H across heads x seq, by flat rank.
        keep = _rank_desc(scores.reshape(B, H * S)) < n_kept * H
        new_mask = mask & keep.reshape(B, H, S)
        if self.compact:
            keys, values, length, new_mask = compact_headwise(keys, values, new_mask)
        return keys, values, length, new_mask, state

    # -- chunked prefill: one layer's whole buffer, a valid length -------- #

    def _chunked_keep(self, ctx, keys, values, length: int, mask):
        """The head-wise keep of ``layer_compress`` with budgets from the
        valid length. Slots past it score NEG_INF: they are never pinned or
        kept, since each head's valid slots alone fill the budget."""
        scores = _window_scores(self.press, ctx, keys, values, length)
        B, H, S, _ = keys.shape
        n_kept = float32_budget(length, self.compression_ratio)
        n_safe = int(np.float32(n_kept) * np.float32(self.alpha_safeguard))
        scores = torch.where(_rank_desc(scores) < n_safe, BIG, scores)
        keep = _rank_desc(scores.reshape(B, H * S)) < n_kept * H
        return mask & keep.reshape(B, H, S)

    def chunked_compress(self, ctx, keys, values, length: int, mask):
        """Returns (keys, values, length, mask)."""
        if self.compression_ratio == 0.0:
            return keys, values, length, mask
        keep = self._chunked_keep(ctx, keys, values, length, mask)
        if not self.compact:
            return keys, values, length, keep
        return compact_headwise(keys, values, keep)

    def chunked_compress_quantized(self, ctx, keys, values, key_scales, value_scales,
                                   bits: int, length: int, mask):
        """Returns (keys, values, key_scales, value_scales, length, mask)."""
        if self.compression_ratio == 0.0:
            return keys, values, key_scales, value_scales, length, mask
        dt = ctx.hidden.dtype
        keep = self._chunked_keep(ctx, dequantize_kv(keys, key_scales, bits, dt),
                                  dequantize_kv(values, value_scales, bits, dt), length, mask)
        if not self.compact:
            return keys, values, key_scales, value_scales, length, keep
        gathered = _gather_seq((keys, values, key_scales, value_scales), _compact_order(keep))
        new_mask, new_length = _prefix_mask(keep)
        return (*gathered, new_length, new_mask)
