"""Wrapper presses (port of ``kvpress_tpu/presses/wrappers.py``): AdaKV and
the compaction helpers. The other wrappers are not ported yet (ROADMAP Queue
A item 11).

Head-wise eviction clears bits of the cache keep-mask, which the attention
paths read as a bias; ``compact=True`` then moves each head's kept entries
to the front of its buffer, so the buffer can shrink to the longest head.
Sorts are stable wherever the JAX package's are, so ties fall alike.
"""

from __future__ import annotations

import dataclasses

import torch

from .base import BasePress, ScorerPress

BIG = torch.finfo(torch.float32).max


def _rank_desc(scores: torch.Tensor) -> torch.Tensor:
    """Rank of each element of a row in descending-score order (0 = highest;
    ties keep their order). ``rank < k`` selects what a top-k of k would."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def _gather_front(keys, values, keep):
    """K/V with each (batch, head) row's kept entries first, in their order."""
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    idx = order[..., None].expand(*order.shape, keys.shape[-1])
    return torch.gather(keys, 2, idx), torch.gather(values, 2, idx)


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
    counts = keep.sum(dim=-1)                               # (B, H)
    new_mask = torch.arange(keys.shape[2], device=keys.device) < counts[..., None]
    return k2, v2, int(counts.max()), new_mask


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
        B, H, S, _ = keys.shape
        scores = self.masked_scores(ctx, keys, values)
        n_kept = int(S * (1 - self.compression_ratio))
        # Keep the top n_kept * H across heads x seq, by flat rank.
        keep = _rank_desc(scores.reshape(B, H * S)) < n_kept * H
        new_mask = mask & keep.reshape(B, H, S)
        if self.compact:
            keys, values, length, new_mask = compact_headwise(keys, values, new_mask)
        return keys, values, length, new_mask, state
