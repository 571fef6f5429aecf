"""MergingPress: merge on eviction (reference merging_press.py:64-177; port
of ``kvpress_tpu/presses/merging.py``). Each evicted token's value folds into
the value of its most cosine-similar kept key, weighted by the similarity and
the value norms, accumulated in float32; keys are not touched (RoPE-safe).

The similarity matrix is (B, H, evicted, kept) float32, 8.6 GB a layer at
32K tokens and the 1B-class width. Its row max and argmax are taken over
slices of the evicted rows that stay under ``SIM_BYTES``: the same result at
bounded memory. The scatter-adds are float32 ``index_put_`` accumulations,
which sum each target's rows in index order (on CUDA, where ``index_add_``
adds by atomics in no fixed order, through a sort): the same merged values
from run to run, within float32 rounding of JAX's. Not a score-then-keep
press: chunked prefill refuses it, and it refuses a bucketed prefill."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .base import BasePress, ScorerPress, order_desc
from .keydiff import _l2_normalize
from .wrappers import (WrappedScorerMixin, _all_kept, _check_scorer, _compact_order, _front,
                       _gather_seq, _refuse_bucket)

_EPS = 1e-6
SIM_BYTES = 1 << 28


def jax_quantile(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(a, q, axis=-1, keepdims=True)`` (linear method), as
    the JAX package computes it on the CPU: the sorted row's two neighbours
    weighted in float32, ``low * w_low + high * w_high`` with the first
    product fused into the sum (taken in float64 here, one rounding to
    float32). Where a ``-inf`` takes part with a weight above 0 the result
    is ``-inf``, and ``-inf`` times a zero weight is NaN (``torch.quantile``
    gives NaN in both cases)."""
    n = a.shape[-1]
    pos = np.float32(q) * np.float32(n - 1)
    low, high = np.floor(pos), np.ceil(pos)
    high_w = np.float32(pos - low)
    low_w = np.float32(1) - high_w
    low, high = int(min(max(low, 0), n - 1)), int(min(max(high, 0), n - 1))
    s = torch.sort(a, dim=-1).values
    high_part = (s[..., high:high + 1] * float(high_w)).to(torch.float64)
    return (s[..., low:low + 1].to(torch.float64) * float(low_w) + high_part).to(a.dtype)


@dataclasses.dataclass(frozen=True)
class MergingPress(WrappedScorerMixin, BasePress):
    press: ScorerPress = None
    similarity_threshold: float = 0.0
    merge_fraction: float = 1.0

    # Evicted values are merged into kept ones: the chunked budget route and
    # bucketed budgets would drop the merge.
    scorer_like = False
    supports_padding = False

    def __post_init__(self):
        _check_scorer(self.press, "MergingPress")
        if not 0.0 <= self.similarity_threshold <= 1.0:
            raise ValueError(f"similarity_threshold must be in [0, 1]: "
                             f"{self.similarity_threshold}")
        if not 0.0 < self.merge_fraction <= 1.0:
            raise ValueError(f"merge_fraction must be in (0, 1]: {self.merge_fraction}")

    @staticmethod
    def nearest_kept(evict_k: torch.Tensor, kept_k: torch.Tensor):
        """(max, argmax) over the kept keys of each evicted key's cosine
        similarity, (B, H, evicted) each; the first index wins a tie. By
        slices of the evicted rows."""
        B, H, n_kept, _ = kept_k.shape
        kn = _l2_normalize(kept_k, eps=_EPS)
        step = max(1, SIM_BYTES // (4 * B * H * n_kept))
        best, target = [], []
        for e in range(0, evict_k.shape[2], step):
            en = _l2_normalize(evict_k[:, :, e:e + step], eps=_EPS)
            m, i = torch.einsum("bhed,bhkd->bhek", en, kn).max(dim=-1)
            best.append(m)
            target.append(i)
        return torch.cat(best, dim=-1), torch.cat(target, dim=-1)

    def merge(self, keys, values, indices):
        """indices: (B, H, n_kept) kept slots. Returns (keys, values) with the
        merged values written at the kept slots (keys unchanged)."""
        B, H, S, D = keys.shape
        n_kept = indices.shape[2]
        n_evict = S - n_kept
        if n_evict == 0 or n_kept == 0:
            return keys, values
        evicted = torch.ones((B, H, S), dtype=torch.bool, device=keys.device).scatter(
            -1, indices, False)
        evict_idx = _compact_order(evicted)[..., :n_evict]      # ascending, as nonzero
        kept_k, kept_v = _gather_seq((keys, values), indices)
        evict_k, evict_v = _gather_seq((keys, values), evict_idx)
        max_sim, target = self.nearest_kept(evict_k.to(torch.float32), kept_k.to(torch.float32))

        merge_ok = max_sim >= self.similarity_threshold
        if self.merge_fraction < 1.0:
            filled = torch.where(merge_ok, max_sim, float("-inf"))
            merge_ok = merge_ok & (max_sim >= jax_quantile(filled, 1.0 - self.merge_fraction))

        kept_v32 = kept_v.to(torch.float32)
        target_norm = torch.gather(torch.linalg.vector_norm(kept_v32, dim=-1), -1, target)
        evict_v32 = evict_v.to(torch.float32)
        evict_norm = torch.linalg.vector_norm(evict_v32, dim=-1)
        weights = torch.clamp(max_sim, min=0.0) * merge_ok.to(torch.float32)
        weights = weights * evict_norm / (evict_norm + target_norm + _EPS)

        # scatter-add into (B * H * n_kept) rows
        row = (torch.arange(B * H, device=keys.device).reshape(B, H, 1) * n_kept
               + target).reshape(-1)
        value_accum = torch.zeros((B * H * n_kept, D), dtype=torch.float32, device=keys.device)
        value_accum.index_put_((row,), (weights[..., None] * evict_v32).reshape(-1, D),
                               accumulate=True)
        weight_accum = torch.zeros(B * H * n_kept, dtype=torch.float32, device=keys.device)
        weight_accum.index_put_((row,), weights.reshape(-1), accumulate=True)
        value_accum = value_accum.reshape(B, H, n_kept, D)
        weight_accum = weight_accum.reshape(B, H, n_kept)

        merged = (kept_v32 + value_accum) / (1.0 + weight_accum)[..., None]
        kept_v_new = torch.where((weight_accum > 0)[..., None], merged.to(values.dtype), kept_v)
        values = values.scatter(2, indices[..., None].expand(B, H, n_kept, D), kept_v_new)
        return keys, values

    def layer_compress(self, ctx, keys, values, length, mask, state=None):
        if self.compression_ratio == 0.0:
            return keys, values, length, mask, state
        _refuse_bucket(self, ctx)
        n_kept = self.n_kept(keys.shape[2])
        scores = self.press.score(ctx, keys, values).to(torch.float32)
        indices = order_desc(scores, n_kept)
        keys, values = self.merge(keys, values, indices)
        kept_k, kept_v = _gather_seq((keys, values), indices)
        return _front(keys, kept_k), _front(values, kept_v), n_kept, _all_kept(keys), state
