"""LUKVPress: per-(layer, head) budgets from a precomputed (99, L, H_kv)
curve (reference lukv_press.py:95-196, arXiv:2602.08585; port of
``kvpress_tpu/presses/lukv.py``). The curve is an array attribute, read
from a local ``.npy`` by ``load_budget_curve`` (the reference fetches it
over HTTP).

Pruning is head-wise through the cache keep-mask. One-shot only: the JAX
press has no chunked form, and under a bucketed prefill it scores the pads,
so the port refuses both. Under a mesh a rank sizes every kv head's budget
from the curve's whole row and keeps its own heads' counts; the sink and
window slots score the largest score over every rank, plus one."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .base import BasePress, LayerCtx, ScorerPress, all_heads, local_heads
from .wrappers import _check_scorer, _rank_desc, _refuse_bucket


def load_budget_curve(path: str) -> np.ndarray:
    curve = np.load(path, allow_pickle=False)
    if curve.ndim != 3 or curve.shape[0] != 99:
        raise ValueError(f"a budget curve is (99, layers, kv heads), got {curve.shape}")
    return curve


@dataclasses.dataclass(frozen=True)
class LUKVPress(BasePress):
    press: ScorerPress = None
    compression_ratio: float = 0.0
    sink: int = 4
    window: int = 1
    budget_curves: Optional[np.ndarray] = None     # (99, L, H_kv)

    # The curve is an array: presses compare and hash by identity.
    __eq__ = object.__eq__
    __hash__ = object.__hash__

    def __post_init__(self):
        _check_scorer(self.press, "LUKVPress")
        if not 0 <= self.compression_ratio < 1:
            raise ValueError(f"compression_ratio must be in [0, 1): {self.compression_ratio}")

    def _head_keep_counts(self, layer_idx: int, S: int, H: int) -> torch.Tensor:
        """(H,) int64 kept counts by largest-remainder rounding (reference
        :160-182), in float32 on the host as the JAX package computes them;
        a remainder goes to the largest fractional parts, ties by head."""
        target_idx = max(0, min(98, int(round(self.compression_ratio * 100)) - 1))
        prune = torch.as_tensor(np.asarray(self.budget_curves)[target_idx, layer_idx],
                                dtype=torch.float32)                   # (H,)
        ideal = torch.clamp(1.0 - prune, 0.0, 1.0) * S
        total = min(max(int(torch.round(ideal.sum())), H), H * S)
        base = torch.floor(ideal).to(torch.int64)
        remainder = total - int(base.sum())
        rank = _rank_desc(ideal - base)
        return torch.clamp(base + (rank < remainder).to(torch.int64), 1, S)

    def layer_compress(self, ctx: LayerCtx, keys, values, length, mask, state=None):
        if self.compression_ratio <= 0:
            return keys, values, length, mask, state
        if self.budget_curves is None:
            raise ValueError("LU-KV budget curves are not loaded; pass "
                             "budget_curves=load_budget_curve(path)")
        _refuse_bucket(self, ctx)
        B, H, S, _ = keys.shape
        scores = self.press.score(ctx, keys, values).to(torch.float32)
        protected = all_heads(ctx.shard, scores.amax(dim=(0, 2)), dim=0).max() + 1
        pos = torch.arange(S, device=keys.device)
        if self.sink > 0:
            scores = torch.where(pos < min(self.sink, S), protected, scores)
        if self.window > 0:
            scores = torch.where(pos >= max(0, S - self.window), protected, scores)
        every = H if ctx.shard is None else H * ctx.shard.size            # every kv head
        counts = self._head_keep_counts(ctx.layer_idx, S, every)[local_heads(ctx.shard, H)]
        counts = counts.to(keys.device)
        keep = _rank_desc(scores) < counts[None, :, None]
        return keys, values, length, mask & keep, state
