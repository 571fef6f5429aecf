"""LagKVPress: attention-free lag-relative scoring (reference
lagkv_press.py:45-97; port of ``kvpress_tpu/presses/lagkv.py``).

The sequence after the sinks is cut into ``lag_size`` blocks; the tokens of
block i are scored by the std of their K and V, min-max normalized against
block i + 1. The last full block and the remainder are kept whole.
"""

from __future__ import annotations

import dataclasses

import torch

from .base import LayerCtx, ScorerPress


@dataclasses.dataclass(frozen=True)
class LagKVPress(ScorerPress):
    n_sink: int = 4
    lag_size: int = 128
    cross_scoring: bool = False

    def _block_scores(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, nblocks, lag, D) -> (B, H, nblocks - 1, lag) scores."""
        ref, cur = x[:, :, 1:], x[:, :, :-1]
        min_r = ref.amin(dim=-2, keepdim=True)
        max_r = ref.amax(dim=-2, keepdim=True)
        std = torch.std((cur - min_r) / (max_r - min_r), dim=-1, correction=1)
        return torch.softmax(std, dim=-1)

    def _block_part(self, keys, values):
        """Scores of [n_sink, end - lag) from the block partition of the
        whole buffer, and ``end``, the end of the last full block."""
        B, H, S, D = keys.shape
        end = self.n_sink + ((S - self.n_sink) // self.lag_size) * self.lag_size
        nb = (end - self.n_sink) // self.lag_size

        def blocks(x):
            return x[:, :, self.n_sink:end].to(torch.float32).reshape(B, H, nb, self.lag_size, D)

        score = (self._block_scores(blocks(keys)) + self._block_scores(blocks(values))) / 2
        if not self.cross_scoring:
            # jnp.argsort is stable: so must these be, or equal scores rank
            # differently and the kept sets drift.
            order = torch.argsort(score, dim=-1, stable=True)
            score = torch.argsort(order, dim=-1, stable=True).to(torch.float32) / self.lag_size
        return score.reshape(B, H, -1), end

    def _ramp(self, B, H, S, n: int, device) -> torch.Tensor:
        """The short-context score: sinks 1, then a ramp over the valid
        length ``n``."""
        pos = torch.arange(S, dtype=torch.float32, device=device)
        ramp = (pos - self.n_sink) / max(n - self.n_sink, 1)
        return torch.where(pos < self.n_sink, 1.0, ramp)[None, None].expand(B, H, S)

    def score(self, ctx: LayerCtx, keys, values):
        B, H, S, _ = keys.shape
        if S < self.n_sink + 2 * self.lag_size:
            return self._ramp(B, H, S, S, keys.device)
        score, end = self._block_part(keys, values)
        ones = lambda n: torch.ones((B, H, n), dtype=score.dtype, device=score.device)
        return torch.cat([ones(self.n_sink), score, ones(self.lag_size + S - end)], dim=-1)

    def dynamic_score(self, ctx: LayerCtx, keys, values, length: int):
        """Bucketed prefill: the block partition of the whole (padded)
        buffer; block i's score reads only blocks i and i + 1, so it is exact
        where both are real. The valid length ``length`` picks between block
        scores, the all-ones tail (the last full block and the remainder) and
        the short-context ramp; the caller masks slots from ``length`` on."""
        B, H, S, _ = keys.shape
        if S < self.n_sink + 2 * self.lag_size or length < self.n_sink + 2 * self.lag_size:
            return self._ramp(B, H, S, length, keys.device)
        score, end = self._block_part(keys, values)
        ones = lambda n: torch.ones((B, H, n), dtype=score.dtype, device=score.device)
        full = torch.cat([ones(self.n_sink), score, ones(S - (end - self.lag_size))], dim=-1)
        # The valid length's full blocks: the last is only a reference, so
        # block scores end at n_sink + (blocks - 1) * lag; the rest is tail.
        scored_upto = self.n_sink + ((length - self.n_sink) // self.lag_size - 1) * self.lag_size
        pos = torch.arange(S, device=keys.device)
        return torch.where((pos >= self.n_sink) & (pos < scored_upto), full, 1.0)
