"""StreamingLLMPress: keep the first n_sink tokens plus the most recent window
(reference streaming_llm_press.py:47-54). Sink and recent slots score 1, the
pruned middle 0, so the top-k keeps exactly sink + recent."""

from __future__ import annotations

import dataclasses

import torch

from .base import LayerCtx, ScorerPress


@dataclasses.dataclass(frozen=True)
class StreamingLLMPress(ScorerPress):
    n_sink: int = 4

    def score(self, ctx: LayerCtx, keys, values):
        B, H, S, _ = keys.shape
        n_pruned = S - self.n_kept(S)
        pos = torch.arange(S, device=keys.device)
        keep = (pos < self.n_sink) | (pos >= self.n_sink + n_pruned)
        # Recency breaks ties among the kept, so the order is fixed.
        s = keep.to(torch.float32) + pos.to(torch.float32) * 1e-9
        return s[None, None].expand(B, H, S)
