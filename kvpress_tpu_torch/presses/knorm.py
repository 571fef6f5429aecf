"""KnormPress: score = -||k||_2 (reference kvpress/presses/knorm_press.py:38)."""

from __future__ import annotations

import dataclasses

import torch

from .base import LayerCtx, ScorerPress


def _knorm_chunk_scores(arg, layer_idx, hidden, keys, values):
    """Per-token chunk scoring (``DMSPress`` through chunked prefill): a key's
    norm reads only that key, so a chunk's scores are exact."""
    return -torch.linalg.vector_norm(keys.to(torch.float32), dim=-1)


@dataclasses.dataclass(frozen=True)
class KnormPress(ScorerPress):
    chunk_score_fn = staticmethod(_knorm_chunk_scores)

    def score(self, ctx: LayerCtx, keys, values):
        return -torch.linalg.vector_norm(keys.to(torch.float32), dim=-1)
