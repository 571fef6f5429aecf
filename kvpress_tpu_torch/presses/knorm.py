"""KnormPress: score = -||k||_2 (reference kvpress/presses/knorm_press.py:38)."""

from __future__ import annotations

import dataclasses

import torch

from .base import LayerCtx, ScorerPress


@dataclasses.dataclass(frozen=True)
class KnormPress(ScorerPress):
    def score(self, ctx: LayerCtx, keys, values):
        return -torch.linalg.vector_norm(keys.to(torch.float32), dim=-1)
