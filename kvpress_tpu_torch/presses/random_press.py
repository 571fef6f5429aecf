"""RandomPress: uniform random scores (reference random_press.py:42-46).

The scores come from a ``torch.Generator`` that the caller makes (on the
device the model runs on) and seeds; every layer draws from it in turn, so a
generator seeded alike gives the same kept entries. Under a tensor-parallel
mesh every rank draws the scores of every kv head, (B, H_kv * model, S),
and keeps its own rows: a rank scores its heads as one process does, and
every rank's generator advances alike."""

from __future__ import annotations

import dataclasses

import torch

from .base import LayerCtx, ScorerPress, local_heads


@dataclasses.dataclass(frozen=True)
class RandomPress(ScorerPress):
    generator: torch.Generator = None

    def __post_init__(self):
        super().__post_init__()
        if not isinstance(self.generator, torch.Generator):
            raise TypeError("RandomPress takes an explicit torch.Generator")

    def score(self, ctx: LayerCtx, keys, values):
        B, H, S = keys.shape[:-1]
        size = 1 if ctx.shard is None else ctx.shard.size
        scores = torch.rand((B, H * size, S), generator=self.generator, device=keys.device,
                            dtype=torch.float32)
        return scores[:, local_heads(ctx.shard, H)]
