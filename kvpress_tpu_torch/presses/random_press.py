"""RandomPress: uniform random scores (reference random_press.py:42-46).

The scores come from a ``torch.Generator`` that the caller makes (on the
device the model runs on) and seeds; every layer draws from it in turn, so a
generator seeded alike gives the same kept entries."""

from __future__ import annotations

import dataclasses

import torch

from .base import LayerCtx, ScorerPress


@dataclasses.dataclass(frozen=True)
class RandomPress(ScorerPress):
    generator: torch.Generator = None

    def __post_init__(self):
        super().__post_init__()
        if not isinstance(self.generator, torch.Generator):
            raise TypeError("RandomPress takes an explicit torch.Generator")

    def score(self, ctx: LayerCtx, keys, values):
        return torch.rand(keys.shape[:-1], generator=self.generator, device=keys.device,
                          dtype=torch.float32)
