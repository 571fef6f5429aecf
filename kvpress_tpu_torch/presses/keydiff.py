"""KeyDiffPress: -cos_sim(k, mean normalized key) (reference
keydiff_press.py:36-46; port of ``kvpress_tpu/presses/keydiff.py``)."""

from __future__ import annotations

import dataclasses

import torch

from .base import LayerCtx, ScorerPress


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


@dataclasses.dataclass(frozen=True)
class KeyDiffPress(ScorerPress):
    def score(self, ctx: LayerCtx, keys, values):
        kn = _l2_normalize(keys.to(torch.float32))
        anchor = kn.mean(dim=2, keepdim=True)
        return -(kn * _l2_normalize(anchor)).sum(dim=-1)

    def dynamic_score(self, ctx: LayerCtx, keys, values, length: int):
        """The anchor is the mean over the first ``length`` (valid) keys."""
        kn = _l2_normalize(keys.to(torch.float32))
        anchor = kn[:, :, :length].sum(dim=2, keepdim=True) / max(length, 1)
        return -(kn * _l2_normalize(anchor)).sum(dim=-1)
