"""CURPress: a CUR-decomposition leverage proxy (reference cur_press.py:34-67;
port of ``kvpress_tpu/presses/cur.py``).

With ``use_random_leverage`` the keys and values are first projected by a
Gaussian sketch (D, 20) drawn from a generator seeded from (seed, layer):
the same seed always gives the same sketch, but not the JAX package's
numbers (``jax.random`` cannot be drawn in torch). ``leverage_scores`` takes
the sketch as an argument, so both can be held to one sketch."""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import torch
import torch.nn.functional as F

from .base import LayerCtx, ScorerPress, layer_generator

SKETCH_RANK = 20


@dataclasses.dataclass(frozen=True)
class CURPress(ScorerPress):
    num_sinks: int = 4
    leverage_type: Literal["key", "value", "kv_avg", "kv_product"] = "kv_product"
    use_random_leverage: bool = False
    local_window_size: int = 16
    use_local_approximation: bool = True
    seed: int = 0

    def sketch(self, ctx: LayerCtx, head_dim: int, device) -> torch.Tensor:
        """The (D, 20) Gaussian sketch of this press and layer."""
        gen = layer_generator(self.seed, ctx.layer_idx, device)
        return torch.randn((head_dim, SKETCH_RANK), generator=gen, device=device,
                           dtype=torch.float32) / SKETCH_RANK ** 0.5

    def _local_normalize(self, e: torch.Tensor) -> torch.Tensor:
        B, H, S = e.shape
        w = self.local_window_size
        ep = F.pad(e, (0, (w - S % w) % w)).reshape(B, H, -1, w)
        ep = ep / torch.clamp(ep.sum(dim=-1, keepdim=True), min=1e-30)
        return ep.reshape(B, H, -1)[:, :, :S]

    def leverage_scores(self, keys, values, sketch: Optional[torch.Tensor] = None,
                        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, H, S) scores, the keys and values projected by ``sketch``
        first when given; with ``valid`` (S,) the pad slots take no part in
        the block or the global normalization."""
        k = keys.to(torch.float32)
        v = values.to(torch.float32)
        if sketch is not None:
            k, v = k @ sketch, v @ sketch
        k2, v2 = (k * k).sum(dim=-1), (v * v).sum(dim=-1)
        if valid is not None:
            k2, v2 = k2.masked_fill(~valid, 0.0), v2.masked_fill(~valid, 0.0)
        if self.use_local_approximation:
            k2, v2 = self._local_normalize(k2), self._local_normalize(v2)
        if self.leverage_type == "key":
            scores = k2
        elif self.leverage_type == "value":
            scores = v2
        elif self.leverage_type == "kv_avg":
            scores = (k2 + v2) / 2
        elif self.leverage_type == "kv_product":
            scores = k2 * v2
        else:
            raise ValueError(f"Unknown leverage type: {self.leverage_type}")
        scores = scores / torch.clamp(scores.sum(dim=-1, keepdim=True), min=1e-30)
        sink = torch.arange(keys.shape[2], device=keys.device) < self.num_sinks
        return scores.masked_fill(sink, 1.0)

    def score(self, ctx: LayerCtx, keys, values, valid: Optional[torch.Tensor] = None):
        sketch = (self.sketch(ctx, keys.shape[-1], keys.device) if self.use_random_leverage
                  else None)
        return self.leverage_scores(keys, values, sketch, valid)

    def dynamic_score(self, ctx: LayerCtx, keys, values, length: int):
        return self.score(ctx, keys, values,
                          valid=torch.arange(keys.shape[2], device=keys.device) < length)
