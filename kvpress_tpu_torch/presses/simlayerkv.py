"""SimLayerKVPress: per-layer "lazy" detection (reference
simlayerkv_press.py:52-116, arXiv:2410.13846; port of
``kvpress_tpu/presses/simlayerkv.py``). When the last queries' attention mass
on the sink and the recent window exceeds ``lazy_threshold``, the layer's
cache is cut to sink + recent; otherwise it stays whole. Layers keep
different lengths, which the cache carries per layer. Each layer's decision
is one host read."""

from __future__ import annotations

import dataclasses

import torch

from ..cache import dequantize_kv
from ..ops.attention import window_attention_probs
from .base import BasePress, LayerCtx
from .wrappers import _compact_order, _gather_seq, _refuse_bucket, compact_by_mask


@dataclasses.dataclass(frozen=True)
class SimLayerKVPress(BasePress):
    lazy_threshold: float = 1.0
    n_last: int = 1
    n_recent: int = 1024
    n_initial: int = 4

    def __post_init__(self):
        if not 0.0 <= self.lazy_threshold <= 1.0:
            raise ValueError(f"lazy_threshold must be in [0, 1]: {self.lazy_threshold}")

    @property
    def compression_ratio(self):
        return 0.0   # an observable (per-layer lengths), not a setting

    @property
    def min_length(self) -> int:
        return self.n_initial + self.n_recent + self.n_last

    def lazy_score(self, ctx: LayerCtx, keys, length: int) -> torch.Tensor:
        """() float32: the mean attention of the last ``n_last`` queries
        (those of the ``length`` valid slots) on the first ``n_initial`` and
        the last ``n_recent`` valid slots (reference :60-72)."""
        S = keys.shape[2]
        attn = window_attention_probs(ctx.queries[:, :, -self.n_last:], keys, ctx.scale,
                                      length - self.n_last)
        pos = torch.arange(S, device=keys.device)
        if length < S:
            attn = torch.where(pos < length, attn, 0.0)
        attn = attn.mean(dim=(0, 1, 2))                                    # (S,)
        return attn[:self.n_initial].sum() + attn[max(length - self.n_recent, 0):length].sum()

    def _keep(self, ctx, keys, length: int):
        """(B, H, S) bool keep of a lazy layer, or None when the layer is not
        lazy."""
        if length <= self.min_length or not bool(
                self.lazy_score(ctx, keys, length) > self.lazy_threshold):
            return None
        B, H, S = keys.shape[:3]
        pos = torch.arange(S, device=keys.device)
        keep = (pos < self.n_initial) | (pos >= length - (self.n_recent - self.n_last))
        return (keep & (pos < length)).expand(B, H, S)

    def layer_compress(self, ctx, keys, values, length, mask, state=None):
        if self.lazy_threshold == 1.0:
            return keys, values, length, mask, state
        _refuse_bucket(self, ctx)
        S = keys.shape[2]
        keep = self._keep(ctx, keys, S)
        ones = torch.ones(keys.shape[:3], dtype=torch.bool, device=keys.device)
        if keep is None:
            return keys, values, S, ones, state
        k2, v2, n = compact_by_mask(keys, values, keep)
        return k2, v2, n, ones, state

    # -- chunked prefill: the decision from the last n_last queries of the
    # scoring window over the valid slots; exact when n_last fits the
    # window (it is 1 by default).

    def chunked_compress(self, ctx, keys, values, length: int, mask):
        if self.lazy_threshold == 1.0:
            return keys, values, length, mask
        keep = self._keep(ctx, keys, length)
        if keep is None:
            return keys, values, length, torch.ones_like(mask)
        k2, v2, n = compact_by_mask(keys, values, keep)
        return k2, v2, n, torch.ones_like(mask)

    def chunked_compress_quantized(self, ctx, keys, values, key_scales, value_scales,
                                   bits: int, length: int, mask):
        if self.lazy_threshold == 1.0:
            return keys, values, key_scales, value_scales, length, mask
        keep = self._keep(ctx, dequantize_kv(keys, key_scales, bits, ctx.hidden.dtype), length)
        if keep is None:
            return keys, values, key_scales, value_scales, length, torch.ones_like(mask)
        gathered = _gather_seq((keys, values, key_scales, value_scales), _compact_order(keep))
        return (*gathered, int(keep.sum(dim=-1).min()), torch.ones_like(mask))
