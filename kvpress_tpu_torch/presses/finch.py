"""FinchPress: SnapKV-style compression with an observation window set per
input by a delimiter token between the context and the question (reference
finch_press.py:56-166; port of ``kvpress_tpu/presses/finch.py``).

The pipeline finds the delimiter on the host before the prefill, strips it,
and gives the press the window size (``with_window``): the model never sees
the delimiter. The kept keys are rotated to positions 0..n-1
(``rerotate_keys``), and the pipeline then continues from the compressed
length (``rerotates``). One-shot budgets are Python ``int(S * (1 - r))``,
chunked ones the JAX package's float32 product; under a bucketed prefill the
JAX press scores the pads, so the port refuses it."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..cache import dequantize_kv, quantize_kv
from ..ops.attention import NEG_INF, window_attention_probs
from .base import BasePress, LayerCtx, float32_budget, order_desc
from .snapkv import group_mean
from .wrappers import (KeyRerotationPress, _all_kept, _compact_order, _front, _gather_seq,
                       _rank_desc, _refuse_bucket)


@dataclasses.dataclass(frozen=True)
class FinchPress(BasePress):
    compression_ratio: float = 0.0
    chunk_length: Optional[int] = None
    normalize_scores: bool = True
    rerotate_keys: bool = True
    delimiter_token_id: Optional[int] = None
    window_size: Optional[int] = None     # set by the pipeline per input

    @property
    def rerotates(self):
        return self.rerotate_keys

    def with_window(self, window_size: int) -> "FinchPress":
        return dataclasses.replace(self, window_size=window_size)

    def _kept_spans(self, S: int) -> list[tuple[int, int, int]]:
        """[(start, size, kept)]: one span, or one a chunk of chunk_length."""
        if self.chunk_length is None:
            return [(0, S, int(S * (1 - self.compression_ratio)))]
        if not self.chunk_length > self.window_size / (1 - self.compression_ratio):
            raise ValueError("chunk_length must exceed window_size / (1 - compression_ratio)")
        out = []
        for start in range(0, S, self.chunk_length):
            size = min(self.chunk_length, S - start)
            out.append((start, size, max(1, int(size * (1 - self.compression_ratio)))))
        return out

    def max_kept(self, seq_len: int, cfg) -> int:
        return sum(n for _, _, n in self._kept_spans(seq_len))

    def exact_kept(self, seq_len: int):
        return self.max_kept(seq_len, None)

    def score(self, ctx: LayerCtx, keys, values):
        """SnapKV with each window row weighted by the number of keys it
        attends (finch_press.py:56-88); the window scores above all."""
        S, Hkv = keys.shape[2], keys.shape[1]
        W = self.window_size
        if W is None or not 0 < W < S:
            raise ValueError(f"FinchPress needs 0 < window_size < {S}, got {W} (the pipeline "
                             "sets it from the delimiter)")
        attn = window_attention_probs(ctx.queries[:, :, S - W:], keys, ctx.scale,
                                      S - W)[..., :S - W]
        if self.normalize_scores:
            counts = torch.arange(S - W, S, dtype=torch.float32, device=keys.device)
            attn = attn * counts[None, None, :, None]
        scores = group_mean(attn.mean(dim=-2), Hkv)                 # (B, Hkv, S - W)
        maxv = scores.max() + 1.0
        return torch.cat([scores, maxv.expand(*scores.shape[:2], W)], dim=-1)

    def layer_compress(self, ctx, keys, values, length, mask, state=None):
        if self.compression_ratio == 0.0:
            return keys, values, length, mask, state
        _refuse_bucket(self, ctx)
        scores = self.score(ctx, keys, values).to(torch.float32)
        idx = torch.cat([start + order_desc(scores[..., start:start + size], n_keep)
                         for start, size, n_keep in self._kept_spans(keys.shape[2])], dim=-1)
        idx = torch.sort(idx, dim=-1).values
        kept_k, kept_v = _gather_seq((keys, values), idx)
        if self.rerotate_keys:
            kept_k = KeyRerotationPress.rerotate(kept_k, idx, ctx.inv_freq)
        return (_front(keys, kept_k), _front(values, kept_v), idx.shape[-1], _all_kept(keys),
                state)

    # -- chunked prefill: the window is the question, at the end of the last
    # chunk's scoring window, so it must fit there; the one-shot scores and
    # selection with S replaced by the valid length.

    def _chunked_scores(self, ctx, keys, length: int):
        W = self.window_size
        if W is None or W > ctx.queries.shape[2]:
            raise ValueError(f"FinchPress window ({W}) exceeds the chunked-prefill scoring "
                             f"window ({ctx.queries.shape[2]}): raise score_window/context_chunk "
                             "or shorten the question part")
        S, Hkv = keys.shape[2], keys.shape[1]
        attn = window_attention_probs(ctx.queries[:, :, -W:], keys, ctx.scale, length - W)
        pos = torch.arange(S, device=keys.device)
        attn = torch.where(pos < length - W, attn, 0.0)
        if self.normalize_scores:
            counts = (length - W + torch.arange(W, device=keys.device)).to(torch.float32)
            attn = attn * counts[None, None, :, None]
        scores = group_mean(attn.mean(dim=-2), Hkv)                 # (B, Hkv, S)
        maxv = scores.max() + 1.0
        scores = torch.where((pos >= length - W) & (pos < length), maxv, scores)
        return torch.where(pos < length, scores, NEG_INF)

    def _chunked_keep(self, ctx, keys, length: int):
        """(keep (B, H, S), kept count)."""
        scores = self._chunked_scores(ctx, keys, length)
        if self.chunk_length is None:
            n_kept = float32_budget(length, self.compression_ratio)
            return _rank_desc(scores) < n_kept, n_kept
        pieces, total = [], 0
        for start in range(0, keys.shape[2], self.chunk_length):
            size = min(self.chunk_length, keys.shape[2] - start)
            valid = min(max(length - start, 0), size)
            budget = float32_budget(valid, self.compression_ratio) if valid > 0 else 0
            pieces.append(_rank_desc(scores[..., start:start + size]) < budget)
            total += budget
        return torch.cat(pieces, dim=-1), total

    def chunked_compress(self, ctx, keys, values, length: int, mask):
        if self.compression_ratio == 0.0:
            return keys, values, length, mask
        keep, total = self._chunked_keep(ctx, keys, length)
        order = _compact_order(keep)                  # the kept slots, in position order
        k2, v2 = _gather_seq((keys, values), order)
        if self.rerotate_keys:
            k2 = KeyRerotationPress.rerotate(k2, order, ctx.inv_freq)
        return k2, v2, total, torch.ones_like(mask)

    def chunked_compress_quantized(self, ctx, keys, values, key_scales, value_scales,
                                   bits: int, length: int, mask):
        if self.compression_ratio == 0.0:
            return keys, values, key_scales, value_scales, length, mask
        kd = dequantize_kv(keys, key_scales, bits, ctx.hidden.dtype)
        keep, total = self._chunked_keep(ctx, kd, length)
        order = _compact_order(keep)
        if self.rerotate_keys:
            # rerotated keys change value: requantize them
            (kd2,) = _gather_seq((kd,), order)
            k2, ks2 = quantize_kv(KeyRerotationPress.rerotate(kd2, order, ctx.inv_freq), bits)
        else:
            k2, ks2 = _gather_seq((keys, key_scales), order)
        v2, vs2 = _gather_seq((values, value_scales), order)
        return k2, v2, ks2, vs2, total, torch.ones_like(mask)
