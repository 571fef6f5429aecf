"""Decode-time compression presses (port of ``kvpress_tpu/presses/decoding.py``):
DecodingPress, CompressionRatioDecodingPress, PrefillDecodingPress and the
internal BudgetDecodingPress.

A press's hidden-state ring buffer and step counter are an explicit
per-layer state dict (``{"buffer", "buf_len", "steps"}``, ``init_state``).
``Runner.forward(phase="decode")`` calls ``decode_compress`` in every layer
after the call's attention and append: compression scores the whole buffer
against queries re-projected from the buffered hidden states, orders it by
score (``jax.lax.top_k``'s order: descending, ties by slot) and drops the
length to the target. On a quantized cache (``decode_compress_quantized``)
the payload and scales ride the same gather: nothing is requantized.
``Runner.prefill_chunked``'s compression pass uses BudgetDecodingPress.

``target_value_vec`` gives the serving engine's per-slot targets from the
host's per-slot positions. ``sync_state=True`` (the distributed decode,
``parallel/decode.py``) resets the counters and the buffer on every interval
hit, whether or not this shard compressed, so every shard's state stays the
same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..cache import dequantize_kv
from ..ops.attention import NEG_INF
from .base import BasePress, LayerCtx, ScorerPress, float32_budget, order_desc


def _buffer_queries(ctx: LayerCtx, hidden: torch.Tensor, positions: torch.Tensor):
    """Post-RoPE queries (B, Hq, W, D) of buffered post-ln1 hidden states
    (B, W, E) at ``positions`` (B, W)."""
    from ..models.llama import _project_qkv
    from ..rope import apply_rope, rope_cos_sin

    q_pre, _, _ = _project_qkv(ctx.layer_params, ctx.cfg, hidden)
    cos, sin = rope_cos_sin(ctx.inv_freq, positions, ctx.attention_scaling)
    return apply_rope(q_pre, cos[:, None], sin[:, None])


def _gather_front(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` (B, H, S, C) with rows ``idx`` (B, H, n) gathered to the front;
    the slots past n keep their contents."""
    out = x.clone()
    out[:, :, :idx.shape[-1]] = torch.gather(x, 2, idx[..., None].expand(*idx.shape, x.shape[-1]))
    return out


@dataclasses.dataclass(frozen=True)
class DecodingPress(BasePress):
    """Compress the cache to ``target_size`` every ``compression_interval``
    decode steps, scoring with ``base_press``."""

    base_press: ScorerPress = None
    compression_interval: int = 512
    target_size: int = 2048
    hidden_states_buffer_size: int = 256

    compresses_prefill = False
    compresses_decode = True
    supports_quantized_decode = True

    def __post_init__(self):
        self._check_base()
        if self.compression_interval <= 0 or self.target_size <= 0:
            raise ValueError("compression_interval and target_size must be positive")

    def _check_base(self):
        if not (isinstance(self.base_press, ScorerPress)
                or getattr(self.base_press, "scorer_like", False)):
            raise TypeError(f"{type(self).__name__} requires a ScorerPress or a scorer-like "
                            "base_press")

    @property
    def compression_ratio(self):
        return 0.0   # measured, not set: prefill is left whole

    def init_layer_state(self, cfg, batch: int, dtype: torch.dtype, device) -> dict:
        """One layer's state: an empty hidden-state ring, no steps taken."""
        buf = max(self.hidden_states_buffer_size, 1)
        return {"buffer": torch.zeros((batch, buf, cfg.hidden_size), dtype=dtype,
                                      device=device),
                "buf_len": 0, "steps": 0}

    def init_state(self, cfg, batch: int, seq_len: int, dtype=None, device=None) -> list:
        """Every layer's ``init_layer_state`` (float32 buffers by default, as
        in JAX)."""
        return [self.init_layer_state(cfg, batch, dtype or torch.float32, device)
                for _ in range(cfg.num_layers)]

    def target_bound(self, ctx: LayerCtx, buf_size: int) -> int:
        return self.target_size

    def target_value(self, ctx: LayerCtx, length: int) -> int:
        return self.target_size

    def target_value_vec(self, last_positions: torch.Tensor, length: torch.Tensor
                         ) -> torch.Tensor:
        """Per-slot targets for the serving engine: ``last_positions`` and
        ``length`` are (N,) host int tensors, one per request slot."""
        return torch.full_like(length, self.target_size)

    def _advance(self, ctx, state, length: int, S: int):
        """Ring-buffer append of this call's hidden states and the interval
        counters. Returns (buf, buf_len, steps, interval_hit, n_top, target):
        the cache is compressed when the interval is hit and it is longer
        than the target."""
        T = ctx.hidden.shape[1]
        buf = state["buffer"]
        buf_size = buf.shape[1]
        if T >= buf_size:
            buf = ctx.hidden[:, -buf_size:].to(buf.dtype)
        else:
            buf = torch.cat([buf[:, T:], ctx.hidden.to(buf.dtype)], dim=1)
        buf_len = min(state["buf_len"] + T, buf_size)
        steps = state["steps"] + 1
        n_top = min(self.target_bound(ctx, buf_size), S)
        target = int(self.target_value(ctx, length))
        interval_hit = steps >= self.compression_interval
        return buf, buf_len, steps, interval_hit, n_top, target

    def _score_buffer(self, ctx, buf, keys, values, length: int) -> torch.Tensor:
        """The cache's scores against the buffered window, slots past
        ``length`` at NEG_INF."""
        buf_size = buf.shape[1]
        S = keys.shape[2]
        last_pos = ctx.positions[:, -1:]                            # (B, 1)
        buf_positions = last_pos - torch.arange(buf_size - 1, -1, -1,
                                                device=last_pos.device)[None]
        dctx = dataclasses.replace(ctx, hidden=buf, positions=buf_positions, kv_len=length,
                                   attn_probs=None)
        scores = self.score_dynamic(dctx, keys, values, length).to(torch.float32)
        valid = torch.arange(S, device=scores.device) < length
        return torch.where(valid, scores, torch.full_like(scores, NEG_INF))

    @staticmethod
    def _finish_state(buf, buf_len, steps, do, interval_hit, sync_state) -> dict:
        if (interval_hit if sync_state else do):
            steps = buf_len = 0
        return {"buffer": buf, "buf_len": buf_len, "steps": steps}

    def decode_compress(self, ctx, keys, values, length: int, mask, state, sync_state=False):
        """Returns (keys, values, length, mask, state): every slot ordered by
        score and the length cut to the target when the interval is hit and
        the cache is longer than the target; else all as given.
        ``sync_state``: the counters reset on every interval hit."""
        S = keys.shape[2]
        buf, buf_len, steps, hit, n_top, target = self._advance(ctx, state, length, S)
        do = hit and length > target
        if do:
            idx = order_desc(self._score_buffer(ctx, buf, keys, values, length), n_top)
            keys, values = _gather_front(keys, idx), _gather_front(values, idx)
            length = min(target, n_top)
            mask = torch.ones(keys.shape[:3], dtype=torch.bool, device=keys.device)
        return keys, values, length, mask, self._finish_state(buf, buf_len, steps, do, hit,
                                                              sync_state)

    def decode_compress_quantized(self, ctx, keys, values, key_scales, value_scales,
                                  kv_bits: int, length: int, mask, state, sync_state=False):
        """``decode_compress`` over int8 / packed-int4 payloads: scored on a
        dequantized transient, gathered at payload width with the scales
        (no requantization)."""
        S = keys.shape[2]
        buf, buf_len, steps, hit, n_top, target = self._advance(ctx, state, length, S)
        do = hit and length > target
        if do:
            dt = ctx.hidden.dtype
            scores = self._score_buffer(ctx, buf, dequantize_kv(keys, key_scales, kv_bits, dt),
                                        dequantize_kv(values, value_scales, kv_bits, dt),
                                        length)
            idx = order_desc(scores, n_top)
            keys, values, key_scales, value_scales = (
                _gather_front(t, idx) for t in (keys, values, key_scales, value_scales))
            length = min(target, n_top)
            mask = torch.ones(keys.shape[:3], dtype=torch.bool, device=keys.device)
        return (keys, values, key_scales, value_scales, length, mask,
                self._finish_state(buf, buf_len, steps, do, hit, sync_state))

    def score_dynamic(self, dctx: LayerCtx, keys, values, length: int) -> torch.Tensor:
        """The base press's scores against a valid length."""
        return self.base_press.dynamic_score(dctx, keys, values, length)


@dataclasses.dataclass(frozen=True)
class CompressionRatioDecodingPress(DecodingPress):
    """Target = the kept share of the logical tokens seen so far (reference
    compression_ratio_decoding_press.py:42-50)."""

    target_compression_ratio: float = 0.5

    def __post_init__(self):
        self._check_base()
        if not 0 <= self.target_compression_ratio < 1:
            raise ValueError(f"target_compression_ratio must be in [0, 1): "
                             f"{self.target_compression_ratio}")

    def target_bound(self, ctx: LayerCtx, buf_size: int) -> int:
        return 2 ** 30      # the whole buffer; the target sets the kept length

    def target_value(self, ctx: LayerCtx, length: int) -> int:
        # The logical tokens seen: the host's last position, no device sync.
        return float32_budget(ctx.last_position + 1, self.target_compression_ratio)

    def target_value_vec(self, last_positions: torch.Tensor, length: torch.Tensor
                         ) -> torch.Tensor:
        seen = (last_positions.numpy() + 1).astype(np.float32)
        kept = (seen * np.float32(1 - self.target_compression_ratio)).astype(np.int32)
        return torch.from_numpy(np.maximum(kept, 1)).to(length.dtype)


@dataclasses.dataclass(frozen=True)
class BudgetDecodingPress(CompressionRatioDecodingPress):
    """Target = the base press's own per-layer budget (``dynamic_budget``),
    so a budget-shaping scorer (PyramidKV) keeps its per-layer shape. The
    compression pass of ``Runner.prefill_chunked`` uses it."""

    def target_value(self, ctx: LayerCtx, length: int) -> int:
        return self.base_press.dynamic_budget(ctx, length)

    def target_value_vec(self, last_positions, length):
        raise NotImplementedError("BudgetDecodingPress is a chunked-prefill internal; the serving "
                                  "engine uses DecodingPress/CompressionRatioDecodingPress")


@dataclasses.dataclass(frozen=True)
class PrefillDecodingPress(BasePress):
    """Phase router (reference prefill_decoding_press.py:45-81): the
    prefilling press compresses the prefill, the decoding press the decode.
    As in JAX, the prefilling press's ``wants_probs`` / ``wants_lse`` are
    not forwarded, so it scores on the route the router takes."""

    prefilling_press: Optional[BasePress] = None
    decoding_press: Optional[DecodingPress] = None

    compresses_prefill = True
    compresses_decode = True

    @property
    def compression_ratio(self):
        return 0.0 if self.prefilling_press is None else self.prefilling_press.compression_ratio

    def max_kept(self, seq_len, cfg):
        if self.prefilling_press is None:
            return seq_len
        return self.prefilling_press.max_kept(seq_len, cfg)

    def init_state(self, cfg, batch: int, seq_len: int, dtype=None, device=None):
        if self.decoding_press is None:
            return None
        return self.decoding_press.init_state(cfg, batch, seq_len, dtype, device)

    def layer_compress(self, ctx, keys, values, length, mask, state=None):
        if self.prefilling_press is None:
            return keys, values, length, mask, state
        k, v, n, m, _ = self.prefilling_press.layer_compress(ctx, keys, values, length, mask,
                                                             None)
        return k, v, n, m, state

    def decode_compress(self, ctx, keys, values, length: int, mask, state):
        if self.decoding_press is None:
            return keys, values, length, mask, state
        return self.decoding_press.decode_compress(ctx, keys, values, length, mask, state)

    @property
    def supports_quantized_decode(self) -> bool:
        return self.decoding_press is None or self.decoding_press.supports_quantized_decode

    def decode_compress_quantized(self, ctx, keys, values, key_scales, value_scales,
                                  kv_bits: int, length: int, mask, state, sync_state=False):
        if self.decoding_press is None:
            return keys, values, key_scales, value_scales, length, mask, state
        return self.decoding_press.decode_compress_quantized(
            ctx, keys, values, key_scales, value_scales, kv_bits, length, mask, state,
            sync_state=sync_state)
