"""Observation-window presses: SnapKV, TOVA, ObservedAttention, PyramidKV
(port of ``kvpress_tpu/presses/snapkv.py``).

Reference semantics: kvpress/presses/snapkv_press.py, tova_press.py,
observed_attention_press.py, pyramidkv_press.py. The runner hands post-RoPE
queries to the press in ``LayerCtx``, so window attention is a small masked
product (ops/attention.py) instead of a re-projection of hidden states.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.attention import (chunked_observed_colsums, chunked_window_probs_mean,
                             window_attention_probs, window_probs_mean_from_lse)
from ..ops.observed_colsum import observed_colsums_flash
from .base import LayerCtx, ScorerPress


def avg_pool_1d(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """``F.avg_pool1d(stride=1, padding=k//2, count_include_pad=True)`` over
    the last axis of a (B, H, S) tensor."""
    if kernel % 2 != 1:
        raise ValueError("kernel_size must be odd")
    return F.avg_pool1d(x, kernel, stride=1, padding=kernel // 2, count_include_pad=True)


def group_mean(scores: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """(B, Hq, S) -> per-GQA-group mean (B, Hkv, S)."""
    B, Hq, S = scores.shape
    return scores.reshape(B, num_kv_heads, Hq // num_kv_heads, S).mean(dim=2)


def _pin(scores: torch.Tensor, n: int) -> torch.Tensor:
    """Append ``n`` slots scored above every other (the observation window is
    always kept)."""
    top = (scores.max() + 1.0).expand(*scores.shape[:-1], n)
    return torch.cat([scores, top], dim=-1)


@dataclasses.dataclass(frozen=True)
class SnapKVPress(ScorerPress):
    """Mean attention of the last ``window_size`` queries onto earlier keys,
    avg-pooled, group-averaged; the window itself is pinned."""

    window_size: int = 64
    kernel_size: int = 5

    # From this length on the W x S probs matrix gives way to a chunked
    # column mean (O(W * chunk) memory): one sweep when the flash prefill's
    # row LSE is there (wants_lse -> ctx.attn_lse), two otherwise.
    chunked_threshold = 8192

    def wants_lse(self, q_len: int) -> bool:
        return q_len >= self.chunked_threshold

    def score(self, ctx: LayerCtx, keys, values):
        Hkv, S = keys.shape[1], keys.shape[2]
        W = self.window_size
        if S <= W:
            raise ValueError(f"Query length {S} should be greater than the window size {W}")
        q_win = ctx.queries[:, :, S - W:]
        if ctx.attn_probs is not None:
            scores = ctx.attn_probs[..., S - W:, :S - W].float().mean(dim=-2)
        elif ctx.attn_lse is not None:
            scores = window_probs_mean_from_lse(
                q_win, keys, ctx.attn_lse[:, :, S - W:], ctx.scale, S - W,
                softcap=ctx.cfg.logit_softcap)[..., :S - W]
        elif S >= self.chunked_threshold:
            scores = chunked_window_probs_mean(q_win, keys, ctx.scale, S - W)[..., :S - W]
        else:
            scores = window_attention_probs(q_win, keys, ctx.scale, S - W)[..., :S - W]
            scores = scores.mean(dim=-2)                  # (B, Hq, S-W)
        scores = group_mean(avg_pool_1d(scores, self.kernel_size), Hkv)
        return _pin(scores, W)


@dataclasses.dataclass(frozen=True)
class TOVAPress(ScorerPress):
    """Attention of the last token, mean over all query heads, shared across
    kv heads (reference tova_press.py:44-60)."""

    def score(self, ctx: LayerCtx, keys, values):
        B, Hkv, S, _ = keys.shape
        if ctx.attn_probs is not None:
            attn = ctx.attn_probs[..., -1:, :S - 1].float()
        else:
            attn = window_attention_probs(ctx.queries[:, :, -1:], keys, ctx.scale,
                                          S - 1)[..., :-1]
        scores = attn.mean(dim=1)[:, 0]                   # (B, S-1)
        return _pin(scores[:, None].expand(B, Hkv, S - 1), 1)


@dataclasses.dataclass(frozen=True)
class ObservedAttentionPress(ScorerPress):
    """Column mean of the prefill's attention matrix, normalized by the number
    of queries that could see each key (observed_attention_press.py:34-49).

    Below ``chunked_threshold`` tokens the runner materializes probs. From it
    on, or whenever probs are missing (under the flash kernel, inside a
    wrapper press), the same column sums are recomputed from the post-RoPE
    queries without the S x S matrix: on the card by the fused kernels of
    ops/observed_colsum.py, on the CPU by ``chunked_observed_colsums``."""

    needs_attn_probs = True
    chunked_threshold = 8192

    def wants_probs(self, q_len: int) -> bool:
        return q_len < self.chunked_threshold

    def wants_lse(self, q_len: int) -> bool:
        # Without probs the flash prefill gives the row LSE, and the
        # column-sum kernel skips its own LSE pass.
        return not self.wants_probs(q_len)

    def column_sums(self, ctx: LayerCtx, keys) -> torch.Tensor:
        """(B, Hq, S) float32 column sums of the causal attention matrix."""
        S = keys.shape[2]
        if ctx.attn_probs is not None:
            # Probs columns span the whole cache buffer, which may be longer
            # than the S tokens being compressed: keep the first S.
            return ctx.attn_probs[..., :S].float().sum(dim=2)
        if ctx.queries.is_cuda:
            return observed_colsums_flash(ctx.queries, keys.contiguous(), ctx.attn_lse,
                                          sm_scale=ctx.scale, softcap=ctx.cfg.logit_softcap)
        Hq = ctx.queries.shape[1]
        # Keep the logits block in flight near 128 MB of float32.
        chunk = max(8, min(128, (32 << 20) // max(1, Hq * S)))
        return chunked_observed_colsums(ctx.queries, keys, ctx.scale,
                                        softcap=ctx.cfg.logit_softcap, chunk=chunk)

    def score(self, ctx: LayerCtx, keys, values):
        S = keys.shape[2]
        n_in_sum = torch.arange(S, 0, -1, dtype=torch.float32, device=keys.device)
        return group_mean(self.column_sums(ctx, keys) / n_in_sum, keys.shape[1])


@dataclasses.dataclass(frozen=True)
class PyramidKVPress(SnapKVPress):
    """SnapKV scoring with a per-layer budget pyramid (pyramidkv_press.py:47-112)."""

    beta: int = 20

    def _budgets(self, q_len: int, num_layers: int) -> list[int]:
        if self.beta < 1:
            raise ValueError("Beta should >= 1")
        max_capacity = self.window_size + q_len * (1 - self.compression_ratio)
        min_num = (max_capacity - self.window_size) / self.beta
        max_num = (max_capacity - self.window_size) * 2 - min_num
        if max_num >= q_len - self.window_size:
            max_num = q_len - self.window_size
            min_num = (max_capacity - self.window_size) * 2 - max_num
        if not (q_len >= max_num >= min_num >= self.window_size):
            return [round(q_len * (1 - self.compression_ratio))] * num_layers
        steps = (max_num - min_num) / (num_layers - 1) if num_layers > 1 else 0.0
        return [round(max_num - i * steps) for i in range(num_layers)]

    def max_kept(self, seq_len: int, cfg) -> int:
        return max(self._budgets(seq_len, cfg.num_layers))

    def exact_kept(self, seq_len: int):
        return None  # the budget depends on the layer

    def budget(self, ctx: LayerCtx, seq_len: int) -> int:
        return self._budgets(seq_len, ctx.cfg.num_layers)[ctx.layer_idx]
