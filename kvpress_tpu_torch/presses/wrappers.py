"""Wrapper presses (port of ``kvpress_tpu/presses/wrappers.py``): AdaKV,
CriticalKV and CriticalAdaKV, KeyRerotation, Chunk, ChunkKV, Block, ThinK,
Composed, PerLayerCompression, and the compaction helpers.

Head-wise eviction clears bits of the cache keep-mask, which the attention
paths read as a bias; ``compact=True`` then moves each head's kept entries
to the front of its buffer, so the buffer can shrink to the longest head.
Sorts are stable wherever the JAX package's are, so ties fall alike, and
invalid slots score the finite ``NEG_INF`` (a pad's ``|Wo.v|`` is 0, and
``-inf * 0`` would be a NaN that a descending sort puts first).

Chunked prefill (``Runner.prefill_chunked``) calls ``chunked_compress`` /
``chunked_compress_quantized`` once per layer on the whole buffer with a
valid ``length``, scored from the trailing window (the press's
``dynamic_score``). The quantized form scores a dequantized transient and
gathers the kept entries at payload width, scales alongside; only keys that
change value (rerotated, or with ThinK's channels zeroed) are requantized.
The ``scorer_like`` wrappers (CriticalKV, PerLayerCompression) go through
``BudgetDecodingPress`` there instead.

Under a bucketed prefill (``ctx.kv_len``) only CriticalKV scores as the
exact prefill does; the other wrappers' JAX counterparts score the pads and
size their budgets from the padded length, so these raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..cache import dequantize_kv, quantize_kv
from ..ops.attention import NEG_INF
from ..rope import apply_rope, rerotate_cos_sin
from .base import BasePress, ScorerPress, float32_budget, order_desc, topk_keep

BIG = torch.finfo(torch.float32).max
# Slots of one slice of CriticalKV's ||Wo.v||_1: the slice's float32
# product (B, Hq, slots, E) stays under 256 MiB. XLA fuses the JAX einsum
# with its sum; eager PyTorch would build the whole product (8.6 GB a layer
# at 32K tokens and the 1B-class width).
WOV_BYTES = 1 << 28


def _rank_desc(scores: torch.Tensor) -> torch.Tensor:
    """Rank of each element of a row in descending-score order (0 = highest;
    ties keep their order). ``rank < k`` selects what a top-k of k would."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def _valid(keys: torch.Tensor, length: int) -> torch.Tensor:
    """(S,) bool: the buffer's first ``length`` slots."""
    return torch.arange(keys.shape[2], device=keys.device) < length


def _window_scores(press: ScorerPress, ctx, keys, values, length: int) -> torch.Tensor:
    """The press's scores from the trailing-window ctx, slots past
    ``length`` at NEG_INF."""
    dctx = dataclasses.replace(ctx, kv_len=length)
    scores = press.dynamic_score(dctx, keys, values, length).to(torch.float32)
    return torch.where(_valid(keys, length), scores, NEG_INF)


def _check_scorer(press, name: str):
    if not isinstance(press, ScorerPress):
        raise TypeError(f"{name} requires a ScorerPress")


def _refuse_bucket(press, ctx):
    if ctx.kv_len is not None:
        raise ValueError(
            f"{type(press).__name__} does not support bucketed prefill (context_bucket): the "
            "JAX press reads the padded length (it scores the pads, or sizes its budget or "
            "window from them), so its bucketed keep is not its exact one")


def _front(x: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` (B, H, S, C) with ``kept`` (B, H, n, C) in its first
    n slots."""
    out = x.clone()
    out[:, :, :kept.shape[2]] = kept
    return out


def _all_kept(keys: torch.Tensor) -> torch.Tensor:
    return torch.ones(keys.shape[:3], dtype=torch.bool, device=keys.device)


def _slice_seq(ctx, start: int, size: int):
    """The ctx of slots [start, start + size): hidden states, queries,
    pre-RoPE queries and keys and positions sliced; no probabilities or
    row LSE."""
    sl = slice(start, start + size)
    return dataclasses.replace(
        ctx, hidden=ctx.hidden[:, sl], queries=ctx.queries[:, :, sl],
        queries_prerope=ctx.queries_prerope[:, :, sl], keys_prerope=ctx.keys_prerope[:, :, sl],
        positions=ctx.positions[:, sl], attn_probs=None, attn_lse=None)


def _compact_order(keep: torch.Tensor) -> torch.Tensor:
    """Each row's kept slots first, in their order, then the others."""
    return torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)


def _gather_seq(arrays, order: torch.Tensor):
    """Each (B, H, S, C) array gathered along the slot axis by ``order``."""
    return tuple(torch.gather(a, 2, order[..., None].expand(*order.shape, a.shape[-1]))
                 for a in arrays)


def _gather_front(keys, values, keep):
    """K/V with each (batch, head) row's kept entries first, in their order."""
    return _gather_seq((keys, values), _compact_order(keep))


def _prefix_mask(keep: torch.Tensor):
    """(each head's kept count as a prefix mask, the longest count)."""
    counts = keep.sum(dim=-1)                               # (B, H)
    return (torch.arange(keep.shape[-1], device=keep.device) < counts[..., None],
            int(counts.max()))


def compact_by_mask(keys, values, keep: torch.Tensor):
    """Move kept (True) entries to the buffer front. keep: (B, H, S) bool.
    Returns (keys, values, length): length is the least kept count of any
    head (callers keep the same number per head)."""
    k2, v2 = _gather_front(keys, values, keep)
    return k2, v2, int(keep.sum(dim=-1).min())


def compact_headwise(keys, values, keep: torch.Tensor):
    """Per-head compaction of a head-wise keep-mask: each (batch, head) row's
    kept entries move to the buffer front, the returned mask marks each
    head's valid prefix, and ``length`` is the longest prefix (a shrink to it
    then frees the memory). Returns (keys, values, length, mask)."""
    k2, v2 = _gather_front(keys, values, keep)
    new_mask, length = _prefix_mask(keep)
    return k2, v2, length, new_mask


def _top_across_heads(ctx, scores: torch.Tensor, n_kept: int) -> torch.Tensor:
    """(B, H, S) keep: the top ``n_kept * H`` of (B, H, S) scores across heads
    x seq, by flat rank. Under a mesh (``ctx.shard``) the decision is taken
    over every rank's heads (the scores all-gathered over "model", the
    budget sized over all kv heads) and the rank keeps its own heads'
    part."""
    shard = ctx.shard
    H = scores.shape[1]
    if shard is not None:
        scores = shard.all_gather(scores, dim=1)
    B, Ha, S = scores.shape
    keep = (_rank_desc(scores.reshape(B, Ha * S)) < n_kept * Ha).reshape(B, Ha, S)
    return keep if shard is None else keep[:, shard.rank * H:(shard.rank + 1) * H]


@dataclasses.dataclass(frozen=True)
class AdaKVPress(BasePress):
    """Head-wise budget allocation (reference adakv_press.py:53-78): the top
    ``alpha_safeguard * n_kept`` of each head are pinned, then the lowest
    scores across heads x seq are pruned: their mask bits become False."""

    press: ScorerPress = None
    alpha_safeguard: float = 0.20
    # Per-head compaction after masking (see compact_headwise). Off by
    # default, which keeps the reference's mask layout.
    compact: bool = False

    headwise_mask = True      # the cache must carry a materialized keep-mask

    def __post_init__(self):
        _check_scorer(self.press, "AdaKVPress")
        if not 0 <= self.alpha_safeguard <= 1:
            raise ValueError(f"alpha_safeguard must be in [0, 1]: {self.alpha_safeguard}")

    @property
    def compression_ratio(self):
        return self.press.compression_ratio

    def masked_scores(self, ctx, keys, values) -> torch.Tensor:
        """Scores with each head's safeguarded entries set above all others."""
        scores = self.press.score(ctx, keys, values).to(torch.float32)
        n_kept = int(keys.shape[2] * (1 - self.compression_ratio))
        n_safe = int(n_kept * self.alpha_safeguard)
        if n_safe > 0:
            scores = torch.where(_rank_desc(scores) < n_safe, BIG, scores)
        return scores

    def layer_compress(self, ctx, keys, values, length, mask, state=None):
        if self.compression_ratio == 0.0:
            return keys, values, length, mask, state
        _refuse_bucket(self, ctx)
        S = keys.shape[2]
        scores = self.masked_scores(ctx, keys, values)
        n_kept = int(S * (1 - self.compression_ratio))
        new_mask = mask & _top_across_heads(ctx, scores, n_kept)
        if self.compact:
            keys, values, length, new_mask = compact_headwise(keys, values, new_mask)
        return keys, values, length, new_mask, state

    # -- chunked prefill: one layer's whole buffer, a valid length -------- #

    def _chunked_keep(self, ctx, keys, values, length: int, mask):
        """The head-wise keep of ``layer_compress`` with budgets from the
        valid length. Slots past it score NEG_INF: they are never pinned or
        kept, since each head's valid slots alone fill the budget."""
        scores = _window_scores(self.press, ctx, keys, values, length)
        n_kept = float32_budget(length, self.compression_ratio)
        n_safe = int(np.float32(n_kept) * np.float32(self.alpha_safeguard))
        scores = torch.where(_rank_desc(scores) < n_safe, BIG, scores)
        return mask & _top_across_heads(ctx, scores, n_kept)

    def chunked_compress(self, ctx, keys, values, length: int, mask):
        """Returns (keys, values, length, mask)."""
        if self.compression_ratio == 0.0:
            return keys, values, length, mask
        keep = self._chunked_keep(ctx, keys, values, length, mask)
        if not self.compact:
            return keys, values, length, keep
        return compact_headwise(keys, values, keep)

    def chunked_compress_quantized(self, ctx, keys, values, key_scales, value_scales,
                                   bits: int, length: int, mask):
        """Returns (keys, values, key_scales, value_scales, length, mask)."""
        if self.compression_ratio == 0.0:
            return keys, values, key_scales, value_scales, length, mask
        dt = ctx.hidden.dtype
        keep = self._chunked_keep(ctx, dequantize_kv(keys, key_scales, bits, dt),
                                  dequantize_kv(values, value_scales, bits, dt), length, mask)
        if not self.compact:
            return keys, values, key_scales, value_scales, length, keep
        gathered = _gather_seq((keys, values, key_scales, value_scales), _compact_order(keep))
        new_mask, new_length = _prefix_mask(keep)
        return (*gathered, new_length, new_mask)


class WrappedScorerMixin:
    """ScorerPress behaviour with ``compression_ratio`` taken from the
    wrapped press. ``scorer_like`` admits the wrapper wherever a ScorerPress
    scores and then keeps: chunked prefill (through ``BudgetDecodingPress``)
    and bucketed prefill."""

    scorer_like = True
    supports_padding = True

    @property
    def compression_ratio(self):
        return self.press.compression_ratio

    def n_kept(self, seq_len: int) -> int:
        return max(1, int(seq_len * (1 - self.compression_ratio)))

    def max_kept(self, seq_len: int, cfg) -> int:
        return self.n_kept(seq_len)

    def exact_kept(self, seq_len: int):
        return self.n_kept(seq_len)

    def budget(self, ctx, seq_len: int) -> int:
        return self.n_kept(seq_len)

    def dynamic_budget(self, ctx, length: int) -> int:
        return float32_budget(length, self.compression_ratio)

    def dynamic_score(self, ctx, keys, values, length: int) -> torch.Tensor:
        """The plain score: right for a wrapped content scorer; subclasses
        reach a wrapped window scorer's own ``dynamic_score``."""
        return self.score(ctx, keys, values)

    layer_compress = ScorerPress.layer_compress


@dataclasses.dataclass(frozen=True)
class CriticalKVPress(WrappedScorerMixin, BasePress):
    """Two-stage rescale by ||Wo.v||_1 (reference criticalkv_press.py:17-94):
    the wrapped press's top ``first_stage_ratio`` of the budget is pinned,
    every other score is rescaled by its value's projected L1 norm."""

    press: ScorerPress = None
    epsilon: float = 1e-4
    first_stage_ratio: float = 0.5

    def __post_init__(self):
        _check_scorer(self.press, "CriticalKVPress")

    @staticmethod
    def vwl1norm(ctx, values: torch.Tensor) -> torch.Tensor:
        """(B, Hkv, S) float32: the group mean of ||Wo_head . v||_1
        (criticalkv_press.py:57-76), over slices of WOV_BYTES. Under a mesh
        ``ctx.cfg`` counts the rank's heads and ``wo`` holds the rank's rows
        (``parallel.mesh.shard_layer``), so the product is the rank's heads'."""
        from ..models.llama import dequant_weight

        B, Hkv, S, D = values.shape
        Hq, E = ctx.cfg.num_heads, ctx.cfg.hidden_size
        G = Hq // Hkv
        wo = dequant_weight(ctx.layer_params, "wo", torch.float32).reshape(Hq, D, E)
        step = max(1, WOV_BYTES // (4 * B * Hq * E))
        norms = []
        for s in range(0, S, step):
            v = values[:, :, s:s + step].to(torch.float32)
            v = v[:, :, None].expand(B, Hkv, G, *v.shape[2:]).reshape(B, Hq, -1, D)
            norms.append(torch.linalg.vector_norm(torch.matmul(v, wo), ord=1, dim=-1))
        return torch.cat(norms, dim=-1).reshape(B, Hkv, G, S).mean(dim=2)

    def score(self, ctx, keys, values):
        scores = self.press.score(ctx, keys, values).to(torch.float32)
        budget = int((1 - self.compression_ratio) * keys.shape[2] * self.first_stage_ratio)
        out = (scores + self.epsilon) * self.vwl1norm(ctx, values)
        if budget > 0:
            out = out.scatter(-1, order_desc(scores, budget), BIG)
        return out

    def dynamic_score(self, ctx, keys, values, length: int):
        """The first-stage pin budget from the valid length. Slots past it
        score NEG_INF before the pin (no pad takes stage-1 budget) and again
        after the rescale (a zero pad value's ||Wo.v|| is 0)."""
        base = _window_scores(self.press, ctx, keys, values, length)
        budget = int(np.float32((1 - self.compression_ratio) * self.first_stage_ratio)
                     * np.float32(length))
        scores = (base + self.epsilon) * self.vwl1norm(ctx, values)
        scores = torch.where(_rank_desc(base) < budget, BIG, scores)
        return torch.where(_valid(keys, length), scores, NEG_INF)


@dataclasses.dataclass(frozen=True)
class CriticalAdaKVPress(BasePress):
    """CriticalKV's rescale with AdaKV's head-wise budgets (reference
    criticalkv_press.py:137-194): the safeguard is pinned, each head's budget
    is its share of the global top, the two-stage rescale runs per head, and
    the global top is kept (mask bits, compacted with ``compact=True``)."""

    press: ScorerPress = None
    alpha_safeguard: float = 0.20
    epsilon: float = 1e-4
    first_stage_ratio: float = 0.5
    compact: bool = False     # per-head compaction (see AdaKVPress.compact)

    headwise_mask = True

    def __post_init__(self):
        _check_scorer(self.press, "CriticalAdaKVPress")
        if not 0 <= self.alpha_safeguard <= 1:
            raise ValueError(f"alpha_safeguard must be in [0, 1]: {self.alpha_safeguard}")

    @property
    def compression_ratio(self):
        return self.press.compression_ratio

    def _select(self, ctx, scores, values, n_kept: int, n_safe: int, valid=None):
        """The three stages on (B, H, S) scores: the keep mask (B, H, S).
        ``valid`` re-masks slots to NEG_INF after the rescale."""
        B, H, S = scores.shape
        scores = torch.where(_rank_desc(scores) < n_safe, BIG, scores)
        top = _rank_desc(scores.reshape(B, H * S)) < n_kept * H
        head_budgets = top.reshape(B, H, S).sum(dim=(0, 2))               # (H,)
        stage1 = (head_budgets.to(torch.float32) * self.first_stage_ratio).to(torch.int64)
        scores = torch.where(_rank_desc(scores) < stage1[None, :, None], BIG, scores)
        scores = (scores + self.epsilon) * CriticalKVPress.vwl1norm(ctx, values)
        if valid is not None:
            scores = torch.where(valid, scores, NEG_INF)
        scores = torch.where(_rank_desc(scores) < head_budgets[None, :, None], BIG, scores)
        return (_rank_desc(scores.reshape(B, H * S)) < n_kept * H).reshape(B, H, S)

    def layer_compress(self, ctx, keys, values, length, mask, state=None):
        if self.compression_ratio == 0.0:
            return keys, values, length, mask, state
        _refuse_bucket(self, ctx)
        S = keys.shape[2]
        n_kept = int(S * (1 - self.compression_ratio))
        scores = self.press.score(ctx, keys, values).to(torch.float32)
        new_mask = mask & self._select(ctx, scores, values, n_kept,
                                       int(n_kept * self.alpha_safeguard))
        if self.compact:
            keys, values, length, new_mask = compact_headwise(keys, values, new_mask)
        return keys, values, length, new_mask, state

    # -- chunked prefill: one layer's whole buffer, a valid length -------- #

    def _chunked_keep(self, ctx, keys, values, length: int, mask):
        """``layer_compress``'s keep with budgets from the valid length;
        slots past it score NEG_INF throughout."""
        scores = _window_scores(self.press, ctx, keys, values, length)
        n_kept = float32_budget(length, self.compression_ratio)
        n_safe = int(np.float32(n_kept) * np.float32(self.alpha_safeguard))
        return mask & self._select(ctx, scores, values, n_kept, n_safe,
                                   valid=_valid(keys, length))

    chunked_compress = AdaKVPress.chunked_compress
    chunked_compress_quantized = AdaKVPress.chunked_compress_quantized


@dataclasses.dataclass(frozen=True)
class KeyRerotationPress(BasePress):
    """Keep the wrapped press's top slots in position order and rotate their
    keys to contiguous RoPE positions 0..n-1 (reference
    key_rerotation_press.py:50-152). The pipeline then continues from the
    compressed length (``rerotates``)."""

    press: ScorerPress = None
    rerotates = True

    def __post_init__(self):
        _check_scorer(self.press, "KeyRerotationPress")

    @property
    def compression_ratio(self):
        return self.press.compression_ratio

    def max_kept(self, seq_len: int, cfg) -> int:
        return self.press.max_kept(seq_len, cfg)

    def exact_kept(self, seq_len: int):
        return self.press.exact_kept(seq_len)

    @staticmethod
    def rerotate(keys_kept: torch.Tensor, idx: torch.Tensor, inv_freq: torch.Tensor):
        """keys_kept (B, H, n, D), gathered at idx (B, H, n), rotated by
        new - old position (slot j's new position is j) in float32
        (reference :50-98)."""
        cos, sin = rerotate_cos_sin(inv_freq, idx,
                                    torch.arange(idx.shape[-1], device=idx.device))
        return apply_rope(keys_kept, cos, sin)

    def layer_compress(self, ctx, keys, values, length, mask, state=None):
        if self.compression_ratio == 0.0:
            return keys, values, length, mask, state
        _refuse_bucket(self, ctx)
        n_kept = self.press.n_kept(keys.shape[2])
        scores = self.press.score(ctx, keys, values).to(torch.float32)
        idx = torch.sort(order_desc(scores, n_kept), dim=-1).values
        kept_k, kept_v = _gather_seq((keys, values), idx)
        kept_k = self.rerotate(kept_k, idx, ctx.inv_freq)
        return _front(keys, kept_k), _front(values, kept_v), n_kept, _all_kept(keys), state

    # -- chunked prefill: one layer's whole buffer, a valid length -------- #

    def _chunked_order(self, ctx, keys, values, length: int):
        """(order (B, H, S), n_kept): the kept slots first in position order,
        as the one-shot path's sorted gather."""
        scores = _window_scores(self.press, ctx, keys, values, length)
        S = keys.shape[2]
        n_kept = float32_budget(length, self.compression_ratio)
        pos = torch.arange(S, device=keys.device)
        order = torch.argsort(torch.where(_rank_desc(scores) < n_kept, pos, S + pos), dim=-1)
        return order, n_kept

    def chunked_compress(self, ctx, keys, values, length: int, mask):
        if self.compression_ratio == 0.0:
            return keys, values, length, mask
        order, n_kept = self._chunked_order(ctx, keys, values, length)
        k2, v2 = _gather_seq((keys, values), order)
        # Slot j's new position is j; the slots past n_kept are rotated too,
        # past the valid length.
        return self.rerotate(k2, order, ctx.inv_freq), v2, n_kept, _all_kept(keys)

    def chunked_compress_quantized(self, ctx, keys, values, key_scales, value_scales,
                                   bits: int, length: int, mask):
        """Rerotated keys are requantized; values are gathered at payload
        width with their scales."""
        if self.compression_ratio == 0.0:
            return keys, values, key_scales, value_scales, length, mask
        dt = ctx.hidden.dtype
        kd = dequantize_kv(keys, key_scales, bits, dt)
        order, n_kept = self._chunked_order(ctx, kd, dequantize_kv(values, value_scales, bits, dt),
                                            length)
        (kd2,) = _gather_seq((kd,), order)
        k2, ks2 = quantize_kv(self.rerotate(kd2, order, ctx.inv_freq), bits)
        v2, vs2 = _gather_seq((values, value_scales), order)
        return k2, v2, ks2, vs2, n_kept, _all_kept(keys)


@dataclasses.dataclass(frozen=True)
class ChunkPress(BasePress):
    """Score and keep the top independently in each chunk of
    ``chunk_length`` slots (reference chunk_press.py:50-87)."""

    press: ScorerPress = None
    chunk_length: int = 1024

    def __post_init__(self):
        _check_scorer(self.press, "ChunkPress")

    @property
    def compression_ratio(self):
        return self.press.compression_ratio

    def _kept_per_chunk(self, S: int) -> list[tuple[int, int, int]]:
        """(start, size, kept) of each chunk."""
        out = []
        for start in range(0, S, self.chunk_length):
            size = min(self.chunk_length, S - start)
            out.append((start, size, max(1, int(size * (1 - self.compression_ratio)))))
        return out

    def max_kept(self, seq_len: int, cfg) -> int:
        return sum(n for _, _, n in self._kept_per_chunk(seq_len))

    def exact_kept(self, seq_len: int):
        return self.max_kept(seq_len, None)

    def layer_compress(self, ctx, keys, values, length, mask, state=None):
        if self.compression_ratio == 0.0:
            return keys, values, length, mask, state
        _refuse_bucket(self, ctx)
        idx = torch.cat([
            start + order_desc(self.press.score(
                _slice_seq(ctx, start, size), keys[:, :, start:start + size],
                values[:, :, start:start + size]).to(torch.float32), n_keep)
            for start, size, n_keep in self._kept_per_chunk(keys.shape[2])], dim=-1)
        kept_k, kept_v = _gather_seq((keys, values), idx)
        return (_front(keys, kept_k), _front(values, kept_v), idx.shape[-1], _all_kept(keys),
                state)

    # -- chunked prefill. Exact for content scorers; a window scorer scores
    # the whole buffer from the trailing window here, where the one-shot path
    # gives each chunk its own window.

    def _chunked_keep(self, ctx, keys, values, length: int):
        """(keep (B, H, S), kept count): each chunk's top, its budget from
        its valid slots (0 for a chunk past ``length``)."""
        scores = _window_scores(self.press, ctx, keys, values, length)
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
        keep, total = self._chunked_keep(ctx, keys, values, length)
        k2, v2 = _gather_front(keys, values, keep)
        return k2, v2, total, _all_kept(keys)

    def chunked_compress_quantized(self, ctx, keys, values, key_scales, value_scales,
                                   bits: int, length: int, mask):
        if self.compression_ratio == 0.0:
            return keys, values, key_scales, value_scales, length, mask
        dt = ctx.hidden.dtype
        keep, total = self._chunked_keep(ctx, dequantize_kv(keys, key_scales, bits, dt),
                                         dequantize_kv(values, value_scales, bits, dt), length)
        gathered = _gather_seq((keys, values, key_scales, value_scales), _compact_order(keep))
        return (*gathered, total, _all_kept(keys))


@dataclasses.dataclass(frozen=True)
class ChunkKVPress(BasePress):
    """Keep whole chunks of ``chunk_length`` slots: a chunk scores the mean
    over its slots of the wrapped press's scores summed over heads
    (reference chunkkv_press.py:51-125). A context shorter than one chunk
    goes to the wrapped press."""

    press: ScorerPress = None
    chunk_length: int = 20

    def __post_init__(self):
        _check_scorer(self.press, "ChunkKVPress")

    @property
    def compression_ratio(self):
        return self.press.compression_ratio

    def max_kept(self, seq_len: int, cfg) -> int:
        n_complete, rem = divmod(seq_len, self.chunk_length)
        if n_complete == 0:
            return self.press.max_kept(seq_len, cfg)
        n_chunks = max(1, int((n_complete + (rem > 0)) * (1 - self.compression_ratio)))
        return min(seq_len, n_chunks * self.chunk_length)

    def exact_kept(self, seq_len: int):
        return None   # it depends on whether the partial tail chunk is kept

    def layer_compress(self, ctx, keys, values, length, mask, state=None):
        if self.compression_ratio == 0.0:
            return keys, values, length, mask, state
        _refuse_bucket(self, ctx)
        B, H, S, _ = keys.shape
        cl = self.chunk_length
        n_complete, rem = divmod(S, cl)
        if n_complete == 0:
            return self.press.layer_compress(ctx, keys, values, length, mask, state)
        scores = self.press.score(ctx, keys, values).to(torch.float32)
        chunk_scores = scores[..., :n_complete * cl].sum(dim=1).reshape(B, n_complete, cl)
        chunk_scores = chunk_scores.mean(dim=-1)                           # (B, n_complete)
        if rem:
            tail = scores[..., S - rem:].sum(dim=1).mean(dim=-1, keepdim=True)
            chunk_scores = torch.cat([chunk_scores, tail], dim=-1)
        n_total = n_complete + (1 if rem else 0)
        top = order_desc(chunk_scores, max(1, int(n_total * (1 - self.compression_ratio))))
        keep_chunk = torch.zeros((B, n_total), dtype=torch.bool, device=keys.device)
        keep_chunk = keep_chunk.scatter(1, top, True)
        pos_chunk = (torch.arange(S, device=keys.device) // cl).clamp(max=n_total - 1)
        keep = keep_chunk[:, pos_chunk][:, None].expand(B, H, S)
        k2, v2, n = compact_by_mask(keys, values, keep)
        return k2, v2, n, _all_kept(keys), state

    # -- chunked prefill: chunk means over the valid slots (the partial tail
    # chunk's over its real count, as the one-shot path), a chunk budget
    # from the valid length, ranks whose ties fall as lax.top_k's.

    def _chunked_keep(self, ctx, keys, values, length: int):
        """(keep (B, H, S), order (B, H, S)): the kept slots, and the
        gather that puts them first."""
        B, H, S, _ = keys.shape
        cl = self.chunk_length
        scores = _window_scores(self.press, ctx, keys, values, length)
        valid = _valid(keys, length)
        if length < cl:
            # Shorter than one chunk: the one-shot path hands the context to
            # the wrapped press, whose top-k gather is in score order.
            keep = (_rank_desc(scores) < float32_budget(length, self.compression_ratio)) & valid
            order = torch.argsort(-torch.where(keep, scores, NEG_INF), dim=-1, stable=True)
            return keep, order
        n_buf = -(-S // cl)
        pad = n_buf * cl - S
        per_chunk = F.pad(torch.where(valid, scores, 0.0).sum(dim=1), (0, pad))
        per_chunk = per_chunk.reshape(B, n_buf, cl).sum(dim=-1)
        counts = F.pad(valid.to(torch.float32), (0, pad)).reshape(n_buf, cl).sum(dim=-1)
        chunk_scores = torch.where(counts > 0, per_chunk / counts.clamp(min=1.0), NEG_INF)
        n_keep = float32_budget(-(-length // cl), self.compression_ratio)
        keep_chunk = _rank_desc(chunk_scores) < n_keep                     # (B, n_buf)
        keep = keep_chunk[:, torch.arange(S, device=keys.device) // cl] & valid
        keep = keep[:, None].expand(B, H, S)
        return keep, _compact_order(keep)

    def chunked_compress(self, ctx, keys, values, length: int, mask):
        if self.compression_ratio == 0.0:
            return keys, values, length, mask
        keep, order = self._chunked_keep(ctx, keys, values, length)
        k2, v2 = _gather_seq((keys, values), order)
        return k2, v2, int(keep.sum(dim=-1).min()), _all_kept(keys)

    def chunked_compress_quantized(self, ctx, keys, values, key_scales, value_scales,
                                   bits: int, length: int, mask):
        if self.compression_ratio == 0.0:
            return keys, values, key_scales, value_scales, length, mask
        dt = ctx.hidden.dtype
        keep, order = self._chunked_keep(ctx, dequantize_kv(keys, key_scales, bits, dt),
                                         dequantize_kv(values, value_scales, bits, dt), length)
        gathered = _gather_seq((keys, values, key_scales, value_scales), order)
        return (*gathered, int(keep.sum(dim=-1).min()), _all_kept(keys))


@dataclasses.dataclass(frozen=True)
class BlockPress(BasePress):
    """Streaming top-k over blocks (reference block_press.py:49-98): the
    kept set and the next ``block_size`` slots are scored together, the top
    ``n_kept`` stay. Each candidate set's hidden states are gathered per kv
    head from a per-head split of the hidden size (block_press.py:74). No
    chunked form: it needs every position's hidden states.

    Under a mesh (``ctx.shard``) the split is over every rank's kv heads, and
    each step all-gathers the candidate sets over "model": the wrapped press
    sees the hidden states the single device builds (each kv head's part
    from that head's candidates), and scores the rank's own heads."""

    press: ScorerPress = None
    block_size: int = 128

    def __post_init__(self):
        _check_scorer(self.press, "BlockPress")

    @property
    def compression_ratio(self):
        return self.press.compression_ratio

    def max_kept(self, seq_len: int, cfg) -> int:
        return self.press.n_kept(seq_len)

    def exact_kept(self, seq_len: int):
        return self.press.n_kept(seq_len)

    def layer_compress(self, ctx, keys, values, length, mask, state=None):
        if self.compression_ratio == 0.0:
            return keys, values, length, mask, state
        _refuse_bucket(self, ctx)
        B, H, S, _ = keys.shape
        E = ctx.hidden.shape[-1]
        n_kept = int(S * (1 - self.compression_ratio))
        dev = keys.device
        kept_idx = torch.arange(n_kept, device=dev).expand(B, H, n_kept)
        shard = ctx.shard
        Ha = H if shard is None else H * shard.size                        # every kv head
        states = ctx.hidden.reshape(B, S, Ha, E // Ha).transpose(1, 2)    # (B, Ha, S, E/Ha)
        for i in range(n_kept, S, min(self.block_size, S)):
            end = min(i + self.block_size, S)
            cand = torch.cat([kept_idx, torch.arange(i, end, device=dev).expand(B, H, end - i)],
                             dim=-1)                                        # (B, H, n + b)
            cand_k, cand_v = _gather_seq((keys, values), cand)
            every = cand if shard is None else shard.all_gather(cand, dim=1)
            (cand_states,) = _gather_seq((states,), every)
            hidden = cand_states.transpose(1, 2).reshape(B, -1, E)
            sub_scores = self.press.score(dataclasses.replace(ctx, hidden=hidden, attn_probs=None),
                                          cand_k, cand_v).to(torch.float32)
            kept_idx = torch.gather(cand, -1, order_desc(sub_scores, n_kept))
        kept_k, kept_v = _gather_seq((keys, values), kept_idx)
        return _front(keys, kept_k), _front(values, kept_v), n_kept, _all_kept(keys), state


@dataclasses.dataclass(frozen=True)
class ThinKPress(BasePress):
    """Prune key channels: each (batch, kv head) zeroes the
    ``key_channel_compression_ratio`` share of its channels with the least
    window-query energy times key energy (reference think_press.py:74-98)."""

    key_channel_compression_ratio: float = 0.0
    window_size: int = 32

    @property
    def compression_ratio(self):
        return self.key_channel_compression_ratio / 2

    def exact_kept(self, seq_len: int):
        return seq_len

    def _channel_keep(self, queries: torch.Tensor, key_energy: torch.Tensor):
        """(B, H, D) bool of the kept channels, or None when none is pruned;
        ``key_energy`` (B, H, D) is the keys' mean square over the slots, the
        query energy that of the last ``window_size`` post-RoPE queries."""
        B, H, D = key_energy.shape
        W = min(self.window_size, queries.shape[2])
        q_energy = (queries[:, :, -W:].to(torch.float32) ** 2).mean(dim=2)   # (B, Hq, D)
        q_energy = q_energy.reshape(B, H, -1, D).mean(dim=2)
        n_pruned = int(D * self.key_channel_compression_ratio)
        if n_pruned == 0:
            return None
        pruned = order_desc(-(q_energy * key_energy), n_pruned)
        return torch.ones((B, H, D), dtype=torch.bool, device=key_energy.device).scatter(
            -1, pruned, False)

    @staticmethod
    def _zeroed(keys: torch.Tensor, ch_keep) -> torch.Tensor:
        return keys if ch_keep is None else keys.masked_fill(~ch_keep[:, :, None, :], 0)

    def layer_compress(self, ctx, keys, values, length, mask, state=None):
        if self.key_channel_compression_ratio == 0.0:
            return keys, values, length, mask, state
        _refuse_bucket(self, ctx)
        energy = (keys.to(torch.float32) ** 2).mean(dim=2)
        return self._zeroed(keys, self._channel_keep(ctx.queries, energy)), values, length, \
            mask, state

    # -- chunked prefill: the key energy over the valid slots (the one-shot
    # mean over S == length), the same channel top-k.

    def _chunked_channel_keep(self, ctx, keys, length: int):
        if self.window_size > ctx.queries.shape[2]:
            raise ValueError(
                f"ThinKPress window ({self.window_size}) exceeds the chunked-prefill scoring "
                f"window ({ctx.queries.shape[2]}): raise score_window/context_chunk (a silent "
                "clamp would diverge from the one-shot channel selection)")
        sq = torch.where(_valid(keys, length)[:, None], keys.to(torch.float32) ** 2, 0.0)
        return self._channel_keep(ctx.queries, sq.sum(dim=2) / float(max(length, 1)))

    def chunked_compress(self, ctx, keys, values, length: int, mask):
        if self.key_channel_compression_ratio == 0.0:
            return keys, values, length, mask
        return self._zeroed(keys, self._chunked_channel_keep(ctx, keys, length)), values, \
            length, mask

    def chunked_compress_quantized(self, ctx, keys, values, key_scales, value_scales,
                                   bits: int, length: int, mask):
        """Dequantize the keys, zero the channels, requantize (what the
        one-shot quantized path does around its press)."""
        if self.key_channel_compression_ratio == 0.0:
            return keys, values, key_scales, value_scales, length, mask
        kd = dequantize_kv(keys, key_scales, bits, ctx.hidden.dtype)
        ch_keep = self._chunked_channel_keep(ctx, kd, length)
        if ch_keep is not None:
            keys, key_scales = quantize_kv(self._zeroed(kd, ch_keep), bits)
        return keys, values, key_scales, value_scales, length, mask


@dataclasses.dataclass(frozen=True)
class ComposedPress(BasePress):
    """Presses applied one after the other (reference composed_press.py:
    56-62), each stage to the slots the previous one kept. Every stage's kept
    length must be known from the length alone (``exact_kept``): the
    head-wise AdaKV presses are refused, as in the reference."""

    presses: tuple = ()

    def __post_init__(self):
        if any(isinstance(p, (AdaKVPress, CriticalAdaKVPress)) for p in self.presses):
            raise TypeError("ComposedPress cannot chain AdaKVPress or CriticalAdaKVPress: "
                            "their heads keep different numbers of slots")

    @property
    def compression_ratio(self):
        retained = 1.0
        for p in self.presses:
            retained *= 1 - p.compression_ratio
        return 1 - retained

    def _kept(self, p, size: int) -> int:
        kept = p.exact_kept(size)
        if kept is None:
            raise ValueError(f"{type(p).__name__} is not composable: its kept length depends "
                             "on the data or the layer")
        return kept

    def max_kept(self, seq_len: int, cfg) -> int:
        for p in self.presses:
            seq_len = self._kept(p, seq_len)
        return seq_len

    def exact_kept(self, seq_len: int):
        return self.max_kept(seq_len, None)

    def layer_compress(self, ctx, keys, values, length, mask, state=None):
        _refuse_bucket(self, ctx)
        size = keys.shape[2]
        cur_k, cur_v, cur_mask, cur_len = keys, values, _all_kept(keys), length
        for p in self.presses:
            kept = self._kept(p, size)
            cur_k, cur_v, _, cur_mask, state = p.layer_compress(
                ctx, cur_k[:, :, :size], cur_v[:, :, :size], cur_len, cur_mask[:, :, :size],
                state)
            size = cur_len = kept
        return (_front(keys, cur_k[:, :, :size]), _front(values, cur_v[:, :, :size]), size,
                _all_kept(keys), state)

    # -- chunked prefill: each scorer stage shrinks an ``alive`` mask to its
    # budget by rank (no slicing); a ThinK stage zeroes channels with the key
    # energy of the alive slots (the one-shot path's sliced buffer). Exact
    # for per-position scorers.

    def _chunked_stages(self, ctx, keys, values, length: int):
        """(keys, with ThinK's channels zeroed; alive (B, H, S); count;
        whether a ThinK stage changed the keys)."""
        alive = _valid(keys, length).expand(keys.shape[:3])
        count, keys_modified = length, False
        for p in self.presses:
            if isinstance(p, ThinKPress):
                if p.key_channel_compression_ratio == 0.0:
                    continue
                energy = ((keys.to(torch.float32) ** 2) * alive[..., None]).sum(dim=2)
                ch_keep = p._channel_keep(ctx.queries, energy / max(float(count), 1.0))
                if ch_keep is not None:
                    keys, keys_modified = ThinKPress._zeroed(keys, ch_keep), True
                continue
            if not isinstance(p, ScorerPress):
                raise TypeError(f"{type(p).__name__} is not chunked-composable")
            if p.compression_ratio == 0.0:
                continue
            dctx = dataclasses.replace(ctx, kv_len=length)
            s = p.dynamic_score(dctx, keys, values, length).to(torch.float32)
            count = float32_budget(count, p.compression_ratio)
            alive = _rank_desc(torch.where(alive, s, NEG_INF)) < count
        return keys, alive, count, keys_modified

    def chunked_compress(self, ctx, keys, values, length: int, mask):
        keys, alive, count, _ = self._chunked_stages(ctx, keys, values, length)
        k2, v2 = _gather_front(keys, values, alive)
        return k2, v2, count, _all_kept(keys)

    def chunked_compress_quantized(self, ctx, keys, values, key_scales, value_scales,
                                   bits: int, length: int, mask):
        dt = ctx.hidden.dtype
        kd, alive, count, keys_modified = self._chunked_stages(
            ctx, dequantize_kv(keys, key_scales, bits, dt),
            dequantize_kv(values, value_scales, bits, dt), length)
        order = _compact_order(alive)
        if keys_modified:
            # ThinK zeroed key channels: requantize the gathered keys.
            k2, ks2 = quantize_kv(_gather_seq((kd,), order)[0], bits)
        else:
            k2, ks2 = _gather_seq((keys, key_scales), order)
        v2, vs2 = _gather_seq((values, value_scales), order)
        return k2, v2, ks2, vs2, count, _all_kept(keys)


@dataclasses.dataclass(frozen=True)
class PerLayerCompressionPress(BasePress):
    """A compression ratio per layer (reference
    per_layer_compression_press.py:56-61): one top-k to the largest budget,
    then each layer's own length. Chunked prefill takes it through
    ``BudgetDecodingPress`` (``scorer_like``), each layer's target from
    ``dynamic_budget``."""

    press: ScorerPress = None
    compression_ratios: tuple = ()

    scorer_like = True
    supports_padding = True

    def __post_init__(self):
        _check_scorer(self.press, "PerLayerCompressionPress")

    @property
    def compression_ratio(self):
        return sum(self.compression_ratios) / len(self.compression_ratios)

    def _budgets(self, S: int) -> list[int]:
        return [max(1, int(S * (1 - r))) for r in self.compression_ratios]

    def max_kept(self, seq_len: int, cfg) -> int:
        return max(self._budgets(seq_len))

    def exact_kept(self, seq_len: int):
        return None

    def layer_compress(self, ctx, keys, values, length, mask, state=None):
        _refuse_bucket(self, ctx)
        S = keys.shape[2]
        scores = self.press.score(ctx, keys, values).to(torch.float32)
        keys, values, _ = topk_keep(scores, keys, values, self.max_kept(S, ctx.cfg))
        return keys, values, self._budgets(S)[ctx.layer_idx], _all_kept(keys), state

    def dynamic_budget(self, ctx, length: int) -> int:
        """The layer's kept count, as the JAX package's float32 product."""
        r = np.float32(self.compression_ratios[ctx.layer_idx])
        return max(int(np.float32(length) * (np.float32(1.0) - r)), 1)

    def dynamic_score(self, ctx, keys, values, length: int):
        return self.press.dynamic_score(ctx, keys, values, length)
