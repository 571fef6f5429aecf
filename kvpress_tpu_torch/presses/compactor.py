"""The Compactor family: NonCausalAttnPress, LeverageScorePress,
CompactorPress (reference non_causal_attention_press.py, leverage_press.py,
compactor_press.py, arXiv:2507.08143; port of
``kvpress_tpu/presses/compactor.py``). Prefill only.

Bucketed prefill: the chunked non-causal attention is block diagonal, so
only the chunk holding the valid length's end sees the pads, and it masks
them as the reference masks its last chunk; the leverage sketch zeroes the
pad rows before the Gram matrix; the z-norm takes masked moments.

``LeverageScorePress`` draws its Gaussian sketch from a generator seeded
from (seed, layer), not the JAX package's numbers;
``compute_leverage_scores`` takes the sketch as an argument."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .base import LayerCtx, ScorerPress, layer_generator
from .snapkv import avg_pool_1d

JITTERS = (1e-2, 1e-1, 1.0)


def _z_norm(scores: torch.Tensor, valid: Optional[torch.Tensor] = None,
            n_valid: int = 0) -> torch.Tensor:
    """z-norm over the whole tensor (ddof 1); with ``valid`` (S,), the
    moments over its ``n_valid`` valid slots of every row only."""
    if valid is None:
        return (scores - scores.mean()) / torch.clamp(torch.std(scores, correction=1), min=1e-6)
    B, H, _ = scores.shape
    cnt = float(B * H * n_valid)
    mean = scores.masked_fill(~valid, 0.0).sum() / cnt
    var = ((scores - mean) ** 2).masked_fill(~valid, 0.0).sum() / (cnt - 1.0)
    return (scores - mean) / torch.clamp(torch.sqrt(var), min=1e-6)


def _needs_one_query_a_slot(press, ctx: LayerCtx, S: int, *fields: str):
    """Refuse a ctx without one query a slot, or without the ``fields`` named
    (chunked prefill's compression pass has the last window's queries only,
    and no pre-RoPE ones)."""
    missing = [f for f in fields if getattr(ctx, f) is None]
    if ctx.queries.shape[2] != S or missing:
        raise ValueError(f"{type(press).__name__} scores the prefill only: it needs a query "
                         f"a slot ({ctx.queries.shape[2]} for {S} slots) and {fields} "
                         f"({missing} missing); use the one-shot prefill")


def cholesky_with_jitter(G: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of G + j I for the first jitter j of JITTERS that
    factors, per matrix (reference chol_with_jitter). ``cholesky_ex`` reports
    a failure in ``info`` (the JAX function returns NaN there), and the
    choice is a ``torch.where``, so nothing waits on the host."""
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    L, info = torch.linalg.cholesky_ex(G + JITTERS[0] * eye)
    for jitter in JITTERS[1:]:
        bad = info != 0
        L_j, info_j = torch.linalg.cholesky_ex(G + jitter * eye)
        L = torch.where(bad[..., None, None], L_j, L)
        info = torch.where(bad, info_j, info)
    return L


@dataclasses.dataclass(frozen=True)
class NonCausalAttnPress(ScorerPress):
    """Column sums of a non-causal chunked attention times ||v||, pooled and
    z-normed (reference :46-122)."""

    chunk_size: int = 256

    @staticmethod
    def non_causal_chunked_attn(q: torch.Tensor, k: torch.Tensor, chunk_size: int,
                                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q/k (B, H, S, d) -> (B, H, S) column sums of the chunked softmax of
        q kᵀ, unscaled as in the reference (:89). ``valid`` (S,) marks the
        real slots (bucketed prefill); None: all but the chunk-alignment pad."""
        B, H, S, d = k.shape
        S_pad = -(-S // chunk_size) * chunk_size
        nc = S_pad // chunk_size
        qc = F.pad(q, (0, 0, 0, S_pad - S)).reshape(B, H, nc, chunk_size, d)
        kc = F.pad(k, (0, 0, 0, S_pad - S)).reshape(B, H, nc, chunk_size, d)
        dots = torch.einsum("bhcqd,bhckd->bhcqk", qc, kc)
        # Invalid query rows to 0, then invalid key columns to -1e-9, in the
        # reference's order (:92-93); all-valid chunks are untouched.
        if valid is None:
            invalid = torch.arange(S_pad, device=k.device) >= S
        else:
            invalid = ~F.pad(valid, (0, S_pad - S), value=False)
        inv_c = invalid.reshape(nc, chunk_size)
        dots = dots.masked_fill(inv_c[:, :, None], 0.0)
        dots = dots.masked_fill(inv_c[:, None, :], -1e-9)
        attn = torch.softmax(dots.to(torch.float32), dim=-1)
        return attn.sum(dim=-2).reshape(B, H, S_pad)[..., :S]

    def _score_impl(self, ctx: LayerCtx, keys, values, valid=None, n_valid: int = 0):
        B, Hkv, S, d = keys.shape
        _needs_one_query_a_slot(self, ctx, S)
        Hq = ctx.queries.shape[1]
        G = Hq // Hkv
        k_rep = keys[:, :, None].expand(B, Hkv, G, S, d).reshape(B, Hq, S, d)
        A = self.non_causal_chunked_attn(ctx.queries.to(torch.float32),
                                         k_rep.to(torch.float32), self.chunk_size, valid)
        A = A.reshape(B, Hkv, G, S).mean(dim=2)
        scores = A * torch.linalg.vector_norm(values.to(torch.float32), dim=-1)
        if valid is not None:
            # avg_pool_1d divides by the whole kernel (count_include_pad), so
            # zeroed pads reproduce the exact length's edge.
            scores = scores.masked_fill(~valid, 0.0)
        return _z_norm(avg_pool_1d(scores, 3), valid, n_valid)

    def score(self, ctx: LayerCtx, keys, values):
        return self._score_impl(ctx, keys, values)

    def dynamic_score(self, ctx: LayerCtx, keys, values, length: int):
        S = keys.shape[2]
        return self._score_impl(ctx, keys, values, torch.arange(S, device=keys.device) < length,
                                min(length, S))


@dataclasses.dataclass(frozen=True)
class LeverageScorePress(ScorerPress):
    """Approximate statistical leverage of the pre-RoPE keys: a right
    Gaussian sketch, then a Cholesky solve with adaptive jitter (reference
    :46-110)."""

    sketch_dimension: int = 48
    seed: int = 0

    def sketch(self, ctx: LayerCtx, shape, device) -> torch.Tensor:
        """The (B, Hkv, d, sketch_dimension) Gaussian sketch of this press and
        layer."""
        gen = layer_generator(self.seed, ctx.layer_idx, device)
        return torch.randn((*shape, self.sketch_dimension), generator=gen, device=device,
                           dtype=torch.float32) / self.sketch_dimension ** 0.5

    @staticmethod
    def compute_leverage_scores(key_states: torch.Tensor, phi: torch.Tensor,
                                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """key_states (B, H, S, d), phi (B, H, d, k) -> (B, H, S) leverage
        scores. With ``valid``, the pad rows are left out of the mean and
        zeroed after the sketch, so that the Gram matrix does not see them."""
        if valid is None:
            mu = key_states.mean(dim=-2, keepdim=True)
        else:
            w = valid.to(key_states.dtype)[:, None]
            mu = (key_states * w).sum(-2, keepdim=True) / w.sum(-2, keepdim=True)
        X = ((key_states - mu) @ phi).to(torch.float32)                # (B, H, S, k)
        if valid is not None:
            X = X.masked_fill(~valid[:, None], 0.0)
        XT = X.transpose(-2, -1)
        G = XT @ X
        L = cholesky_with_jitter(0.5 * (G + G.transpose(-2, -1)))
        inv_Xt = torch.cholesky_solve(XT, L)                            # (B, H, k, S)
        return torch.clamp((X * inv_Xt.transpose(-2, -1)).sum(dim=-1), min=0.0)

    def _score_impl(self, ctx: LayerCtx, keys, values, valid=None, n_valid: int = 0):
        B, Hkv, S, d = keys.shape
        _needs_one_query_a_slot(self, ctx, S, "keys_prerope")
        k_pre = ctx.keys_prerope.to(torch.float32)
        phi = self.sketch(ctx, (B, Hkv, d), keys.device)
        return _z_norm(self.compute_leverage_scores(k_pre, phi, valid), valid, n_valid)

    def score(self, ctx: LayerCtx, keys, values):
        return self._score_impl(ctx, keys, values)

    def dynamic_score(self, ctx: LayerCtx, keys, values, length: int):
        S = keys.shape[2]
        return self._score_impl(ctx, keys, values, torch.arange(S, device=keys.device) < length,
                                min(length, S))


@dataclasses.dataclass(frozen=True)
class CompactorPress(ScorerPress):
    """blending * leverage + non-causal attention, with protected sinks at
    the start and the end (reference compactor_press.py:87-122)."""

    sink_size_start: int = 8
    sink_size_end: int = 4
    chunk_size: int = 256
    sketch_dimension: int = 48
    blending: Optional[float] = None
    seed: int = 0

    def _children(self):
        return (LeverageScorePress(compression_ratio=self.compression_ratio,
                                   sketch_dimension=self.sketch_dimension, seed=self.seed),
                NonCausalAttnPress(compression_ratio=self.compression_ratio,
                                   chunk_size=self.chunk_size))

    def _blend(self, l_scores, a_scores):
        blending = self.blending if self.blending is not None else self.compression_ratio
        return blending * l_scores + a_scores

    @staticmethod
    def _sub_ctx(ctx: LayerCtx, left: int, end: int) -> LayerCtx:
        return dataclasses.replace(
            ctx, hidden=ctx.hidden[:, left:end], queries=ctx.queries[:, :, left:end],
            queries_prerope=ctx.queries_prerope[:, :, left:end],
            keys_prerope=ctx.keys_prerope[:, :, left:end], positions=ctx.positions[:, left:end],
            attn_probs=None)

    def score(self, ctx: LayerCtx, keys, values):
        S = keys.shape[2]
        _needs_one_query_a_slot(self, ctx, S, "queries_prerope", "keys_prerope")
        left = min(self.sink_size_start, S)
        right = min(self.sink_size_end, max(0, S - left))
        end = S - right
        sub_ctx = self._sub_ctx(ctx, left, end)
        k_sub, v_sub = keys[:, :, left:end], values[:, :, left:end]
        lev, nca = self._children()
        scores = self._blend(lev.score(sub_ctx, k_sub, v_sub), nca.score(sub_ctx, k_sub, v_sub))
        top = scores.max()
        B, H = scores.shape[:2]
        return torch.cat([top.expand(B, H, left), scores, top.expand(B, H, right)], dim=-1)

    def dynamic_score(self, ctx: LayerCtx, keys, values, length: int):
        """Bucketed prefill: the children score the slice [left, S) with the
        slots [left, length - right) valid (the end sink floats with the
        valid length); both sinks take the max over the valid scores."""
        S = keys.shape[2]
        _needs_one_query_a_slot(self, ctx, S, "queries_prerope", "keys_prerope")
        left = min(self.sink_size_start, S)
        right = min(self.sink_size_end, max(length - left, 0))
        n_sub = max(length - right - left, 0)
        sub_ctx = self._sub_ctx(ctx, left, S)
        k_sub, v_sub = keys[:, :, left:], values[:, :, left:]
        sub_valid = torch.arange(S - left, device=keys.device) < n_sub
        n_valid = min(n_sub, S - left)
        lev, nca = self._children()
        scores = self._blend(lev._score_impl(sub_ctx, k_sub, v_sub, sub_valid, n_valid),
                             nca._score_impl(sub_ctx, k_sub, v_sub, sub_valid, n_valid))
        top = scores.masked_fill(~sub_valid, float("-inf")).max()
        scores = F.pad(scores, (left, 0))
        pos = torch.arange(S, device=keys.device)
        protected = (pos < left) | ((pos >= length - right) & (pos < length))
        return torch.where(protected, top, scores)
