"""ExpectedAttentionPress, the reference's flagship method
(kvpress/presses/expected_attention_press.py:62-165, arXiv:2510.00636; port
of ``kvpress_tpu/presses/expected_attention.py``).

Keys are scored by the attention that future queries are expected to pay
them. Future queries are modelled as Gaussian with the mean and covariance
of the observed pre-RoPE queries, rotated by the average RoPE matrix over the
next ``n_future_positions`` (``rope.mean_rotation_matrix``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..rope import mean_rotation_matrix
from .base import LayerCtx, ScorerPress


def _rotate_stats(ctx: LayerCtx, mu, cov, start: int, n_future: int):
    """mu (..., Hq, D) and cov (..., Hq, D, D) rotated by the mean future-RoPE
    matrix from ``start``."""
    R = mean_rotation_matrix(ctx.inv_freq, float(start), n_future) * ctx.attention_scaling
    mu = mu @ R.T
    if cov is not None:
        cov = R @ cov @ R.T
    return mu, cov


def _needs_prerope(press, ctx: LayerCtx):
    if ctx.queries_prerope is None:
        raise ValueError(f"{type(press).__name__} reads the pre-RoPE queries of every context "
                         "position: chunked prefill's compression pass has only the last "
                         "window's post-RoPE queries (use the one-shot prefill)")


def expected_logits(mu, cov, keys, use_covariance: bool):
    """(B, Hkv, G, S) expected attention logits of keys (B, Hkv, S, D) under
    queries of mean mu (B', Hq, D) and covariance cov (B', Hq, D, D)."""
    B, Hkv, S, D = keys.shape
    k = keys.to(torch.float32)
    G = mu.shape[1] // Hkv
    mug = mu.reshape(mu.shape[0], Hkv, G, D)
    logits = torch.einsum("bhgd,bhsd->bhgs", mug, k) / D ** 0.5
    if use_covariance:
        covg = cov.reshape(cov.shape[0], Hkv, G, D, D)
        # k^T cov k for each group: (k @ cov) . k
        kc = torch.einsum("bhsi,bhgij->bhgsj", k, covg)
        logits = logits + (kc * k[:, :, None]).sum(dim=-1) / D / 2
    return logits


@dataclasses.dataclass(frozen=True)
class ExpectedAttentionPress(ScorerPress):
    n_future_positions: int = 512
    n_sink: int = 4
    use_covariance: bool = True
    use_vnorm: bool = True
    epsilon: float = 0.0

    def query_statistics(self, ctx: LayerCtx):
        """mu (B, Hq, D) and cov (B, Hq, D, D) of the pre-RoPE queries (sinks
        left out), rotated by the mean future-RoPE matrix."""
        _needs_prerope(self, ctx)
        q = ctx.queries_prerope[:, :, self.n_sink:].to(torch.float32)
        mu = q.mean(dim=2)
        cov = None
        if self.use_covariance:
            centered = q - mu[:, :, None]
            cov = torch.einsum("bhsi,bhsj->bhij", centered, centered) / q.shape[2]
        return _rotate_stats(ctx, mu, cov, ctx.seq_len, self.n_future_positions)

    def score(self, ctx: LayerCtx, keys, values):
        S = keys.shape[2]
        if S <= self.n_sink:
            raise ValueError(f"Input should contain more tokens than n_sink={self.n_sink}")
        mu, cov = self.query_statistics(ctx)
        # The softmax runs over the key axis, then the mean over the group.
        scores = torch.softmax(expected_logits(mu, cov, keys[:, :, self.n_sink:],
                                               self.use_covariance), dim=-1).mean(dim=2)
        if self.use_vnorm:
            v = values[:, :, self.n_sink:].to(torch.float32)
            scores = (scores + self.epsilon) * torch.linalg.vector_norm(v, dim=-1)
        # The sinks score above every other key of the whole tensor.
        top = scores.max() + 1.0
        return torch.cat([top.expand(*scores.shape[:2], self.n_sink), scores], dim=-1)

    def dynamic_score(self, ctx: LayerCtx, keys, values, length: int):
        """Bucketed prefill: the query moments over the valid rows only, the
        rotation from the valid length, the pad keys left out of the
        softmax. Equal to ``score`` when ``length`` is S."""
        _needs_prerope(self, ctx)
        S = keys.shape[2]
        idx = torch.arange(S, device=keys.device)
        valid = (idx >= self.n_sink) & (idx < length)
        w = valid.to(torch.float32)[:, None]
        q = ctx.queries_prerope.to(torch.float32)
        cnt = float(max(min(length, S) - self.n_sink, 1))
        mu = (q * w).sum(dim=2) / cnt
        cov = None
        if self.use_covariance:
            centered = (q - mu[:, :, None]) * w
            cov = torch.einsum("bhsi,bhsj->bhij", centered, centered) / cnt
        mu, cov = _rotate_stats(ctx, mu, cov, length, self.n_future_positions)
        logits = expected_logits(mu, cov, keys, self.use_covariance)
        logits = logits.masked_fill(~valid, float("-inf"))
        scores = torch.softmax(logits, dim=-1).mean(dim=2)
        if self.use_vnorm:
            scores = (scores + self.epsilon) * torch.linalg.vector_norm(
                values.to(torch.float32), dim=-1)
        scores = scores.masked_fill(~valid, 0.0)
        return torch.where(idx < self.n_sink, scores.max() + 1.0, scores)
