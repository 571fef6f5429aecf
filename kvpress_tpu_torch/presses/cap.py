"""CapPress: CAPKV scoring (reference cap_press.py, arXiv:2604.25975; port
of ``kvpress_tpu/presses/cap.py``). The query anchor is the mean of the
pre-RoPE queries rotated by the mean future-RoPE matrix; alignment weights
are w_i = exp(tau * cos(k_i, anchor)); the score is w_i times the leverage of
v_i against the capacity matrix I + Σ w_i v_i v_iᵀ, by a linear solve."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..rope import mean_rotation_matrix
from .base import LayerCtx, ScorerPress
from .expected_attention import _needs_prerope
from .keydiff import _l2_normalize


@dataclasses.dataclass(frozen=True)
class CapPress(ScorerPress):
    tau: float = 5.0
    n_future_positions: int = 512
    n_sink: int = 4
    epsilon: float = 1e-6

    def _scores(self, ctx: LayerCtx, keys, values, start: int, rot_from: int,
                valid: Optional[torch.Tensor] = None, n_valid: int = 0):
        """(B, Hkv, S') scores of keys/values (B, Hkv, S', D) against the
        queries ``ctx.queries_prerope[:, :, start:start + S']``, rotated from
        position ``rot_from``; with ``valid`` (S',) only those ``n_valid``
        slots count (anchor, weights, capacity matrix)."""
        B, Hkv, Sp, D = keys.shape
        Hq = ctx.queries.shape[1]
        G = Hq // Hkv
        k = keys.to(torch.float32)
        v = values.to(torch.float32)
        q_pre = ctx.queries_prerope[:, :, start:start + Sp].to(torch.float32)
        R = mean_rotation_matrix(ctx.inv_freq, float(rot_from), self.n_future_positions)
        q_rot = q_pre @ (R * ctx.attention_scaling).T                   # (B, Hq, S', D)
        if valid is None:
            anchor = q_rot.mean(dim=2)
        else:
            anchor = (q_rot * valid[:, None]).sum(dim=2) / max(n_valid, 1)
        k_rep = k[:, :, None].expand(B, Hkv, G, Sp, D).reshape(B, Hq, Sp, D)
        v_rep = v[:, :, None].expand(B, Hkv, G, Sp, D).reshape(B, Hq, Sp, D)
        stat = torch.einsum("bhd,bhtd->bht", _l2_normalize(anchor), _l2_normalize(k_rep))
        logits = self.tau * torch.clamp(stat, -1.0, 1.0)
        if valid is not None:
            logits = logits.masked_fill(~valid, float("-inf"))
        weights = torch.exp(logits - logits.amax(dim=-1, keepdim=True))     # (B, Hq, S')
        sqrt_w = torch.sqrt(weights + self.epsilon)[..., None]
        if valid is not None:
            sqrt_w = sqrt_w * valid[:, None].to(torch.float32)
        scaled = v_rep * sqrt_w
        eye = torch.eye(D, dtype=torch.float32, device=k.device)
        cap = eye + torch.einsum("bhtd,bhte->bhde", scaled, scaled)
        vt = v_rep.transpose(2, 3)                                      # (B, Hq, D, S')
        leverage = (vt * torch.linalg.solve(cap, vt)).sum(dim=2)
        return (weights * leverage).reshape(B, Hkv, G, Sp).mean(dim=2)

    def score(self, ctx: LayerCtx, keys, values):
        _needs_prerope(self, ctx)
        S = keys.shape[2]
        if S <= self.n_sink:
            raise ValueError(f"Input should contain more tokens than n_sink={self.n_sink}")
        scores = self._scores(ctx, keys[:, :, self.n_sink:], values[:, :, self.n_sink:],
                              self.n_sink, ctx.seq_len)
        top = scores.max() + 1.0
        return torch.cat([top.expand(*scores.shape[:2], self.n_sink), scores], dim=-1)

    def dynamic_score(self, ctx: LayerCtx, keys, values, length: int):
        """Bucketed prefill: the anchor, the weights' max and the capacity
        matrix over the valid (non-sink, non-pad) slots only; the rotation
        from the valid length."""
        _needs_prerope(self, ctx)
        S = keys.shape[2]
        idx = torch.arange(S, device=keys.device)
        valid = (idx >= self.n_sink) & (idx < length)
        n_valid = max(min(length, S) - self.n_sink, 0)
        scores = self._scores(ctx, keys, values, 0, length, valid, n_valid)
        scores = scores.masked_fill(~valid, 0.0)
        return torch.where(idx < self.n_sink, scores.max() + 1.0, scores)
