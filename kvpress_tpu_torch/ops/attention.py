"""Dense attention with slot-index causal masking (port of
``kvpress_tpu/ops/attention.py:26-198``).

Causality is enforced in slot space: the ``i``-th new token of a call may
attend cache slot ``s`` iff ``s <= prior_length + i`` and the keep-mask bit
of ``s`` is set. Compression front-compacts the cache, so slot order is
chronological and this is exactly causal without position bookkeeping.

These are the paths the runner takes on the CPU, and the plain versions the
Hopper kernels (ops/flash.py, ops/decode.py) are held against.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..cache import unpack_int4

NEG_INF = -2.0e38  # finite: avoids exp(-inf - -inf) NaNs


def attention_bias(
    prior_length: int,
    num_new: int,
    buf_size: int,
    sliding_window: Optional[int] = None,
    head_mask: Optional[torch.Tensor] = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Additive float32 bias: (num_new, buf_size), or (B, H_kv, num_new,
    buf_size) with a (B, H_kv, buf_size) bool ``head_mask``."""
    if head_mask is not None:
        device = head_mask.device
    q_slot = prior_length + torch.arange(num_new, device=device)[:, None]
    k_slot = torch.arange(buf_size, device=device)[None, :]
    allowed = k_slot <= q_slot
    if sliding_window is not None:
        allowed &= k_slot > q_slot - sliding_window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=device)
    bias = torch.where(allowed, zero, neg)
    if head_mask is not None:
        bias = bias[None, None] + torch.where(head_mask, zero, neg)[:, :, None, :]
    return bias


def _add_bias(logits: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    # logits (B, Hkv, G, T, S); bias (T, S) or (B, Hkv, T, S)
    if bias.dim() == 2:
        return logits + bias[None, None, None]
    return logits + bias[:, :, None]


def gqa_attention(
    q: torch.Tensor,             # (B, Hq, T, D)
    k: torch.Tensor,             # (B, Hkv, S, D)
    v: torch.Tensor,
    bias: torch.Tensor,          # (T, S) or (B, Hkv, T, S)
    scale: float,
    softcap: Optional[float] = None,
    return_probs: bool = False,
):
    """Grouped-query attention with a float32 softmax.
    Returns (out (B, Hq, T, D), probs (B, Hq, T, S) or None)."""
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, T, D)
    logits = torch.einsum(
        "bhgtd,bhsd->bhgts", qg.float(), k.float()
    ) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    probs = torch.softmax(_add_bias(logits, bias), dim=-1)
    out = torch.einsum("bhgts,bhsd->bhgtd", probs.to(v.dtype), v)
    out = out.reshape(B, Hq, T, D)
    if return_probs:
        return out, probs.reshape(B, Hq, T, -1)
    return out, None


def quant_gqa_attention(
    q: torch.Tensor,             # (B, Hq, T, D)
    k_payload: torch.Tensor,     # (B, Hkv, S, D) int8 | (B, Hkv, S, D//2) uint8
    v_payload: torch.Tensor,
    k_scales: torch.Tensor,      # (B, Hkv, S, 1) f32
    v_scales: torch.Tensor,
    bias: torch.Tensor,
    scale: float,
    bits: int,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention reading the quantized payload: per-token scales are
    applied outside the reductions, ``q.(k_int*s) = (q.k_int)*s`` on logit
    columns and ``p.(v_int*s) = (p*s).v_int`` on prob rows."""
    B, Hq, T, D = q.shape
    Hkv, S = k_payload.shape[1], k_payload.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G * T, D)
    logits = quant_qk_logits(qg, k_payload, k_scales, bits)
    logits = logits.reshape(B, Hkv, G, T, S) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    probs = torch.softmax(_add_bias(logits, bias), dim=-1)
    out = quant_pv_out(probs.reshape(B, Hkv, G * T, S), v_payload, v_scales,
                       bits, q.dtype)
    return out.reshape(B, Hq, T, D)


def quant_qk_logits(
    qg: torch.Tensor,            # (B, Hkv, R, D), R = folded (group, time) rows
    k_payload: torch.Tensor,
    k_scales: torch.Tensor,      # (B, Hkv, S, 1) f32
    bits: int,
) -> torch.Tensor:
    """q.K logits against the payload, key scales applied outside the
    reduction. Returns (B, Hkv, R, S) float32, not yet multiplied by the
    softmax scale."""
    B, H, R, D = qg.shape
    S = k_payload.shape[2]
    ks_row = k_scales.reshape(B, H, 1, S)
    qf = qg.float()
    if bits == 8:
        logits = torch.einsum("bhrd,bhsd->bhrs", qf, k_payload.float())
    else:
        d2 = D // 2
        k_lo, k_hi = unpack_int4(k_payload, torch.float32)
        logits = (torch.einsum("bhrd,bhsd->bhrs", qf[..., :d2], k_lo)
                  + torch.einsum("bhrd,bhsd->bhrs", qf[..., d2:], k_hi))
    return logits * ks_row


def quant_pv_out(
    probs: torch.Tensor,         # (B, Hkv, R, S) f32
    v_payload: torch.Tensor,
    v_scales: torch.Tensor,      # (B, Hkv, S, 1) f32
    bits: int,
    dtype: torch.dtype,
) -> torch.Tensor:
    """probs.V against the payload. Returns (B, Hkv, R, D); int4 nibble-plane
    outputs concatenate back to D (concat-halves layout)."""
    B, H, R, S = probs.shape
    pv = (probs * v_scales.reshape(B, H, 1, S)).to(dtype)
    if bits == 8:
        return torch.einsum("bhrs,bhsd->bhrd", pv, v_payload.to(dtype))
    v_lo, v_hi = unpack_int4(v_payload, dtype)
    return torch.cat([torch.einsum("bhrs,bhsd->bhrd", pv, v_lo),
                      torch.einsum("bhrs,bhsd->bhrd", pv, v_hi)], dim=-1)


# ---------------------------------------------------------------------- #
# Attention probabilities for the scoring presses, rebuilt from post-RoPE
# queries without the S x S matrix (port of kvpress_tpu/ops/attention.py:
# 199-378). The JAX package computes these outside any Pallas kernel, so
# they are plain PyTorch here too.


def _window_logit_chunks(q_window, k, scale, prior_length, chunk, softcap=None):
    """Yield (c0, logits (B, Hkv, G, W, n) float32, allowed (W, n)) over runs
    of ``chunk`` keys: scaled (softcapped) logits of the window queries, the
    first of which sits at slot ``prior_length``."""
    B, Hq, W, D = q_window.shape
    Hkv, S = k.shape[1], k.shape[2]
    qg = q_window.reshape(B, Hkv, Hq // Hkv, W, D).float()
    q_slot = int(prior_length) + torch.arange(W, device=k.device)[:, None]
    for c0 in range(0, S, chunk):
        kc = k[:, :, c0:c0 + chunk].float()
        s = torch.einsum("bhgtd,bhsd->bhgts", qg, kc) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        yield c0, s, (c0 + torch.arange(kc.shape[2], device=k.device))[None, :] <= q_slot


def chunked_window_probs_mean(
    q_window: torch.Tensor,      # (B, Hq, W, D)
    k: torch.Tensor,             # (B, Hkv, S, D)
    scale: float,
    prior_length: int,
    chunk: int = 4096,
) -> torch.Tensor:
    """Column means over the window of softmax probs, (B, Hq, S), in
    O(W * chunk) memory: a two-pass online softmax over key chunks (running
    max and sum, then normalized columns). Takes no softcap, as in the JAX
    package."""
    B, Hq, W, _ = q_window.shape
    Hkv, S = k.shape[1], k.shape[2]
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=k.device)
    m = torch.full((B, Hkv, Hq // Hkv, W), float("-inf"), device=k.device)
    l = torch.zeros_like(m)
    for _, s, allowed in _window_logit_chunks(q_window, k, scale, prior_length, chunk):
        s = torch.where(allowed, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(dim=-1)
        m = m_new
    inv_l = torch.where(l == 0, torch.zeros_like(l), 1.0 / l)
    cols = []
    for _, s, allowed in _window_logit_chunks(q_window, k, scale, prior_length, chunk):
        p = torch.exp(torch.where(allowed, s, neg) - m[..., None]) * inv_l[..., None]
        cols.append(p.mean(dim=-2))                       # (B, Hkv, G, n)
    return torch.cat(cols, dim=-1).reshape(B, Hq, S)


def window_probs_mean_from_lse(
    q_window: torch.Tensor,      # (B, Hq, W, D): the last W post-RoPE queries
    k: torch.Tensor,             # (B, Hkv, S, D)
    lse_window: torch.Tensor,    # (B, Hq, W) f32: their row logsumexp from the
                                 # flash prefill (the tail of ctx.attn_lse)
    scale: float,
    prior_length: int,           # causal offset of the first window row
    softcap: Optional[float] = None,
    chunk: int = 4096,
) -> torch.Tensor:
    """Column means over the window, (B, Hq, S), in one sweep over K: with
    the exact row logsumexp, probs are ``exp(s - lse)``. ``softcap`` must be
    that of the attention that produced the lse."""
    B, Hq, W, _ = q_window.shape
    Hkv, S = k.shape[1], k.shape[2]
    lse = lse_window.reshape(B, Hkv, Hq // Hkv, W, 1)
    zero = torch.zeros((), dtype=torch.float32, device=k.device)
    cols = [torch.where(allowed, torch.exp(s - lse), zero).mean(dim=-2)
            for _, s, allowed in _window_logit_chunks(q_window, k, scale, prior_length, chunk,
                                                      softcap)]
    return torch.cat(cols, dim=-1).reshape(B, Hq, S)


def chunked_observed_colsums(
    queries: torch.Tensor,       # (B, Hq, S, D): all post-RoPE prefill queries
    keys: torch.Tensor,          # (B, Hkv, S, D)
    scale: float,
    softcap: Optional[float] = None,
    chunk: int = 64,
) -> torch.Tensor:
    """Causal column sums of the full softmax attention matrix, (B, Hq, S),
    without materializing it: ``chunk`` query rows at a time are softmaxed
    over the whole key axis and column-summed into an accumulator.
    O(Hq * chunk * S) memory, the same S^2 * D operations as attention."""
    B, Hq, S, D = queries.shape
    Hkv = keys.shape[1]
    qg = queries.reshape(B, Hkv, Hq // Hkv, S, D).float()
    kf = keys.float()
    acc = torch.zeros((B, Hkv, Hq // Hkv, S), dtype=torch.float32, device=keys.device)
    for c0 in range(0, S, chunk):
        s = torch.einsum("bhgtd,bhsd->bhgts", qg[:, :, :, c0:c0 + chunk], kf) * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        s = s + attention_bias(c0, s.shape[3], S, device=keys.device)
        acc += torch.softmax(s, dim=-1).sum(dim=-2)
    return acc.reshape(B, Hq, S)


def window_attention_probs(
    q_window: torch.Tensor,      # (B, Hq, W, D): the last W queries (post-RoPE)
    k: torch.Tensor,             # (B, Hkv, S, D)
    scale: float,
    prior_length: int,           # causal offset of the first window query
) -> torch.Tensor:
    """Softmax probs of the last W queries over all S keys: (B, Hq, W, S)."""
    B, Hq, W, D = q_window.shape
    Hkv, S = k.shape[1], k.shape[2]
    qg = q_window.reshape(B, Hkv, Hq // Hkv, W, D).float()
    logits = torch.einsum("bhgtd,bhsd->bhgts", qg, k.float()) * scale
    logits = logits + attention_bias(int(prior_length), W, S, device=k.device)
    return torch.softmax(logits, dim=-1).reshape(B, Hq, W, S)
