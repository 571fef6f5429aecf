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
