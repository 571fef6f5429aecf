"""Causal softmax column sums for ObservedAttention scoring (port of
``kvpress_tpu/ops/observed_colsum.py``).

``observed_colsums_flash(q, k, lse=None)`` returns, per query head, the sum
over queries of the prefill's attention probabilities onto each key,
``(B, Hq, S)`` float32, without the S x S matrix: pass 1 (``observed_lse``)
computes each query row's logsumexp over its causal logits, pass 2 adds up
``exp(s - lse[row])`` column by column. Given the row LSE of the flash prefill
kernel (``flash_attention(..., return_lse=True)``), pass 1 is skipped.

Prefill-only contract: queries are slot-aligned with keys (S == T, nothing
before them in the cache), causal, no keep-mask; optional logit softcap.

On CUDA tensors the two wrappers launch the hand-written Hopper kernels of
``csrc/observed_colsum.cu`` and add one to their ``launches`` counts; anything
the kernels do not take raises. On CPU tensors they run the plain PyTorch
versions beside them. There is no fall-back from one to the other.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import attention_bias
from .flash import MAX_GROUP, _lse_from_logits, _opt

PLAIN_ROWS = 512      # query rows per step of the plain versions
COLSUM_GROUPS = (1, 2, 4, 8)    # query heads per kv head pass 2 is built for


def _row_chunks(q, k, sm_scale, softcap):
    """Yield (r0, logits (B, Hkv, G, t, S) float32, bias (t, S)) for runs of
    PLAIN_ROWS query rows: scaled, softcapped logits, not yet masked."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, S, D).float()
    kf = k.float()
    for r0 in range(0, S, PLAIN_ROWS):
        logits = torch.einsum("bhgtd,bhsd->bhgts", qg[:, :, :, r0:r0 + PLAIN_ROWS], kf) * sm_scale
        if softcap is not None:
            logits = torch.tanh(logits / softcap) * softcap
        yield r0, logits, attention_bias(r0, logits.shape[3], S, device=q.device)


def observed_lse_plain(q, k, *, sm_scale, softcap=None) -> torch.Tensor:
    """The plain PyTorch version of ``observed_lse``."""
    return torch.cat([_lse_from_logits(logits, bias)
                      for _, logits, bias in _row_chunks(q, k, sm_scale, softcap)], dim=-1)


def observed_colsums_plain(q, k, lse=None, *, sm_scale, softcap=None) -> torch.Tensor:
    """The plain PyTorch version of ``observed_colsums_flash``."""
    B, Hq, S, _ = q.shape
    if lse is None:
        lse = observed_lse_plain(q, k, sm_scale=sm_scale, softcap=softcap)
    # A row that saw no key (lse = -inf from the flash kernel) adds 0.
    lse = torch.where(torch.isinf(lse), torch.full_like(lse, float("inf")), lse)
    out = torch.zeros((B, Hq, S), dtype=torch.float32, device=q.device)
    for r0, logits, bias in _row_chunks(q, k, sm_scale, softcap):
        t = logits.shape[3]
        rows = lse[:, :, r0:r0 + t].reshape(B, -1, Hq // k.shape[1], t, 1)
        p = torch.where(bias == 0, torch.exp(logits - rows), torch.zeros((), device=q.device))
        out += p.sum(dim=3).reshape(B, Hq, S)
    return out


def _check(q, k, lse=None):
    B, Hq, S, D = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16:
        raise TypeError(f"kernel takes bf16 queries and keys, got {q.dtype}, {k.dtype}")
    if k.dim() != 4 or k.shape[0] != B or Hq % k.shape[1]:
        raise ValueError(f"bad key shape {tuple(k.shape)} for queries {tuple(q.shape)}")
    Hkv = k.shape[1]
    if tuple(k.shape) != (B, Hkv, S, D):
        raise ValueError(f"keys must be slot-aligned with queries: expected "
                         f"{(B, Hkv, S, D)}, got {tuple(k.shape)}")
    if Hq // Hkv > MAX_GROUP or D not in (64, 128):
        raise ValueError(f"kernel takes GQA groups <= {MAX_GROUP} and head_dim 64/128")
    if lse is not None and (lse.dtype != torch.float32 or tuple(lse.shape) != (B, Hq, S)):
        raise ValueError(f"lse: expected float32 {(B, Hq, S)}")
    for name, t in (("q", q), ("k", k), ("lse", lse)):
        if t is None:
            continue
        if not t.is_cuda or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: kernel inputs must be contiguous on one CUDA device")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: kernel inputs must be 16-byte aligned")
    return B, Hq, Hkv, S, D


def observed_lse(
    q: torch.Tensor,                 # (B, Hq, S, D), slot-aligned prefill
    k: torch.Tensor,                 # (B, Hkv, S, D)
    *,
    sm_scale: float,
    softcap: Optional[float] = None,
) -> torch.Tensor:                   # (B, Hq, S) f32 row logsumexp
    """Pass 1: the natural-log logsumexp of each query row's causal, scaled,
    softcapped logits (what ``flash_attention(return_lse=True)`` also gives)."""
    if not q.is_cuda:
        return observed_lse_plain(q, k, sm_scale=sm_scale, softcap=softcap)
    B, Hq, Hkv, S, D = _check(q, k)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    fn = _build.entry("observed_colsum", "kvp_observed_lse")
    err = fn(q.data_ptr(), k.data_ptr(), lse.data_ptr(), B, Hq, Hkv, S, D, float(sm_scale),
             float(_opt(softcap, 0.0)), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "observed_lse")
    observed_lse.launches += 1
    return lse


observed_lse.launches = 0


def observed_colsums_flash(
    q: torch.Tensor,                 # (B, Hq, S, D), slot-aligned prefill
    k: torch.Tensor,                 # (B, Hkv, S, D)
    lse: Optional[torch.Tensor] = None,   # (B, Hq, S) f32 from the flash prefill
    *,
    sm_scale: float,
    softcap: Optional[float] = None,
) -> torch.Tensor:                   # (B, Hq, S) f32 causal softmax column sums
    if not q.is_cuda:
        return observed_colsums_plain(q, k, lse, sm_scale=sm_scale, softcap=softcap)
    B, Hq, Hkv, S, D = _check(q, k, lse)
    if Hq // Hkv not in COLSUM_GROUPS:
        raise ValueError(f"kernel takes {COLSUM_GROUPS} query heads per kv head, "
                         f"got {Hq // Hkv}")
    if lse is None:
        lse = observed_lse(q, k, sm_scale=sm_scale, softcap=softcap)
    out = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    fn = _build.entry("observed_colsum", "kvp_observed_colsum")
    err = fn(q.data_ptr(), k.data_ptr(), lse.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, D,
             float(sm_scale), float(_opt(softcap, 0.0)),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "observed_colsums_flash")
    observed_colsums_flash.launches += 1
    return out


observed_colsums_flash.launches = 0
