"""Multi-token attention kernels (port of ``kvpress_tpu/ops/flash.py``).

``flash_attention`` and ``flash_attention_quant`` keep the Pallas kernels'
contract: query ``i`` of the call attends cache slot ``s`` iff
``s <= prior_length + i``, the ``(B, Hkv, S)`` keep-mask bit of ``s`` is set
and, with ``window``, ``s > prior_length + i - window``; optional logit
softcap and float32 logsumexp.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``csrc/flash.cu``, ``csrc/flash_quant.cu``) and adds one to its
``launches`` count; anything the kernel does not take raises. On a CPU
tensor it runs the plain PyTorch version beside it (``*_plain``), built on
ops/attention.py. There is no fall-back from one to the other.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import attention_bias, gqa_attention, quant_gqa_attention, quant_qk_logits

MAX_GROUP = 8   # query heads per kv head the kernels' block geometry takes


def _lse_from_logits(logits: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    # logits (B, Hkv, G, T, S) scaled; returns (B, Hq, T)
    logits = logits + (bias[None, None, None] if bias.dim() == 2 else bias[:, :, None])
    B, Hkv, G, T, _ = logits.shape
    return torch.logsumexp(logits, dim=-1).reshape(B, Hkv * G, T)


def flash_attention_plain(q, k, v, prior_length, head_mask=None, *, sm_scale,
                          softcap=None, window=None, return_lse=False):
    """The plain PyTorch version of ``flash_attention``."""
    T, S = q.shape[2], k.shape[2]
    bias = attention_bias(int(prior_length), T, S, sliding_window=window,
                          head_mask=head_mask, device=q.device)
    out, _ = gqa_attention(q, k, v, bias, sm_scale, softcap=softcap)
    if not return_lse:
        return out
    B, Hq, _, D = q.shape
    Hkv = k.shape[1]
    logits = torch.einsum("bhgtd,bhsd->bhgts",
                          q.reshape(B, Hkv, Hq // Hkv, T, D).float(), k.float()) * sm_scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return out, _lse_from_logits(logits, bias)


def flash_attention_quant_plain(q, k, v, k_scales, v_scales, prior_length,
                                head_mask=None, *, bits, sm_scale, softcap=None,
                                window=None, return_lse=False):
    """The plain PyTorch version of ``flash_attention_quant``."""
    T, S = q.shape[2], k.shape[2]
    bias = attention_bias(int(prior_length), T, S, sliding_window=window,
                          head_mask=head_mask, device=q.device)
    out = quant_gqa_attention(q, k, v, k_scales, v_scales, bias, sm_scale, bits,
                              softcap=softcap)
    if not return_lse:
        return out
    B, Hq, _, D = q.shape
    Hkv = k.shape[1]
    logits = quant_qk_logits(q.reshape(B, Hkv, Hq // Hkv * T, D), k, k_scales, bits)
    logits = logits.reshape(B, Hkv, Hq // Hkv, T, S) * sm_scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return out, _lse_from_logits(logits, bias)


def _check_common(q, k, v, head_mask, payload_dtype, payload_d):
    B, Hq, T, D = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"kernel takes bf16 queries, got {q.dtype}")
    if k.dim() != 4 or k.shape[0] != B or Hq % k.shape[1]:
        raise ValueError(f"bad key shape {tuple(k.shape)} for queries {tuple(q.shape)}")
    Hkv, S = k.shape[1], k.shape[2]
    if Hq // Hkv > MAX_GROUP:
        raise ValueError(f"kernel takes at most {MAX_GROUP} query heads per kv head")
    if D not in (64, 128):
        raise ValueError(f"kernel takes head_dim 64 or 128, got {D}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != payload_dtype or tuple(t.shape) != (B, Hkv, S, payload_d):
            raise ValueError(f"{name}: expected {payload_dtype} {(B, Hkv, S, payload_d)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    tensors = [q, k, v] + ([head_mask] if head_mask is not None else [])
    for t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError("all kernel inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if head_mask is not None and (head_mask.dtype != torch.bool
                                  or tuple(head_mask.shape) != (B, Hkv, S)):
        raise ValueError(f"head_mask: expected bool {(B, Hkv, S)}")
    return B, Hq, Hkv, T, S, D


def _opt(x, default):
    return default if x is None else x


def padded_mask(mask: Optional[torch.Tensor]) -> tuple[Optional[torch.Tensor], int]:
    """The keep-mask as the kernels read it: rows padded with False to a
    multiple of 16 slots (16-byte asynchronous copies). Returns (mask, pitch)."""
    if mask is None:
        return None, 0
    S = mask.shape[-1]
    pitch = -(-S // 16) * 16
    if pitch != S:
        mask = torch.nn.functional.pad(mask, (0, pitch - S), value=False)
    return mask, pitch


def flash_attention(
    q: torch.Tensor,                 # (B, Hq, T, D)
    k: torch.Tensor,                 # (B, Hkv, S, D)
    v: torch.Tensor,
    prior_length,                    # int: cache slots before this call
    head_mask: Optional[torch.Tensor] = None,    # (B, Hkv, S) bool keep-mask
    q_groups: Optional[torch.Tensor] = None,
    k_groups: Optional[torch.Tensor] = None,
    *,
    sm_scale: float,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    or_span: Optional[int] = None,
    return_lse: bool = False,
):
    if q_groups is not None or k_groups is not None or or_span is not None:
        raise NotImplementedError(
            "same-image or-mask (q_groups/k_groups/or_span) belongs to the "
            "multimodal slice (ROADMAP Queue A item 15)")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, prior_length, head_mask, sm_scale=sm_scale,
                                     softcap=softcap, window=window, return_lse=return_lse)
    B, Hq, Hkv, T, S, D = _check_common(q, k, v, head_mask, torch.bfloat16, q.shape[3])
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device) if return_lse else None
    mask, pitch = padded_mask(head_mask)
    fn = _build.entry("flash")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(mask),
             out.data_ptr(), _build.ptr(lse), B, Hq, Hkv, T, S, D, int(prior_length), pitch,
             float(sm_scale), float(_opt(softcap, 0.0)), int(_opt(window, 0)),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_quant(
    q: torch.Tensor,                 # (B, Hq, T, D) bf16
    k: torch.Tensor,                 # (B, Hkv, S, D) int8 | (B, Hkv, S, D//2) uint8
    v: torch.Tensor,
    k_scales: torch.Tensor,          # (B, Hkv, S, 1) f32
    v_scales: torch.Tensor,
    prior_length,
    head_mask: Optional[torch.Tensor] = None,
    *,
    bits: int,
    sm_scale: float,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    return_lse: bool = False,
):
    """Multi-token flash attention reading the quantized cache at payload
    width; the dequantized buffer never exists."""
    if not q.is_cuda:
        return flash_attention_quant_plain(
            q, k, v, k_scales, v_scales, prior_length, head_mask, bits=bits,
            sm_scale=sm_scale, softcap=softcap, window=window, return_lse=return_lse)
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    D = q.shape[3]
    B, Hq, Hkv, T, S, D = _check_common(
        q, k, v, head_mask, torch.int8 if bits == 8 else torch.uint8,
        D if bits == 8 else D // 2)
    _check_scales(k_scales, v_scales, B, Hkv, S, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device) if return_lse else None
    mask, pitch = padded_mask(head_mask)
    fn = _build.entry("flash_quant")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scales.data_ptr(),
             v_scales.data_ptr(), _build.ptr(mask), out.data_ptr(), _build.ptr(lse),
             B, Hq, Hkv, T, S, D, bits, int(prior_length), pitch, float(sm_scale),
             float(_opt(softcap, 0.0)), int(_opt(window, 0)),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_quant")
    flash_attention_quant.launches += 1
    return (out, lse) if return_lse else out


flash_attention_quant.launches = 0


def _check_scales(k_scales, v_scales, B, Hkv, S, device):
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, Hkv, S, 1)
                or t.device != device or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous float32 {(B, Hkv, S, 1)} "
                             f"on {device}")

