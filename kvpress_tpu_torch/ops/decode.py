"""Few-token decode attention (port of ``kvpress_tpu/ops/decode.py``).

Query row ``r`` of a call with ``T`` new tokens attends slot ``s`` iff
``s <= (length - T) + r`` and the keep-mask bit of ``s`` is set (optional
slot-space window and logit softcap). The cache may be bf16, int8 or packed
int4 (``cache.quantize_kv`` layout) with per-token scales.

On a CUDA tensor ``decode_attention`` launches the hand-written Hopper kernel
(``csrc/decode.cu``), which walks only the live tiles of ``live_block_table``
at payload width, and adds one to ``decode_attention.launches``. On a CPU
tensor it runs ``decode_attention_plain``, built on ops/attention.py.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import NEG_INF, attention_bias, gqa_attention, quant_gqa_attention
from .flash import MAX_GROUP, _check_scales, _opt

KERNEL_KEYS = 256      # keys per step of the kernel's block (decode.cu DEC_KEYS)


def live_block_table(
    mask: Optional[torch.Tensor],    # (B, H, S) keep-bits or None
    length: int,                     # valid slots
    B: int,
    H: int,
    S: int,
    block_k: int,
    device: torch.device | str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(table (B, H, nb) int32: live tile indices, front-compacted;
    count (B, H) int32). A tile is live if it holds a slot < length whose
    keep-bit is set. S must be a multiple of block_k."""
    nb = S // block_k
    if mask is None:
        count = torch.full((B, H), (length + block_k - 1) // block_k, dtype=torch.int32,
                           device=device)
        table = torch.arange(nb, dtype=torch.int32, device=device).expand(B, H, nb)
        return table.contiguous(), count
    device = mask.device
    slot_live = mask & (torch.arange(S, device=device)[None, None] < length)
    blk_live = slot_live.reshape(B, H, nb, block_k).any(-1)
    table = torch.argsort((~blk_live).to(torch.int8), dim=-1, stable=True).to(torch.int32)
    count = blk_live.sum(-1).to(torch.int32)
    return table, count


def decode_attention_plain(q, k, v, length, k_scales=None, v_scales=None, mask=None, *,
                           bits=None, sm_scale, softcap=None, window=None):
    """The plain PyTorch version of ``decode_attention``: dense attention over
    the whole buffer with causality, validity and keep-mask as a bias."""
    T, S = q.shape[2], k.shape[2]
    length = int(length)
    bias = attention_bias(length - T, T, S, sliding_window=window, head_mask=mask,
                          device=q.device)
    dead = torch.arange(S, device=q.device) >= length
    bias = bias.masked_fill(dead, NEG_INF)
    if bits is None:
        out, _ = gqa_attention(q, k, v, bias, sm_scale, softcap=softcap)
        return out
    return quant_gqa_attention(q, k, v, k_scales, v_scales, bias, sm_scale, bits,
                               softcap=softcap)


def decode_attention(
    q: torch.Tensor,                     # (B, Hq, T, D) bf16, T small
    k: torch.Tensor,                     # (B, Hkv, S, D) bf16/int8 | (..., D//2) uint8
    v: torch.Tensor,
    length,                              # int: valid slots incl. the new T
    k_scales: Optional[torch.Tensor] = None,   # (B, Hkv, S, 1) f32 if quantized
    v_scales: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,       # (B, Hkv, S) keep-bits
    *,
    bits: Optional[int] = None,          # None = bf16 payload, 8 / 4 = quantized
    sm_scale: float,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    block_k: int = 2048,                 # live-table tile (a multiple of 256)
) -> torch.Tensor:
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, length, k_scales, v_scales, mask, bits=bits,
                                      sm_scale=sm_scale, softcap=softcap, window=window)
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    length = int(length)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"kernel takes bf16 queries, got {q.dtype}")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP or D not in (64, 128):
        raise ValueError(f"kernel takes GQA groups <= {MAX_GROUP} and head_dim 64/128")
    if block_k % KERNEL_KEYS:
        raise ValueError(f"block_k must be a multiple of {KERNEL_KEYS}, got {block_k}")
    if not T <= length <= S:
        raise ValueError(f"need T <= length <= S, got T={T} length={length} S={S}")
    payload = {None: (torch.bfloat16, D), 8: (torch.int8, D), 4: (torch.uint8, D // 2)}
    if bits not in payload:
        raise ValueError(f"bits must be None, 8 or 4, got {bits}")
    dtype, pd = payload[bits]
    for name, t in (("q", q), ("k", k), ("v", v), ("mask", mask)):
        if t is None:
            continue
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: kernel inputs must be contiguous on {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != dtype or tuple(t.shape) != (B, Hkv, S, pd):
            raise ValueError(f"{name}: expected {dtype} {(B, Hkv, S, pd)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if mask is not None and (mask.dtype != torch.bool or tuple(mask.shape) != (B, Hkv, S)):
        raise ValueError(f"mask: expected bool {(B, Hkv, S)}")
    if bits is not None:
        _check_scales(k_scales, v_scales, B, Hkv, S, q.device)

    bk = min(block_k, -(-S // KERNEL_KEYS) * KERNEL_KEYS)
    nb = -(-S // bk)
    table_mask = None
    if mask is not None:
        table_mask = torch.nn.functional.pad(mask, (0, nb * bk - S), value=False)
    table, count = live_block_table(table_mask, length, B, Hkv, nb * bk, bk, q.device)
    out = torch.empty_like(q)
    fn = _build.entry("decode")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(k_scales),
             _build.ptr(v_scales), _build.ptr(table_mask), table.data_ptr(), count.data_ptr(),
             out.data_ptr(), B, Hq, Hkv, T, S, D, _opt(bits, 0), length, bk, nb, nb * bk,
             float(sm_scale), float(_opt(softcap, 0.0)), int(_opt(window, 0)),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
