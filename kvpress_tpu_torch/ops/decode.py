"""Few-token decode attention (port of ``kvpress_tpu/ops/decode.py``).

Query row ``r`` of a call with ``T`` new tokens attends slot ``s`` iff
``s <= (length - T) + r`` and the keep-mask bit of ``s`` is set (optional
slot-space window and logit softcap). The cache may be bf16, int8 or packed
int4 (``cache.quantize_kv`` layout) with per-token scales.

On a CUDA tensor ``decode_attention`` launches the hand-written Hopper kernel
(``csrc/decode.cu``) and adds one to ``decode_attention.launches`` and to the
instantiation's entry of ``decode_attention.launches_by_kind``. The
kernel splits the key range of each kv head over ``decode_splits`` blocks
(from the shapes alone), each of which finds the live steps of its own range
in the keep-mask and reads only those, at payload width; a second kernel of
the same launch merges the ranges in a fixed order. On a CPU tensor it runs
``decode_attention_plain``, built on ops/attention.py;
``decode_attention_split_plain`` is the plain version of a split launch's
arithmetic. ``live_block_table`` is the port of the JAX function; the kernel
builds its own list of live steps.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import (NEG_INF, attention_bias, gqa_attention, quant_gqa_attention,
                        quant_pv_out, quant_qk_logits)
from .flash import (MAX_GROUP, _check_scale, _check_scales, _opt, _split_merge, _split_scratch,
                    check_head_dim, launch_counts)

BLOCK_K_UNIT = 256     # block_k must be a multiple of this (the JAX kernel's contract)
TARGET_BLOCKS = 256    # about two blocks for each of an H100's 132 SMs
# Steps a key range holds at least: the kernel's ring depth (decode_sm90.cuh
# Stages::STAGES; a bf16 ring at head_dim 256 has 3 stages and splits as if it had 4).
RING_STAGES = 4
MAX_SPLITS = 64


def step_keys(head_dim: int, bits: Optional[int]) -> int:
    """Keys of one step of the kernels (decode_sm90.cuh step_keys): 8 KB of
    K payload in whole 64-key steps, at least 64 (head_dim 96: 64, 64 and
    128 for bf16, int8 and int4)."""
    row = {None: 2 * head_dim, 8: head_dim, 4: head_dim // 2}[bits]
    return max(64, 8192 // row // 64 * 64)


def decode_splits(B: int, Hkv: int, G: int, T: int, S: int, D: int, length: int,
                  block: int) -> int:
    """Blocks that share the key range of one (16-row group, kv head, batch
    row): enough for about TARGET_BLOCKS blocks in all, at most one for every
    RING_STAGES steps of ``block`` keys below ``min(length, S)`` (a block
    walks at least a ring's worth), at most MAX_SPLITS. Shapes alone: the
    keep-mask's contents never change the launch."""
    blocks = -(-(G * T) // 16) * Hkv * B
    steps = -(-min(length, S) // block)
    return max(1, min(-(-TARGET_BLOCKS // blocks), steps // RING_STAGES, MAX_SPLITS))


def decode_key_ranges(length: int, T: int, window: Optional[int], block: int,
                      splits: int) -> list[tuple[int, int]]:
    """The (lo, hi) slot ranges of a split decode launch: steps of ``block``
    keys from the first slot any query row can see (a window starts it late)
    up to ``length``, cut into ``splits`` runs of whole steps."""
    first = max(0, length - T - window + 1) // block * block if window else 0
    per = -(-(-(-(length - first) // block)) // splits) * block
    return [(min(length, first + i * per), min(length, first + (i + 1) * per))
            for i in range(splits)]


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


def decode_attention_split_plain(q, k, v, length, k_scales=None, v_scales=None, mask=None, *,
                                 bits=None, splits, sm_scale, softcap=None, window=None):
    """The plain PyTorch version of ``decode_attention`` launched over
    ``splits`` key ranges (``decode_key_ranges``): a partial softmax over each
    range, merged in range order with ``flash.merge_key_ranges``. A row that
    meets no live key gives 0."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    length = int(length)
    bias = attention_bias(length - T, T, S, sliding_window=window, head_mask=mask,
                          device=q.device)
    bias = bias.masked_fill(torch.arange(S, device=q.device) >= length, NEG_INF)
    if bits is None:
        logits = torch.einsum("bhgtd,bhsd->bhgts", q.reshape(B, Hkv, G, T, D).float(),
                              k.float())

        def pv(p, lo, hi):
            return torch.einsum("bhgts,bhsd->bhgtd", p, v[:, :, lo:hi].float())
    else:
        logits = quant_qk_logits(q.reshape(B, Hkv, G * T, D), k, k_scales, bits)
        logits = logits.reshape(B, Hkv, G, T, S)

        def pv(p, lo, hi):
            return quant_pv_out(p.reshape(B, Hkv, G * T, hi - lo), v[:, :, lo:hi],
                                v_scales[:, :, lo:hi], bits, torch.float32
                                ).reshape(B, Hkv, G, T, D)
    logits = logits * sm_scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    ranges = decode_key_ranges(length, T, window, step_keys(D, bits), splits)
    out, _ = _split_merge(logits, bias, pv, ranges)
    return out.reshape(B, Hq, T, D).to(q.dtype)


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
    block_k: int = 2048,
) -> torch.Tensor:
    """``block_k`` (a multiple of 256) is the tile of the JAX kernel's
    live-tile table, kept so that the signature and ``Runner.decode_block_k``
    match the JAX package's. The Hopper kernel does not read it: it skips
    dead keys at the grain of its own steps (``step_keys``: 64 to 256 keys),
    which no larger tile can beat. The launch takes ``decode_splits`` key
    ranges (the tests and ``tools/decode_sweep.py`` substitute that function
    to reach the edges of the merge)."""
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, length, k_scales, v_scales, mask, bits=bits,
                                      sm_scale=sm_scale, softcap=softcap, window=window)
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    length = int(length)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"kernel takes bf16 queries, got {q.dtype}")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"kernel takes GQA groups <= {MAX_GROUP}")
    check_head_dim(D)
    if block_k % BLOCK_K_UNIT:
        raise ValueError(f"block_k must be a multiple of {BLOCK_K_UNIT}, got {block_k}")
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
    _check_scale(sm_scale)

    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: kernel inputs must start on a 16-byte boundary")
    splits = decode_splits(B, Hkv, Hq // Hkv, T, S, D, length, step_keys(D, bits))
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits must be 1..{MAX_SPLITS}, got {splits}")
    part_o, part_ml = _split_scratch(q, splits)
    out = torch.empty_like(q)
    fn = _build.entry("decode")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(k_scales),
             _build.ptr(v_scales), _build.ptr(mask), out.data_ptr(), _build.ptr(part_o),
             _build.ptr(part_ml), B, Hq, Hkv, T, S, D, _opt(bits, 0), length, splits,
             float(sm_scale), float(_opt(softcap, 0.0)), int(_opt(window, 0)),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    decode_attention.launches_by_kind[D, "bf16" if bits is None else f"int{bits}"] += 1
    decode_attention.launches_windowed += bool(window)     # among those counted
    return out


decode_attention.launches = 0
decode_attention.launches_by_kind = launch_counts("bf16", "int8", "int4")
decode_attention.launches_windowed = 0
