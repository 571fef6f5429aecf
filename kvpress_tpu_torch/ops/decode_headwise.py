"""Per-head-length decode attention (port of
``kvpress_tpu/ops/decode_headwise.py``).

After per-head compaction (``AdaKVPress(..., compact=True)``,
``presses.wrappers.compact_headwise``) each (batch, kv head) owns a live
prefix of its own length, and later appends land in a tail above the longest
prefix that every head shares. The live set of a head is two dense ranges,

    [0, prefix_len[b, h])  and  [tail_start, tail_start + tail_len),

so attention need read only those instead of the longest head's buffer for
every head. ``prefix_tail_from_mask`` derives the ranges from a keep-mask; it
is exact for masks of that shape (per-head compaction followed by appends),
and callers gate on it.

Prefix columns are visible to every query row; tail columns are causal (row
``t`` of a ``T``-token call is slot ``tail_end - T + t``). A head's live set is
the union of its two ranges: slots of the tail that its prefix already covers
count once. (The longest head's prefix absorbs the appended tokens; those
are then visible to every row, which is why the runner routes only ``T == 1``
here.) A head with nothing to read gives zeros.

On CUDA tensors ``decode_attention_headwise`` launches the hand-written Hopper
kernel (``csrc/decode_headwise.cu``), which takes the ranges as device tensors
(no host round trip), and adds one to its ``launches`` count; anything the
kernel does not take raises. On CPU tensors it runs
``decode_attention_headwise_plain``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import NEG_INF, gqa_attention
from .flash import MAX_GROUP, _opt


def prefix_tail_from_mask(mask: torch.Tensor, length):
    """(B, H, S) keep-mask and the valid length -> (prefix_lens (B, H) int32,
    tail_start () int32, tail_len () int32), all on the mask's device.

    Exact when each head's live set is a leading prefix plus the shared
    appended range [tail_start, length)."""
    S = mask.shape[-1]
    col = torch.arange(S, device=mask.device)
    m = mask & (col < length)
    first_dead = torch.argmax((~m).to(torch.int8), dim=-1)       # first dead slot
    prefix_lens = torch.where(m.all(dim=-1), length, first_dead)
    extra = m & (col >= prefix_lens[..., None])
    tail_start = torch.where(extra, col, length).min().clamp(max=length)
    return (prefix_lens.to(torch.int32), tail_start.to(torch.int32),
            (length - tail_start).to(torch.int32))


def decode_attention_headwise_plain(q, k, v, prefix_lens, tail_start, tail_len, *, sm_scale,
                                    softcap=None):
    """The plain PyTorch version of ``decode_attention_headwise``: dense
    attention over the whole buffer with the two ranges as a bias."""
    T, S = q.shape[2], k.shape[2]
    col = torch.arange(S, device=q.device)
    tail_end = tail_start + tail_len
    row_limit = tail_end - T + torch.arange(T, device=q.device)[:, None]      # (T, 1)
    in_tail = (col >= tail_start) & (col < tail_end) & (col <= row_limit)     # (T, S)
    live = (col < prefix_lens[..., None])[:, :, None, :] | in_tail            # (B, Hkv, T, S)
    bias = torch.where(live, 0.0, NEG_INF).to(torch.float32)
    out, _ = gqa_attention(q, k, v, bias, sm_scale, softcap=softcap)
    # A row with no live key: the softmax over an all-masked row is uniform.
    empty = ~live.any(dim=-1)                                                 # (B, Hkv, T)
    G = q.shape[1] // k.shape[1]
    return out.masked_fill(empty.repeat_interleave(G, dim=1)[..., None], 0.0)


def decode_attention_headwise(
    q: torch.Tensor,                 # (B, Hq, T, D) bf16, T small
    k: torch.Tensor,                 # (B, Hkv, S, D) bf16
    v: torch.Tensor,
    prefix_lens: torch.Tensor,       # (B, Hkv) int32
    tail_start: torch.Tensor,        # () int32
    tail_len: torch.Tensor,          # () int32
    *,
    sm_scale: float,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    if not q.is_cuda:
        return decode_attention_headwise_plain(q, k, v, prefix_lens, tail_start, tail_len,
                                               sm_scale=sm_scale, softcap=softcap)
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if Hq % Hkv or Hq // Hkv > MAX_GROUP or D not in (64, 128):
        raise ValueError(f"kernel takes GQA groups <= {MAX_GROUP} and head_dim 64/128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: kernel takes a bf16 cache and queries, got {t.dtype}")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, Hkv, S, D):
            raise ValueError(f"{name}: expected {(B, Hkv, S, D)}, got {tuple(t.shape)}")
    if tuple(prefix_lens.shape) != (B, Hkv) or tail_start.dim() or tail_len.dim():
        raise ValueError(f"expected prefix_lens {(B, Hkv)} and scalar tail_start, tail_len")
    tail = torch.stack([tail_start, tail_len]).to(torch.int32)
    prefix_lens = prefix_lens.to(torch.int32)
    for name, t in (("q", q), ("k", k), ("v", v), ("prefix_lens", prefix_lens), ("tail", tail)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: kernel inputs must be contiguous on {q.device}")
    out = torch.empty_like(q)
    fn = _build.entry("decode_headwise")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), prefix_lens.data_ptr(), tail.data_ptr(),
             out.data_ptr(), B, Hq, Hkv, T, S, D, float(sm_scale), float(_opt(softcap, 0.0)),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention_headwise")
    decode_attention_headwise.launches += 1
    return out


decode_attention_headwise.launches = 0
