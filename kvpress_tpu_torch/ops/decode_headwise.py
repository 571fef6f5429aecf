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
(no host round trip), and adds one to its ``launches`` count (and to
``launches_by_kind``, by head_dim); anything the
kernel does not take raises. The kernel lays each head's live set out as a
list of steps and cuts it into ``decode_splits`` chunks of a length fixed by
S, one block each, merged in a second kernel of the same launch;
``decode_attention_headwise_split_plain`` is the plain version of that
arithmetic. On CPU tensors it runs ``decode_attention_headwise_plain``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, decode
from .attention import NEG_INF, gqa_attention
from .decode import MAX_SPLITS, step_keys
from .flash import (MAX_GROUP, _check_scale, _opt, _split_scratch, check_head_dim,
                    launch_counts, merge_key_ranges)


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


def headwise_chunks(prefix_lens, tail_start, tail_len, S: int, block: int, splits: int):
    """(B, Hkv, S) int64: the chunk of a split launch that reads each slot,
    -1 where the slot is not in its head's live set. A head's steps are its
    prefix steps of ``block`` keys, then its tail steps from the first tail
    slot the prefix does not cover; chunks are runs of
    ``ceil((ceil(S / block) + 1) / splits)`` steps."""
    col = torch.arange(S, device=prefix_lens.device)
    pl = prefix_lens.clamp(max=S).to(torch.int64)[..., None]
    tail_end = torch.clamp(tail_start + tail_len, max=S).to(torch.int64)
    tail_lo = torch.maximum(tail_start.to(torch.int64), pl)
    n_pref = -(-pl // block)
    step = torch.where(col < pl, col // block,
                       torch.where((col >= tail_lo) & (col < tail_end),
                                   n_pref + (col - tail_lo) // block, -1))
    per = -(-(-(-S // block) + 1) // splits)
    return torch.where(step >= 0, step // per, -1)


def decode_attention_headwise_split_plain(q, k, v, prefix_lens, tail_start, tail_len, *,
                                          splits, sm_scale, softcap=None):
    """The plain PyTorch version of ``decode_attention_headwise`` launched over
    ``splits`` chunks (``headwise_chunks``): a partial softmax over each
    chunk's slots, merged in chunk order with ``flash.merge_key_ranges``."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    col = torch.arange(S, device=q.device)
    tail_end = tail_start + tail_len
    row_limit = tail_end - T + torch.arange(T, device=q.device)[:, None]      # (T, 1)
    in_tail = (col >= tail_start) & (col < tail_end) & (col <= row_limit)     # (T, S)
    live = (col < prefix_lens[..., None])[:, :, None, :] | in_tail            # (B, Hkv, T, S)
    logits = torch.einsum("bhgtd,bhsd->bhgts", q.reshape(B, Hkv, G, T, D).float(),
                          k.float()) * sm_scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    chunk = headwise_chunks(prefix_lens, tail_start, tail_len, S, step_keys(D, None), splits)
    parts = []
    for i in range(splits):
        x = logits.masked_fill(~(live & (chunk == i)[:, :, None])[:, :, None], float("-inf"))
        m = x.amax(-1)
        safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp(x - safe[..., None])
        parts.append((torch.einsum("bhgts,bhsd->bhgtd", p, v.float()), m, p.sum(-1)))
    out, _ = merge_key_ranges(*(torch.stack(t) for t in zip(*parts)))
    return out.reshape(B, Hq, T, D).to(q.dtype)


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
    """A head's live set is cut into ``decode.decode_splits`` chunks, counted
    over the whole buffer (the tests and ``tools/decode_sweep.py`` substitute
    that function to reach the edges of the merge)."""
    if not q.is_cuda:
        return decode_attention_headwise_plain(q, k, v, prefix_lens, tail_start, tail_len,
                                               sm_scale=sm_scale, softcap=softcap)
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"kernel takes GQA groups <= {MAX_GROUP}")
    check_head_dim(D)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: kernel takes a bf16 cache and queries, got {t.dtype}")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, Hkv, S, D):
            raise ValueError(f"{name}: expected {(B, Hkv, S, D)}, got {tuple(t.shape)}")
    _check_scale(sm_scale)
    if tuple(prefix_lens.shape) != (B, Hkv) or tail_start.dim() or tail_len.dim():
        raise ValueError(f"expected prefix_lens {(B, Hkv)} and scalar tail_start, tail_len")
    tail = torch.stack([tail_start, tail_len]).to(torch.int32)
    prefix_lens = prefix_lens.to(torch.int32)
    for name, t in (("q", q), ("k", k), ("v", v), ("prefix_lens", prefix_lens), ("tail", tail)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: kernel inputs must be contiguous on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: kernel inputs must start on a 16-byte boundary")
    splits = decode.decode_splits(B, Hkv, Hq // Hkv, T, S, D, S, step_keys(D, None))
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits must be 1..{MAX_SPLITS}, got {splits}")
    part_o, part_ml = _split_scratch(q, splits)
    out = torch.empty_like(q)
    fn = _build.entry("decode_headwise")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), prefix_lens.data_ptr(), tail.data_ptr(),
             out.data_ptr(), _build.ptr(part_o), _build.ptr(part_ml), B, Hq, Hkv, T, S, D,
             splits, float(sm_scale), float(_opt(softcap, 0.0)),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention_headwise")
    decode_attention_headwise.launches += 1
    decode_attention_headwise.launches_by_kind[D, "bf16"] += 1
    return out


decode_attention_headwise.launches = 0
decode_attention_headwise.launches_by_kind = launch_counts("bf16")
