"""Multi-token attention kernels (port of ``kvpress_tpu/ops/flash.py``).

``flash_attention`` and ``flash_attention_quant`` keep the Pallas kernels'
contract: query ``i`` of the call attends cache slot ``s`` iff
``s <= prior_length + i``, the ``(B, Hkv, S)`` keep-mask bit of ``s`` is set
and, with ``window``, ``s > prior_length + i - window``; optional logit
softcap and float32 logsumexp. ``flash_attention`` also takes the
same-image or-mask (Gemma3 multimodal prefill): with ``or_span``, query ``i``
also attends slot ``s`` when ``q_groups[b, i] >= 0`` and equals
``k_groups[b, s]``, whatever the causal order and the window; the keep-bit
still applies. ``or_span`` bounds an image span's length: the kernel widens
each q-tile's key range by ``or_span - 1`` slots on both sides.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``csrc/flash.cu``, ``csrc/flash_quant.cu``: one wgmma main loop,
``csrc/flash_sm90.cuh``) and adds one to its ``launches`` count and to the
instantiation's entry of ``launches_by_kind``; anything the kernel does not
take raises. On a CPU tensor it runs the plain PyTorch
version beside it (``*_plain``), built on ops/attention.py. There is no
fall-back from one to the other.

A launch with too few q-tiles to fill the card splits the key range of each
q-tile over ``flash_splits`` blocks and merges the ranges in a second kernel
of the same call. The split count depends on the shapes alone; the
``*_split_plain`` functions are the plain version of that arithmetic.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import (NEG_INF, attention_bias, gqa_attention, quant_gqa_attention,
                        quant_pv_out, quant_qk_logits)

MAX_GROUP = 8        # query heads per kv head the kernels' block geometry takes
HEAD_DIMS = (64, 96, 128, 256)   # head_dims the five kernels are instantiated for
BLOCK_ROWS = 128     # (head, time) rows of a kernel block: G heads by 128 // G positions
TARGET_BLOCKS = 264  # two blocks for each of an H100's 132 SMs
MAX_SPLITS = 16


def launch_counts(*kinds: str) -> dict:
    """A wrapper's launches by kernel instantiation, keyed ``(head_dim,
    kind)``: ``kind`` is the payload ("bf16", "int8", "int4") or the or-mask
    branch ("or_mask")."""
    return {(d, kind): 0 for d in HEAD_DIMS for kind in kinds}


def key_tile(head_dim: int) -> int:
    """Keys of one K/V tile of the kernels' shared-memory ring: 16 KB of bf16
    keys laid out in whole 64-channel panels (128, 64, 64 and 32 at head_dim
    64, 96, 128 and 256: 96 takes 128's two panels; csrc/flash_sm90.cuh)."""
    return 8192 // (-(-head_dim // 64) * 64)


def flash_splits(B: int, Hkv: int, G: int, T: int, S: int, D: int, prior: int,
                 window: Optional[int] = None, or_span: Optional[int] = None) -> int:
    """Blocks that share the key range of one q-tile. 1 when the q-tiles
    alone give every SM about two blocks; else enough to get there, at most
    one per key tile of the last q-tile and at most MAX_SPLITS. The last
    q-tile's key range is the kernel's: with ``or_span`` it reaches
    ``or_span - 1`` slots past the causal end and starts
    ``max(window - 1, or_span - 1)`` slots behind the tile's first query."""
    bq = BLOCK_ROWS // G
    q_tiles = -(-T // bq)
    blocks = q_tiles * Hkv * B
    if blocks >= TARGET_BLOCKS:
        return 1
    nk = key_tile(D)
    reach = or_span - 1 if or_span else 0
    back = max(window - 1, reach) if window else 0
    first = max(0, prior + (q_tiles - 1) * bq - back) // nk * nk if window else 0
    tiles = -(-(min(S, prior + T + reach) - first) // nk)
    return max(1, min(-(-TARGET_BLOCKS // blocks), tiles, MAX_SPLITS))


def same_image(q_groups: torch.Tensor, k_groups: torch.Tensor) -> torch.Tensor:
    """(B, T, S) bool or-mask: query t and slot s lie in one image (equal
    group ids, and the query's id is not -1, the id of text)."""
    gq = q_groups[:, :, None]
    return (gq >= 0) & (gq == k_groups[:, None, :])


def _has_or_mask(q_groups, k_groups, or_span) -> bool:
    """Whether a call carries the or-mask. The groups and the span come
    together, as the Pallas kernel takes them."""
    if or_span is None:
        if q_groups is not None or k_groups is not None:
            raise ValueError("q_groups/k_groups need or_span (the longest image span)")
        return False
    if q_groups is None or k_groups is None:
        raise ValueError("or_span needs q_groups and k_groups")
    if or_span < 1:
        raise ValueError(f"or_span must be positive, got {or_span}")
    return True


def _or_allow(q_groups, k_groups, or_span):
    """The (B, T, S) or-mask of a call, or None without one."""
    return same_image(q_groups, k_groups) if _has_or_mask(q_groups, k_groups, or_span) else None


def _lse_from_logits(logits: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    # logits (B, Hkv, G, T, S) scaled; returns (B, Hq, T)
    logits = logits + (bias[None, None, None] if bias.dim() == 2 else bias[:, :, None])
    B, Hkv, G, T, _ = logits.shape
    return torch.logsumexp(logits, dim=-1).reshape(B, Hkv * G, T)


def flash_attention_plain(q, k, v, prior_length, head_mask=None, q_groups=None,
                          k_groups=None, *, sm_scale, softcap=None, window=None,
                          or_span=None, return_lse=False):
    """The plain PyTorch version of ``flash_attention``."""
    T, S = q.shape[2], k.shape[2]
    bias = attention_bias(int(prior_length), T, S, sliding_window=window,
                          head_mask=head_mask, device=q.device,
                          extra_allow=_or_allow(q_groups, k_groups, or_span))
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


def merge_key_ranges(part_o, part_m, part_l):
    """The merge of a split launch. ``part_o`` (n, ..., D) holds each key
    range's unnormalised float32 output, ``part_m`` and ``part_l`` (n, ...)
    its row max (-inf for a range without a live key) and row sum. Ranges are
    summed in index order. Returns (out (..., D), lse (...))."""
    m = part_m.amax(0)
    safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    w = torch.exp(part_m - safe)
    l = (w * part_l).sum(0)
    o = (w[..., None] * part_o).sum(0)
    out = o / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    lse = torch.where(l > 0, safe + torch.log(l.clamp_min(1e-38)),
                      torch.full_like(l, float("-inf")))
    return out, lse


def key_ranges(S: int, nk: int, splits: int) -> list[tuple[int, int]]:
    """The (lo, hi) slot ranges of a split flash launch: the key tiles of
    ``nk`` keys cut into ``splits`` contiguous runs."""
    per = -(-(-(-S // nk)) // splits) * nk
    return [(min(S, i * per), min(S, i * per + per)) for i in range(splits)]


def _split_merge(logits, bias, pv, ranges):
    """Attention from biased logits (B, Hkv, G, T, S) as a split launch takes
    it: a partial softmax over each (lo, hi) slot range of ``ranges``
    (``pv(p, lo, hi)`` multiplies the unnormalised probabilities of keys
    lo..hi-1 into the values), then the merge. Returns (out (B, Hkv, G, T, D)
    float32, lse (B, Hkv, G, T))."""
    allowed = (bias > NEG_INF / 2)
    allowed = allowed[None, None, None] if bias.dim() == 2 else allowed[:, :, None]
    neg = torch.full((), float("-inf"), dtype=torch.float32, device=logits.device)
    parts = []
    for lo, hi in ranges:
        x = torch.where(allowed[..., lo:hi], logits[..., lo:hi], neg)
        m = x.amax(-1) if hi > lo else torch.full(logits.shape[:-1], float("-inf"),
                                                  device=logits.device)
        safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp(x - safe[..., None])
        parts.append((pv(p, lo, hi), m, p.sum(-1)))
    return merge_key_ranges(*(torch.stack(t) for t in zip(*parts)))


def flash_attention_split_plain(q, k, v, prior_length, head_mask=None, q_groups=None,
                                k_groups=None, *, splits, sm_scale, softcap=None, window=None,
                                or_span=None, return_lse=False):
    """The plain PyTorch version of ``flash_attention`` launched over
    ``splits`` key ranges."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    bias = attention_bias(int(prior_length), T, S, sliding_window=window,
                          head_mask=head_mask, device=q.device,
                          extra_allow=_or_allow(q_groups, k_groups, or_span))
    logits = torch.einsum("bhgtd,bhsd->bhgts",
                          q.reshape(B, Hkv, Hq // Hkv, T, D).float(), k.float()) * sm_scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    out, lse = _split_merge(
        logits, bias,
        lambda p, lo, hi: torch.einsum("bhgts,bhsd->bhgtd", p, v[:, :, lo:hi].float()),
        key_ranges(S, key_tile(D), splits))
    out = out.reshape(B, Hq, T, D).to(q.dtype)
    return (out, lse.reshape(B, Hq, T)) if return_lse else out


def flash_attention_quant_split_plain(q, k, v, k_scales, v_scales, prior_length,
                                      head_mask=None, *, bits, splits, sm_scale,
                                      softcap=None, window=None, return_lse=False):
    """The plain PyTorch version of ``flash_attention_quant`` launched over
    ``splits`` key ranges."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    bias = attention_bias(int(prior_length), T, S, sliding_window=window,
                          head_mask=head_mask, device=q.device)
    logits = quant_qk_logits(q.reshape(B, Hkv, G * T, D), k, k_scales, bits)
    logits = logits.reshape(B, Hkv, G, T, S) * sm_scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap

    def pv(p, lo, hi):
        return quant_pv_out(p.reshape(B, Hkv, G * T, hi - lo), v[:, :, lo:hi],
                            v_scales[:, :, lo:hi], bits, torch.float32
                            ).reshape(B, Hkv, G, T, D)

    out, lse = _split_merge(logits, bias, pv, key_ranges(S, key_tile(D), splits))
    out = out.reshape(B, Hq, T, D).to(q.dtype)
    return (out, lse.reshape(B, Hq, T)) if return_lse else out


def _check_common(q, k, v, head_mask, payload_dtype, payload_d):
    B, Hq, T, D = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"kernel takes bf16 queries, got {q.dtype}")
    if k.dim() != 4 or k.shape[0] != B or Hq % k.shape[1]:
        raise ValueError(f"bad key shape {tuple(k.shape)} for queries {tuple(q.shape)}")
    Hkv, S = k.shape[1], k.shape[2]
    if Hq // Hkv > MAX_GROUP:
        raise ValueError(f"kernel takes at most {MAX_GROUP} query heads per kv head")
    check_head_dim(D)
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


def check_head_dim(D: int) -> None:
    """Raise on a head_dim the kernels are not instantiated for: one that no
    architecture of the package uses."""
    if D not in HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim {HEAD_DIMS}, got {D}")


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


def _split_scratch(q, splits):
    """(splits, B, Hq, T, D) and (splits, B, Hq, T, 2) float32 scratch of a
    split launch (each range's output; its row max and sum), or no scratch."""
    if splits == 1:
        return None, None
    return (torch.empty((splits, *q.shape), dtype=torch.float32, device=q.device),
            torch.empty((splits, *q.shape[:3], 2), dtype=torch.float32, device=q.device))


def flash_attention(
    q: torch.Tensor,                 # (B, Hq, T, D)
    k: torch.Tensor,                 # (B, Hkv, S, D)
    v: torch.Tensor,
    prior_length,                    # int: cache slots before this call
    head_mask: Optional[torch.Tensor] = None,    # (B, Hkv, S) bool keep-mask
    q_groups: Optional[torch.Tensor] = None,     # (B, T) int32 image ids, -1 for text
    k_groups: Optional[torch.Tensor] = None,     # (B, S) int32, slot-aligned
    *,
    sm_scale: float,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    or_span: Optional[int] = None,               # the longest image span (tokens)
    return_lse: bool = False,
):
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, prior_length, head_mask, q_groups, k_groups,
                                     sm_scale=sm_scale, softcap=softcap, window=window,
                                     or_span=or_span, return_lse=return_lse)
    B, Hq, Hkv, T, S, D = _check_common(q, k, v, head_mask, torch.bfloat16, q.shape[3])
    _check_scale(sm_scale)
    qg, kg, kg_pitch = _check_groups(q_groups, k_groups, or_span, B, T, S, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device) if return_lse else None
    mask, pitch = padded_mask(head_mask)
    splits = flash_splits(B, Hkv, Hq // Hkv, T, S, D, int(prior_length), window, or_span)
    part_o, part_ml = _split_scratch(q, splits)
    fn = _build.entry("flash")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(mask),
             _build.ptr(qg), _build.ptr(kg),
             out.data_ptr(), _build.ptr(lse), _build.ptr(part_o), _build.ptr(part_ml),
             B, Hq, Hkv, T, S, D, int(prior_length), pitch, kg_pitch, int(_opt(or_span, 0)),
             splits, float(sm_scale), float(_opt(softcap, 0.0)), int(_opt(window, 0)),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.launches_by_kind[D, "bf16" if or_span is None else "or_mask"] += 1
    flash_attention.launches_windowed += bool(window)     # among those counted
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.launches_by_kind = launch_counts("bf16", "or_mask")
flash_attention.launches_windowed = 0


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
    _check_scale(sm_scale)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device) if return_lse else None
    mask, pitch = padded_mask(head_mask)
    splits = flash_splits(B, Hkv, Hq // Hkv, T, S, D, int(prior_length), window)
    part_o, part_ml = _split_scratch(q, splits)
    fn = _build.entry("flash_quant")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scales.data_ptr(),
             v_scales.data_ptr(), _build.ptr(mask), out.data_ptr(), _build.ptr(lse),
             _build.ptr(part_o), _build.ptr(part_ml),
             B, Hq, Hkv, T, S, D, bits, int(prior_length), pitch, splits, float(sm_scale),
             float(_opt(softcap, 0.0)), int(_opt(window, 0)),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_quant")
    flash_attention_quant.launches += 1
    flash_attention_quant.launches_by_kind[D, f"int{bits}"] += 1
    return (out, lse) if return_lse else out


flash_attention_quant.launches = 0
flash_attention_quant.launches_by_kind = launch_counts("int8", "int4")


def _check_scale(sm_scale):
    # The kernels fold sm_scale into the exponent and take the row max of the
    # raw products, which needs a positive scale.
    if not sm_scale > 0:
        raise ValueError(f"kernel takes a positive sm_scale, got {sm_scale}")


def _check_groups(q_groups, k_groups, or_span, B, T, S, device):
    """The group ids as the kernel reads them: q_groups (B, T) int32, and
    k_groups (B, pitch) int32 padded with -1 to a multiple of 16 slots, on a
    16-byte boundary (its tiles are copied 16 bytes at a time). Returns (qg,
    kg, pitch); all None and 0 without an or-mask."""
    if not _has_or_mask(q_groups, k_groups, or_span):
        return None, None, 0
    for name, t, shape in (("q_groups", q_groups, (B, T)), ("k_groups", k_groups, (B, S))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous int32 {shape} on {device}")
    pitch = -(-S // 16) * 16
    kg = k_groups
    if pitch != S or kg.data_ptr() % 16:
        kg = torch.full((B, pitch), -1, dtype=torch.int32, device=device)
        kg[:, :S] = k_groups
    return q_groups, kg, pitch


def _check_scales(k_scales, v_scales, B, Hkv, S, device):
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, Hkv, S, 1)
                or t.device != device or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous float32 {(B, Hkv, S, 1)} "
                             f"on {device}")

