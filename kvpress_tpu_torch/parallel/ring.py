"""Ring attention over a sequence sharded on the mesh's ``"seq"`` axis
(port of ``kvpress_tpu/parallel/ring.py``).

Each rank holds the queries, keys and values of its block of the sequence
(block ``i`` holds positions ``i * Sl .. (i + 1) * Sl - 1``). Every step
attends the local queries to the key/value block that is resident, then
rotates that block to the next rank (``SeqShard.rotate``, the counterpart of
``jax.lax.ppermute``); after ``N`` steps every query has seen every key. The
JAX functions take an ``axis_name`` inside ``shard_map``; these take the
rank's ``SeqShard``, and attend causally (JAX's ``causal`` is True at every
call). JAX's traced ``window_active`` flag is a host bool in the port: the
caller passes ``window`` for a sliding layer and None else.

``ring_flash_self_attention`` runs ``ops.flash.flash_attention`` (the Hopper
kernel on CUDA tensors, its plain version on CPU tensors) on each step's
block with ``prior = q_start - k_start``; blocks wholly in the future, and
on a windowed layer blocks wholly behind the window, are skipped before any
launch, and the blocks combine by their row LSE.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash import flash_attention
from .mesh import SeqShard

NEG_INF = -2.0e38


def _block_attend(q, k, v, scale: float, q_start: int, k_start: int,
                  window: Optional[int] = None):
    """One (local-q x resident-k) causal block: (unnormalised acc, row max,
    row sum), all float32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    rows = q_start + torch.arange(q.shape[2], device=q.device)[:, None]
    cols = k_start + torch.arange(k.shape[2], device=q.device)[None, :]
    allowed = cols <= rows
    if window is not None:
        allowed = allowed & (cols > rows - window)
    s = torch.where(allowed, s, torch.full((), NEG_INF, device=s.device))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()), m, p.sum(-1)


def _ring_online(q, k, v, seq: SeqShard, sm_scale: float, window):
    """The naive ring's running (m, l, acc) over every block."""
    B, Hq, Sl, D = q.shape
    G = Hq // k.shape[1]
    q_start = seq.rank * Sl
    m = torch.full((B, Hq, Sl), float("-inf"), device=q.device)
    l = torch.zeros((B, Hq, Sl), device=q.device)
    acc = torch.zeros((B, Hq, Sl, D), device=q.device)
    k_blk, v_blk = k, v
    for step in range(seq.size):
        src = (seq.rank - step) % seq.size
        blk_acc, blk_m, blk_l = _block_attend(
            q, k_blk.repeat_interleave(G, dim=1), v_blk.repeat_interleave(G, dim=1), sm_scale,
            q_start, src * Sl, window)
        m_new = torch.maximum(m, blk_m)
        alpha, beta = torch.exp(m - m_new), torch.exp(blk_m - m_new)
        l = alpha * l + beta * blk_l
        acc = alpha[..., None] * acc + beta[..., None] * blk_acc
        m = m_new
        if step + 1 < seq.size:
            k_blk, v_blk = seq.rotate(k_blk, v_blk)
    return m, l, acc


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, seq: SeqShard,
                        sm_scale: float, window: Optional[int] = None) -> torch.Tensor:
    """Causal self-attention of the local queries (B, Hq, Sl, D) over every
    rank's keys and values (B, Hkv, Sl, D), a block at a time: each block
    materializes its (B, Hq, Sl, Sl) float32 logits. ``window`` masks keys
    ``window`` or more positions behind a query (global positions)."""
    _, l, acc = _ring_online(q, k, v, seq, sm_scale, window)
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l[..., None]).to(q.dtype)


def lse_combine(out, lse, o_blk, lse_blk):
    """The running result (out (B, Hq, T, D) float32, lse (B, Hq, T)) and a
    block's (output, row LSE) of the same rows, combined by LSE weights. A
    row whose combined LSE is -inf (no visible key yet) takes weight 0 from
    both."""
    lse_new = torch.logaddexp(lse, lse_blk)
    dead = lse_new == float("-inf")
    w_old = torch.where(dead, 0.0, torch.exp(lse - lse_new))
    w_blk = torch.where(dead, 0.0, torch.exp(lse_blk - lse_new))
    return w_old[..., None] * out + w_blk[..., None] * o_blk.float(), lse_new


def ring_flash_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              seq: SeqShard, sm_scale: float, softcap: Optional[float] = None,
                              window: Optional[int] = None) -> torch.Tensor:
    """Ring attention with ``flash_attention`` on each step's block: the
    block's output and row LSE at ``prior = q_start - k_start`` (the
    diagonal shifted by whole blocks), combined by LSE weights. A block
    wholly in the future (``prior + Sl - 1 < 0``) is skipped, and with
    ``window`` so is a block whose newest key is already ``window`` or more
    positions behind the oldest query. A row with no visible key in a block
    (a windowed block's late rows) has LSE ``-inf`` from the kernel and a
    finite, very negative one from the plain version: either way its weight
    is 0. The keys and values rotate at Hkv width."""
    B, Hq, Sl, D = q.shape
    q_start = seq.rank * Sl
    out = torch.zeros((B, Hq, Sl, D), device=q.device)
    lse = torch.full((B, Hq, Sl), float("-inf"), device=q.device)
    k_blk, v_blk = k, v
    for step in range(seq.size):
        src = (seq.rank - step) % seq.size
        prior = q_start - src * Sl
        if prior + Sl - 1 >= 0 and (window is None or prior <= window + Sl - 2):
            out, lse = lse_combine(out, lse, *flash_attention(
                q, k_blk, v_blk, prior, sm_scale=sm_scale, softcap=softcap, window=window,
                return_lse=True))
        if step + 1 < seq.size:
            k_blk, v_blk = seq.rotate(k_blk, v_blk)
    return out.to(q.dtype)


def context_parallel_attention(q, k, v, mesh, *, sm_scale: Optional[float] = None,
                               impl: str = "xla"):
    """Attention of whole (B, H, S, D) tensors, the same on every rank, with
    the sequence sharded over ``mesh``'s ``"seq"`` axis: each rank runs the
    ring on its block (``impl="flash"``: ``ring_flash_self_attention``) and
    the blocks are all-gathered, so every rank returns the whole output."""
    from .mesh import gather_seq, seq_block, seq_shard

    sm_scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    ring = ring_flash_self_attention if impl == "flash" else ring_self_attention
    seq = seq_shard(mesh, q.device)
    out = ring(*(seq_block(t, mesh, dim=2) for t in (q, k, v)), seq=seq, sm_scale=sm_scale)
    return gather_seq(out, mesh, dim=2)


def ring_self_attention_lse(q, k, v, *, seq: SeqShard, sm_scale: float):
    """``ring_self_attention`` (causal) that also returns each local query's
    float32 logsumexp (B, Hq, Sl) over its whole visible range: the softmax
    denominators of KVCompose's column sweep."""
    m, l, acc = _ring_online(q, k, v, seq, sm_scale, None)
    lse = m + torch.log(l.clamp_min(1e-38))
    ls = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / ls[..., None]).to(q.dtype), lse


def ring_colagg(q, k, lse, *, seq: SeqShard, sm_scale: float, ctx_len: int, agg: str,
                block: int = 512) -> torch.Tensor:
    """KVCompose's column aggregation over the ring (the doubled-sequence
    form of ``ops.attention.refeed_colagg``): the queries and their LSE
    rotate while each rank's keys stay, so after N steps every rank holds,
    for its own columns, the max (``agg="max"``) or sum over every scoring
    query (global position >= ``ctx_len``) of exp(q.k * scale - lse). Only
    columns below ``ctx_len`` count (the others read 0). Every context
    column precedes every scoring query, so a block needs no causal test.
    Columns go ``block`` at a time. Returns (B, Hq, Sl) float32."""
    B, Hq, Sl, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    k_start = seq.rank * Sl
    out = torch.zeros((B, Hq, Sl), device=q.device)
    q_blk, lse_blk = q, lse
    bk = min(block, Sl)
    for step in range(seq.size):
        src = (seq.rank - step) % seq.size
        q_pos = src * Sl + torch.arange(Sl, device=q.device)
        scoring = (q_pos >= ctx_len)[None, None, None, :, None]
        qg = q_blk.reshape(B, Hkv, G, Sl, D).float()
        lg = lse_blk.reshape(B, Hkv, G, Sl)[..., None]
        parts = []
        for c0 in range(0, Sl, bk):
            kblk = k[:, :, c0:c0 + bk].float()
            p = torch.exp(torch.einsum("bhgtd,bhsd->bhgts", qg, kblk) * sm_scale - lg)
            cols = k_start + c0 + torch.arange(kblk.shape[2], device=q.device)
            p = torch.where(scoring & (cols < ctx_len), p, torch.zeros((), device=q.device))
            parts.append(p.amax(3) if agg == "max" else p.sum(3))
        blk_out = torch.cat(parts, dim=-1).reshape(B, Hq, Sl)
        out = torch.maximum(out, blk_out) if agg == "max" else out + blk_out
        if step + 1 < seq.size:
            q_blk, lse_blk = seq.rotate(q_blk, lse_blk)
    return out
