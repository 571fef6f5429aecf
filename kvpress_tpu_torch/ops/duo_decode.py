"""Split-cache decode for DuoAttention's head-static eviction (port of
``kvpress_tpu/ops/duo_decode.py``).

A Duo cache keeps, per (layer, kv head), either every slot (a retrieval
head) or only sink + recent (a streaming head); the masked decode still
reads the middle of every streaming head through its keep-mask. The split
puts each class in its own dense buffer,

  retrieval  (L, B, Hr_max, S_r, D): appends at len_r
  streaming  (L, B, Hs_max, sink + recent + room, D): appends at len_s

and runs each layer's attention twice, once a buffer, through
``ops.decode.decode_attention`` (the Hopper decode kernel on the card, its
plain version on the CPU). Every slot below each buffer's length is live, so
neither launch takes a mask. The outputs go back to kv-head order through a
per-layer inverse permutation. Head counts differ per layer (Duo prunes the
lowest scores over all layers and heads), so the head-index arrays are padded
to the largest count; padded lanes attend a copy of head 0, and the inverse
permutation never gathers them. The keep-set is fixed at the prefill and
new tokens are visible to every head, as in the masked decode. bf16 (or
float32 on the CPU) buffers only; sliding-window models are refused (their
window layers already keep a windowed buffer).

On a sharded runner (tensor parallelism) a rank splits its own kv heads by
its columns of the global pattern (``build_duo_split(..., shard=)``) and
the step all-reduces and gathers the logits as ``Runner`` does. Neither
buffer is ever empty: the streaming one is padded to at least one head, and
the retrieval one is as wide as the kv heads (``Hkv - n_s.min(initial=0)``,
as the JAX package computes it), so a rank holding no retrieval head still
makes both launches a layer."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cache import KVCache, clamp_start
from ..presses.base import local_heads
from .decode import decode_attention


@dataclasses.dataclass
class DuoSplitCache:
    keys_r: torch.Tensor          # (L, B, Hr_max, S_r, D)
    values_r: torch.Tensor
    keys_s: torch.Tensor          # (L, B, Hs_max, S_s, D)
    values_s: torch.Tensor
    len_r: torch.Tensor           # (L,) int32, host: valid slots of the retrieval buffers
    len_s: torch.Tensor           # (L,) int32, host
    retr_idx: torch.Tensor        # (L, Hr_max) int64 kv-head ids (padded with 0)
    stream_idx: torch.Tensor      # (L, Hs_max) int64
    inv_idx: torch.Tensor         # (L, Hkv) int64 rows of concat(retrieval, streaming)
    offset: torch.Tensor          # () int32, host: position of the next token


def build_duo_split(cache: KVCache, streaming_mask: np.ndarray, sink: int, recent: int,
                    room: int, *, shard=None) -> DuoSplitCache:
    """Split a prefill cache whose keep-mask Duo set into the two buffers.
    ``streaming_mask`` is the press's (L, Hkv) bool
    (``DuoAttentionPress.streaming_mask()``); ``room`` reserves the append
    slots of decode in both buffers. ``shard``: the sharded runner's
    ``ModelShard``, whose rank's cache holds its own kv heads; the rank
    takes their columns of the global ``streaming_mask``."""
    if cache.is_quantized:
        raise ValueError("build_duo_split takes a bf16 cache (the split buffers are not "
                         "quantized)")
    L, B, Hkv, S, D = cache.keys.shape
    sm = np.asarray(streaming_mask, bool)[:, local_heads(shard, Hkv)]
    if S < sink + recent:
        raise ValueError(f"buffer ({S}) smaller than sink+recent ({sink}+{recent}): a split "
                         "cache cannot hold the streaming window; use the masked decode")
    n_s = sm.sum(axis=1)
    hs_max = int(n_s.max(initial=0))
    hr_max = Hkv - int(n_s.min(initial=0))
    retr_idx = np.zeros((L, hr_max), np.int64)
    stream_idx = np.zeros((L, max(hs_max, 1)), np.int64)
    inv_idx = np.zeros((L, Hkv), np.int64)
    for l in range(L):
        r, s = np.flatnonzero(~sm[l]), np.flatnonzero(sm[l])
        retr_idx[l, :len(r)] = r
        stream_idx[l, :len(s)] = s
        inv_idx[l, r] = np.arange(len(r))
        inv_idx[l, s] = hr_max + np.arange(len(s))
    dev = cache.keys.device
    ri, si = torch.from_numpy(retr_idx).to(dev), torch.from_numpy(stream_idx).to(dev)
    lengths = cache.length.tolist()
    # Room for `room` appends past the longest layer in the retrieval buffer.
    S_r = max(S, max(lengths) + room)

    def retrieval(a):
        out = torch.zeros((L, B, hr_max, S_r, D), dtype=a.dtype, device=dev)
        for l in range(L):
            out[l, :, :, :S] = a[l][:, ri[l]]
        return out

    def streaming(a):
        # The first `sink` slots, then the `recent` slots up to each layer's
        # length, starting no earlier than `sink` (for a length under sink +
        # recent, slot sink + j stays token sink + j), then the room.
        out = torch.zeros((L, B, si.shape[1], sink + recent + room, D), dtype=a.dtype,
                          device=dev)
        for l, ln in enumerate(lengths):
            heads = a[l][:, si[l]]
            start = clamp_start(max(ln - recent, sink), recent, S)
            out[l, :, :, :sink] = heads[:, :, :sink]
            out[l, :, :, sink:sink + recent] = heads[:, :, start:start + recent]
        return out

    return DuoSplitCache(
        keys_r=retrieval(cache.keys), values_r=retrieval(cache.values),
        keys_s=streaming(cache.keys), values_s=streaming(cache.values),
        len_r=cache.length.to(torch.int32).clone(),
        len_s=torch.clamp(cache.length, max=sink + recent).to(torch.int32),
        retr_idx=ri, stream_idx=si, inv_idx=torch.from_numpy(inv_idx).to(dev),
        offset=torch.tensor(int(cache.offset.max()), dtype=torch.int32))


@torch.no_grad()
def duo_decode_step(params, tok: torch.Tensor, ds: DuoSplitCache, *, runner):
    """One greedy token over the split cache: tok (B, 1) -> (next (B, 1),
    logits (B, V) float32, the split cache with both lengths and the offset
    advanced). The new token's K/V are written into both buffers in place.
    The layer body is ``Runner._layer_step``'s, with the attention split by
    head class."""
    from ..models.llama import (_finish_layer, _project_qkv, _sm_scale, embed_tokens,
                                lm_head_logits, rms_norm)
    from ..rope import apply_rope

    cfg = runner.cfg
    if cfg.sliding_window is not None:
        raise ValueError("duo_decode_step takes full-attention models: sliding-window layers "
                         "already keep a windowed buffer")
    B = tok.shape[0]
    Hkv, D = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // Hkv
    hr, hs = ds.retr_idx.shape[1], ds.stream_idx.shape[1]
    offset = int(ds.offset)
    shard = runner.shard
    x = embed_tokens(params, tok, cfg)                                  # (B, 1, E)
    (cos, sin), _ = runner._ropes(torch.full((B, 1), offset, device=x.device))
    scale = _sm_scale(cfg)
    len_r, len_s = ds.len_r.tolist(), ds.len_s.tolist()
    for l, layer in enumerate(params.layers):
        h = rms_norm(x, layer.ln1, cfg.rms_norm_eps, cfg.rms_one_offset)
        q_pre, k_pre, v = _project_qkv(layer, cfg, h)
        q = apply_rope(q_pre, cos, sin)                                 # (B, Hq, 1, D)
        k = apply_rope(k_pre, cos, sin)                                 # (B, Hkv, 1, D)
        ridx, sidx = ds.retr_idx[l], ds.stream_idx[l]
        kr, vr, ks, vs = ds.keys_r[l], ds.values_r[l], ds.keys_s[l], ds.values_s[l]
        at_r = clamp_start(len_r[l], 1, kr.shape[2])
        at_s = clamp_start(len_s[l], 1, ks.shape[2])
        kr[:, :, at_r] = k[:, ridx, 0].to(kr.dtype)
        vr[:, :, at_r] = v[:, ridx, 0].to(vr.dtype)
        ks[:, :, at_s] = k[:, sidx, 0].to(ks.dtype)
        vs[:, :, at_s] = v[:, sidx, 0].to(vs.dtype)
        qg = q.reshape(B, Hkv, G, D)
        q_r = qg[:, ridx].reshape(B, hr * G, 1, D).contiguous()
        q_s = qg[:, sidx].reshape(B, hs * G, 1, D).contiguous()
        o_r = decode_attention(q_r, kr, vr, len_r[l] + 1, sm_scale=scale,
                               softcap=cfg.logit_softcap)
        o_s = decode_attention(q_s, ks, vs, len_s[l] + 1, sm_scale=scale,
                               softcap=cfg.logit_softcap)
        o = torch.cat([o_r.reshape(B, hr, G, D), o_s.reshape(B, hs, G, D)], dim=1)
        o = o[:, ds.inv_idx[l]].reshape(B, Hkv * G, 1, D)
        x = _finish_layer(x, o, layer, cfg, shard)
    x = rms_norm(x, params.ln_f, cfg.rms_norm_eps, cfg.rms_one_offset)
    logits = lm_head_logits(x[:, 0], params, cfg, shard)
    nds = dataclasses.replace(ds, len_r=ds.len_r + 1, len_s=ds.len_s + 1,
                              offset=ds.offset + 1)
    return torch.argmax(logits, dim=-1)[:, None], logits, nds
