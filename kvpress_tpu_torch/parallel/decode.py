"""Distributed decode over context-parallel KV shards (port of
``kvpress_tpu/parallel/decode.py``).

After ``context_parallel_prefill`` the cache stays in its shards: every rank
runs the dense compute for the new token and attends its own block only; the
per-shard softmax partials combine with an all-reduce MAX of the row maxima,
then one SUM of the row sums and unnormalised outputs, over ``"seq"`` (the
split-KV reduction of flash decoding). The new token's key and value go onto
the last shard's block, into the slack that compression left there.
Positions are logical: the caller threads ``offset`` (the context length
plus the tokens decoded so far).

The dense products of a shard are float32 einsums (``quant_qk_logits`` /
``quant_pv_out`` over an int8 or packed-int4 shard), as in JAX: the decode
kernel returns no partials.

The port writes the shards in place where JAX returns new arrays. So
``context_parallel_decode_step`` tests for overflow first, with one MAX
over the mesh: when the last shard's block is full it changes nothing and
returns ``overflow`` 1 (JAX skips the full layers' writes and returns the
rest; its caller redoes the step from the shards it had either way).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.attention import NEG_INF, quant_pv_out, quant_qk_logits
from ..rope import apply_rope
from .context_prefill import check_rank_runner, context_parallel_prefill, refuse_rerotation
from .mesh import axis_size, seq_shard
from .presses import check_seq_press


class _LayerView(dict):
    """A layer's tensors by name, read as the runner reads a DecoderLayer."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def _seq_tp_layers(params, rank: int, n: int):
    """Per layer, (the q/k/v view, the rest's view) of seq rank ``rank``'s
    column blocks of the replicated weights: its query and kv heads, its
    slice of the MLP, and the matching row blocks of ``wo`` and ``wd``, as
    JAX's seq-tp decode cuts them. Per-output int8 scales follow the column
    blocks; those of the row-parallel ``wo`` and ``wd`` stay whole."""
    def cols(w):
        c = w.shape[-1] // n
        return w.narrow(-1, rank * c, c)

    def rows(w):
        r = w.shape[0] // n
        return w.narrow(0, rank * r, r)

    views = []
    for layer in params.layers:
        t = {name: p.data for name, p in layer.named_parameters(recurse=False)}
        qkv = dict(t, **{w: cols(t[w]) for w in ("wq", "wk", "wv")})
        qkv.update({b: rows(t[b]) for b in ("bq", "bk", "bv") if b in t})
        qkv.update({f"{w}_scale": cols(t[f"{w}_scale"]) for w in ("wq", "wk", "wv")
                    if f"{w}_scale" in t})
        rest = dict(t, wo=rows(t["wo"]), wg=cols(t["wg"]), wu=cols(t["wu"]), wd=rows(t["wd"]))
        rest.update({f"{w}_scale": cols(t[f"{w}_scale"]) for w in ("wg", "wu")
                     if f"{w}_scale" in t})
        views.append((_LayerView(qkv), _LayerView(rest)))
    return views


def _uses_seq_tp(runner, params, n_seq: int) -> bool:
    """The seq axis doubles as tensor parallelism when there is no "model"
    axis and the head and MLP counts divide it; not for int4 weights (a row
    block of a packed payload pairs the wrong nibbles)."""
    cfg = runner.cfg
    return (runner.shard is None and n_seq > 1 and cfg.num_heads % n_seq == 0
            and cfg.num_kv_heads % n_seq == 0 and cfg.intermediate_size % n_seq == 0
            and params.layers[0].wo.dtype != torch.uint8)


def _unpack(shards):
    """(keys, values, lengths, masks, scales or None, kv_bits)."""
    if len(shards) == 6:
        bits = 4 if shards[0].dtype == torch.uint8 else 8
        return (*shards[:4], tuple(shards[4:]), bits)
    return (*shards, None, 8)


def _checks(runner, params, mesh, quantized: bool, press, prefill_shard_len):
    if quantized and press is not None and not getattr(press, "supports_quantized_decode",
                                                       False):
        raise ValueError("this decode-phase press needs dense buffers every step (e.g. CAM): "
                         "decode bf16, or use a DecodingPress-family press")
    if press is not None:
        check_seq_press(press, decode=True)
    check_rank_runner(runner, params, mesh)
    if runner.cfg.sliding_window is not None and prefill_shard_len is None:
        raise ValueError("sliding-window models need prefill_shard_len (= prefill S // n_seq) "
                         "to map shard slots to global positions")


def _mesh_max(seq, runner, value: int) -> int:
    value = seq.max(value)
    return runner.shard.max(value) if runner.shard is not None else value


@torch.no_grad()
def _decode(params, tok, shards, offset: int, press_state, *, runner, seq, tp_views, press,
            prefill_shard_len):
    """One token through every layer against the rank's shards (written in
    place). A full layer on the last shard takes no append. Returns (logits
    (B, 1, V) float32, the new press state, this rank's overflow)."""
    from ..models.llama import (_finish_layer, _project_qkv, _rope_of, _sm_scale,
                                embed_tokens, lm_head_logits, rms_norm)
    from ..presses.base import LayerCtx
    from ..cache import quantize_kv

    cfg = runner.cfg
    keys, values, lengths, masks, scales, bits = _unpack(shards)
    B = tok.shape[0]
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = Hq // Hkv
    Sl = keys.shape[3]
    is_last = seq.rank == seq.size - 1
    dev = keys.device
    scale = _sm_scale(cfg)
    positions = torch.full((B, 1), offset, device=dev)
    rope, rope_local = runner._ropes(positions)
    slot = torch.arange(Sl, device=dev)
    slot_pos = None
    if cfg.sliding_window is not None:
        # Sliding layers are never compressed and appends land on the last
        # shard's tail, so slot s of seq rank i holds position i * psl + s.
        slot_pos = seq.rank * int(prefill_shard_len) + slot
    sub_cfg = (None if tp_views is None else
               dataclasses.replace(cfg, num_heads=Hq // seq.size, num_kv_heads=Hkv // seq.size))
    x = embed_tokens(params, tok, cfg)
    overflow = False
    new_state = None if press_state is None else list(press_state)
    for l, (layer, sliding) in enumerate(zip(params.layers, cfg.sliding_flags())):
        h = rms_norm(x, layer.ln1, cfg.rms_norm_eps, cfg.rms_one_offset)
        if tp_views is not None:
            # Decode reads every weight once a token: over the seq ranks each
            # reads its column block, and the few q/k/v heads are gathered.
            q_pre, k_pre, v = (seq.all_gather(t.contiguous(), dim=1)
                               for t in _project_qkv(tp_views[l][0], sub_cfg, h))
        else:
            q_pre, k_pre, v = _project_qkv(layer, cfg, h)
        cos, sin = _rope_of(rope, rope_local, sliding)
        q = apply_rope(q_pre, cos, sin)
        k_new = apply_rope(k_pre, cos, sin)

        k_l, v_l, m_l = keys[l], values[l], masks[l]
        ks_l, vs_l = (None, None) if scales is None else (scales[0][l], scales[1][l])
        length = int(lengths[l])
        if is_last and length < Sl:
            if scales is None:
                k_l[:, :, length] = k_new[:, :, 0].to(k_l.dtype)
                v_l[:, :, length] = v[:, :, 0].to(v_l.dtype)
            else:
                (k_l[:, :, length:length + 1], ks_l[:, :, length:length + 1]) = quantize_kv(
                    k_new, bits)
                (v_l[:, :, length:length + 1], vs_l[:, :, length:length + 1]) = quantize_kv(
                    v, bits)
            m_l[:, :, length] = True
            length += 1
        elif is_last:
            overflow = True

        # The shard's softmax partials, then the split-KV combine.
        qg = q.reshape(B, Hkv, G, D)
        if scales is None:
            s = torch.einsum("bhgd,bhsd->bhgs", qg.float(), k_l.float()) * scale
        else:
            s = quant_qk_logits(qg, k_l, ks_l, bits) * scale
        if cfg.logit_softcap is not None:
            s = torch.tanh(s / cfg.logit_softcap) * cfg.logit_softcap
        valid = m_l & (slot < length)
        if sliding:
            valid = valid & (slot_pos > offset - cfg.sliding_window)
        s = torch.where(valid[:, :, None], s, torch.full((), NEG_INF, device=dev))
        m_g = seq.all_reduce(s.amax(-1), dist.ReduceOp.MAX)
        p = torch.exp(s - m_g[..., None])
        if scales is None:
            acc = torch.einsum("bhgs,bhsd->bhgd", p.to(v_l.dtype).float(), v_l.float())
        else:
            acc = quant_pv_out(p, v_l, vs_l, bits, x.dtype).float()
        # One SUM for the row sums and the outputs: (B, Hkv, G, D + 1).
        acc_l = seq.all_reduce(torch.cat([acc, p.sum(-1, keepdim=True)], dim=-1))
        attn = (acc_l[..., :D] / acc_l[..., D:].clamp_min(1e-30)).to(x.dtype)
        attn = attn.reshape(B, Hq, 1, D)

        if tp_views is not None:
            n = Hq // seq.size
            x = _finish_layer(x, attn[:, seq.rank * n:(seq.rank + 1) * n], tp_views[l][1], cfg,
                              seq)
        else:
            x = _finish_layer(x, attn, layer, cfg, runner.shard)

        if press is not None and not sliding:
            # Shard-local decode compression: per-shard targets; sync_state
            # keeps the counters the same on every shard.
            ctx = LayerCtx(layer_idx=l, hidden=h, queries=q, queries_prerope=q_pre,
                           keys_prerope=k_pre, positions=positions, attn_probs=None,
                           layer_params=layer, inv_freq=runner.inv_freq, cfg=cfg,
                           attention_scaling=runner.attention_scaling, last_position=offset,
                           shard=runner.shard)
            if scales is None:
                nk, nv, length, nm, new_state[l] = press.decode_compress(
                    ctx, k_l, v_l, length, m_l, press_state[l], sync_state=True)
                bufs, dst = (nk, nv, nm), (k_l, v_l, m_l)
            else:
                *bufs, length, nm, new_state[l] = press.decode_compress_quantized(
                    ctx, k_l, v_l, ks_l, vs_l, bits, length, m_l, press_state[l],
                    sync_state=True)
                bufs, dst = (*bufs, nm), (k_l, v_l, ks_l, vs_l, m_l)
            for d, b in zip(dst, bufs):
                if b is not d:
                    d.copy_(b)
        lengths[l] = int(length)

    x = rms_norm(x, params.ln_f, cfg.rms_norm_eps, cfg.rms_one_offset)
    return lm_head_logits(x, params, cfg, runner.shard), new_state, overflow


def _setup(params, mesh, runner, shards, press, prefill_shard_len):
    _checks(runner, params, mesh, len(shards) == 6, press, prefill_shard_len)
    seq = seq_shard(mesh, runner.device)
    tp_views = _seq_tp_layers(params, seq.rank, seq.size) if _uses_seq_tp(
        runner, params, seq.size) else None
    return dict(runner=runner, seq=seq, tp_views=tp_views, press=press,
                prefill_shard_len=prefill_shard_len)


def context_parallel_decode_step(params, tok: torch.Tensor, shards, offset: int, *, runner,
                                 mesh, press=None, press_state=None,
                                 prefill_shard_len: Optional[int] = None):
    """One decode step of ``tok`` (B, 1) at logical position ``offset``
    against the rank's shards (``context_parallel_prefill``'s tuple, written
    in place). Returns (logits (B, 1, V), shards, offset + 1, overflow,
    press state).

    ``overflow`` 1: the last shard's block was full. The step then changed
    nothing and its logits are None: ``grow_shards`` and run it again
    (``context_parallel_generate`` does).

    Over a seq-only mesh the dense compute is tensor-parallel over ``"seq"``
    (column blocks of the replicated weights, an all-gather of q/k/v and two
    all-reduces a layer) when the head and MLP counts divide it and the
    weights are not int4.

    ``press`` (the ``DecodingPress`` family) compresses each rank's shard on
    its own: ``target_size`` is a per-shard budget. Thread ``press_state``
    (``press.init_state(cfg, B, 1, device=...)``) through the steps; with
    ``sync_state`` it stays the same on every rank. A press that needs dense
    buffers every step (CAM) is refused over quantized shards.

    A sliding-window model needs ``prefill_shard_len`` (the prefill's S // N):
    slot s of seq rank i holds position ``i * prefill_shard_len + s``."""
    kw = _setup(params, mesh, runner, shards, press, prefill_shard_len)
    seq = kw["seq"]
    lengths, Sl = shards[2], shards[0].shape[3]
    full = seq.rank == seq.size - 1 and int(lengths.max()) >= Sl
    if _mesh_max(seq, runner, int(full)):
        return None, shards, offset + 1, 1, press_state
    logits, state, _ = _decode(params, tok, shards, int(offset), press_state, **kw)
    return logits, shards, offset + 1, 0, state


def context_parallel_generate_fused(params, tok: torch.Tensor, shards, offset: int, *, runner,
                                    mesh, press=None, press_state=None,
                                    max_new_tokens: int = 32, eos_id: Optional[int] = None,
                                    prefill_shard_len: Optional[int] = None):
    """Greedy decode of ``max_new_tokens`` with no host read per token: the
    tokens stay on the device, and a row that emits ``eos_id`` emits it
    from then on (its appends go on, unread). The shards must hold every
    append (``ensure_tail_capacity``): a full layer drops its appends, and
    ``overflow`` (read once, at the end) says so. Returns (tokens (B,
    max_new_tokens), shards, offset + max_new_tokens, overflow, press
    state)."""
    kw = _setup(params, mesh, runner, shards, press, prefill_shard_len)
    B = tok.shape[0]
    toks = torch.empty((B, max_new_tokens), dtype=torch.long, device=tok.device)
    done = torch.zeros((B,), dtype=torch.bool, device=tok.device)
    over = False
    state = press_state
    for i in range(max_new_tokens):
        logits, state, ovf = _decode(params, tok, shards, int(offset) + i, state, **kw)
        over |= ovf
        ntok = torch.argmax(logits[:, -1:], dim=-1)
        if eos_id is not None:
            ntok = torch.where(done[:, None], torch.full_like(ntok, eos_id), ntok)
            done = done | (ntok[:, 0] == eos_id)
        toks[:, i] = ntok[:, 0]
        tok = ntok
    overflow = _mesh_max(kw["seq"], runner, int(over))
    return toks, shards, offset + max_new_tokens, overflow, state


def grow_shards(shards, extra: int):
    """Every block of the rank's shards ``extra`` slots longer: zeros, mask
    False, scales 1.0. Each rank pads its own block (in JAX the padding goes
    inside each shard's block of the global array). Takes the bf16 4-tuple
    or the quantized 6-tuple."""
    def pad(t, fill):
        shape = list(t.shape)
        shape[3] = extra
        return torch.cat([t, torch.full(shape, fill, dtype=t.dtype, device=t.device)], dim=3)

    out = (pad(shards[0], 0), pad(shards[1], 0), shards[2].clone(), pad(shards[3], False))
    if len(shards) == 6:
        out = out + (pad(shards[4], 1.0), pad(shards[5], 1.0))
    return out


def ensure_tail_capacity(shards, mesh, extra: int, runner=None):
    """The shards grown (``grow_shards``, every rank alike) so that
    ``extra`` appends fit after the longest layer of any rank; as they are
    when they fit already. ``runner``: a sharded runner's model axis joins
    the maximum."""
    seq = seq_shard(mesh, shards[0].device)
    longest = seq.max(int(shards[2].max()))
    if runner is not None and runner.shard is not None:
        longest = runner.shard.max(longest)
    need = longest + extra - shards[0].shape[3]
    return shards if need <= 0 else grow_shards(shards, need)


def context_parallel_generate(params, ids: torch.Tensor, *, runner, mesh, press=None,
                              decode_press=None, max_new_tokens: int = 32,
                              eos_id: Optional[int] = None, fused: bool = False,
                              quantized: bool = False, kv_bits: int = 8) -> torch.Tensor:
    """Compress, then generate, on the mesh: ``context_parallel_prefill`` of
    ``ids`` (B, S) with shard-local ``press``, then greedy decode with the
    split-KV combine; the cache never leaves its shards. The first token is
    ``ids[:, -1:]`` re-projected at position S (the single-device pipeline's
    decode contract). ``decode_press`` compresses during generation, shard
    by shard. Returns the new tokens (B, <= max_new_tokens); generation stops
    after the first ``eos_id`` of row 0.

    ``fused=True`` grows the shards for every append first and runs
    ``context_parallel_generate_fused``. Otherwise a full last shard is
    grown and its step run again from the same shards and press state."""
    refuse_rerotation(press)
    _checks(runner, params, mesh, quantized, decode_press, 0)
    shards = context_parallel_prefill(params, ids, runner=runner, mesh=mesh, press=press,
                                      quantized=quantized, kv_bits=kv_bits)
    B, S = ids.shape
    n_seq = axis_size(mesh, "seq")
    tok = ids[:, -1:].to(runner.device)
    dstate = (None if decode_press is None else
              decode_press.init_state(runner.cfg, B, 1, device=runner.device))
    common = dict(runner=runner, mesh=mesh, press=decode_press, prefill_shard_len=S // n_seq)
    if fused:
        shards = ensure_tail_capacity(shards, mesh, max_new_tokens + 1, runner)
        toks, shards, _, overflow, _ = context_parallel_generate_fused(
            params, tok, shards, S, press_state=dstate, max_new_tokens=max_new_tokens,
            eos_id=eos_id, **common)
        if overflow:
            raise RuntimeError("the shards overflowed after ensure_tail_capacity")
        if eos_id is not None:
            row = toks[0].tolist()
            if eos_id in row:
                return toks[:, :row.index(eos_id) + 1]
        return toks
    out, offset = [], S
    for _ in range(max_new_tokens):
        logits, shards, offset2, overflow, state = context_parallel_decode_step(
            params, tok, shards, offset, press_state=dstate, **common)
        if overflow:
            shards = grow_shards(shards, max(32, max_new_tokens))
            logits, shards, offset2, overflow, state = context_parallel_decode_step(
                params, tok, shards, offset, press_state=dstate, **common)
            if overflow:
                raise RuntimeError("the shards overflowed after grow_shards")
        offset, dstate = offset2, state
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
        if eos_id is not None and int(tok[0, 0]) == eos_id:
            break
    return torch.cat(out, dim=1)
