"""Continuous-batching serving engine over compressed KV caches (port of
``kvpress_tpu/serving.py``).

One decode step over a fixed pool of request slots, a host admission loop
around it, and per-request press-compressed prefills inserted into free
slots. Each served answer equals, teacher-forced, the single-request path
through ``Runner`` (prefill with the press, question forward, decode).

- ``SlotCache``: buffers ``(L, N_slots, H_kv, C, D)`` (or the int8 /
  packed-int4 payload with ``(L, N, H_kv, C, 1)`` float32 scales) and a
  keep-mask ``(L, N, H_kv, C)`` on the runner's device; per-slot per-layer
  ``lengths (L, N)`` and per-slot ``offsets (N,)`` on the host, as
  ``KVCache.length`` and ``offset`` are, so the host knows every slot's
  length without a device sync.
- Admission: ``Runner.prefill`` (one-shot, or bucketed with ``valid_len``)
  or ``Runner.prefill_chunked_steps`` with the press; a multi-pass press's
  scoring passes (``KVPressPipeline._run_kvzip`` / ``_run_kvcompose``), a
  post-mask press's mask, ``compact_masked`` for a ``host_compact`` press;
  then the question forward (padded to ``question_bucket`` with
  ``valid_len``), the re-bucket to the slot capacity and a copy into the
  slot.
- Decode (``_decode_step``): one token for every slot. Each layer appends
  at each slot's own length and attends with each slot's own causality,
  sliding window and keep bits: through ``ops.decode.decode_attention`` on a
  runner with the decode kernel (its ``mask`` argument carries all three;
  its ``length`` is the largest over the slots), else JAX's own arithmetic,
  ``gqa_attention`` / ``quant_gqa_attention`` with a per-slot bias. Dead
  slots compute too; their lengths, offsets and input tokens stay.
- Decode-time compression: a ``DecodingPress`` (or the decode half of a
  ``PrefillDecodingPress``) compresses each slot on its own. Each slot has
  its own ring buffer of ln1-normed hidden states and its own interval
  counter, advanced for live slots only; the host decides from its lengths
  and counters which slots compress in a layer, and scores each with its own
  scalar length (JAX ``vmap``s the scoring over the slots).
- Every step and every admission makes a new tokens tensor: a step's tokens
  are copied to the host without blocking and read ``fetch_lag`` steps
  later, and nothing may change a step's tokens after it returned them.

Tensor-parallel serving (``mesh=``, a ``torch.distributed`` ``DeviceMesh``):
one process a rank, each with the same host loop; weights and the pool's kv
heads over "model", slots over the batch axes (``ServingEngine._shard``).
The presses of ``parallel.presses.MESH_PRESSES`` run there; others raise
``NotImplementedError``.

Not supported (``ValueError``, where JAX asserts): CAM-style merge presses
and other decode-time presses.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from .cache import KVCache, compact_masked, dequantize_kv, grow, quantize_kv, resize, shrink
from .config import ModelConfig
from .device import DeviceLike, resolve_device
from .models.llama import (LlamaModel, Runner, _finish_layer, _project_qkv, _rope_of, _sm_scale,
                           embed_tokens, lm_head_logits, rms_norm)
from .ops.attention import NEG_INF, gqa_attention, quant_gqa_attention
from .ops.decode import decode_attention
from .pipeline import KVPressPipeline, kvzip_repeat_bound
from .presses.base import BasePress, LayerCtx, ScorerPress, order_desc
from .presses.decoding import DecodingPress, PrefillDecodingPress
from .presses.dms import DMSPress
from .rope import apply_rope

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class SlotCache:
    keys: torch.Tensor                   # (L, N, H, C, D) | int payload
    values: torch.Tensor
    lengths: torch.Tensor                # (L, N) int32, host
    offsets: torch.Tensor                # (N,) int32, host: logical positions
    mask: torch.Tensor                   # (L, N, H, C) bool
    key_scales: Optional[torch.Tensor] = None    # (L, N, H, C, 1) f32
    value_scales: Optional[torch.Tensor] = None
    bits: int = 8

    @property
    def capacity(self) -> int:
        return self.keys.shape[3]

    @property
    def n_slots(self) -> int:
        return self.keys.shape[1]

    @property
    def quantized(self) -> bool:
        return self.key_scales is not None


def init_slot_cache(cfg: ModelConfig, n_slots: int, capacity: int,
                    dtype: torch.dtype = torch.bfloat16, quantized: bool = False, bits: int = 8,
                    device: DeviceLike = "cuda") -> SlotCache:
    """An empty slot pool on ``device``: the card unless the caller passes
    ``device="cpu"``."""
    device = resolve_device(device)
    L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    ks = vs = None
    if quantized:
        if bits not in (8, 4):
            raise ValueError(f"kv bits must be 8 or 4, got {bits}")
        pd, pt = (D, torch.int8) if bits == 8 else (D // 2, torch.uint8)
        keys = torch.zeros((L, n_slots, H, capacity, pd), dtype=pt, device=device)
        values = torch.zeros_like(keys)
        ks = torch.ones((L, n_slots, H, capacity, 1), dtype=torch.float32, device=device)
        vs = torch.ones_like(ks)
    else:
        keys = torch.zeros((L, n_slots, H, capacity, D), dtype=dtype, device=device)
        values = torch.zeros_like(keys)
    return SlotCache(keys=keys, values=values,
                     lengths=torch.zeros((L, n_slots), dtype=torch.int32),
                     offsets=torch.zeros((n_slots,), dtype=torch.int32),
                     mask=torch.ones((L, n_slots, H, capacity), dtype=torch.bool, device=device),
                     key_scales=ks, value_scales=vs, bits=bits if quantized else 8)


# --------------------------------------------------------------------- #
# The engine's steps


def _sample_rows(logits: torch.Tensor, generator: torch.Generator, temperature: float,
                 top_p: float) -> torch.Tensor:
    """Nucleus sampling of one token from each row of (N, V) logits, on
    their device (no host sync). Returns (N,) int64."""
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True)
    keep = torch.cumsum(sorted_probs, dim=-1) - sorted_probs < top_p    # keeps the top token
    filtered = torch.where(keep, sorted_probs, torch.zeros_like(sorted_probs))
    idx = torch.multinomial(filtered, 1, generator=generator)
    return order.gather(-1, idx)[:, 0]


def _slot_attention(runner: Runner, q, ck, cv, cks, cvs, allowed, length: int, bits: int):
    """One layer's attention for every slot: ``allowed`` (N, H, C) bool holds
    each slot's causality, window and keep bits; ``length`` the largest
    valid length over the slots (at most C)."""
    cfg = runner.cfg
    scale = _sm_scale(cfg)
    quantized = cks is not None
    if runner.attn_impl == "flash" and runner.decode_kernel:
        if quantized:
            return decode_attention(q, ck, cv, length, cks, cvs, allowed, bits=bits,
                                    sm_scale=scale, softcap=cfg.logit_softcap,
                                    block_k=runner.decode_block_k)
        return decode_attention(q, ck, cv, length, mask=allowed, sm_scale=scale,
                                softcap=cfg.logit_softcap, block_k=runner.decode_block_k)
    bias = torch.where(allowed, 0.0, NEG_INF)[:, :, None, :]               # (N, H, 1, C)
    if quantized:
        return quant_gqa_attention(q, ck, cv, cks, cvs, bias, scale, bits,
                                   softcap=cfg.logit_softcap)
    return gqa_attention(q, ck, cv, bias, scale, softcap=cfg.logit_softcap)[0]


def _compress_slot(runner: Runner, press, layer, l: int, b: int, sc: SlotCache, hidden,
                   length: int, offset: int, n_top: int, dtype: torch.dtype):
    """One slot of one layer compressed by a DecodingPress-family press: the
    slot's buffer scored against its ring of hidden states (positions up to
    ``offset``), the top ``n_top`` of each head (over the valid, kept slots)
    gathered to the front, payload and scales together; the slot's keep bits
    set."""
    cfg = runner.cfg
    C = sc.capacity
    bufs = [t[l, b:b + 1] for t in (sc.keys, sc.values, sc.key_scales, sc.value_scales)
            if t is not None]
    if sc.quantized:
        dk = dequantize_kv(bufs[0], bufs[2], sc.bits, dtype)
        dv = dequantize_kv(bufs[1], bufs[3], sc.bits, dtype)
    else:
        dk, dv = bufs[0], bufs[1]
    W = hidden.shape[1]
    positions = offset - torch.arange(W - 1, -1, -1, device=hidden.device)[None]
    dctx = LayerCtx(layer_idx=l, hidden=hidden, queries=None, queries_prerope=None,
                    keys_prerope=None, positions=positions, attn_probs=None,
                    layer_params=layer, inv_freq=runner.inv_freq, cfg=cfg,
                    attention_scaling=runner.attention_scaling, kv_len=length,
                    last_position=offset, shard=runner.shard)
    scores = press.score_dynamic(dctx, dk, dv, length).to(torch.float32)   # (1, H, C)
    valid = (torch.arange(C, device=scores.device) < length) & sc.mask[l, b:b + 1]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    idx = order_desc(scores, n_top)                                        # (1, H, n_top)
    for t in bufs:
        t[:, :, :n_top] = torch.gather(t, 2, idx[..., None].expand(*idx.shape, t.shape[-1]))
    sc.mask[l, b] = True


@torch.no_grad()
def _decode_step(params: LlamaModel, tokens: torch.Tensor, sc: SlotCache, live: torch.Tensor,
                 dp_state: Optional[dict] = None, generator: Optional[torch.Generator] = None,
                 *, runner: Runner, decode_press=None, do_sample: bool = False,
                 temperature: float = 1.0, top_p: float = 1.0, own: Optional[slice] = None,
                 gather=None):
    """One token for every slot: ``tokens (N,)`` on the device, ``live (N,)``
    bool on the host. Returns (next tokens (N,), the pool with new host
    lengths and offsets, the decode press's state).

    Under a mesh the pool's device tensors hold the slots ``own`` (their
    kv heads on a sharded runner) and the host state every slot: the device
    work runs for ``own`` only, the host bookkeeping for every slot, and
    ``gather`` (``parallel.mesh.gather_batch``) brings every data shard's
    rows: the next tokens, or under sampling the logits, so that every rank
    draws every slot's token from its generator as one process would.

    ``Runner._layer_step``'s decode path with per-slot lengths: each layer
    appends at each slot's own length (a lane whose length is the capacity
    writes nothing, as JAX's scatter drops it), attends with each slot's own
    causality (``k_slot <= length[b]``), sliding window and keep bits, and
    advances the lengths of live slots only. The buffers are written in
    place. Dead lanes keep their input token: an admission stages its first
    token in a dead lane before the slot goes live."""
    cfg = runner.cfg
    dev = tokens.device
    C = sc.capacity
    own = own or slice(0, tokens.shape[0])
    live_own = live[own]
    live_dev = live_own.to(dev)
    x = embed_tokens(params, tokens[own, None], cfg)                        # (n, 1, E)
    offsets = sc.offsets
    rope, rope_local = runner._ropes(offsets[own].to(dev, torch.int64)[:, None])
    lengths = sc.lengths.clone()
    lengths_dev = lengths[:, own].to(dev, torch.int64)
    k_slot = torch.arange(C, device=dev)
    lanes = torch.arange(live_own.shape[0], device=dev)
    if decode_press is not None:
        steps, buf_len = dp_state["steps"].clone(), dp_state["buf_len"].clone()
        buf_size = dp_state["buffer"].shape[2]
        n_top = min(decode_press.target_bound(None, buf_size), C)
    for l, (layer, sliding) in enumerate(zip(params.layers, cfg.sliding_flags())):
        h = rms_norm(x, layer.ln1, cfg.rms_norm_eps, cfg.rms_one_offset)
        q_pre, k_pre, v = _project_qkv(layer, cfg, h)
        cos, sin = _rope_of(rope, rope_local, sliding)
        q = apply_rope(q_pre, cos, sin).contiguous()
        k = apply_rope(k_pre, cos, sin)

        ck, cv, cmask = sc.keys[l], sc.values[l], sc.mask[l]
        cks = None if sc.key_scales is None else sc.key_scales[l]
        cvs = None if sc.value_scales is None else sc.value_scales[l]
        clen = lengths[l, own]
        if bool((clen < C).all()):
            rows, at = lanes, lengths_dev[l]
        else:
            fits = torch.nonzero(clen < C)[:, 0]
            rows, at = fits.to(dev), clen[fits].to(dev, torch.int64)
        if sc.quantized:
            pk, sk = quantize_kv(k, sc.bits)
            pv, sv = quantize_kv(v, sc.bits)
            writes = ((ck, pk), (cv, pv), (cks, sk), (cvs, sv))
        else:
            writes = ((ck, k), (cv, v))
        for buf, new in writes:
            buf[rows, :, at] = new[rows, :, 0].to(buf.dtype)
        cmask[rows, :, at] = True

        allowed = k_slot[None] <= lengths_dev[l][:, None]                 # (N, C)
        if sliding and cfg.sliding_window is not None:
            allowed &= k_slot[None] > lengths_dev[l][:, None] - cfg.sliding_window
        allowed = cmask & allowed[:, None]
        attn = _slot_attention(runner, q, ck, cv, cks, cvs, allowed,
                               min(int(clen.max()) + 1, C), sc.bits)
        x = _finish_layer(x, attn, layer, cfg, runner.shard)
        lengths[l] = torch.where(live, lengths[l] + 1, lengths[l])

        if decode_press is None:
            continue
        # Per-slot decode-time compression: the ring buffers and counters
        # advance for live slots only (an admitted slot that is not live yet
        # must not take a hidden state in).
        ring = dp_state["buffer"][l]                                       # (N, W, E)
        shifted = torch.cat([ring[:, 1:], h.to(ring.dtype)], dim=1)
        ring.copy_(torch.where(live_dev[:, None, None], shifted, ring))
        buf_len[l] = torch.where(live, torch.clamp(buf_len[l] + 1, max=buf_size), buf_len[l])
        steps[l] += live.to(torch.int32)
        target = decode_press.target_value_vec(offsets, lengths[l])
        do = live & (steps[l] >= decode_press.compression_interval) & (lengths[l] > target)
        if sliding:
            do = torch.zeros_like(do)      # sliding layers are never compressed
        for b in torch.nonzero(do[own])[:, 0].tolist():
            g = own.start + b                  # the slot's index among all slots
            _compress_slot(runner, decode_press, layer, l, b, sc, ring[b:b + 1],
                           int(lengths[l, g]), int(offsets[g]), n_top, x.dtype)
        lengths[l] = torch.where(do, torch.clamp(target, max=n_top), lengths[l])
        steps[l] = torch.where(do, 0, steps[l])
        buf_len[l] = torch.where(do, 0, buf_len[l])

    x = rms_norm(x, params.ln_f, cfg.rms_norm_eps, cfg.rms_one_offset)
    logits = lm_head_logits(x[:, 0], params, cfg, runner.shard)            # (n, V)
    if do_sample:
        nxt = _sample_rows(logits if gather is None else gather(logits), generator,
                           temperature, top_p)
    else:
        nxt = torch.argmax(logits, dim=-1)
        if gather is not None:
            nxt = gather(nxt)
    if decode_press is not None:
        dp_state = dict(dp_state, steps=steps, buf_len=buf_len)
    new_sc = dataclasses.replace(sc, lengths=lengths,
                                 offsets=torch.where(live, offsets + 1, offsets))
    return torch.where(live.to(dev), nxt, tokens), new_sc, dp_state


def _insert_slot(sc: SlotCache, pc: KVCache, slot: int, own: Optional[slice] = None
                 ) -> SlotCache:
    """Copy a (L, 1, H, C, D) request cache into slot ``slot`` of the pool;
    under a mesh, into the rank's pool if it holds the slot (``own``), the
    host lengths and offset on every rank."""
    own = own or slice(0, sc.n_slots)
    if own.start <= slot < own.stop:
        b = slot - own.start
        bufs = [(sc.keys, pc.keys), (sc.values, pc.values)]
        if sc.key_scales is not None:
            bufs += [(sc.key_scales, pc.key_scales), (sc.value_scales, pc.value_scales)]
        for dst, src in bufs:
            dst[:, b].copy_(src[:, 0])
        if pc.mask is None:
            sc.mask[:, b] = True
        else:
            sc.mask[:, b].copy_(pc.mask[:, 0])
    lengths, offsets = sc.lengths.clone(), sc.offsets.clone()
    lengths[:, slot] = pc.length
    offsets[slot] = pc.offset
    return dataclasses.replace(sc, lengths=lengths, offsets=offsets)


def _reset_slot_state(state: dict, slot: int, own: Optional[slice] = None) -> dict:
    """Zero one slot's decode-press ring buffer (where the rank holds it)
    and counters (admission)."""
    own = own or slice(0, state["buffer"].shape[1])
    if own.start <= slot < own.stop:
        state["buffer"][:, slot - own.start] = 0
    steps, buf_len = state["steps"].clone(), state["buf_len"].clone()
    steps[:, slot] = 0
    buf_len[:, slot] = 0
    return dict(state, steps=steps, buf_len=buf_len)


def _copy_to_host(t: torch.Tensor):
    """A host copy of ``t`` that does not block: on the card, into pinned
    memory behind an event recorded after the copy. Read with
    ``_read_host``."""
    if not t.is_cuda:
        return t.clone(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _read_host(copy) -> torch.Tensor:
    host, event = copy
    if event is not None:
        event.synchronize()
    return host


def _cache_nbytes(cache: KVCache) -> int:
    return sum(t.numel() * t.element_size()
               for t in (cache.keys, cache.values, cache.mask, cache.key_scales,
                         cache.value_scales) if t is not None)


# --------------------------------------------------------------------- #


_UNSET = object()        # "use the engine's press" sentinel for overrides


def _with_ratio(press, ratio: float):
    """A copy of ``press`` with its effective compression_ratio replaced:
    its own dataclass field or the wrapped press's (AdaKV-family wrappers
    read it from ``press.press``)."""
    fields = {f.name for f in dataclasses.fields(press)}
    if "compression_ratio" in fields:
        return dataclasses.replace(press, compression_ratio=ratio)
    if "press" not in fields or press.press is None:
        raise ValueError(f"cannot override compression_ratio on {type(press).__name__}")
    return dataclasses.replace(press, press=_with_ratio(press.press, ratio))


@dataclasses.dataclass
class Request:
    context_ids: list
    question_ids: list
    max_new_tokens: int = 64
    # Multimodal admission (Gemma3): context embeds (1, S, E) on the engine's
    # device replace the token embedding (``convert.multimodal_embeds``), and
    # token_types (1, S) mark the image placeholders for the same-image
    # or-mask; the engine's image_span= bounds the spans.
    inputs_embeds: Optional[torch.Tensor] = None
    token_types: Optional[torch.Tensor] = None
    # Image fingerprint (``KVPressPipeline.batch`` sets a SHA-1 of the
    # pixels): a multimodal admission takes part in the context LRU keyed on
    # (context_ids, content_key). None with inputs_embeds set bypasses it.
    content_key: Optional[object] = None
    # Scheduling weight (schedule="priority"): higher admits first; ties by
    # submission order.
    priority: int = 0


@dataclasses.dataclass
class _SlotState:
    req_idx: int = -1
    generated: list = dataclasses.field(default_factory=list)
    budget: int = 0
    in_flight: int = 0        # steps issued whose tokens are not read yet
    done_at: Optional[int] = None   # index into generated past the EOS


class ServingEngine:
    """Fixed-pool continuous batching. ``run(requests)`` drives admission,
    batched decode and retirement until every request has an answer.

    capacity: the per-slot KV budget. The compressed context, the question,
    ``max_new_tokens`` and one more slot must fit (checked before any device
    work, from the press's static bound; a compacting press is admitted
    optimistically and checked against its measured length)."""

    def __init__(
        self,
        runner: Runner,
        params: LlamaModel,
        n_slots: int = 8,
        capacity: int = 4096,
        press: Optional[BasePress] = None,
        quantized: bool = False,
        kv_bits: int = 8,
        context_bucket: Optional[int] = None,
        context_chunk: Optional[int] = None,   # bounded-activation admission
        question_bucket: int = 64,
        fetch_lag: int = 4,
        eos_ids: tuple = (),
        mesh=None,
        tokenizer=None,             # the KVzip family's repeat prompts
        schedule: str = "fifo",     # "fifo" | "sjf" | "priority"
        interleave: bool = False,   # one admission chunk or layer per loop turn
        context_cache: int = 0,     # LRU of compressed contexts (entries)
        do_sample: bool = False,    # nucleus sampling instead of greedy
        temperature: float = 1.0,
        top_p: float = 1.0,
        seed: int = 0,
        image_span: Optional[int] = None,   # the longest image span (multimodal)
        max_admissions: Optional[int] = None,   # concurrent admissions; None: one
        # per free slot (each holds a whole uncompressed prefill until it lands)
    ):
        self.decode_press = None
        if isinstance(press, PrefillDecodingPress):
            self.decode_press = press.decoding_press
            press = press.prefilling_press
        elif isinstance(press, DecodingPress):
            self.decode_press, press = press, None
        if self.decode_press is not None and \
                type(self.decode_press).decode_compress is not DecodingPress.decode_compress:
            raise ValueError("only DecodingPress-family presses (score, then top-k) run in the "
                             "serving loop; CAM-style merge presses need the pipeline")
        self.multi_pass = bool(getattr(press, "multi_pass", False))
        self.post_mask = bool(getattr(press, "post_mask", False))
        if press is not None:
            if not self.multi_pass and press.compresses_decode:
                raise ValueError("decode-phase presses other than DecodingPress/"
                                 "PrefillDecodingPress are not supported in the serving loop")
            if (self.multi_pass or self.post_mask) and context_bucket is not None:
                raise ValueError("context_bucket is not supported for multi-pass presses")
            if self.multi_pass and press.multi_pass != "kvcompose" and tokenizer is None:
                raise ValueError("KVzip-family presses need the tokenizer (repeat-prompt "
                                 "construction): pass tokenizer= to ServingEngine")
        if context_chunk is not None:
            if context_bucket is not None:
                raise ValueError("context_chunk and context_bucket are mutually exclusive")
            if not (press is None or isinstance(press, ScorerPress)
                    or getattr(press, "scorer_like", False)
                    or hasattr(press, "chunked_compress")
                    or (isinstance(press, DMSPress) and press.press.chunk_score_fn is not None)
                    or self.multi_pass or self.post_mask):
                raise ValueError(
                    "context_chunk admission compresses with a ScorerPress, a scorer-like or "
                    "chunked-composable wrapper, DMS over a per-token scorer, or a "
                    "multi-pass/post-mask press (repeat passes run after the chunked prefill)")
        if schedule not in ("fifo", "sjf", "priority"):
            raise ValueError(f"unknown schedule {schedule!r}")
        if interleave and context_chunk is None:
            raise ValueError("interleave=True requires context_chunk= (the chunk is the "
                             "scheduling unit: a one-shot prefill is one indivisible call)")
        # The slots this rank's pool holds, and how a step's rows of every
        # data shard are gathered (both for every slot without a mesh).
        self.own, self._gather = slice(0, n_slots), None
        if mesh is not None:
            runner, params = self._shard(runner, params, mesh, n_slots, press)
        self.tokenizer = tokenizer
        self.runner = runner
        self.params = params
        self.device = runner.device
        self.n_slots = n_slots
        self.capacity = capacity
        self.press = press
        self.quantized = quantized
        self.kv_bits = kv_bits
        self.context_bucket = context_bucket
        self.context_chunk = context_chunk
        self.image_span = image_span
        self.max_admissions = max_admissions
        self.question_bucket = question_bucket
        self.fetch_lag = max(1, fetch_lag)
        self.schedule = schedule
        self.interleave = bool(interleave)
        self.eos_ids = set(int(e) for e in eos_ids)
        self.dtype = params.dtype
        n_own = self.own.stop - self.own.start
        self.sc = init_slot_cache(runner.cfg, n_own, capacity, dtype=self.dtype,
                                  quantized=quantized, bits=kv_bits, device=self.device)
        # The host lengths and offsets cover every slot on every rank.
        self.sc = dataclasses.replace(self.sc, lengths=torch.zeros((runner.cfg.num_layers,
                                                                    n_slots), dtype=torch.int32),
                                      offsets=torch.zeros((n_slots,), dtype=torch.int32))
        self.dp_state = None
        if self.decode_press is not None:
            L, E = runner.cfg.num_layers, runner.cfg.hidden_size
            buf = max(self.decode_press.hidden_states_buffer_size, 1)
            self.dp_state = {
                "buffer": torch.zeros((L, n_own, buf, E), dtype=self.dtype, device=self.device),
                "steps": torch.zeros((L, n_slots), dtype=torch.int32),
                "buf_len": torch.zeros((L, n_slots), dtype=torch.int32),
            }
        self.tokens = torch.zeros((n_slots,), dtype=torch.int64, device=self.device)
        self.live = np.zeros((n_slots,), bool)
        self.slots = [_SlotState() for _ in range(n_slots)]
        # Optimistic admission: requests dropped after their retry, and the
        # pending capacity-clamped retries (run()'s admission loop takes them).
        self._dropped: list[int] = []
        self._retry_pending: list[dict] = []
        self._retries = 0
        self._on_token = None
        # Compressed-context reuse: an admission whose (context_ids,
        # content_key) has an entry skips the prefill and the compression
        # and runs only the question forward on (a copy of) the stored cache.
        self.context_cache = int(context_cache)
        self._ctx_lru: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.ctx_hits = 0
        # Contexts whose (interleaved) prefill is in flight: a concurrent
        # admission of the same context waits for the first one's entry.
        self._ctx_pending: set = set()
        self._skipped_ctx_tokens = 0
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        # Two generators seeded from one host draw of the seed: the decode
        # steps' and the first tokens' draws are separate streams.
        host = torch.Generator().manual_seed(seed)
        step_seed, adm_seed = (int(torch.randint(0, 2 ** 62, (), generator=host))
                               for _ in range(2))
        self._step_gen = torch.Generator(device=self.device).manual_seed(step_seed)
        self._adm_gen = torch.Generator(device=self.device).manual_seed(adm_seed)
        self._t_run_start = None
        self._ttfts: list = []

    def _shard(self, runner: Runner, params: LlamaModel, mesh, n_slots: int, press):
        """Tensor-parallel serving over ``mesh`` (a ``DeviceMesh`` with a
        "model" axis and optional "data" / "dcn" axes), as the JAX engine
        lays it out: weights and the pool's kv heads over "model"; slots over
        the batch axes when ``n_slots`` divides by their size, else every
        data shard holds every slot. Every rank runs the same host loop, and
        every admission (a batch of one, which cannot split over "data"), so
        its queue, slot states, host lengths, LRU and statistics are those of
        one process; only the rank that holds a slot inserts into it.
        Returns the rank's runner and params."""
        from torch.distributed.device_mesh import DeviceMesh

        from .parallel.mesh import batch_coord, gather_batch, shard_params
        from .parallel.presses import check_press

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh= takes a torch.distributed DeviceMesh "
                            f"(parallel.make_mesh), not {type(mesh).__name__}")
        for p in (press, self.decode_press):
            if p is not None:
                check_press(p)
        if runner.shard is None:
            runner = runner.sharded(mesh)
        if getattr(params, "shard", None) is None:
            params = shard_params(params, mesh)
        index, count = batch_coord(mesh)
        if n_slots % count == 0:
            n = n_slots // count
            self.own = slice(index * n, (index + 1) * n)
            self._gather = lambda x: gather_batch(x, mesh)
        return runner, params

    # ---------------- admission ---------------- #

    def _kept_bound(self, ctx_len: int, press=_UNSET) -> int:
        """Static upper bound on the kept context entries after compression."""
        if press is _UNSET:
            press = self.press
        if self.runner.cfg.sliding_window is not None:
            return ctx_len        # sliding layers keep everything
        return press.max_kept(ctx_len, self.runner.cfg) if press is not None else ctx_len

    def _slots_needed(self, req: Request) -> int:
        """Static upper bound on the slots a request occupies once admitted:
        kept context, question, token budget and the final-logits slot."""
        return (self._kept_bound(len(req.context_ids)) + len(req.question_ids)
                + req.max_new_tokens + 1)

    def _prefill_issue(self, req: Request, press=_UNSET):
        """A request's press-compressed prefill, question forward and
        re-bucket to the capacity, without a host sync. Returns ``(cache,
        kept, first, lru_key)``: the kept length (a host int), the first token
        on the device and the LRU key the admission stored under (or None)."""
        gen = self._prefill_issue_steps(req, press)
        while True:
            try:
                next(gen)
            except StopIteration as stop:
                return stop.value

    def _prefill_issue_steps(self, req: Request, press=_UNSET):
        """Generator form of :meth:`_prefill_issue`: on the chunked path it
        yields after each chunk and each compressed layer, so that the run
        loop can issue decode steps between them (``interleave=True``).
        ``press`` overrides the engine's (a capacity-clamped retry); an
        overridden admission bypasses the LRU."""
        overridden = press is not _UNSET
        if not overridden:
            press = self.press
        ctx = list(req.context_ids)
        key = None
        if self.context_cache and not overridden:
            if req.inputs_embeds is None:
                key = (tuple(req.context_ids), None)
            elif req.content_key is not None:
                key = (tuple(req.context_ids), req.content_key)
        if key is not None:
            # In-flight dedup (interleave): wait for the first admission of
            # this context to store its entry instead of prefilling again.
            while key in self._ctx_pending and key not in self._ctx_lru:
                yield
            if key in self._ctx_lru:
                cache, pre_row = self._ctx_lru[key]
                self._ctx_lru.move_to_end(key)
                self.ctx_hits += 1
                self._skipped_ctx_tokens += len(req.context_ids)
                return self._finish_issue(req, ctx, cache, pre_row, press, None, shared=True)
            self._ctx_pending.add(key)
        try:
            return (yield from self._prefill_issue_miss(req, ctx, key, press))
        finally:
            if key is not None:
                self._ctx_pending.discard(key)

    def _prefill_issue_miss(self, req: Request, ctx: list, key, press):
        """The LRU-miss body of :meth:`_prefill_issue_steps` (same generator
        contract): the press-compressed prefill, a multi-pass press's scoring
        passes, the LRU store."""
        runner, params = self.runner, self.params
        valid = None
        if self.context_bucket is not None:
            if req.inputs_embeds is not None:
                raise ValueError("multimodal admissions need context_chunk or exact-length "
                                 "prefill (bucket pads break the image-span or-mask)")
            pad = -(-len(ctx) // self.context_bucket) * self.context_bucket
            valid = len(ctx)
            ctx = ctx + [0] * (pad - len(ctx))
        ids = torch.tensor([ctx], dtype=torch.long, device=self.device)
        common = dict(press=press, compute_logits=True, dtype=self.dtype,
                      quantized=self.quantized, kv_bits=self.kv_bits,
                      inputs_embeds=req.inputs_embeds, token_types=req.token_types,
                      image_span=self.image_span if req.token_types is not None else None)
        multi_pass = getattr(press, "multi_pass", False)
        if self.context_chunk is not None:
            # Bounded activations: the context in chunks, the buffer presized
            # for a multi-pass press's scoring passes and bucketed to a chunk
            # multiple.
            need = ids.shape[1]
            if multi_pass == "kvcompose" and press.compression_ratio > 0:
                need += ids.shape[1]      # the re-fed context
            elif multi_pass is True:
                need += kvzip_repeat_bound(press, req.context_ids, self.tokenizer)
            bucketed = -(-need // self.context_chunk) * self.context_chunk
            logits, cache, press_state = yield from runner.prefill_chunked_steps(
                params, ids, chunk_size=self.context_chunk, max_size=bucketed, **common)
        else:
            logits, cache, press_state = runner.prefill(params, ids, valid_len=valid, **common)

        if press is not None and getattr(press, "rerotates", False):
            # Rerotated keys sit at positions 0..n-1: the question and the
            # answer continue from the compressed length.
            cache = dataclasses.replace(
                cache, offset=torch.tensor(int(cache.length.max()), dtype=torch.int32))
        if self.multi_pass or self.post_mask:
            pipe = KVPressPipeline(runner, params, tokenizer=self.tokenizer)
            if multi_pass == "kvcompose":
                cache = pipe._run_kvcompose(cache, list(req.context_ids), press,
                                            context_chunk=self.context_chunk,
                                            context_embeds=req.inputs_embeds)
            elif multi_pass:
                cache = pipe._run_kvzip(cache, list(req.context_ids), press,
                                        context_embeds=req.inputs_embeds)
            if self.post_mask:
                cache = press.apply_post_mask(cache, press_state)
        if press is not None and getattr(press, "host_compact", False):
            # Head-wise compaction lets a masked admission fit a small slot.
            cache = compact_masked(cache, runner.shard)

        pre_row = logits[0, -1]
        if key is not None:
            # The entry: the compressed pre-question cache, shrunk to the
            # static kept bound of the unpadded context (front-compacted: the
            # slice is lossless), with the last prefill logits for a
            # questionless admission. A compacting press's entry shrinks again
            # to its measured length at completion.
            bound = min(self._kept_bound(len(req.context_ids), press), cache.max_size)
            if cache.max_size > bound:
                cache = shrink(cache, bound)
            self._lru_store(key, cache, pre_row)
        return self._finish_issue(req, ctx, cache, pre_row, press, key, shared=key is not None)

    def _lru_store(self, key, cache: KVCache, pre_row: torch.Tensor):
        self._ctx_lru[key] = (cache, pre_row)
        while len(self._ctx_lru) > self.context_cache:
            self._ctx_lru.popitem(last=False)

    def _pick_first(self, row: torch.Tensor) -> torch.Tensor:
        """The first token from a (V,) logits row, on the device: argmax, or a
        draw from the admissions' generator."""
        if not self.do_sample:
            return torch.argmax(row)
        return _sample_rows(row[None], self._adm_gen, self.temperature, self.top_p)[0]

    def _finish_issue(self, req: Request, ctx: list, cache: KVCache, pre_row, press, lru_key,
                      shared: bool = False):
        """Question forward and re-bucket to the capacity, on a compressed
        cache fresh from the prefill or stored in the LRU (``shared``: the
        forward writes K/V in place, so a stored cache that is not grown for
        the question is copied first)."""
        q_ids = list(req.question_ids)
        if q_ids:
            qb = self.question_bucket
            qpad = -(-len(q_ids) // qb) * qb
            qarr = torch.tensor([q_ids + [0] * (qpad - len(q_ids))], dtype=torch.long,
                                device=self.device)
            # The static kept bound, not a device read: growth needs only an
            # upper bound, and the re-bucket to the capacity follows.
            need = min(self._kept_bound(len(ctx), press), cache.max_size) + qpad
            if cache.max_size < need:
                cache = grow(cache, need - cache.max_size)
            elif shared:
                cache = dataclasses.replace(cache, **{
                    n: getattr(cache, n).clone()
                    for n in ("keys", "values", "mask", "key_scales", "value_scales")
                    if getattr(cache, n) is not None})
            logits, cache, _ = self.runner.forward(self.params, qarr, cache,
                                                   logits_last_only=True, valid_len=len(q_ids))
            first = self._pick_first(logits[0, -1])
        else:
            first = self._pick_first(pre_row)
        kept = int(cache.length.max())
        return resize(cache, self.capacity), kept, first, lru_key

    def _issue_admission(self, slot: int, req_idx: int, req: Request, press=_UNSET,
                         retried: bool = False) -> dict:
        """The prefill issued and its cache inserted into the slot, with no
        host sync. The slot is not live yet."""
        cache, kept, first, lru_key = self._prefill_issue(req, press)
        return self._insert_admitted(slot, req_idx, req, cache, kept, first, lru_key,
                                     retried=retried)

    def _insert_admitted(self, slot: int, req_idx: int, req: Request, cache: KVCache, kept: int,
                         first: torch.Tensor, lru_key=None, retried: bool = False) -> dict:
        """Insert an issued admission's cache into the pool and stage its
        first token in a new tokens tensor (a pending step may hold the old
        one); the slot goes live in :meth:`_complete_admission`."""
        self.sc = _insert_slot(self.sc, cache, slot, self.own)
        if self.dp_state is not None:
            self.dp_state = _reset_slot_state(self.dp_state, slot, self.own)
        tokens = self.tokens.clone()
        tokens[slot] = first
        self.tokens = tokens
        return dict(slot=slot, req_idx=req_idx, req=req, kept=kept, first=_copy_to_host(first),
                    lru_key=lru_key, retried=retried)

    def _complete_admission(self, adm: dict):
        """Read the first token (its copy was issued with the admission, so
        the wait overlaps the decode steps queued since) and mark the slot
        live; or retry / drop a compacting press's admission that does not
        fit."""
        slot, req = adm["slot"], adm["req"]
        kept, first = adm["kept"], int(_read_host(adm["first"]))
        key = adm.get("lru_key")
        if (key is not None and key in self._ctx_lru and self.press is not None
                and getattr(self.press, "compact", False)):
            # The measured-length LRU shrink of a compacting press: the store
            # used the static bound (the whole context for KVzip); ``kept``
            # bucketed is the lossless one.
            bucket = self.context_chunk or self.question_bucket
            tgt = -(-max(kept, 1) // bucket) * bucket
            entry, pre_row = self._ctx_lru[key]
            if entry.max_size > tgt:
                self._ctx_lru[key] = (shrink(entry, tgt), pre_row)
        if kept + req.max_new_tokens + 1 > self.capacity:
            if self.press is None or not getattr(self.press, "compact", False):
                raise RuntimeError(
                    f"request needs {kept + req.max_new_tokens + 1} slots, capacity is "
                    f"{self.capacity}: raise capacity or compress more")
            # Optimistic admission missed: the compacted cache was cut by the
            # re-bucket. Retry once at a ratio clamped to the slot; a failed
            # retry drops the request (empty answer, the slot reusable).
            self.live[slot] = False
            self.slots[slot] = _SlotState()
            if isinstance(self.press, DMSPress):
                logger.warning("request %d compacted to %d slots but needs %d > capacity %d: "
                               "dropped (a threshold press has no ratio to clamp)",
                               adm["req_idx"], kept, kept + req.max_new_tokens + 1,
                               self.capacity)
                self._dropped.append(adm["req_idx"])
                return
            if not adm.get("retried"):
                budget = self.capacity - len(req.question_ids) - req.max_new_tokens - 1
                r0 = float(self.press.compression_ratio)
                # kept ~ (1 - r) ctx per head at ratio r: aim 5% under the
                # slot budget, at least a real increase, below 1.
                r2 = 1.0 - (1.0 - r0) * (budget / max(kept, 1)) * 0.95
                r2 = min(max(r2, min(r0 + 0.05, 0.999)), 0.999)
                logger.warning("request %d compacted to %d slots but needs %d > capacity %d: "
                               "retrying once at compression_ratio %.3f", adm["req_idx"], kept,
                               kept + req.max_new_tokens + 1, self.capacity, r2)
                self._retry_pending.append(dict(req_idx=adm["req_idx"], req=req,
                                                press=_with_ratio(self.press, r2)))
                self._retries += 1
                return
            logger.warning("request %d still needs %d > capacity %d after the clamped retry: "
                           "dropped", adm["req_idx"], kept + req.max_new_tokens + 1,
                           self.capacity)
            self._dropped.append(adm["req_idx"])
            return
        if self._t_run_start is not None:
            # TTFT, queueing included, of admissions that go live only.
            self._ttfts.append(time.perf_counter() - self._t_run_start)
        self.live[slot] = True
        st = self.slots[slot]
        st.req_idx = adm["req_idx"]
        st.generated = [first]
        st.budget = req.max_new_tokens
        st.in_flight = 0
        st.done_at = 1 if first in self.eos_ids else None
        if self._on_token is not None:
            self._on_token(adm["req_idx"], first, 1)

    def _admit(self, slot: int, req_idx: int, req: Request):
        self._complete_admission(self._issue_admission(slot, req_idx, req))
        while self._retry_pending:
            r = self._retry_pending.pop(0)
            self._complete_admission(self._issue_admission(slot, r["req_idx"], r["req"],
                                                           press=r["press"], retried=True))

    def _step(self) -> torch.Tensor:
        """Issue one decode step over the pool; returns its tokens."""
        self.tokens, self.sc, self.dp_state = _decode_step(
            self.params, self.tokens, self.sc, torch.from_numpy(self.live.copy()),
            self.dp_state, self._step_gen, runner=self.runner, decode_press=self.decode_press,
            do_sample=self.do_sample, temperature=self.temperature, top_p=self.top_p,
            own=self.own, gather=self._gather)
        return self.tokens

    # ---------------- main loop ---------------- #

    def _next_request(self, requests: list, queue: list) -> int:
        if self.schedule == "sjf":
            # shortest job first: the smallest budget, then the shortest context
            pos = min(range(len(queue)), key=lambda j: (requests[queue[j]].max_new_tokens,
                                                         len(requests[queue[j]].context_ids)))
        elif self.schedule == "priority":
            pos = min(range(len(queue)), key=lambda j: (-requests[queue[j]].priority, j))
        else:
            pos = 0
        return queue.pop(pos)

    def run(self, requests: list[Request], progress: bool = False,
            on_token=None) -> list[list[int]]:
        """Serve every request; returns the generated token lists (EOS
        included, tokens issued past it trimmed).

        ``on_token(req_idx, token_id, n_so_far)`` is called as tokens are read
        from the device (the first at admission, then one per decode token);
        tokens past an EOS are never delivered, so the streamed sequence
        equals the returned answer. It runs on the host loop between issues:
        keep it cheap.

        A slot stops taking steps once its budget is fully issued or an EOS
        is read; it retires, and is reusable, once every issued step has been
        read."""
        # Requests that cannot fit a slot are refused before any device work
        # (the static bound; a compacting press is admitted optimistically,
        # checked only for question + generation here).
        optimistic = (self.press is not None and getattr(self.press, "compact", False)
                      and self.runner.cfg.sliding_window is None)
        too_big = [i for i, r in enumerate(requests)
                   if (len(r.question_ids) + r.max_new_tokens + 1 >= self.capacity
                       if optimistic else self._slots_needed(r) > self.capacity)]
        if too_big:
            raise ValueError(f"requests {too_big} cannot fit capacity={self.capacity}: static "
                             "bound kept + question + max_new_tokens + 1 exceeds the slot; raise "
                             "capacity or compress more")
        t_start = time.perf_counter()
        self._t_run_start = t_start
        self._on_token = on_token
        self._ttfts = []
        hits0, skipped0 = self.ctx_hits, self._skipped_ctx_tokens
        n_steps = 0
        answers: list[Optional[list]] = [None] * len(requests)
        self._dropped, self._retry_pending, self._retries = [], [], 0
        queue = list(range(len(requests)))
        pending: list[tuple] = []    # (host copy of a step's tokens, live snapshot)
        admits: list[dict] = []      # issued, not completed
        inflight: list[dict] = []    # interleaved admissions in progress
        rr = 0                       # round-robin cursor over inflight
        reserved: set[int] = set()   # slots held by admissions
        drain_times: list[float] = []

        def drain_one():
            copy, live_snap = pending.pop(0)
            host = _read_host(copy).tolist()
            drain_times.append(time.perf_counter())
            for s in range(self.n_slots):
                if not live_snap[s]:
                    continue
                st = self.slots[s]
                st.in_flight -= 1
                if st.req_idx < 0:
                    continue
                st.generated.append(host[s])
                if st.done_at is None and host[s] in self.eos_ids:
                    st.done_at = len(st.generated)
                    self.live[s] = False
                if on_token is not None and (st.done_at is None
                                             or len(st.generated) <= st.done_at) \
                        and len(st.generated) <= st.budget:
                    on_token(st.req_idx, host[s], len(st.generated))

        def finish(s: int):
            st = self.slots[s]
            n = st.done_at if st.done_at is not None else st.budget
            answers[st.req_idx] = st.generated[:n]
            if progress:
                print(f"finished request {st.req_idx} ({len(answers[st.req_idx])} tokens)",
                      flush=True)
            self.slots[s] = _SlotState()

        while (queue or admits or inflight or self._retry_pending
               or any(st.req_idx >= 0 for st in self.slots)):
            while len(pending) > self.fetch_lag:
                drain_one()
            for s in range(self.n_slots):
                st = self.slots[s]
                if st.req_idx >= 0 and not self.live[s] and st.in_flight == 0:
                    finish(s)
            # Issue every free slot's admission back to back; their first
            # tokens are read after this turn's decode step is issued.
            for s in range(self.n_slots):
                if self.max_admissions is not None and len(reserved) >= self.max_admissions:
                    break
                if not (self.slots[s].req_idx < 0 and s not in reserved
                        and (queue or self._retry_pending)):
                    continue
                if self._retry_pending:
                    # Clamped retries first: their request is partly paid for.
                    r = self._retry_pending.pop(0)
                    idx, req, press, retried = r["req_idx"], r["req"], r["press"], True
                else:
                    idx = self._next_request(requests, queue)
                    req, press, retried = requests[idx], _UNSET, False
                if self.interleave:
                    inflight.append(dict(slot=s, req_idx=idx, req=req, retried=retried,
                                         gen=self._prefill_issue_steps(req, press)))
                else:
                    admits.append(self._issue_admission(s, idx, req, press=press,
                                                        retried=retried))
                reserved.add(s)
                if progress:
                    print(f"admitting request {idx} -> slot {s}", flush=True)
            # Interleaved admission: one in-flight admission advances by one
            # chunk or compressed layer per turn, round robin, so this turn's
            # decode step lands between chunk calls (Sarathi-style).
            if inflight:
                rr %= len(inflight)
                st = inflight[rr]
                try:
                    next(st["gen"])
                    rr += 1
                except StopIteration as stop:
                    cache, kept, first, lru_key = stop.value
                    inflight.remove(st)
                    admits.append(self._insert_admitted(st["slot"], st["req_idx"], st["req"],
                                                        cache, kept, first, lru_key,
                                                        retried=st["retried"]))
            if self.live.any():
                tokens = self._step()
                n_steps += 1
                snap = self.live.copy()
                pending.append((_copy_to_host(tokens), snap))
                for s in range(self.n_slots):
                    if snap[s]:
                        st = self.slots[s]
                        st.in_flight += 1
                        if len(st.generated) + st.in_flight >= st.budget:
                            self.live[s] = False      # budget fully issued
            elif pending and not admits and not inflight:
                drain_one()
            for adm in admits:
                self._complete_admission(adm)
                reserved.discard(adm["slot"])
                if progress:
                    print(f"admitted request {adm['req_idx']} -> slot {adm['slot']}",
                          flush=True)
            admits.clear()
        wall = time.perf_counter() - t_start
        for i in self._dropped:
            answers[i] = []
        gen = sum(len(a) for a in answers)
        skipped = self._skipped_ctx_tokens - skipped0
        proc = gen + sum(len(r.context_ids) + len(r.question_ids) for r in requests) - skipped
        self.last_stats = {
            "wall_s": wall,
            "requests": len(requests),
            "generated_tokens": gen,
            "generated_tok_s": gen / wall if wall > 0 else float("inf"),
            "processed_tokens": proc,
            "processed_tok_s": proc / wall if wall > 0 else float("inf"),
            "decode_steps": n_steps,
            "slot_step_utilization": gen / (n_steps * self.n_slots) if n_steps else 0.0,
            "ctx_hits": self.ctx_hits - hits0,
            "skipped_context_tokens": skipped,
            "dropped_requests": len(self._dropped),
            "dropped": list(self._dropped),
            "retried_admissions": self._retries,
            "lru_entries": len(self._ctx_lru),
            # Over every rank's kv heads, as one device would hold them.
            "lru_bytes": sum(_cache_nbytes(c) * (self.runner.shard.size if self.runner.shard
                                                 else 1) + r.numel() * r.element_size()
                             for c, r in self._ctx_lru.values()),
        }
        gaps = sorted(b - a for a, b in zip(drain_times, drain_times[1:]))
        if gaps:
            self.last_stats["p50_intertoken_gap_s"] = gaps[len(gaps) // 2]
            self.last_stats["p99_intertoken_gap_s"] = gaps[min(len(gaps) - 1,
                                                               int(len(gaps) * 0.99))]
            self.last_stats["max_intertoken_gap_s"] = gaps[-1]
        if self._ttfts:
            ts = sorted(self._ttfts)
            self.last_stats["p50_ttft_s"] = ts[len(ts) // 2]
            self.last_stats["p99_ttft_s"] = ts[min(len(ts) - 1, int(len(ts) * 0.99))]
            self.last_stats["max_ttft_s"] = ts[-1]
        self._t_run_start = None
        self._on_token = None
        return answers
