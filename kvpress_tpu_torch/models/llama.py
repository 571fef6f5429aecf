"""Llama-family decoder runner (port of ``kvpress_tpu/models/llama.py``,
Llama only).

Weights live in an ``nn.Module`` (``LlamaModel``: embedding, a
``ModuleList`` of decoder layers, final norm, head) in the JAX package's
``(in, out)`` layout, so ``h @ w`` is the JAX ``_lin``. The JAX ``lax.scan``
over stacked layers is a Python loop over layers; the press runs inside the
layer body during prefill, with the same ``LayerCtx``.

Attention routing is the JAX runner's (``llama.py:446-683``): a press that
wants attention probabilities gets the dense path; other multi-token calls
go to ``ops.flash.flash_attention`` (with the row LSE for a press that wants
it; ``flash_attention_quant`` for an int8 cache with no press applied);
few-token calls (T <= 128 and T*G <= 512) go to
``ops.decode.decode_attention`` when ``decode_kernel`` is set, or, for one
token over a bf16 cache with ``headwise_kernel`` set and the decode kernel
off, to ``ops.decode_headwise.decode_attention_headwise``; everything else
goes to the dense paths of ``ops.attention``. Those wrappers launch the
Hopper kernels on CUDA tensors and run their plain versions on CPU tensors.

``Runner.prefill_chunked`` is the bounded-activation prefill (port of the
JAX lean chunk path): the context goes through the layers a chunk at a time
(``_chunk_forward_lean``, no press), then ``_compress_layer`` compresses the
cache once, layer by layer, in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..cache import (KVCache, append_layer_kv, clamp_start, dequantize_kv, init_cache,
                     quantize_kv)
from ..config import ModelConfig
from ..device import DeviceLike, resolve_device
from ..ops.attention import attention_bias, gqa_attention, quant_gqa_attention
from ..ops.decode import decode_attention
from ..ops.decode_headwise import decode_attention_headwise, prefix_tail_from_mask
from ..ops.flash import flash_attention, flash_attention_quant
from ..presses.base import BasePress, LayerCtx, ScorerPress
from ..rope import apply_rope, compute_inv_freq, rope_cos_sin

LINEARS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float, one_offset: bool = False):
    xf = x.to(torch.float32)
    normed = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    weight = (1.0 + w.to(torch.float32)) if one_offset else w.to(torch.float32)
    return (normed * weight).to(x.dtype)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class DecoderLayer(nn.Module):
    """One layer's weights: wq/wk/wv/wo/wg/wu/wd as (in, out) matrices
    (int8 payloads carry a ``<name>_scale`` of shape (1, out), int4 payloads,
    uint8 of shape (in/2, out), one of shape (2, out)), ln1/ln2."""

    def __init__(self, tensors: dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, _frozen(t))

    def get(self, name: str, default=None):
        return getattr(self, name, default)


class LlamaModel(nn.Module):
    def __init__(self, embed: torch.Tensor, layers: list[dict[str, torch.Tensor]],
                 ln_f: torch.Tensor, lm_head: Optional[torch.Tensor] = None,
                 extra: Optional[dict[str, torch.Tensor]] = None):
        super().__init__()
        self.embed = _frozen(embed)
        self.layers = nn.ModuleList(DecoderLayer(t) for t in layers)
        self.ln_f = _frozen(ln_f)
        self.lm_head = None if lm_head is None else _frozen(lm_head)
        for name, t in (extra or {}).items():      # embed_scale, lm_head_scale
            setattr(self, name, _frozen(t))

    def get(self, name: str, default=None):
        return getattr(self, name, default)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype, read from a norm weight (the embedding may be
        int8)."""
        return self.ln_f.dtype

    @property
    def device(self) -> torch.device:
        return self.ln_f.device


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = "cuda") -> LlamaModel:
    """Random init, N(0, 0.02) weights and unit norms, drawn from
    ``generator`` (which must live on ``device``)."""
    if cfg.attention_bias or cfg.qk_norm or cfg.post_norms:
        raise NotImplementedError(
            "qkv bias, q/k-norm and post-norms come with the other "
            "architectures (ROADMAP Queue A item 9)")
    device = resolve_device(device)
    E, Fd = cfg.hidden_size, cfg.intermediate_size
    Hq, Hkv, D, V = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.vocab_size

    def init(*shape):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * 0.02).to(dtype)

    shapes = {"wq": (E, Hq * D), "wk": (E, Hkv * D), "wv": (E, Hkv * D),
              "wo": (Hq * D, E), "wg": (E, Fd), "wu": (E, Fd), "wd": (Fd, E)}
    layers = []
    for _ in range(cfg.num_layers):
        t = {name: init(*shape) for name, shape in shapes.items()}
        t["ln1"] = torch.ones(E, dtype=dtype, device=device)
        t["ln2"] = torch.ones(E, dtype=dtype, device=device)
        layers.append(t)
    embed = init(V, E)
    head = None if cfg.tie_word_embeddings else init(E, V)
    return LlamaModel(embed, layers, torch.ones(E, dtype=dtype, device=device), head)


def _lin(h: torch.Tensor, layer, name: str) -> torch.Tensor:
    """h @ layer.<name>, reading quantized weights with their
    per-output-channel scales.

    int8: ``(h @ w_int8) * scale``. int4 (a uint8 payload of shape
    (in/2, out)): the low nibbles hold the first half of the contraction
    axis and the high nibbles the second, each with a +8 offset, like the
    int4 KV cache; two half-width products, each with its own (out,) scale
    from the (2, out) ``<name>_scale``."""
    w = layer.get(name)
    scale = layer.get(name + "_scale")
    if scale is None:
        return h @ w
    if w.dtype == torch.uint8:
        E2 = w.shape[-2]
        lo = (w & 0xF).to(h.dtype) - 8
        hi = (w >> 4).to(h.dtype) - 8
        return ((h[..., :E2] @ lo) * scale[0].to(h.dtype)
                + (h[..., E2:] @ hi) * scale[1].to(h.dtype))
    return (h @ w.to(h.dtype)) * scale.to(h.dtype)


def _quantize_int8(w: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    wf = w.to(torch.float32)
    scale = torch.clamp(wf.abs().amax(dim=dim, keepdim=True) / 127.0, min=1e-8)
    return torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8), scale


def quantize_params_int8(params: LlamaModel, include_embeddings: bool = False) -> LlamaModel:
    """Per-output-channel int8 quantization of the layer matmuls (norms keep
    their dtype); ``include_embeddings`` also quantizes the embedding (per
    row) and an untied head (per output channel). Returns a new module."""
    layers = []
    for layer in params.layers:
        t = {name: p.data for name, p in layer.named_parameters(recurse=False)}
        for name in LINEARS:
            t[name], t[name + "_scale"] = _quantize_int8(t[name], dim=0)
        layers.append(t)
    embed, head, extra = params.embed.data, params.get("lm_head"), {}
    head = None if head is None else head.data
    if include_embeddings:
        embed, extra["embed_scale"] = _quantize_int8(embed, dim=1)
        if head is not None:
            head, extra["lm_head_scale"] = _quantize_int8(head, dim=0)
    return LlamaModel(embed, layers, params.ln_f.data, head, extra)


def dequant_weight(layer, name: str, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The full-precision (in, out) matrix of a possibly int8- or
    int4-quantized weight, scales applied."""
    w = layer.get(name)
    scale = layer.get(name + "_scale")
    if scale is None:
        return w.to(dtype)
    if w.dtype == torch.uint8:
        lo = ((w & 0xF).to(dtype) - 8) * scale[0].to(dtype)
        hi = ((w >> 4).to(dtype) - 8) * scale[1].to(dtype)
        return torch.cat([lo, hi], dim=0)
    return w.to(dtype) * scale.to(dtype)


def quantize_params_int4(params: LlamaModel) -> LlamaModel:
    """int4 quantization of the layer matmuls, per output channel and per
    half of the contraction axis (scales (2, out), float32); the payload is
    ``_lin``'s uint8 layout. Norms, embedding and head stay as they are, so
    this composes after ``quantize_params_int8(include_embeddings=True)``;
    an int8 matrix is dequantized first. Returns a new module."""
    layers = []
    for layer in params.layers:
        t = {name: p.data for name, p in layer.named_parameters(recurse=False)}
        for name in LINEARS:
            w = t[name]
            if w.dtype == torch.int8:
                w = w.to(torch.float32) * t[name + "_scale"]
            w = w.to(torch.float32)                              # (in, out)
            half = w.shape[0] // 2
            halves = torch.stack([w[:half], w[half:]])           # (2, in/2, out)
            scale = torch.clamp(halves.abs().amax(dim=1) / 7.0, min=1e-8)   # (2, out)
            q = (torch.clamp(torch.round(halves / scale[:, None]), -8, 7) + 8).to(torch.uint8)
            t[name] = q[0] | (q[1] << 4)
            t[name + "_scale"] = scale
        layers.append(t)
    head = params.get("lm_head")
    extra = {n: params.get(n).data for n in ("embed_scale", "lm_head_scale")
             if params.get(n) is not None}
    return LlamaModel(params.embed.data, layers, params.ln_f.data,
                      None if head is None else head.data, extra)


def embed_tokens(params: LlamaModel, ids: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    emb = params.embed
    x = emb[ids]
    if emb.dtype == torch.int8:
        dt = params.dtype
        x = x.to(dt) * params.embed_scale[ids].to(dt)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
    return x


def lm_head_logits(x: torch.Tensor, params: LlamaModel, cfg: ModelConfig) -> torch.Tensor:
    """Final-normed hidden -> float32 logits (+ softcap)."""
    head = params.get("lm_head")
    if head is not None:
        logits = (x @ head.to(x.dtype)).to(torch.float32)
        scale = params.get("lm_head_scale")
        if scale is not None and head.dtype == torch.int8:
            logits = logits * scale.to(torch.float32)
    else:
        emb = params.embed
        logits = (x @ emb.t().to(x.dtype)).to(torch.float32)
        if emb.dtype == torch.int8:
            logits = logits * params.embed_scale[:, 0].to(torch.float32)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _project_qkv(layer, cfg: ModelConfig, h: torch.Tensor):
    """h (B, S, E) -> q (B, Hq, S, D), k/v (B, Hkv, S, D), pre-RoPE."""
    B, S, _ = h.shape
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _lin(h, layer, "wq").reshape(B, S, Hq, D).transpose(1, 2)
    k = _lin(h, layer, "wk").reshape(B, S, Hkv, D).transpose(1, 2)
    v = _lin(h, layer, "wv").reshape(B, S, Hkv, D).transpose(1, 2)
    return q, k, v


def _sm_scale(cfg: ModelConfig) -> float:
    return (cfg.query_pre_attn_scalar ** -0.5 if cfg.query_pre_attn_scalar is not None
            else cfg.head_dim ** -0.5)


def _finish_layer(x: torch.Tensor, attn_out: torch.Tensor, layer, cfg: ModelConfig):
    """The residual stream after a layer's attention output (B, Hq, T, D): the
    output projection, then the MLP block."""
    B, _, T, _ = attn_out.shape
    x = x + _lin(attn_out.transpose(1, 2).reshape(B, T, -1), layer, "wo")
    h2 = rms_norm(x, layer.ln2, cfg.rms_norm_eps, cfg.rms_one_offset)
    mlp = _act(_lin(h2, layer, "wg"), cfg.act) * _lin(h2, layer, "wu")
    return x + _lin(mlp, layer, "wd")


def _unsupported(cfg: ModelConfig) -> None:
    if (cfg.sliding_window is not None or cfg.qk_norm or cfg.attention_bias
            or cfg.post_norms or cfg.rope_local_base_freq is not None):
        raise NotImplementedError(
            "sliding-window, q/k-norm, qkv-bias and Gemma/Qwen3/Phi3 specifics "
            "come with the other architectures (ROADMAP Queue A item 9)")


@dataclasses.dataclass(frozen=True)
class Runner:
    """Config + host RoPE constants + attention routing."""
    cfg: ModelConfig
    attention_scaling: float
    device: torch.device
    inv_freq: torch.Tensor = dataclasses.field(compare=False)   # (head_dim/2,) f32
    # "flash": kernel wrappers for multi-token calls; "xla": dense paths (the
    # name is the JAX package's, kept so both runners take the same options).
    attn_impl: str = "xla"
    # Few-token calls through ops/decode.py (live-step skipping, fused
    # dequant). Only meaningful with attn_impl="flash".
    decode_kernel: bool = False
    decode_block_k: int = 2048
    # One-token decode over per-head prefixes through ops/decode_headwise.py
    # (caches compacted head by head, AdaKV ``compact=True``). Only
    # meaningful with attn_impl="flash" and the decode kernel off.
    headwise_kernel: bool = False

    @staticmethod
    def create(cfg: ModelConfig, attn_impl: str = "auto",
               decode_kernel: Optional[bool] = None, decode_block_k: int = 2048,
               headwise_kernel: bool = False, device: DeviceLike = "cuda") -> "Runner":
        """``attn_impl="auto"`` is "flash" on CUDA and "xla" on the CPU;
        ``decode_kernel=None`` turns the decode kernel on for CUDA. (The JAX
        runner leaves it off for a TPU-only reason: Mosaic's per-grid-cell
        overhead.) The decode kernel takes every few-token call it can, so
        ``headwise_kernel=True`` routes only with ``decode_kernel=False``."""
        _unsupported(cfg)
        device = resolve_device(device)
        inv, scaling = compute_inv_freq(cfg)
        if attn_impl == "auto":
            attn_impl = "flash" if device.type == "cuda" else "xla"
        if decode_kernel is None:
            decode_kernel = device.type == "cuda"
        return Runner(cfg=cfg, attention_scaling=scaling, device=device,
                      inv_freq=torch.from_numpy(inv).to(device), attn_impl=attn_impl,
                      decode_kernel=decode_kernel, decode_block_k=decode_block_k,
                      headwise_kernel=headwise_kernel)

    # ------------------------------------------------------------------ #

    def _layer_step(
        self,
        x: torch.Tensor,                 # (B, T, E)
        layer,
        cache_layer: dict,               # keys/values/length/mask/scales, one layer
        positions: torch.Tensor,         # (B, T)
        rope: tuple[torch.Tensor, torch.Tensor],   # cos/sin (B, 1, T, D) f32
        layer_idx: int,
        press: Optional[BasePress],
        press_state,
        phase: str,
        kv_bits: int = 8,
    ):
        cfg = self.cfg
        apply_press = press is not None and (
            (phase == "prefill" and press.compresses_prefill)
            or (phase == "decode" and press.compresses_decode)
        )
        if apply_press and phase == "decode":
            raise NotImplementedError("decode-time presses come with ROADMAP Queue A item 12")
        B, T, E = x.shape
        h = rms_norm(x, layer.ln1, cfg.rms_norm_eps, cfg.rms_one_offset)
        q_pre, k_pre, v = _project_qkv(layer, cfg, h)
        cos, sin = rope
        q = apply_rope(q_pre, cos, sin).contiguous()
        k = apply_rope(k_pre, cos, sin)

        prior_len = int(cache_layer["length"])
        quantized = cache_layer.get("key_scales") is not None
        scale = _sm_scale(cfg)
        return_probs = apply_press and press.wants_probs(T)
        want_lse = apply_press and press.wants_lse(T)

        G = cfg.num_heads // cfg.num_kv_heads
        use_decode_kernel = (
            self.attn_impl == "flash" and self.decode_kernel and not return_probs
            and T <= 128 and T * G <= 512
        )
        # One token only: appended tokens that a head's all-live prefix
        # absorbs are visible to every row of the call.
        use_headwise = (
            self.attn_impl == "flash" and self.headwise_kernel and not use_decode_kernel
            and not return_probs and not apply_press and not quantized and T == 1
        )
        S_buf = cache_layer["keys"].shape[2]
        start = clamp_start(prior_len, T, S_buf)
        qkeys = qvalues = key_scales = value_scales = None
        if quantized:
            # Store the new K/V as payload + scales. The whole layer buffer is
            # dequantized only when dense K/V are needed (press scoring, or a
            # multi-token call the quantized kernel does not take).
            qk, k_scale = quantize_kv(k, kv_bits)
            qv, v_scale = quantize_kv(v, kv_bits)
            qkeys, qvalues = cache_layer["keys"], cache_layer["values"]
            key_scales, value_scales = cache_layer["key_scales"], cache_layer["value_scales"]
            qkeys[:, :, start:start + T] = qk
            qvalues[:, :, start:start + T] = qv
            key_scales[:, :, start:start + T] = k_scale
            value_scales[:, :, start:start + T] = v_scale
            new_len = prior_len + T
            # int8 only, as in the JAX runner (int4's two half-depth nibble
            # products were slower at multi-token shapes on the TPU; kept so
            # both runners route alike).
            use_quant_flash = (
                self.attn_impl == "flash" and T > 1 and kv_bits == 8
                and not use_decode_kernel and not apply_press
            )
            needs_dense = apply_press or return_probs or (
                self.attn_impl == "flash" and T > 1
                and not use_decode_kernel and not use_quant_flash
            )
            if needs_dense:
                keys = dequantize_kv(qkeys, key_scales, kv_bits, x.dtype)
                values = dequantize_kv(qvalues, value_scales, kv_bits, x.dtype)
                # The current block attends (and is scored on) its original
                # values: quantization is storage-only for the pass that
                # produced them (reference QuantizedCache.update semantics).
                keys[:, :, start:start + T] = k.to(keys.dtype)
                values[:, :, start:start + T] = v.to(values.dtype)
            else:
                keys = values = None
        else:
            keys, values, new_len = append_layer_kv(
                cache_layer["keys"], cache_layer["values"], prior_len, k, v)
        mask = cache_layer["mask"]                       # (B, Hkv, S_buf)
        # Newly appended tokens are attendable by every head.
        mask[:, :, start:start + T] = True

        use_flash = (self.attn_impl == "flash" and not return_probs and T > 1
                     and not use_decode_kernel)
        probs = attn_lse = None
        if use_headwise:
            pfx, tail_start, tail_len = prefix_tail_from_mask(mask, new_len)
            attn_out = decode_attention_headwise(q, keys, values, pfx, tail_start, tail_len,
                                                 sm_scale=scale, softcap=cfg.logit_softcap)
        elif use_decode_kernel:
            if quantized:
                attn_out = decode_attention(
                    q, qkeys, qvalues, new_len, key_scales, value_scales, mask,
                    bits=kv_bits, sm_scale=scale, softcap=cfg.logit_softcap,
                    block_k=self.decode_block_k)
            else:
                attn_out = decode_attention(
                    q, keys, values, new_len, mask=mask, sm_scale=scale,
                    softcap=cfg.logit_softcap, block_k=self.decode_block_k)
        elif use_flash:
            if quantized and keys is None:
                attn_out = flash_attention_quant(
                    q, qkeys, qvalues, key_scales, value_scales, prior_len, mask,
                    bits=kv_bits, sm_scale=scale, softcap=cfg.logit_softcap)
            else:
                attn_out = flash_attention(q, keys, values, prior_len, mask, sm_scale=scale,
                                           softcap=cfg.logit_softcap, return_lse=want_lse)
                if want_lse:
                    attn_out, attn_lse = attn_out
        else:
            bias = attention_bias(prior_len, T, S_buf, head_mask=mask)
            if quantized and keys is None:
                attn_out = quant_gqa_attention(q, qkeys, qvalues, key_scales, value_scales,
                                               bias, scale, kv_bits, softcap=cfg.logit_softcap)
            else:
                attn_out, probs = gqa_attention(q, keys, values, bias, scale,
                                                softcap=cfg.logit_softcap,
                                                return_probs=return_probs)

        new_state = press_state
        if apply_press:
            ctx = LayerCtx(
                layer_idx=layer_idx, hidden=h, queries=q, queries_prerope=q_pre,
                keys_prerope=k_pre, positions=positions, attn_probs=probs,
                layer_params=layer, inv_freq=self.inv_freq, cfg=cfg,
                attention_scaling=self.attention_scaling, attn_lse=attn_lse,
            )
            # Prefill into an empty cache: compress over the first T slots.
            nk, nv, new_len, nmask, new_state = press.layer_compress(
                ctx, keys[:, :, :T], values[:, :, :T], new_len, mask[:, :, :T], press_state)
            keys[:, :, :T] = nk
            values[:, :, :T] = nv
            mask[:, :, :T] = nmask
            if quantized:
                # The press moved entries in the dense buffer: requantize.
                qk2, ks2 = quantize_kv(keys, kv_bits)
                qv2, vs2 = quantize_kv(values, kv_bits)
                qkeys.copy_(qk2)
                qvalues.copy_(qv2)
                key_scales.copy_(ks2)
                value_scales.copy_(vs2)

        return _finish_layer(x, attn_out, layer, cfg), int(new_len), new_state

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def forward(
        self,
        params: LlamaModel,
        ids: torch.Tensor,               # (B, T)
        cache: KVCache,
        press: Optional[BasePress] = None,
        press_state=None,
        phase: str = "none",
        compute_logits: bool = True,
        logits_last_only: bool = False,
    ):
        """Run T tokens through all layers against (and appending to) the cache.

        Returns (logits | None, cache', press_state'). K/V are written into
        the cache's buffers in place; cache' carries new ``length``/``offset``
        tensors, so the caller's ``cache.length``/``cache.offset`` still
        describe the state before the call (restoring them rolls back)."""
        cfg = self.cfg
        B, T = ids.shape
        x = embed_tokens(params, ids, cfg)
        offset = int(cache.offset)
        positions = (offset + torch.arange(T, device=ids.device))[None].expand(B, T)
        cos, sin = rope_cos_sin(self.inv_freq, positions, self.attention_scaling)
        rope = (cos[:, None], sin[:, None])             # shared by every layer
        mask = cache.mask
        if mask is None:
            mask = torch.ones(cache.keys.shape[:4], dtype=torch.bool, device=cache.keys.device)
        lengths = cache.length.tolist()
        new_lengths = []
        states = press_state
        for l, layer in enumerate(params.layers):
            cache_layer = dict(
                keys=cache.keys[l], values=cache.values[l], length=lengths[l], mask=mask[l],
                key_scales=None if cache.key_scales is None else cache.key_scales[l],
                value_scales=None if cache.value_scales is None else cache.value_scales[l],
            )
            state_l = None if states is None else states[l]
            x, nlen, state_l = self._layer_step(
                x, layer, cache_layer, positions, rope, l, press, state_l, phase,
                cache.bits)
            if states is not None:
                states[l] = state_l
            new_lengths.append(nlen)

        ovf = max(lengths) + T > cache.max_size
        if cache.overflowed is not None:
            ovf = ovf or bool(cache.overflowed)
        new_cache = dataclasses.replace(
            cache, length=torch.tensor(new_lengths, dtype=torch.int32), mask=mask,
            offset=torch.tensor(offset + T, dtype=torch.int32),
            overflowed=torch.tensor(ovf))

        logits = None
        if compute_logits:
            x = rms_norm(x, params.ln_f, cfg.rms_norm_eps, cfg.rms_one_offset)
            if logits_last_only:
                x = x[:, -1:]
            logits = lm_head_logits(x, params, cfg)
        return logits, new_cache, states

    def prefill(self, params: LlamaModel, ids: torch.Tensor, press=None, max_size=None,
                dtype: Optional[torch.dtype] = None, compute_logits: bool = False,
                quantized: bool = False, kv_bits: int = 8):
        """Compress-on-prefill entry: build a fresh cache for ids (B, S)."""
        B, S = ids.shape
        cache = init_cache(self.cfg, B, max_size or S, dtype=dtype or params.dtype,
                           quantized=quantized, bits=kv_bits, device=self.device)
        state = press.init_state(self.cfg, B, S) if press is not None else None
        return self.forward(params, ids, cache, press=press, press_state=state,
                            phase="prefill", compute_logits=compute_logits,
                            logits_last_only=True)

    # ------------------------------------------------------------------ #
    # Chunked prefill

    def prefill_chunked(self, params: LlamaModel, ids: torch.Tensor, press=None,
                        chunk_size: int = 8192, max_size: Optional[int] = None,
                        dtype: Optional[torch.dtype] = None, compute_logits: bool = False,
                        quantized: bool = False, kv_bits: int = 8, score_window: int = 1024,
                        fused_kv: Optional[bool] = None):
        """Bounded-activation prefill: the context goes through the layers
        ``chunk_size`` tokens at a time (each chunk's activations replace the
        whole context's), appended to the cache in place; then the cache is
        compressed once, layer by layer, scored against the last ``W =
        min(score_window, chunk_size, S)`` positions' queries, re-projected
        from their post-ln1 hidden states.

        Exact against ``prefill`` for content scorers (Knorm, Random) and for
        window scorers whose window fits in W (SnapKV, TOVA, PyramidKV,
        StreamingLLM). A ``ScorerPress`` compresses through
        ``BudgetDecodingPress`` (its own per-layer budget); a wrapper with
        ``chunked_compress`` (AdaKV) compresses itself.

        ``fused_kv`` (quantized caches): attention reads the payload through
        ``flash_attention_quant``; else each layer's buffer is dequantized and
        ``flash_attention`` runs. By default int8 is always fused and int4
        only when the dense transient (2 x 2 bytes x B x Hkv x max_size x D)
        is over 512 MiB. Either way a chunk attends its own quantized values.
        Returns (logits | None, cache, None)."""
        steps = self.prefill_chunked_steps(
            params, ids, press=press, chunk_size=chunk_size, max_size=max_size, dtype=dtype,
            compute_logits=compute_logits, quantized=quantized, kv_bits=kv_bits,
            score_window=score_window, fused_kv=fused_kv)
        while True:
            try:
                next(steps)
            except StopIteration as stop:
                return stop.value

    @torch.no_grad()
    def prefill_chunked_steps(self, params: LlamaModel, ids: torch.Tensor, press=None,
                              chunk_size: int = 8192, max_size: Optional[int] = None,
                              dtype: Optional[torch.dtype] = None,
                              compute_logits: bool = False, quantized: bool = False,
                              kv_bits: int = 8, score_window: int = 1024,
                              fused_kv: Optional[bool] = None):
        """Generator form of :meth:`prefill_chunked`: yields after each chunk
        forward and each compressed layer, and returns its triple through
        ``StopIteration`` (a server can interleave decode steps between the
        yields)."""
        from ..presses.decoding import BudgetDecodingPress

        if chunk_size < 1:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        cfg = self.cfg
        B, S = ids.shape
        size = max_size or S
        if size < S:
            raise ValueError(f"max_size {size} cannot hold the {S}-token context")
        if fused_kv is None:
            dense_bytes = 2 * 2 * B * cfg.num_kv_heads * size * cfg.head_dim
            fused_kv = kv_bits == 8 or dense_bytes > (1 << 29)
        cache = init_cache(cfg, B, size, dtype=dtype or params.dtype, quantized=quantized,
                           bits=kv_bits, device=self.device)
        W = min(score_window, chunk_size, S)
        wrap = None
        if press is not None:
            if getattr(press, "post_mask", False):
                raise NotImplementedError("post-mask presses (FastKVzip) come with ROADMAP "
                                          "Queue A items 11 and 13")
            if not press.compresses_prefill:
                raise NotImplementedError(
                    "multi-pass presses come with ROADMAP Queue A item 13 and decode-time "
                    "presses with item 12")
            if hasattr(press, "chunked_compress"):
                wrap = press
                if getattr(press, "headwise_mask", False):
                    cache.mask = torch.ones(cache.keys.shape[:4], dtype=torch.bool,
                                            device=self.device)
            elif isinstance(press, ScorerPress):
                # The press's own dynamic_budget sets each layer's target, so
                # a budget-shaping scorer (PyramidKV) keeps its shape.
                wrap = BudgetDecodingPress(base_press=press,
                                           target_compression_ratio=press.compression_ratio,
                                           compression_interval=1,
                                           hidden_states_buffer_size=W)
            else:
                raise TypeError(
                    f"prefill_chunked cannot compress with {type(press).__name__}: it takes a "
                    "ScorerPress or a wrapper with chunked_compress (AdaKVPress)")

        # The ragged remainder goes first, so the last (scoring) chunk is full.
        head = S % chunk_size if S > chunk_size else 0
        starts = ([0] if head else []) + list(range(head, S, chunk_size))
        logits = hidden_win = None
        for i, start in enumerate(starts):
            last = i == len(starts) - 1
            end = S if last else starts[i + 1]
            logits, cache, hidden_win = self._chunk_forward_lean(
                params, ids[:, start:end], cache, compute_logits=compute_logits and last,
                hidden_window=W if (last and wrap is not None) else None, fused_kv=fused_kv)
            yield
        if wrap is not None:
            for l in range(cfg.num_layers):
                cache = self._compress_layer(params, cache, hidden_win, l, wrap)
                yield
        return logits, cache, None

    @torch.no_grad()
    def _chunk_forward_lean(self, params: LlamaModel, chunk_ids: torch.Tensor, cache: KVCache,
                            compute_logits: bool = False, hidden_window: Optional[int] = None,
                            fused_kv: bool = True, collect_fn=None, kvzip_spec=None,
                            kvcompose_spec=None, img_groups=None):
        """One chunk (B, T) through every layer, appended to the cache in
        place at each layer's length (port of ``_chunk_forward_lean_impl``).
        No press runs. A quantized cache stores the chunk as payload and
        scales first, and the chunk attends those. Returns (last position's
        logits | None, cache with length and offset advanced by T, each
        layer's last ``hidden_window`` post-ln1 hidden states (L, B, W, E) |
        None)."""
        if kvzip_spec is not None or kvcompose_spec is not None:
            raise NotImplementedError("multi-pass scoring passes come with ROADMAP Queue A "
                                      "item 13")
        if collect_fn is not None:
            raise NotImplementedError("per-chunk score collection (DMS, FastKVzip) comes with "
                                      "ROADMAP Queue A items 11 and 13")
        if img_groups is not None:
            raise NotImplementedError("image-span attention comes with ROADMAP Queue A "
                                      "item 15")
        cfg = self.cfg
        B, T = chunk_ids.shape
        x = embed_tokens(params, chunk_ids, cfg)
        offset = int(cache.offset)
        positions = (offset + torch.arange(T, device=chunk_ids.device))[None].expand(B, T)
        cos, sin = rope_cos_sin(self.inv_freq, positions, self.attention_scaling)
        cos, sin = cos[:, None], sin[:, None]
        scale = _sm_scale(cfg)
        softcap = cfg.logit_softcap
        quantized = cache.key_scales is not None
        bits = cache.bits
        S_buf = cache.max_size
        use_flash = self.attn_impl == "flash" and T > 1
        lengths = cache.length.tolist()
        windows = []
        for l, layer in enumerate(params.layers):
            ln = lengths[l]
            lmask = None if cache.mask is None else cache.mask[l]
            h = rms_norm(x, layer.ln1, cfg.rms_norm_eps, cfg.rms_one_offset)
            q_pre, k_pre, v = _project_qkv(layer, cfg, h)
            q = apply_rope(q_pre, cos, sin).contiguous()
            k = apply_rope(k_pre, cos, sin)
            kb, vb = cache.keys[l], cache.values[l]
            if quantized:
                ks, vs = cache.key_scales[l], cache.value_scales[l]
                kb[:, :, ln:ln + T], ks[:, :, ln:ln + T] = quantize_kv(k, bits)
                vb[:, :, ln:ln + T], vs[:, :, ln:ln + T] = quantize_kv(v, bits)
                if use_flash and not fused_kv:
                    # Slots past ln + T are never attended: dequantize up to there.
                    end = ln + T
                    kd = dequantize_kv(kb[:, :, :end], ks[:, :, :end], bits, x.dtype)
                    vd = dequantize_kv(vb[:, :, :end], vs[:, :, :end], bits, x.dtype)
                    m = None if lmask is None else lmask[:, :, :end].contiguous()
                    o = flash_attention(q, kd, vd, ln, m, sm_scale=scale, softcap=softcap)
                    del kd, vd
                elif use_flash:
                    o = flash_attention_quant(q, kb, vb, ks, vs, ln, lmask, bits=bits,
                                              sm_scale=scale, softcap=softcap)
                else:
                    bias = attention_bias(ln, T, S_buf, head_mask=lmask, device=x.device)
                    o = quant_gqa_attention(q, kb, vb, ks, vs, bias, scale, bits,
                                            softcap=softcap)
            else:
                kb[:, :, ln:ln + T] = k.to(kb.dtype)
                vb[:, :, ln:ln + T] = v.to(vb.dtype)
                if use_flash:
                    o = flash_attention(q, kb, vb, ln, lmask, sm_scale=scale, softcap=softcap)
                else:
                    bias = attention_bias(ln, T, S_buf, head_mask=lmask, device=x.device)
                    o, _ = gqa_attention(q, kb, vb, bias, scale, softcap=softcap)
            if hidden_window is not None:
                windows.append(h[:, -hidden_window:])
            x = _finish_layer(x, o, layer, cfg)
        logits = None
        if compute_logits:
            xl = rms_norm(x[:, -1:], params.ln_f, cfg.rms_norm_eps, cfg.rms_one_offset)
            logits = lm_head_logits(xl, params, cfg)
        cache = dataclasses.replace(cache, length=cache.length + T, offset=cache.offset + T)
        return logits, cache, (torch.stack(windows) if windows else None)

    @torch.no_grad()
    def _compress_layer(self, params: LlamaModel, cache: KVCache, hidden_win: torch.Tensor,
                        l: int, wrap) -> KVCache:
        """Compress layer ``l`` of a chunk-prefilled cache in place (port of
        ``_compress_layer``): score the whole buffer against the queries of
        the last W positions (re-projected from ``hidden_win[l]``), keep the
        top of it (or the wrapper's head-wise keep), and write back the
        layer's length and, for a head-wise wrapper, its keep-mask."""
        from ..presses.decoding import _buffer_queries

        cfg = self.cfg
        layer = params.layers[l]
        hidden_l = hidden_win[l]                                 # (B, W, E)
        B, W, _ = hidden_l.shape
        length = int(cache.length[l])
        last_pos = int(cache.offset) - 1
        positions = (last_pos - torch.arange(W - 1, -1, -1, device=hidden_l.device)
                     )[None].expand(B, W)
        ctx = LayerCtx(layer_idx=l, hidden=hidden_l, queries=None, queries_prerope=None,
                       keys_prerope=None, positions=positions, attn_probs=None,
                       layer_params=layer, inv_freq=self.inv_freq, cfg=cfg,
                       attention_scaling=self.attention_scaling)
        ctx = dataclasses.replace(ctx, queries=_buffer_queries(ctx, hidden_l, positions))
        keys_l, values_l = cache.keys[l], cache.values[l]
        mask_l = (cache.mask[l] if cache.mask is not None else
                  torch.ones(keys_l.shape[:3], dtype=torch.bool, device=keys_l.device))
        is_wrapper = hasattr(wrap, "chunked_compress")
        new_mask = None
        if cache.key_scales is not None:
            ks_l, vs_l = cache.key_scales[l], cache.value_scales[l]
            if is_wrapper:
                k2, v2, ks2, vs2, nlen, new_mask = wrap.chunked_compress_quantized(
                    ctx, keys_l, values_l, ks_l, vs_l, cache.bits, length, mask_l)
            else:
                k2, v2, ks2, vs2, nlen, _, _ = wrap.decode_compress_quantized(
                    ctx, keys_l, values_l, ks_l, vs_l, cache.bits, length, mask_l,
                    wrap.init_layer_state(cfg, B, hidden_l.dtype, hidden_l.device))
            for dst, src in ((ks_l, ks2), (vs_l, vs2)):
                if src is not dst:
                    dst.copy_(src)
        elif is_wrapper:
            k2, v2, nlen, new_mask = wrap.chunked_compress(ctx, keys_l, values_l, length, mask_l)
        else:
            k2, v2, nlen, _, _ = wrap.decode_compress(
                ctx, keys_l, values_l, length, mask_l,
                wrap.init_layer_state(cfg, B, hidden_l.dtype, hidden_l.device))
        for dst, src in ((keys_l, k2), (values_l, v2)):
            if src is not dst:
                dst.copy_(src)
        if new_mask is not None and cache.mask is not None:
            cache.mask[l].copy_(new_mask)
        lengths = cache.length.clone()
        lengths[l] = int(nlen)
        return dataclasses.replace(cache, length=lengths)

