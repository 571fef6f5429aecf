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
from ..presses.base import BasePress, LayerCtx
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
    (int8 payloads carry a ``<name>_scale`` of shape (1, out)), ln1/ln2."""

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
    """h @ layer.<name>, reading int8 weights with their per-output-channel
    scale: ``(h @ w_int8) * scale``."""
    w = layer.get(name)
    scale = layer.get(name + "_scale")
    if scale is None:
        return h @ w
    if w.dtype == torch.uint8:
        raise NotImplementedError("int4 weights wait for a later slice "
                                  "(ROADMAP Queue A item 8)")
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
    # Few-token calls through ops/decode.py (live-tile skipping, fused
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
        scale = (cfg.query_pre_attn_scalar ** -0.5 if cfg.query_pre_attn_scalar is not None
                 else cfg.head_dim ** -0.5)
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

        o = _lin(attn_out.transpose(1, 2).reshape(B, T, -1), layer, "wo")
        x = x + o
        h2 = rms_norm(x, layer.ln2, cfg.rms_norm_eps, cfg.rms_one_offset)
        mlp = _act(_lin(h2, layer, "wg"), cfg.act) * _lin(h2, layer, "wu")
        x = x + _lin(mlp, layer, "wd")
        return x, int(new_len), new_state

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

