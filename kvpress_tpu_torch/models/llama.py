"""Decoder runner for the Llama family: Llama, Mistral, Qwen2 (qkv bias),
Qwen3 (q/k-norm), Phi3 (fused projections split at conversion) and Gemma3
(q/k-norm, post-norms, ``(1 + w)`` norms, scaled embeddings, interleaved
sliding-window layers with their own RoPE base, same-image attention for
multimodal prefill). Port of ``kvpress_tpu/models/llama.py``.

Weights live in an ``nn.Module`` (``LlamaModel``: embedding, a
``ModuleList`` of decoder layers, final norm, head) in the JAX package's
``(in, out)`` layout, so ``h @ w`` is the JAX ``_lin``. The JAX ``lax.scan``
over stacked layers is a Python loop over layers; the press runs inside the
layer body, with the same ``LayerCtx``: ``layer_compress`` in the prefill,
and in a decode-phase call (``press.compresses_decode``) ``decode_compress``
over the whole layer buffer after the call's attention and append
(``decode_compress_quantized`` on the payload for a press that supports it;
any other press runs on the dequantized buffer, which is then requantized).

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

Sliding-window layers (``cfg.sliding_flags()``) attend through
``window=cfg.sliding_window`` on every route, rotate at
``rope_local_base_freq`` when the config has one, and are never compressed:
the press is not called on them, so their length, keep-mask, buffers and
quantized payloads stay as the append left them (the JAX runner calls the
press and restores all four; the two differ only for a press whose state or
generator advances per call). Head-wise decode is off on sliding models.

Multimodal prefill (``inputs_embeds`` with ``token_types``, 1 for image
tokens) lets the tokens of one image attend each other whatever their order
and the window (HF's ``token_type_ids`` or-mask): group ids from contiguous
image runs go to ``flash_attention`` (``q_groups``/``k_groups``, bounded by
``image_span``), and layers that take the dense path (a press that wants
probabilities, or ``attn_impl="xla"``) get the (B, T, S) or-mask. The decode
kernels take no image groups.

``Runner.prefill_chunked`` is the bounded-activation prefill (port of the
JAX lean chunk path): the context goes through the layers a chunk at a time
(``_chunk_forward_lean``, no press), then ``_compress_layer`` compresses the
cache once, layer by layer, in place. With images, chunk starts move back
so that no image span is split.
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
from ..ops.flash import check_head_dim, flash_attention, flash_attention_quant, same_image
from ..parallel.mesh import ModelShard, local_config, model_shard, vocab_sharded
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
    uint8 of shape (in/2, out), one of shape (2, out)), ln1/ln2; bq/bk/bv
    (qkv bias), q_norm/k_norm (q/k-norm) and ln1_post/ln2_post (Gemma3's
    norms after attention and after the MLP; ln2 is then its pre-MLP norm)
    where the config has them."""

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


def _normal(generator, device, dtype, *shape):
    return (torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * 0.02).to(dtype)


def init_layer(cfg: ModelConfig, generator: torch.Generator, dtype: torch.dtype,
               device: torch.device) -> dict[str, torch.Tensor]:
    """One layer's random weights, as ``init_params`` draws them: N(0, 0.02)
    matrices, zero biases, unit norms."""
    t = {name: _normal(generator, device, dtype, *shape)
         for name, shape in _matrix_shapes(cfg).items()}
    return {**t, **_norms_and_biases(cfg, dtype, device)}


def _matrix_shapes(cfg: ModelConfig) -> dict[str, tuple[int, int]]:
    """A layer's (in, out) matrix shapes."""
    E, Fd = cfg.hidden_size, cfg.intermediate_size
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": (E, Hq * D), "wk": (E, Hkv * D), "wv": (E, Hkv * D),
            "wo": (Hq * D, E), "wg": (E, Fd), "wu": (E, Fd), "wd": (Fd, E)}


def _norms_and_biases(cfg: ModelConfig, dtype: torch.dtype, device: torch.device) -> dict:
    """A layer's unit norms and zero biases, those the config has."""
    E, Hq, Hkv, D = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=device)
    ones = lambda n: torch.ones(n, dtype=dtype, device=device)
    t = {"ln1": ones(E), "ln2": ones(E)}
    if cfg.attention_bias:
        t["bq"], t["bk"], t["bv"] = zeros(Hq * D), zeros(Hkv * D), zeros(Hkv * D)
    if cfg.qk_norm:
        t["q_norm"], t["k_norm"] = ones(D), ones(D)
    if cfg.post_norms:
        t["ln1_post"], t["ln2_post"] = ones(E), ones(E)
    return t


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device: DeviceLike = "cuda") -> LlamaModel:
    """Random init, N(0, 0.02) weights, zero biases and unit norms, drawn
    from ``generator`` (which must live on ``device``), as the JAX
    ``init_params`` lays them out."""
    device = resolve_device(device)
    E, V = cfg.hidden_size, cfg.vocab_size
    layers = [init_layer(cfg, generator, dtype, device) for _ in range(cfg.num_layers)]
    embed = _normal(generator, device, dtype, V, E)
    head = None if cfg.tie_word_embeddings else _normal(generator, device, dtype, E, V)
    return LlamaModel(embed, layers, torch.ones(E, dtype=dtype, device=device), head)


def init_params_int8(cfg: ModelConfig, generator: torch.Generator,
                     dtype: torch.dtype = torch.bfloat16, bits: int = 8,
                     int8_embeddings: bool = False, device: DeviceLike = "cuda") -> LlamaModel:
    """Random init straight into int8 or packed-int4 payloads with their
    per-output-channel scales, as the JAX ``init_params_int8`` lays them out,
    for models whose bf16 copy would not fit beside its quantized one.

    int8: payloads uniform in [-127, 127] with scale 0.02/127 of shape
    (1, out); int4 (``bits=4``): uint8 payloads (in/2, out) uniform over
    0..255 with scales (2, out) of 0.02/7. Norms are ones and biases zeros in
    ``dtype`` (the compute dtype). ``int8_embeddings`` draws an int8
    embedding with ``embed_scale`` (V, 1) and, when the embeddings are
    untied, an int8 head with ``lm_head_scale`` (1, V); otherwise both are
    N(0, 0.02) in ``dtype``. Drawn a layer at a time from ``generator``,
    which must live on ``device``: no bf16 copy of the model exists."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    device = resolve_device(device)
    E, V = cfg.hidden_size, cfg.vocab_size

    def draw_int8(*shape):
        return torch.randint(-127, 128, shape, generator=generator, device=device,
                             dtype=torch.int8)

    def full(n_rows, out, value):
        return torch.full((n_rows, out), value, dtype=torch.float32, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        t = {}
        for name, (n_in, out) in _matrix_shapes(cfg).items():
            if bits == 4:
                t[name] = torch.randint(0, 256, (n_in // 2, out), generator=generator,
                                        device=device, dtype=torch.uint8)
                t[name + "_scale"] = full(2, out, 0.02 / 7.0)
            else:
                t[name] = draw_int8(n_in, out)
                t[name + "_scale"] = full(1, out, 0.02 / 127.0)
        layers.append({**t, **_norms_and_biases(cfg, dtype, device)})
    extra, head = {}, None
    if int8_embeddings:
        embed = draw_int8(V, E)
        extra["embed_scale"] = full(V, 1, 0.02 / 127.0)
        if not cfg.tie_word_embeddings:
            head = draw_int8(E, V)
            extra["lm_head_scale"] = full(1, V, 0.02 / 127.0)
    else:
        embed = _normal(generator, device, dtype, V, E)
        if not cfg.tie_word_embeddings:
            head = _normal(generator, device, dtype, E, V)
    return LlamaModel(embed, layers, torch.ones(E, dtype=dtype, device=device), head, extra)


def _lin(h: torch.Tensor, layer, name: str) -> torch.Tensor:
    """h @ layer.<name>, reading quantized weights with their
    per-output-channel scales.

    int8: ``(h @ w_int8) * scale``. int4 (a uint8 payload of shape
    (in/2, out)): the low nibbles hold the first half of the contraction
    axis and the high nibbles the second, each with a +8 offset, like the
    int4 KV cache; two half-width products, each with its own (out,) scale
    from the (2, out) ``<name>_scale``. A float weight of another dtype than
    ``h`` is cast to ``h``'s, as JAX promotes a float32 activation against
    bf16 weights (a prefill into a float32 cache, KVzap's collector)."""
    w = layer.get(name)
    scale = layer.get(name + "_scale")
    if scale is None:
        return h @ (w if w.dtype == h.dtype else w.to(h.dtype))
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


def quantize_layer_int4(t: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """One layer's tensors with its matmuls quantized to int4 (see
    ``quantize_params_int4``); the dict is updated in place and returned."""
    for name in LINEARS:
        w = t[name]
        if w.dtype == torch.int8:
            w = w.to(torch.float32) * t[name + "_scale"]
        w = w.to(torch.float32)                              # (in, out)
        half = w.shape[0] // 2
        halves = torch.stack([w[:half], w[half:]])           # (2, in/2, out)
        del w
        scale = torch.clamp(halves.abs().amax(dim=1) / 7.0, min=1e-8)   # (2, out)
        q = (torch.clamp(torch.round(halves / scale[:, None]), -8, 7) + 8).to(torch.uint8)
        t[name] = q[0] | (q[1] << 4)
        t[name + "_scale"] = scale
    return t


def quantize_params_int4(params: LlamaModel) -> LlamaModel:
    """int4 quantization of the layer matmuls, per output channel and per
    half of the contraction axis (scales (2, out), float32); the payload is
    ``_lin``'s uint8 layout. Norms, biases, embedding and head stay as they
    are, so this composes after
    ``quantize_params_int8(include_embeddings=True)``; an int8 matrix is
    dequantized first. Returns a new module."""
    layers = [quantize_layer_int4({name: p.data for name, p in
                                   layer.named_parameters(recurse=False)})
              for layer in params.layers]
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


def lm_head_logits(x: torch.Tensor, params: LlamaModel, cfg: ModelConfig,
                   shard: Optional[ModelShard] = None) -> torch.Tensor:
    """Final-normed hidden -> float32 logits (+ softcap). Under a mesh whose
    model size divides the vocabulary, a rank computes its block of the
    vocabulary (its ``lm_head`` shard, or its rows of the tied embedding) and
    the blocks are all-gathered before the softcap."""
    head = params.get("lm_head")
    split = vocab_sharded(cfg.vocab_size, shard)
    if head is not None:
        logits = (x @ head.to(x.dtype)).to(torch.float32)
        scale = params.get("lm_head_scale")
        if scale is not None and head.dtype == torch.int8:
            logits = logits * scale.to(torch.float32)
    else:
        emb, rows = params.embed, slice(None)
        if split:
            n = cfg.vocab_size // shard.size
            rows = slice(shard.rank * n, (shard.rank + 1) * n)
        logits = (x @ emb[rows].t().to(x.dtype)).to(torch.float32)
        if emb.dtype == torch.int8:
            logits = logits * params.embed_scale[rows, 0].to(torch.float32)
    if split:
        logits = shard.all_gather(logits, dim=-1)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _project_qkv(layer, cfg: ModelConfig, h: torch.Tensor):
    """h (B, S, E) -> q (B, Hq, S, D), k/v (B, Hkv, S, D): pre-RoPE, after the
    qkv bias and the q/k RMS-norm where the config has them."""
    B, S, _ = h.shape
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _lin(h, layer, "wq"), _lin(h, layer, "wk"), _lin(h, layer, "wv")
    if cfg.attention_bias:
        q, k, v = q + layer.bq, k + layer.bk, v + layer.bv
    q = q.reshape(B, S, Hq, D).transpose(1, 2)
    k = k.reshape(B, S, Hkv, D).transpose(1, 2)
    v = v.reshape(B, S, Hkv, D).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, layer.q_norm, cfg.rms_norm_eps, cfg.rms_one_offset)
        k = rms_norm(k, layer.k_norm, cfg.rms_norm_eps, cfg.rms_one_offset)
    return q, k, v


def _sm_scale(cfg: ModelConfig) -> float:
    return (cfg.query_pre_attn_scalar ** -0.5 if cfg.query_pre_attn_scalar is not None
            else cfg.head_dim ** -0.5)


def _finish_layer(x: torch.Tensor, attn_out: torch.Tensor, layer, cfg: ModelConfig,
                  shard: Optional[ModelShard] = None):
    """The residual stream after a layer's attention output (B, Hq, T, D): the
    output projection, then the MLP block, each followed by its post-norm
    where the config has them. Under a mesh (``shard``) the two row-parallel
    products are partial sums, all-reduced over "model" before the
    post-norms."""
    B, _, T, _ = attn_out.shape
    o = _lin(attn_out.transpose(1, 2).reshape(B, T, -1), layer, "wo")
    if shard is not None:
        shard.all_reduce(o)
    if cfg.post_norms:
        o = rms_norm(o, layer.ln1_post, cfg.rms_norm_eps, cfg.rms_one_offset)
    x = x + o
    h2 = rms_norm(x, layer.ln2, cfg.rms_norm_eps, cfg.rms_one_offset)
    mlp = _lin(_act(_lin(h2, layer, "wg"), cfg.act) * _lin(h2, layer, "wu"), layer, "wd")
    if shard is not None:
        shard.all_reduce(mlp)
    if cfg.post_norms:
        mlp = rms_norm(mlp, layer.ln2_post, cfg.rms_norm_eps, cfg.rms_one_offset)
    return x + mlp


def image_groups(token_types: torch.Tensor) -> torch.Tensor:
    """(B, T) int32 group ids from token types (1 = image token): each
    contiguous run of image tokens is one image, numbered from 0 in order;
    text tokens get -1."""
    is_img = token_types == 1
    new_start = is_img & ~F.pad(is_img, (1, 0))[:, :-1]
    group = torch.cumsum(new_start.to(torch.int32), dim=1) - 1
    return torch.where(is_img, group, torch.full_like(group, -1)).to(torch.int32)


def _write_back(dst: tuple, src: tuple) -> None:
    """Copy each tensor a press returned into the cache tensor it replaces
    (skipped where the press returned that tensor itself)."""
    for d, x in zip(dst, src):
        if x is not d:
            d.copy_(x)


def _rope_of(cos_sin, cos_sin_local, sliding: bool):
    return cos_sin_local if sliding and cos_sin_local is not None else cos_sin


@dataclasses.dataclass(frozen=True)
class Runner:
    """Config + host RoPE constants + attention routing."""
    cfg: ModelConfig
    attention_scaling: float
    device: torch.device
    inv_freq: torch.Tensor = dataclasses.field(compare=False)   # (head_dim/2,) f32
    # Sliding layers' RoPE (Gemma3 ``rope_local_base_freq``: the plain base
    # frequency, no scaling), or None when every layer uses ``inv_freq``.
    inv_freq_local: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False)
    # "flash": kernel wrappers for multi-token calls; "xla": dense paths (the
    # name is the JAX package's, kept so both runners take the same options).
    attn_impl: str = "xla"
    # Few-token calls through ops/decode.py (live-step skipping, fused
    # dequant). Only meaningful with attn_impl="flash".
    decode_kernel: bool = False
    decode_block_k: int = 2048
    # One-token decode over per-head prefixes through ops/decode_headwise.py
    # (caches compacted head by head, AdaKV ``compact=True``). Only
    # meaningful with attn_impl="flash", the decode kernel off and no
    # sliding layers.
    headwise_kernel: bool = False
    # Tensor parallelism: the rank's place on the mesh's "model" axis. A
    # sharded runner's ``cfg`` holds the rank's head and MLP counts
    # (``parallel.mesh.local_config``) and it runs the params of
    # ``parallel.mesh.shard_params``.
    shard: Optional[ModelShard] = dataclasses.field(default=None, compare=False)

    @staticmethod
    def create(cfg: ModelConfig, attn_impl: str = "auto",
               decode_kernel: Optional[bool] = None, decode_block_k: int = 2048,
               headwise_kernel: bool = False, device: DeviceLike = "cuda",
               mesh=None) -> "Runner":
        """``attn_impl="auto"`` is "flash" on CUDA and "xla" on the CPU;
        ``decode_kernel=None`` turns the decode kernel on for CUDA. (The JAX
        runner leaves it off for a TPU-only reason: Mosaic's per-grid-cell
        overhead.) The decode kernel takes every few-token call it can, so
        ``headwise_kernel=True`` routes only with ``decode_kernel=False``.

        On CUDA the kernels take head_dim 64, 96 (Phi-3-mini), 128 and 256
        (Gemma-3 1B/4B/12B): another head_dim, which no architecture of the
        package has, raises unless the dense path is asked for
        (``attn_impl="xla"``).

        ``mesh`` (a ``torch.distributed`` ``DeviceMesh`` with a "model"
        axis) makes the rank's runner: its local heads and MLP slice, the
        two all-reduces a layer and the vocabulary all-gather; run it with
        ``parallel.mesh.shard_params``' params."""
        device = resolve_device(device)
        inv, scaling = compute_inv_freq(cfg)
        if attn_impl == "auto":
            attn_impl = "flash" if device.type == "cuda" else "xla"
        if decode_kernel is None:
            decode_kernel = device.type == "cuda"
        if device.type == "cuda" and attn_impl == "flash":
            check_head_dim(cfg.head_dim)
        local = None
        if cfg.rope_local_base_freq is not None:
            local, _ = compute_inv_freq(dataclasses.replace(
                cfg, rope_theta=cfg.rope_local_base_freq, rope_scaling=None))
            local = torch.from_numpy(local).to(device)
        runner = Runner(cfg=cfg, attention_scaling=scaling, device=device,
                        inv_freq=torch.from_numpy(inv).to(device), inv_freq_local=local,
                        attn_impl=attn_impl, decode_kernel=decode_kernel,
                        decode_block_k=decode_block_k, headwise_kernel=headwise_kernel)
        return runner if mesh is None else runner.sharded(mesh)

    def sharded(self, mesh) -> "Runner":
        """This runner for the rank's shard of ``mesh``'s "model" axis."""
        if self.shard is not None:
            raise ValueError("the runner is sharded already")
        shard = model_shard(mesh, self.device)
        return dataclasses.replace(self, cfg=local_config(self.cfg, shard.size), shard=shard)

    def _check_params(self, params: LlamaModel, press=None) -> None:
        """A sharded runner takes the params of ``shard_params`` on its own
        shard, and only the presses that run under a mesh."""
        pshard = getattr(params, "shard", None)
        if (pshard is None) != (self.shard is None) or (
                pshard is not None and (pshard.rank, pshard.size)
                != (self.shard.rank, self.shard.size)):
            raise ValueError("a sharded runner takes parallel.mesh.shard_params' params of its "
                             "own shard, an unsharded runner unsharded params")
        if self.shard is not None and press is not None:
            from ..parallel.presses import check_press
            check_press(press)

    def _ropes(self, positions: torch.Tensor):
        """(global, local) cos/sin pairs (B, 1, T, D) at ``positions``; local
        is None without a separate base for the sliding layers."""
        cos, sin = rope_cos_sin(self.inv_freq, positions, self.attention_scaling)
        rope = (cos[:, None], sin[:, None])
        if self.inv_freq_local is None:
            return rope, None
        cos, sin = rope_cos_sin(self.inv_freq_local, positions, 1.0)
        return rope, (cos[:, None], sin[:, None])

    # ------------------------------------------------------------------ #

    def _layer_step(
        self,
        x: torch.Tensor,                 # (B, T, E)
        layer,
        cache_layer: dict,               # keys/values/length/mask/scales, one layer
        positions: torch.Tensor,         # (B, T)
        rope: tuple[torch.Tensor, torch.Tensor],   # this layer's cos/sin (B, 1, T, D) f32
        layer_idx: int,
        sliding: bool,
        press: Optional[BasePress],
        press_state,
        phase: str,
        kv_bits: int = 8,
        extra_allow: Optional[torch.Tensor] = None,   # (B, T, S_buf) image spans
        img_groups: Optional[tuple] = None,           # (q_groups, k_groups, span)
        valid_len: Optional[int] = None,              # bucketed prefill: real tokens
        last_position: Optional[int] = None,          # positions[:, -1] on the host
    ):
        cfg = self.cfg
        apply_press = press is not None and (
            (phase == "prefill" and press.compresses_prefill)
            or (phase == "decode" and press.compresses_decode)
        )
        B, T, E = x.shape
        h = rms_norm(x, layer.ln1, cfg.rms_norm_eps, cfg.rms_one_offset)
        q_pre, k_pre, v = _project_qkv(layer, cfg, h)
        cos, sin = rope
        q = apply_rope(q_pre, cos, sin).contiguous()
        k = apply_rope(k_pre, cos, sin)

        prior_len = int(cache_layer["length"])
        quantized = cache_layer.get("key_scales") is not None
        # A DecodingPress-family press compresses the payload at its width
        # (decode_compress_quantized): no dense buffer is built for it.
        quant_press_decode = (quantized and apply_press and phase == "decode"
                              and getattr(press, "supports_quantized_decode", False))
        dense_press = apply_press and not quant_press_decode
        scale = _sm_scale(cfg)
        window = cfg.sliding_window if sliding else None
        # Routing follows the press on every layer, sliding ones included, as
        # in the JAX runner; only the compression below skips sliding layers.
        return_probs = apply_press and press.wants_probs(T)
        want_lse = apply_press and press.wants_lse(T)

        G = cfg.num_heads // cfg.num_kv_heads
        # A bucketed call takes neither decode kernel (both read the keys up
        # to prior + T, pads included): its prefill stays on flash_attention.
        use_decode_kernel = (
            self.attn_impl == "flash" and self.decode_kernel and not return_probs
            and T <= 128 and T * G <= 512 and valid_len is None
        )
        # One token only: appended tokens that a head's all-live prefix
        # absorbs are visible to every row of the call.
        use_headwise = (
            self.attn_impl == "flash" and self.headwise_kernel and not use_decode_kernel
            and not return_probs and not apply_press and not quantized and T == 1
            and cfg.sliding_window is None and valid_len is None
        )
        if (extra_allow is not None or img_groups is not None) and (use_decode_kernel
                                                                   or use_headwise):
            raise ValueError("same-image attention (token_types) is a prefill feature: the "
                             "decode kernels take no image groups")
        S_buf = cache_layer["keys"].shape[2]
        start = clamp_start(prior_len, T, S_buf)
        qkeys = qvalues = key_scales = value_scales = None
        if quantized:
            # Store the new K/V as payload + scales. The whole layer buffer is
            # dequantized only when dense K/V are needed (a press that scores
            # dense K/V, or a multi-token call the quantized kernel does not
            # take).
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
            # both runners route alike); flash_attention_quant has no or-mask.
            use_quant_flash = (
                self.attn_impl == "flash" and T > 1 and kv_bits == 8 and img_groups is None
                and not use_decode_kernel and not dense_press
            )
            needs_dense = dense_press or return_probs or (
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
        if valid_len is not None:
            # Bucketed prefill: only the first valid_len of the T tokens are
            # real. The pads sit after every real row, so causal masking keeps
            # them out of every real row's attention; they lie past the length.
            new_len = prior_len + valid_len
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
                    bits=kv_bits, sm_scale=scale, softcap=cfg.logit_softcap, window=window,
                    block_k=self.decode_block_k)
            else:
                attn_out = decode_attention(
                    q, keys, values, new_len, mask=mask, sm_scale=scale,
                    softcap=cfg.logit_softcap, window=window, block_k=self.decode_block_k)
        elif use_flash:
            if quantized and keys is None:
                attn_out = flash_attention_quant(
                    q, qkeys, qvalues, key_scales, value_scales, prior_len, mask,
                    bits=kv_bits, sm_scale=scale, softcap=cfg.logit_softcap, window=window)
            else:
                qg, kg, span = img_groups or (None, None, None)
                attn_out = flash_attention(q, keys, values, prior_len, mask, qg, kg,
                                           sm_scale=scale, softcap=cfg.logit_softcap,
                                           window=window, or_span=span, return_lse=want_lse)
                if want_lse:
                    attn_out, attn_lse = attn_out
        else:
            # HF applies the image-span or-mask to the sliding layers' mask too.
            bias = attention_bias(prior_len, T, S_buf, sliding_window=window, head_mask=mask,
                                  extra_allow=extra_allow)
            if quantized and keys is None:
                attn_out = quant_gqa_attention(q, qkeys, qvalues, key_scales, value_scales,
                                               bias, scale, kv_bits, softcap=cfg.logit_softcap)
            else:
                attn_out, probs = gqa_attention(q, keys, values, bias, scale,
                                                softcap=cfg.logit_softcap,
                                                return_probs=return_probs)

        new_state = press_state
        # Sliding layers are never compressed. The JAX runner calls the press
        # there and restores the layer after it; skipping it gives the same
        # cache, but the press state of a sliding layer stays as it was
        # given. A press that only scores (``writes_cache`` False: the
        # multi-pass scorers, FastKVzip) is called there too, for its scores.
        writes = apply_press and press.writes_cache
        if apply_press and not (sliding and writes):
            ctx = LayerCtx(
                layer_idx=layer_idx, hidden=h, queries=q, queries_prerope=q_pre,
                keys_prerope=k_pre, positions=positions, attn_probs=probs,
                layer_params=layer, inv_freq=self.inv_freq, cfg=cfg,
                attention_scaling=self.attention_scaling, attn_lse=attn_lse,
                kv_len=valid_len if phase == "prefill" else None,
                last_position=last_position, shard=self.shard,
            )
            if phase == "prefill":
                # Prefill into an empty cache: compress over the first T slots.
                nk, nv, new_len, nmask, new_state = press.layer_compress(
                    ctx, keys[:, :, :T], values[:, :, :T], new_len, mask[:, :, :T],
                    press_state)
                if writes:
                    keys[:, :, :T] = nk
                    values[:, :, :T] = nv
                    mask[:, :, :T] = nmask
            elif quant_press_decode:
                # After this call's attention and append, over the whole
                # buffer: the payload and scales are gathered, not requantized.
                out = press.decode_compress_quantized(
                    ctx, qkeys, qvalues, key_scales, value_scales, kv_bits, new_len, mask,
                    press_state)
                *bufs, new_len, nmask, new_state = out
                _write_back((qkeys, qvalues, key_scales, value_scales, mask), (*bufs, nmask))
            else:
                nk, nv, new_len, nmask, new_state = press.decode_compress(
                    ctx, keys, values, new_len, mask, press_state)
                if writes:
                    _write_back((keys, values, mask), (nk, nv, nmask))
            if quantized and dense_press and writes:
                # The press moved (or merged) entries in the dense buffer:
                # requantize the whole layer.
                qk2, ks2 = quantize_kv(keys, kv_bits)
                qv2, vs2 = quantize_kv(values, kv_bits)
                _write_back((qkeys, qvalues, key_scales, value_scales), (qk2, qv2, ks2, vs2))
            if self.shard is not None:
                # A head-wise compaction ends at its longest head: over every
                # rank's heads, as on one device.
                new_len = self.shard.max(new_len)

        return _finish_layer(x, attn_out, layer, cfg, self.shard), int(new_len), new_state

    # ------------------------------------------------------------------ #

    def _image_spans(self, token_types, T: int, S_buf: int, press, image_span):
        """The or-mask of a multimodal prefill from empty (token position ==
        slot): (extra_allow (B, T, S_buf) | None, (q_groups, k_groups, span) |
        None). The dense mask is built whenever a layer can take the dense
        path, a flash runner's included (a press that wants probabilities),
        and the group ids for the flash kernel."""
        if token_types is None:
            return None, None
        group = image_groups(token_types.to(self.device))
        kg = F.pad(group, (0, S_buf - T), value=-1)
        extra_allow = None
        if self.attn_impl == "xla" or (press is not None and press.wants_probs(T)):
            extra_allow = same_image(group, kg)
        img = None
        if self.attn_impl != "xla":
            if image_span is None:
                raise ValueError("token_types on the flash path needs image_span (the "
                                 "longest image span: mm_tokens_per_image)")
            img = (group, kg, int(image_span))
        return extra_allow, img

    @torch.no_grad()
    def forward(
        self,
        params: LlamaModel,
        ids: Optional[torch.Tensor],     # (B, T), or None with inputs_embeds
        cache: KVCache,
        press: Optional[BasePress] = None,
        press_state=None,
        phase: str = "none",
        compute_logits: bool = True,
        logits_last_only: bool = False,
        inputs_embeds: Optional[torch.Tensor] = None,   # (B, T, E): overrides ids
        token_types: Optional[torch.Tensor] = None,     # (B, T): 1 = image token
        image_span: Optional[int] = None,               # the longest image span
        valid_len: Optional[int] = None,                # bucketed prefill
    ):
        """Run T tokens through all layers against (and appending to) the cache.

        Returns (logits | None, cache', press_state'). K/V are written into
        the cache's buffers in place; cache' carries new ``length``/``offset``
        tensors, so the caller's ``cache.length``/``cache.offset`` still
        describe the state before the call (restoring them rolls back).

        ``inputs_embeds`` is the multimodal entry (``convert.multimodal_embeds``
        puts the vision features into the text embedding). ``token_types``
        lets the tokens of one image attend each other (prefill into an
        empty cache only); on the flash path it needs ``image_span``.

        ``valid_len`` is bucketed prefill: the ids are padded to a bucket and
        only the first ``valid_len`` are real. Each layer's length and the
        offset advance by ``valid_len``, the press gets it as ``ctx.kv_len``
        (prefill only), and the last position's logits read slot
        ``valid_len - 1``."""
        cfg = self.cfg
        self._check_params(params, press)
        if inputs_embeds is not None:
            x = inputs_embeds
            B, T = x.shape[:2]
        else:
            B, T = ids.shape
            x = embed_tokens(params, ids, cfg)
        offset = int(cache.offset)
        lengths = cache.length.tolist()
        if token_types is not None and (offset or any(lengths)):
            raise ValueError("token_types: same-image attention is for a prefill into an "
                             "empty cache (token position == slot)")
        positions = (offset + torch.arange(T, device=x.device))[None].expand(B, T)
        rope, rope_local = self._ropes(positions)      # shared by every layer
        mask = cache.mask
        if mask is None:
            mask = torch.ones(cache.keys.shape[:4], dtype=torch.bool, device=cache.keys.device)
        extra_allow, img = self._image_spans(token_types, T, cache.max_size, press, image_span)
        new_lengths = []
        states = press_state
        for l, (layer, sliding) in enumerate(zip(params.layers, cfg.sliding_flags())):
            cache_layer = dict(
                keys=cache.keys[l], values=cache.values[l], length=lengths[l], mask=mask[l],
                key_scales=None if cache.key_scales is None else cache.key_scales[l],
                value_scales=None if cache.value_scales is None else cache.value_scales[l],
            )
            state_l = None if states is None else states[l]
            x, nlen, state_l = self._layer_step(
                x, layer, cache_layer, positions, _rope_of(rope, rope_local, sliding), l,
                sliding, press, state_l, phase, cache.bits, extra_allow, img, valid_len,
                offset + T - 1)
            if states is not None:
                states[l] = state_l
            new_lengths.append(nlen)

        ovf = max(lengths) + T > cache.max_size
        if cache.overflowed is not None:
            ovf = ovf or bool(cache.overflowed)
        new_cache = dataclasses.replace(
            cache, length=torch.tensor(new_lengths, dtype=torch.int32), mask=mask,
            offset=torch.tensor(offset + (T if valid_len is None else valid_len),
                                dtype=torch.int32),
            overflowed=torch.tensor(ovf))

        logits = None
        if compute_logits:
            x = rms_norm(x, params.ln_f, cfg.rms_norm_eps, cfg.rms_one_offset)
            if logits_last_only:
                last = T if valid_len is None else valid_len
                x = x[:, last - 1:last]
            logits = lm_head_logits(x, params, cfg, self.shard)
        return logits, new_cache, states

    def prefill(self, params: LlamaModel, ids: Optional[torch.Tensor], press=None,
                max_size=None, dtype: Optional[torch.dtype] = None,
                compute_logits: bool = False, quantized: bool = False, kv_bits: int = 8,
                inputs_embeds: Optional[torch.Tensor] = None,
                token_types: Optional[torch.Tensor] = None, image_span: Optional[int] = None,
                valid_len: Optional[int] = None):
        """Compress-on-prefill entry: build a fresh cache for ids (B, S), or
        for ``inputs_embeds`` (B, S, E) (the multimodal entry). ``valid_len``:
        bucketed prefill over ids padded past their first ``valid_len``."""
        B, S = (ids if inputs_embeds is None else inputs_embeds).shape[:2]
        dtype = dtype or params.dtype
        cache = init_cache(self.cfg, B, max_size or S, dtype=dtype, quantized=quantized,
                           bits=kv_bits, device=self.device)
        state = (None if press is None else
                 press.init_state(self.cfg, B, S, dtype=dtype, device=self.device))
        return self.forward(params, ids, cache, press=press, press_state=state,
                            phase="prefill", compute_logits=compute_logits,
                            logits_last_only=True, inputs_embeds=inputs_embeds,
                            token_types=token_types, image_span=image_span,
                            valid_len=valid_len)

    # ------------------------------------------------------------------ #
    # Chunked prefill

    def prefill_chunked(self, params: LlamaModel, ids: Optional[torch.Tensor], press=None,
                        chunk_size: int = 8192, max_size: Optional[int] = None,
                        dtype: Optional[torch.dtype] = None, compute_logits: bool = False,
                        quantized: bool = False, kv_bits: int = 8, score_window: int = 1024,
                        fused_kv: Optional[bool] = None,
                        inputs_embeds: Optional[torch.Tensor] = None,
                        token_types: Optional[torch.Tensor] = None,
                        image_span: Optional[int] = None):
        """Bounded-activation prefill: the context goes through the layers
        ``chunk_size`` tokens at a time (each chunk's activations replace the
        whole context's), appended to the cache in place; then the cache is
        compressed once, layer by layer, scored against the last ``W =
        min(score_window, chunk_size, S)`` positions' queries, re-projected
        from their post-ln1 hidden states. Sliding layers are not compressed.

        Exact against ``prefill`` for content scorers (Knorm, Random) and for
        window scorers whose window fits in W (SnapKV, TOVA, PyramidKV,
        StreamingLLM). A ``ScorerPress`` or a scorer-like wrapper
        (CriticalKV, PerLayerCompression) compresses through
        ``BudgetDecodingPress`` (its own per-layer budget); a wrapper with
        ``chunked_compress`` (the AdaKV family, KeyRerotation, Chunk,
        ChunkKV, ThinK, Composed, Duo, SimLayerKV, Finch) compresses itself.
        ``DMSPress`` over a per-token scorer (KVzap, Knorm) scores each chunk's
        tokens as they go through and sets its threshold mask after the last
        chunk. ``FastKVzipPress`` (a post-mask press) collects each chunk's
        gate scores the same way and returns them, protected over the whole
        context, as its state (one entry a layer) for the pipeline's
        ``apply_post_mask``. A decode-time press (the ``DecodingPress``
        family, ``CAMPress``) and a multi-pass press (``KVzipPress``,
        ``RestoreKVPress``, ``KVComposePress``: the pipeline's scoring passes
        follow) leave the prefill whole, as in JAX: the state is made after
        the last chunk. ``BlockPress`` is refused: it needs every position's hidden
        states; so are ``MergingPress``: no chunked pass merges, and
        ``PrefillDecodingPress``, as JAX's assertion refuses it.

        ``fused_kv`` (quantized caches): attention reads the payload through
        ``flash_attention_quant``; else each layer's buffer is dequantized and
        ``flash_attention`` runs. By default int8 is always fused and int4
        only when the dense transient (2 x 2 bytes x B x Hkv x max_size x D)
        is over 512 MiB; with images never (``flash_attention_quant`` has no
        or-mask). Either way a chunk attends its own quantized values.

        ``inputs_embeds`` and ``token_types`` (``image_span`` on the flash
        path) as in ``prefill``: each chunk start moves back to the first
        token of an image span it would split, so that a span's tokens see
        each other. Returns (logits | None, cache, press state: DMS's ring per
        layer, FastKVzip's scores per layer, a decode-time press's initial
        state, else None)."""
        steps = self.prefill_chunked_steps(
            params, ids, press=press, chunk_size=chunk_size, max_size=max_size, dtype=dtype,
            compute_logits=compute_logits, quantized=quantized, kv_bits=kv_bits,
            score_window=score_window, fused_kv=fused_kv, inputs_embeds=inputs_embeds,
            token_types=token_types, image_span=image_span)
        while True:
            try:
                next(steps)
            except StopIteration as stop:
                return stop.value

    @staticmethod
    def chunk_starts(S: int, chunk_size: int, token_types: Optional[torch.Tensor] = None
                     ) -> list[int]:
        """The first token of each chunk: the ragged remainder first, so the
        last (scoring) chunk is full; with ``token_types``, each start moved
        back to the first token of an image span it would split (an image
        token of any batch row right before it)."""
        head = S % chunk_size if S > chunk_size else 0
        starts = ([0] if head else []) + list(range(head, S, chunk_size))
        if token_types is None:
            return starts
        img_any = (token_types != 0).any(dim=0).tolist()
        moved = []
        for st in starts:
            while st > 0 and img_any[st] and img_any[st - 1]:
                st -= 1
            moved.append(st)
        return sorted(set(moved))

    @torch.no_grad()
    def prefill_chunked_steps(self, params: LlamaModel, ids: Optional[torch.Tensor],
                              press=None, chunk_size: int = 8192,
                              max_size: Optional[int] = None,
                              dtype: Optional[torch.dtype] = None,
                              compute_logits: bool = False, quantized: bool = False,
                              kv_bits: int = 8, score_window: int = 1024,
                              fused_kv: Optional[bool] = None,
                              inputs_embeds: Optional[torch.Tensor] = None,
                              token_types: Optional[torch.Tensor] = None,
                              image_span: Optional[int] = None):
        """Generator form of :meth:`prefill_chunked`: yields after each chunk
        forward and each compressed layer, and returns its triple through
        ``StopIteration`` (a server can interleave decode steps between the
        yields)."""
        from ..presses.decoding import BudgetDecodingPress
        from ..presses.dms import DMSPress
        from ..presses.wrappers import BlockPress

        if chunk_size < 1:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        cfg = self.cfg
        self._check_params(params, press)
        B, S = (ids if inputs_embeds is None else inputs_embeds).shape[:2]
        size = max_size or S
        if size < S:
            raise ValueError(f"max_size {size} cannot hold the {S}-token context")
        if fused_kv is None:
            fused_kv = self._fused_kv(B, size, kv_bits)
        groups = k_groups = None
        if token_types is not None:
            # Group ids over the whole context (slot == position until the
            # compression after the last chunk); each chunk takes its slice of
            # the queries' ids and the whole buffer's for the keys.
            token_types = token_types.to(self.device)
            groups = image_groups(token_types)
            k_groups = F.pad(groups, (0, size - S), value=-1)
            if self.attn_impl != "xla" and image_span is None:
                raise ValueError("token_types on the flash path needs image_span")
            if quantized:
                fused_kv = False    # flash_attention_quant has no or-mask
        dtype = dtype or params.dtype
        cache = init_cache(cfg, B, size, dtype=dtype, quantized=quantized, bits=kv_bits,
                           device=self.device)
        W = min(score_window, chunk_size, S)
        wrap = dms = deferred = None
        if isinstance(press, DMSPress):
            # DMS threshold eviction: each chunk's tokens are scored as the
            # chunk goes through (the wrapped scorer's chunk_score_fn, exact for
            # a per-token scorer), then the threshold mask and the ring are set
            # over the whole context (DMSPress.apply_chunked).
            if press.press.chunk_score_fn is None:
                raise ValueError(
                    f"DMSPress over {type(press.press).__name__} cannot run through "
                    "prefill_chunked: the wrapped scorer has no per-token chunk_score_fn (its "
                    "score for token t depends on more than that token's own hidden/k/v). Use "
                    "the one-shot prefill, or wrap a per-token scorer (KVzapPress, KnormPress).")
            dms, press = press, None
        post = None
        if press is not None and getattr(press, "post_mask", False):
            # FastKVzip: each chunk's gate scores are collected as it goes
            # through; the pipeline sets the cross-layer mask afterwards.
            post, press = press, None
        if press is not None and not press.compresses_prefill:
            # A decode-time press, or a multi-pass press (KVzip, KVCompose:
            # the pipeline runs its scoring passes after the prefill), leaves
            # the prefill whole: its state is made after the last chunk.
            deferred, press = press, None
        if press is not None:
            if hasattr(press, "chunked_compress"):
                # A wrapper compresses itself; a head-wise one clears bits of
                # a keep-mask, materialized here.
                wrap = press
                if getattr(press, "headwise_mask", False):
                    cache.mask = torch.ones(cache.keys.shape[:4], dtype=torch.bool,
                                            device=self.device)
            elif isinstance(press, BlockPress):
                raise ValueError(
                    "BlockPress cannot run through prefill_chunked: its streaming top-k "
                    "re-gathers the hidden states of every candidate set (reference "
                    "block_press.py:49-98), which needs every position's hidden states, and the "
                    "chunked path keeps only the trailing scoring window. Use the one-shot "
                    "prefill (BlockPress is itself streaming: its peak memory is already bounded "
                    "by block_size).")
            elif isinstance(press, ScorerPress) or getattr(press, "scorer_like", False):
                # The press's own dynamic_budget sets each layer's target, so
                # a budget-shaping scorer (PyramidKV, PerLayerCompression)
                # keeps its shape.
                wrap = BudgetDecodingPress(base_press=press,
                                           target_compression_ratio=press.compression_ratio,
                                           compression_interval=1,
                                           hidden_states_buffer_size=W)
            else:
                raise TypeError(
                    f"prefill_chunked cannot compress with {type(press).__name__}: it takes a "
                    "ScorerPress, a scorer-like wrapper (CriticalKVPress, "
                    "PerLayerCompressionPress), a wrapper with chunked_compress (AdaKVPress, "
                    "CriticalAdaKVPress, KeyRerotationPress, ChunkPress, ChunkKVPress, "
                    "ThinKPress, ComposedPress, DuoAttentionPress, SimLayerKVPress, FinchPress), "
                    "DMSPress over a per-token scorer or a decode-time press; MergingPress "
                    "merges evicted values, which no chunked pass keeps, and "
                    "PrefillDecodingPress compresses its prefill in the layer body")

        starts = self.chunk_starts(S, chunk_size, token_types)
        logits = hidden_win = None
        collect = {}
        if dms is not None:
            collect = dict(collect_fn=dms.press.chunk_score_fn,
                           collect_arg=dms.press.chunk_score_arg if self.shard is None else
                           dms.press.chunk_score_arg_local(self.shard, cfg.num_kv_heads))
        elif post is not None:
            collect = dict(collect_fn=post.chunk_score_fn, collect_arg=post.chunk_score_arg)
        all_scores = []
        for i, start in enumerate(starts):
            last = i == len(starts) - 1
            end = S if last else starts[i + 1]
            logits, cache, hidden_win = self._chunk_forward_lean(
                params, None if ids is None else ids[:, start:end], cache,
                compute_logits=compute_logits and last,
                hidden_window=W if (last and wrap is not None) else None, fused_kv=fused_kv,
                chunk_embeds=None if inputs_embeds is None else inputs_embeds[:, start:end],
                img_groups=None if groups is None else groups[:, start:end].contiguous(),
                k_groups=k_groups, image_span=image_span, scores_out=all_scores, **collect)
            yield
        if wrap is not None:
            for l, sliding in enumerate(cfg.sliding_flags()):
                if sliding:
                    continue                # sliding layers are never compressed
                cache = self._compress_layer(params, cache, hidden_win, l, wrap)
                yield
        state = None
        if deferred is not None:
            state = deferred.init_state(cfg, B, S, dtype=dtype, device=self.device)
        if dms is not None:
            mask = cache.mask
            if mask is None:
                mask = torch.ones(cache.keys.shape[:4], dtype=torch.bool, device=self.device)
            mask, state = dms.apply_chunked(torch.cat(all_scores, dim=-1), S, mask,
                                            cfg.sliding_flags())
            cache = dataclasses.replace(cache, mask=mask)
        if post is not None:
            # The raw gate scores over the whole context, protected once
            # (the one-shot layer_compress's window), one entry a layer.
            state = [{"scores": s} for s in post.protect_scores(torch.cat(all_scores, dim=-1),
                                                                S)]
        return logits, cache, state

    def _fused_kv(self, B: int, size: int, bits: int) -> bool:
        """The chunk route over a quantized cache of ``size`` slots: the
        payload through ``flash_attention_quant`` for int8, or for int4 when
        the layer's dense transient (2 x 2 bytes x B x H_kv x size x D) is
        over 512 MiB; else each layer dequantized for ``flash_attention``."""
        dense_bytes = 2 * 2 * B * self.cfg.num_kv_heads * size * self.cfg.head_dim
        return bits == 8 or dense_bytes > (1 << 29)

    @torch.no_grad()
    def kvzip_repeat_pass(self, params: LlamaModel, rep_ids: Optional[torch.Tensor],
                          cache: KVCache, start: int, sink: int, chunk_len: int,
                          rep_embeds: Optional[torch.Tensor] = None):
        """One KVzip repeat-chunk scoring pass (reference score_kvzip,
        kvzip_press.py:287-358) over the lean chunk forward, a layer at a
        time (the JAX package's host-loop form; its scan form computes the
        same). The repeat prompt ``rep_ids`` (B, T) (or ``rep_embeds``
        (B, T, E)) attends the cache after its live slots; each layer scores
        the chunk's slots ``start .. start + chunk_len`` with the ``sink``
        first slots beside them. The repeat K/V are written past the length
        (the buffer must have room for them); the slots below the length,
        the length and the offset stay as they were. Returns ``(cache,
        scores)``, the cache the one given and scores (L, B, H_kv,
        chunk_len) float32. Sliding layers take their window."""
        B = (rep_ids if rep_embeds is None else rep_embeds).shape[0]
        out = []
        _, cache, _ = self._chunk_forward_lean(
            params, None if rep_embeds is not None else rep_ids, cache,
            fused_kv=self._fused_kv(B, cache.max_size, cache.bits),
            kvzip_spec=(int(start), int(sink), int(chunk_len)),
            chunk_embeds=rep_embeds, scores_out=out)
        return cache, out[0]

    @torch.no_grad()
    def kvcompose_refeed_pass(self, params: LlamaModel, ids_chunk: Optional[torch.Tensor],
                              cache: KVCache, ctx_len: int, agg_task: str,
                              chunk_embeds: Optional[torch.Tensor] = None):
        """One chunk of KVCompose's scoring pass (reference
        kvcompose_press.py :197-219, :384-424: the extra pass over the
        context, here in bounded chunks). The chunk's K/V are appended (a
        later chunk's queries attend it: the one-shot causality over the
        doubled sequence), and each layer aggregates the chunk's attention
        onto the first ``ctx_len`` columns (``refeed_colagg`` with the
        attention's own logsumexp). Returns ``(cache, part)``, the cache
        advanced by the chunk and part (L, B, Hq, ctx_len): combine chunks by
        max or running sum, and roll back by restoring the length and offset
        after the last (the first ``ctx_len`` slots are not touched).
        Sliding-window models are refused, as in JAX (the sweep has no
        window)."""
        if self.cfg.sliding_window is not None:
            raise ValueError("KVCompose chunked re-feed does not support sliding-window models "
                             "(the press skips sliding layers; use the one-shot prefill)")
        B = (ids_chunk if chunk_embeds is None else chunk_embeds).shape[0]
        out = []
        _, cache, _ = self._chunk_forward_lean(
            params, None if chunk_embeds is not None else ids_chunk, cache,
            fused_kv=self._fused_kv(B, cache.max_size, cache.bits),
            kvcompose_spec=(int(ctx_len), agg_task),
            chunk_embeds=chunk_embeds, scores_out=out)
        return cache, out[0]

    @torch.no_grad()
    def _chunk_forward_lean(self, params: LlamaModel, chunk_ids: Optional[torch.Tensor],
                            cache: KVCache, compute_logits: bool = False,
                            hidden_window: Optional[int] = None, fused_kv: bool = True,
                            collect_fn=None, kvzip_spec=None, kvcompose_spec=None,
                            chunk_embeds: Optional[torch.Tensor] = None,
                            img_groups: Optional[torch.Tensor] = None,
                            k_groups: Optional[torch.Tensor] = None,
                            image_span: Optional[int] = None, collect_arg=None,
                            scores_out: Optional[list] = None):
        """One chunk (B, T) through every layer, appended to the cache in
        place at each layer's length (port of ``_chunk_forward_lean_impl``).
        No press runs. A quantized cache stores the chunk as payload and
        scales first, and the chunk attends those. ``chunk_embeds`` (B, T, E)
        overrides the token embedding; ``img_groups`` (B, T) and ``k_groups``
        (B, S_buf) are the image ids of the chunk's queries and of every slot
        (``image_span`` bounds a span on the flash path). ``collect_fn`` (a
        press's ``chunk_score_fn``, given ``collect_arg``) scores the chunk's
        own tokens in each layer from their post-ln1 hidden states and their
        K/V at cache width (dequantized from the payload the chunk stored):
        the (L, B, H_kv, T) scores are appended to ``scores_out``.

        The scoring passes of the multi-pass presses:

        - ``kvzip_spec = (start, sink, chunk_len)`` (host ints): a KVzip
          repeat pass. Each layer scores the chunk's slots ``start ..
          start + chunk_len`` with ``subset_max_scores`` over the ``[sink |
          chunk]`` keys read from the buffer (dequantized) and the repeat
          keys as computed; (L, B, H_kv, chunk_len) to ``scores_out``. The
          repeat K/V are written past the length, and the length and offset
          do not move: the cache returned is the one given.
        - ``kvcompose_spec = (ctx_len, agg)``: a KVCompose re-feed chunk. The
          attention also gives each query's logsumexp (``return_lse``), and
          ``refeed_colagg`` aggregates the chunk's probabilities onto the
          first ``ctx_len`` columns (the dense route aggregates the
          probabilities it builds); (L, B, Hq, ctx_len) to ``scores_out``,
          bfloat16 under ``max`` from 65,536 columns on, as in JAX.

        Returns (last position's logits | None, cache with length and offset
        advanced by T, each layer's last ``hidden_window`` post-ln1 hidden
        states (L, B, W, E) | None)."""
        from ..presses.kvzip import subset_max_scores
        from ..ops.attention import refeed_colagg

        if kvzip_spec is not None and (
                not isinstance(kvzip_spec, tuple) or len(kvzip_spec) != 3
                or not all(isinstance(v, int) for v in kvzip_spec)):
            raise TypeError(f"kvzip_spec must be (start, sink, chunk_len), host ints: "
                            f"{kvzip_spec!r}")
        if kvcompose_spec is not None and (
                not isinstance(kvcompose_spec, tuple) or len(kvcompose_spec) != 2
                or not isinstance(kvcompose_spec[0], int)
                or kvcompose_spec[1] not in ("max", "mean")):
            raise TypeError(f"kvcompose_spec must be (ctx_len, 'max' | 'mean'): "
                            f"{kvcompose_spec!r}")
        cfg = self.cfg
        self._check_params(params)
        if kvcompose_spec is not None and (
                cfg.sliding_window is not None or kvzip_spec is not None
                or collect_fn is not None):
            raise ValueError("a KVCompose re-feed pass takes no sliding window, KVzip pass or "
                             "chunk scores")
        if chunk_embeds is not None:
            x = chunk_embeds
            B, T = x.shape[:2]
        else:
            B, T = chunk_ids.shape
            x = embed_tokens(params, chunk_ids, cfg)
        offset = int(cache.offset)
        positions = (offset + torch.arange(T, device=x.device))[None].expand(B, T)
        rope, rope_local = self._ropes(positions)
        scale = _sm_scale(cfg)
        softcap = cfg.logit_softcap
        quantized = cache.key_scales is not None
        bits = cache.bits
        S_buf = cache.max_size
        use_flash = self.attn_impl == "flash" and T > 1
        want_lse = kvcompose_spec is not None
        extra_allow = span = None
        if img_groups is not None:
            if k_groups is None:
                raise ValueError("img_groups needs k_groups")
            if quantized and fused_kv and use_flash:
                raise ValueError("image-span chunks take the dense route (fused_kv=False): "
                                 "flash_attention_quant has no or-mask")
            if use_flash:
                span = image_span
            else:
                extra_allow = same_image(img_groups, k_groups)
        lengths = cache.length.tolist()
        if max(lengths) + T > S_buf:
            # A write past the buffer would land on live slots (the JAX
            # update clamps its start back).
            raise ValueError(f"the chunk's {T} tokens do not fit after the longest layer's "
                             f"{max(lengths)} slots in a {S_buf}-slot buffer (presize or grow)")
        windows, scores = [], []
        for l, (layer, sliding) in enumerate(zip(params.layers, cfg.sliding_flags())):
            ln = lengths[l]
            lmask = None if cache.mask is None else cache.mask[l]
            window = cfg.sliding_window if sliding else None
            h = rms_norm(x, layer.ln1, cfg.rms_norm_eps, cfg.rms_one_offset)
            q_pre, k_pre, v = _project_qkv(layer, cfg, h)
            cos, sin = _rope_of(rope, rope_local, sliding)
            q = apply_rope(q_pre, cos, sin).contiguous()
            k = apply_rope(k_pre, cos, sin)
            kb, vb = cache.keys[l], cache.values[l]
            lse = probs = None
            if quantized:
                ks, vs = cache.key_scales[l], cache.value_scales[l]
                kb[:, :, ln:ln + T], ks[:, :, ln:ln + T] = quantize_kv(k, bits)
                vb[:, :, ln:ln + T], vs[:, :, ln:ln + T] = quantize_kv(v, bits)
                if collect_fn is not None:
                    scores.append(collect_fn(
                        collect_arg, l, h,
                        dequantize_kv(kb[:, :, ln:ln + T], ks[:, :, ln:ln + T], bits, x.dtype),
                        dequantize_kv(vb[:, :, ln:ln + T], vs[:, :, ln:ln + T], bits, x.dtype)))
                if use_flash and not fused_kv:
                    # Slots past ln + T are never attended: dequantize up to
                    # there (a same-image key lies inside the chunk too).
                    end = ln + T
                    kd = dequantize_kv(kb[:, :, :end], ks[:, :, :end], bits, x.dtype)
                    vd = dequantize_kv(vb[:, :, :end], vs[:, :, :end], bits, x.dtype)
                    m = None if lmask is None else lmask[:, :, :end].contiguous()
                    kg = None if span is None else k_groups[:, :end].contiguous()
                    o = flash_attention(q, kd, vd, ln, m, img_groups if span else None, kg,
                                        sm_scale=scale, softcap=softcap, window=window,
                                        or_span=span, return_lse=want_lse)
                    del kd, vd
                elif use_flash:
                    o = flash_attention_quant(q, kb, vb, ks, vs, ln, lmask, bits=bits,
                                              sm_scale=scale, softcap=softcap, window=window,
                                              return_lse=want_lse)
                else:
                    bias = attention_bias(ln, T, S_buf, sliding_window=window, head_mask=lmask,
                                          device=x.device, extra_allow=extra_allow)
                    if want_lse:
                        # the dense re-feed builds its probabilities anyway
                        o, probs = gqa_attention(q, dequantize_kv(kb, ks, bits, x.dtype),
                                                 dequantize_kv(vb, vs, bits, x.dtype), bias,
                                                 scale, softcap=softcap, return_probs=True)
                    else:
                        o = quant_gqa_attention(q, kb, vb, ks, vs, bias, scale, bits,
                                                softcap=softcap)
            else:
                ks = None
                kb[:, :, ln:ln + T] = k.to(kb.dtype)
                vb[:, :, ln:ln + T] = v.to(vb.dtype)
                if collect_fn is not None:
                    scores.append(collect_fn(collect_arg, l, h, k.to(kb.dtype), v.to(vb.dtype)))
                if use_flash:
                    o = flash_attention(q, kb, vb, ln, lmask, img_groups if span else None,
                                        None if span is None else k_groups, sm_scale=scale,
                                        softcap=softcap, window=window, or_span=span,
                                        return_lse=want_lse)
                else:
                    bias = attention_bias(ln, T, S_buf, sliding_window=window, head_mask=lmask,
                                          device=x.device, extra_allow=extra_allow)
                    o, probs = gqa_attention(q, kb, vb, bias, scale, softcap=softcap,
                                             return_probs=want_lse)
            if want_lse and use_flash:
                o, lse = o
            if kvcompose_spec is not None:
                zctx, zagg = kvcompose_spec
                red = "max" if zagg == "max" else "sum"
                big = zctx >= (1 << 16)
                if probs is None:
                    part = refeed_colagg(q, kb, ks, bits, lse, zctx, red, scale, softcap,
                                         block=256 if big else 512)
                else:
                    pc = probs[..., :zctx].float()
                    part = pc.amax(dim=2) if red == "max" else pc.sum(dim=2)
                    del probs
                if big and red == "max":
                    # the stacked (L, B, Hq, ctx_len) partials next to the
                    # doubled buffer: max is monotone, bf16 halves them
                    part = part.to(torch.bfloat16)
                scores.append(part)
            if kvzip_spec is not None:
                zstart, zsink, zcl = kvzip_spec
                if quantized:
                    parts = ([dequantize_kv(kb[:, :, :zsink], ks[:, :, :zsink], bits, x.dtype)]
                             if zsink else [])
                    parts.append(dequantize_kv(kb[:, :, zstart:zstart + zcl],
                                               ks[:, :, zstart:zstart + zcl], bits, x.dtype))
                else:
                    parts = ([kb[:, :, :zsink]] if zsink else []) + [
                        kb[:, :, zstart:zstart + zcl]]
                parts.append(k.to(parts[-1].dtype))
                scores.append(subset_max_scores(q, torch.cat(parts, dim=2), zsink, zcl))
            if hidden_window is not None:
                # a copy: a view would keep every layer's whole chunk of
                # hidden states alive until the stack below
                windows.append(h[:, -hidden_window:].clone())
            x = _finish_layer(x, o, layer, cfg, self.shard)
        logits = None
        if compute_logits:
            xl = rms_norm(x[:, -1:], params.ln_f, cfg.rms_norm_eps, cfg.rms_one_offset)
            logits = lm_head_logits(xl, params, cfg, self.shard)
        if kvzip_spec is None:
            cache = dataclasses.replace(cache, length=cache.length + T, offset=cache.offset + T)
        if scores:
            scores_out.append(torch.stack(scores))
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
                       attention_scaling=self.attention_scaling, last_position=last_pos,
                       shard=self.shard)
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
        lengths[l] = int(nlen) if self.shard is None else self.shard.max(nlen)
        return dataclasses.replace(cache, length=lengths)

