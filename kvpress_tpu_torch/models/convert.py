"""Weights into the port's ``LlamaModel`` (port of
``kvpress_tpu/models/convert.py``).

- ``params_from_jax`` carries the JAX package's parameter tree across: the
  stacked ``(L, ...)`` layout of ``kvpress_tpu.models.llama.init_params``
  (every weight name: qkv biases, q/k-norms, Gemma3's post-norms, int8 and
  int4 payloads with their ``_scale`` arrays), handed over as numpy arrays;
  ``siglip.vision_from_jax`` does the same for the vision tower.
- ``convert_state_dict`` maps an HF-style state dict over the architecture
  surface the reference special-cases (``kvpress/utils.py:12-95``): plain
  q/k/v/o (Llama, Mistral, Qwen2 with its qkv bias), fused ``qkv_proj`` and
  ``gate_up_proj`` (Phi3, split here so the runner has one layout), q/k-norm
  (Qwen3, Gemma3), Gemma3's four norms, and fine-grained fp8 checkpoints
  (128 x 128 block scales, dequantized here).
- ``from_torch_model`` / ``from_torch_multimodal`` convert a live
  ``transformers`` model (the parity tests build tiny ones from configs);
  ``multimodal_embeds`` puts vision features into the text embedding;
  ``load_pretrained`` reads a local directory of safetensors shards.
"""

from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np
import torch

from ..config import ModelConfig
from ..device import DeviceLike, resolve_device
from .llama import LlamaModel, embed_tokens


def params_from_jax(np_params: dict, cfg: ModelConfig, device: DeviceLike = "cuda",
                    dtype: torch.dtype = torch.bfloat16) -> LlamaModel:
    """The JAX parameter tree (numpy arrays, stacked over layers) as the
    port's module. Weights, biases and norms take ``dtype``; int8 and int4
    payloads keep their integer type and their scales float32."""
    device = resolve_device(device)

    def conv(name, a):
        t = torch.from_numpy(np.array(a)).to(device)      # a copy: numpy views may be read-only
        if t.is_floating_point() and not name.endswith("_scale"):
            t = t.to(dtype)
        return t

    stacked = np_params["layers"]
    layers = [{name: conv(name, a[i]) for name, a in stacked.items()}
              for i in range(cfg.num_layers)]
    extra = {n: conv(n, np_params[n]) for n in ("embed_scale", "lm_head_scale")
             if n in np_params}
    head = np_params.get("lm_head")
    return LlamaModel(conv("embed", np_params["embed"]), layers,
                      conv("ln_f", np_params["ln_f"]),
                      None if head is None else conv("lm_head", head), extra)


def _np(t) -> np.ndarray:
    """A tensor or array as numpy; bf16 and fp8 tensors are upcast to
    float32 (numpy has neither)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16 or "float8" in str(t.dtype):
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def convert_state_dict(sd: Mapping[str, object], cfg: ModelConfig,
                       dtype: torch.dtype = torch.bfloat16,
                       device: DeviceLike = "cuda") -> LlamaModel:
    """HF-style state dict -> ``LlamaModel`` ((in, out) linears)."""
    device = resolve_device(device)
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    has = sd.__contains__

    def get(name) -> np.ndarray:
        return _np(sd[name])

    def conv(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    def linear(i, name) -> np.ndarray:
        w = get(f"model.layers.{i}.{name}.weight")
        # Fine-grained fp8 checkpoints carry 128 x 128 block inverse scales.
        for key in (f"model.layers.{i}.{name}.weight_scale_inv",
                    f"model.layers.{i}.{name}.weight_scale"):
            if has(key):
                s = get(key)
                if s.ndim == 2 and s.shape != w.shape:          # block scales
                    br, bc = -(-w.shape[0] // s.shape[0]), -(-w.shape[1] // s.shape[1])
                    s = np.repeat(np.repeat(s, br, 0), bc, 1)[:w.shape[0], :w.shape[1]]
                w = w * s
                break
        return w.T                                              # (in, out)

    fused_qkv = has("model.layers.0.self_attn.qkv_proj.weight")
    fused_gu = has("model.layers.0.mlp.gate_up_proj.weight")
    F_ = cfg.intermediate_size
    layers = []
    for i in range(cfg.num_layers):
        L = f"model.layers.{i}."
        if fused_qkv:
            qkv = get(L + "self_attn.qkv_proj.weight").T
            wq, wk, wv = qkv[:, :Hq * D], qkv[:, Hq * D:(Hq + Hkv) * D], qkv[:, (Hq + Hkv) * D:]
        else:
            wq, wk, wv = (linear(i, f"self_attn.{n}_proj") for n in "qkv")
        if fused_gu:
            gu = get(L + "mlp.gate_up_proj.weight").T
            wg, wu = gu[:, :F_], gu[:, F_:]
        else:
            wg, wu = linear(i, "mlp.gate_proj"), linear(i, "mlp.up_proj")
        t = {"wq": wq, "wk": wk, "wv": wv, "wo": linear(i, "self_attn.o_proj"),
             "wg": wg, "wu": wu, "wd": linear(i, "mlp.down_proj"),
             "ln1": get(L + "input_layernorm.weight")}
        if cfg.post_norms:
            # Gemma3: ln2 is the pre-MLP norm; post-attention and post-MLP
            # norms follow the two blocks.
            t["ln2"] = get(L + "pre_feedforward_layernorm.weight")
            t["ln1_post"] = get(L + "post_attention_layernorm.weight")
            t["ln2_post"] = get(L + "post_feedforward_layernorm.weight")
        elif has(L + "post_attention_layernorm.weight"):
            t["ln2"] = get(L + "post_attention_layernorm.weight")
        else:
            t["ln2"] = get(L + "pre_feedforward_layernorm.weight")
        if cfg.attention_bias and has("model.layers.0.self_attn.q_proj.bias"):
            for n in "qkv":
                t[f"b{n}"] = get(L + f"self_attn.{n}_proj.bias")
        if cfg.qk_norm:
            t["q_norm"] = get(L + "self_attn.q_norm.weight")
            t["k_norm"] = get(L + "self_attn.k_norm.weight")
        layers.append({name: conv(a) for name, a in t.items()})
    head = None
    if not cfg.tie_word_embeddings and has("lm_head.weight"):
        head = conv(get("lm_head.weight").T)
    return LlamaModel(conv(get("model.embed_tokens.weight")), layers,
                      conv(get("model.norm.weight")), head)


def from_torch_model(model, dtype: torch.dtype = torch.float32,
                     device: DeviceLike = "cuda") -> tuple[LlamaModel, ModelConfig]:
    """Convert a live ``transformers`` CausalLM (used by the parity tests)."""
    cfg = ModelConfig.from_hf_config(model.config)
    return convert_state_dict(dict(model.state_dict()), cfg, dtype, device), cfg


def from_torch_multimodal(model, dtype: torch.dtype = torch.float32,
                          device: DeviceLike = "cuda"):
    """``Gemma3ForConditionalGeneration`` -> (params, cfg, tower): the text
    decoder (``model.language_model.*`` keys) and the vision tower with its
    projector as a ``siglip.VisionTower``, whose call maps (B, C, I, I)
    pixels to the (B, mm_tokens_per_image, E) features that
    ``multimodal_embeds`` takes (``tower.vcfg`` is its config). The press
    sees the text decoder's layers only, sliding ones skipped (reference
    base_press.py:191-202)."""
    from .siglip import VisionConfig, convert_vision_tower

    cfg = ModelConfig.from_hf_config(model.config.text_config)
    full = dict(model.state_dict())
    sd = {}
    for k, v in full.items():
        if k.startswith("model.language_model."):
            sd["model." + k[len("model.language_model."):]] = v
        elif k == "lm_head.weight":
            sd[k] = v
    params = convert_state_dict(sd, cfg, dtype, device)
    tower = convert_vision_tower(full, VisionConfig.from_hf_config(model.config), dtype,
                                 device)
    return params, cfg, tower


def multimodal_embeds(params: LlamaModel, cfg: ModelConfig, ids: torch.Tensor,
                      image_features: torch.Tensor, image_token_id: int) -> torch.Tensor:
    """(B, S) ids + (n_images, P, E) projected vision features -> inputs_embeds.

    ``ids`` hold ``image_token_id`` placeholders (the HF processor contract:
    each image gives P consecutive placeholder tokens); feature rows go to
    those positions in order of appearance. Text embeddings are scaled by
    sqrt(E) here (Gemma3ScaledWordEmbedding), because the runner, like HF,
    does not scale ``inputs_embeds``."""
    ids = torch.as_tensor(ids, device=params.device)
    x = embed_tokens(params, ids, cfg)
    feats = torch.as_tensor(image_features, device=x.device).reshape(-1, x.shape[-1])
    mask = ids == image_token_id
    # each placeholder's row in order of appearance (unused where not one)
    row = torch.cumsum(mask.reshape(-1).to(torch.int64), 0).reshape(ids.shape) - 1
    repl = feats[row.clamp(0, feats.shape[0] - 1)].to(x.dtype)
    return torch.where(mask[..., None], repl, x)


def load_pretrained(path: str, dtype: torch.dtype = torch.bfloat16,
                    device: DeviceLike = "cuda") -> tuple[LlamaModel, ModelConfig]:
    """Load from a local HF checkpoint directory of safetensors shards."""
    from safetensors.torch import load_file
    from transformers import AutoConfig

    hf_cfg = AutoConfig.from_pretrained(path)
    cfg = ModelConfig.from_hf_config(getattr(hf_cfg, "text_config", hf_cfg))
    idx = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = ["model.safetensors"]
    sd = {}
    for fname in files:
        sd.update(load_file(os.path.join(path, fname)))
    return convert_state_dict(sd, cfg, dtype=dtype, device=device), cfg
