"""Weights into the port's ``LlamaModel``.

- ``params_from_jax`` carries the JAX package's parameter tree across: the
  stacked ``(L, ...)`` layout of ``kvpress_tpu.models.llama.init_params``
  (int8 payloads with their ``_scale`` arrays included), handed over as
  numpy arrays.
- ``convert_state_dict`` (port of ``kvpress_tpu/models/convert.py:35-145``,
  Llama only) maps an HF-style state dict, and ``load_pretrained`` reads one
  from a local directory of safetensors shards.
"""

from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np
import torch

from ..config import ModelConfig
from ..device import DeviceLike, resolve_device
from .llama import LlamaModel


def params_from_jax(np_params: dict, cfg: ModelConfig, device: DeviceLike = "cuda",
                    dtype: torch.dtype = torch.bfloat16) -> LlamaModel:
    """The JAX parameter tree (numpy arrays, stacked over layers) as the
    port's module. Weights and norms take ``dtype``; int8 payloads stay int8
    and their scales float32."""
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
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def convert_state_dict(sd: Mapping[str, object], cfg: ModelConfig,
                       dtype: torch.dtype = torch.bfloat16,
                       device: DeviceLike = "cuda") -> LlamaModel:
    """HF Llama-style state dict -> ``LlamaModel`` ((in, out) linears)."""
    if (cfg.qk_norm or cfg.post_norms or cfg.attention_bias
            or "model.layers.0.self_attn.qkv_proj.weight" in sd):
        raise NotImplementedError(
            "q/k-norm, post-norms, qkv bias and fused qkv come with the other "
            "architectures (ROADMAP Queue A item 9)")
    device = resolve_device(device)

    def get(name):
        return torch.from_numpy(np.ascontiguousarray(_np(sd[name]))).to(device=device,
                                                                         dtype=dtype)

    def linear(i, name):
        return get(f"model.layers.{i}.{name}.weight").t().contiguous()   # (in, out)

    layers = []
    for i in range(cfg.num_layers):
        layers.append({
            "wq": linear(i, "self_attn.q_proj"),
            "wk": linear(i, "self_attn.k_proj"),
            "wv": linear(i, "self_attn.v_proj"),
            "wo": linear(i, "self_attn.o_proj"),
            "wg": linear(i, "mlp.gate_proj"),
            "wu": linear(i, "mlp.up_proj"),
            "wd": linear(i, "mlp.down_proj"),
            "ln1": get(f"model.layers.{i}.input_layernorm.weight"),
            "ln2": get(f"model.layers.{i}.post_attention_layernorm.weight"),
        })
    head = None
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        head = get("lm_head.weight").t().contiguous()
    return LlamaModel(get("model.embed_tokens.weight"), layers, get("model.norm.weight"),
                      head)


def load_pretrained(path: str, dtype: torch.dtype = torch.bfloat16,
                    device: DeviceLike = "cuda") -> tuple[LlamaModel, ModelConfig]:
    """Load from a local HF checkpoint directory of safetensors shards."""
    from safetensors.torch import load_file
    from transformers import AutoConfig

    cfg = ModelConfig.from_hf_config(AutoConfig.from_pretrained(path))
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
