"""Model configuration for the PyTorch decoder runner (a copy of
``kvpress_tpu/config.py``: the port imports nothing of the JAX package).

Covers the architecture surface that the reference special-cases in
``kvpress/utils.py:12-95`` and ``kvpress/presses/base_press.py:27-34``:
Llama / Mistral / Qwen2 (plain GQA), Qwen3 / Gemma3 (q/k RMS-norm),
Phi3 (fused qkv — handled at weight-conversion time), Gemma3
(interleaved sliding-window layers), with default and YaRN RoPE scaling.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # HF-style rope_scaling dict: {"rope_type": "yarn"|"llama3"|"default", ...}
    rope_scaling: Optional[dict] = None
    qk_norm: bool = False            # Qwen3/Gemma3 per-head RMSNorm on q and k
    tie_word_embeddings: bool = False
    attention_bias: bool = False     # Qwen2 uses qkv bias
    mlp_bias: bool = False
    # Gemma3-style interleaved local attention: sliding window size, and for
    # each layer whether it is a sliding-window ("local") layer. None = all global.
    sliding_window: Optional[int] = None
    layer_is_sliding: Optional[tuple[bool, ...]] = None
    act: str = "silu"                # "silu" | "gelu_tanh" (gemma)
    max_position_embeddings: int = 131072
    # Gemma3 scales embeddings by sqrt(hidden) and uses different norm placement.
    scale_embeddings: bool = False
    post_norms: bool = False         # Gemma3 pre+post attention/mlp norms
    rms_one_offset: bool = False     # Gemma-style (1 + w) RMSNorm weights
    logit_softcap: Optional[float] = None
    # Gemma-family: fixed attention scale and a separate RoPE base frequency
    # for sliding-window (local) layers.
    query_pre_attn_scalar: Optional[float] = None
    rope_local_base_freq: Optional[float] = None
    model_type: str = "llama"

    def __post_init__(self) -> None:
        assert self.num_heads % self.num_kv_heads == 0
        if self.layer_is_sliding is not None:
            assert len(self.layer_is_sliding) == self.num_layers

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def sliding_flags(self) -> tuple[bool, ...]:
        if self.layer_is_sliding is not None:
            return self.layer_is_sliding
        return tuple(False for _ in range(self.num_layers))

    @staticmethod
    def from_hf_config(hf: Any) -> "ModelConfig":
        """Build from a ``transformers`` PretrainedConfig (no torch needed)."""
        get = lambda name, default=None: getattr(hf, name, default)
        model_type = get("model_type", "llama")
        head_dim = get("head_dim", None) or hf.hidden_size // hf.num_attention_heads
        qk_norm = model_type in ("qwen3", "gemma3", "gemma3_text")
        layer_types = get("layer_types", None)
        layer_is_sliding = None
        sliding = get("sliding_window", None)
        if layer_types is not None and sliding is not None:
            layer_is_sliding = tuple(t == "sliding_attention" for t in layer_types)
        elif model_type in ("gemma3", "gemma3_text") and sliding is not None:
            pattern = get("sliding_window_pattern", 6)
            layer_is_sliding = tuple(
                (i + 1) % pattern != 0 for i in range(hf.num_hidden_layers)
            )
        else:
            sliding = None
        rope_scaling = get("rope_scaling", None)
        if isinstance(rope_scaling, dict):
            rope_scaling = dict(rope_scaling)
        return ModelConfig(
            vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            intermediate_size=hf.intermediate_size,
            num_layers=hf.num_hidden_layers,
            num_heads=hf.num_attention_heads,
            num_kv_heads=get("num_key_value_heads", hf.num_attention_heads),
            head_dim=head_dim,
            rms_norm_eps=get("rms_norm_eps", 1e-6),
            rope_theta=get("rope_theta", 10000.0),
            rope_scaling=rope_scaling,
            qk_norm=qk_norm,
            tie_word_embeddings=get("tie_word_embeddings", False),
            attention_bias=get("attention_bias", False) or model_type == "qwen2",
            mlp_bias=get("mlp_bias", False),
            sliding_window=sliding,
            layer_is_sliding=layer_is_sliding,
            act="gelu_tanh" if model_type.startswith("gemma") else "silu",
            max_position_embeddings=get("max_position_embeddings", 131072),
            scale_embeddings=model_type.startswith("gemma"),
            post_norms=model_type.startswith("gemma3"),
            rms_one_offset=model_type.startswith("gemma"),
            logit_softcap=get("final_logit_softcapping", None),
            query_pre_attn_scalar=get("query_pre_attn_scalar", None),
            rope_local_base_freq=get("rope_local_base_freq", None),
            model_type=model_type,
        )


def tiny_config(**overrides: Any) -> ModelConfig:
    """A 0-parameter-scale config mirroring the reference's llama2-0b unit-test
    fixture (SURVEY §4; reference tests/fixtures.py:15-24)."""
    cfg = dict(
        vocab_size=1024,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        rope_theta=10000.0,
    )
    cfg.update(overrides)
    return ModelConfig(**cfg)
