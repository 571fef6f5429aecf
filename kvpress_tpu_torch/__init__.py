"""kvpress_tpu_torch: the PyTorch / NVIDIA Hopper port of ``kvpress_tpu``.

The same modules and names as the JAX package (config, rope, cache,
ops.attention, ops.flash, ops.decode, ops.observed_colsum,
ops.decode_headwise, models.llama, models.convert, presses, pipeline), in
PyTorch. The JAX package's Pallas kernels are hand-written CUDA kernels for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The package imports nothing of JAX or of ``kvpress_tpu``.
"""

from .cache import KVCache, init_cache, quantize_kv, dequantize_kv, resize, shrink, valid_mask
from .config import ModelConfig, tiny_config
from .models.convert import convert_state_dict, params_from_jax
from .models.llama import Runner, init_params, quantize_params_int4, quantize_params_int8
from .pipeline import KVPressPipeline
from .presses import (AdaKVPress, BasePress, KnormPress, LayerCtx, ObservedAttentionPress,
                      PyramidKVPress, RandomPress, ScorerPress, SnapKVPress,
                      StreamingLLMPress, TOVAPress, topk_keep)

__version__ = "0.1.0"

__all__ = [
    "KVCache", "init_cache", "quantize_kv", "dequantize_kv", "resize", "shrink",
    "valid_mask", "ModelConfig", "tiny_config", "convert_state_dict",
    "params_from_jax", "Runner", "init_params", "quantize_params_int4", "quantize_params_int8",
    "KVPressPipeline", "AdaKVPress", "BasePress", "KnormPress", "LayerCtx",
    "ObservedAttentionPress", "PyramidKVPress", "RandomPress", "ScorerPress", "SnapKVPress",
    "StreamingLLMPress", "TOVAPress", "topk_keep",
]
