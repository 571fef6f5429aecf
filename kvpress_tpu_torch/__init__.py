"""kvpress_tpu_torch: the PyTorch / NVIDIA Hopper port of ``kvpress_tpu``.

The same modules and names as the JAX package (config, rope, cache,
ops.attention, ops.flash, ops.decode, ops.observed_colsum,
ops.decode_headwise, ops.duo_decode, models.llama, models.convert, models.siglip, presses,
pipeline), in
PyTorch. The JAX package's Pallas kernels are hand-written CUDA kernels for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The package imports nothing of JAX or of ``kvpress_tpu``.
"""

from .cache import (KVCache, compact_masked, dequantize_kv, init_cache, masked_fraction,
                    quantize_kv, resize, shrink, valid_mask)
from .config import ModelConfig, tiny_config
from .models.convert import (convert_state_dict, from_torch_model, from_torch_multimodal,
                             multimodal_embeds, params_from_jax)
from .models.llama import (Runner, init_params, quantize_layer_int4, quantize_params_int4,
                           quantize_params_int8)
from .models.siglip import VisionConfig, VisionTower, encode_images, init_vision_params
from .ops.duo_decode import DuoSplitCache, build_duo_split, duo_decode_step
from .pipeline import KVPressPipeline
from .presses import (AdaKVPress, BasePress, BlockPress, CAMPress, CapPress, ChunkKVPress,
                      ChunkPress, CompactorPress, CompressionRatioDecodingPress, DecodingPress,
                      PrefillDecodingPress, ComposedPress, CriticalAdaKVPress, CriticalKVPress,
                      CURPress, ExpectedAttentionPress, ExpectedAttentionStatsPress,
                      KeyDiffPress, KeyRerotationPress, KnormPress, KVzapPress, LagKVPress,
                      LayerCtx, LeverageScorePress, NonCausalAttnPress, ObservedAttentionPress,
                      PerLayerCompressionPress, PyramidKVPress, QFilterPress, RandomPress,
                      ScorerPress, SnapKVPress, StreamingLLMPress, ThinKPress, TOVAPress,
                      collect_query_stats, load_kvzap_model, load_q_filters, load_query_stats,
                      save_kvzap_model, save_query_stats, topk_keep, DMSPress,
                      DuoAttentionPress, FinchPress, LUKVPress, MergingPress, SimLayerKVPress,
                      duo_attention_on_the_fly, load_budget_curve, load_duo_head_scores)

__version__ = "0.1.0"

__all__ = [
    "KVCache", "init_cache", "quantize_kv", "dequantize_kv", "resize", "shrink",
    "valid_mask", "ModelConfig", "tiny_config", "convert_state_dict", "from_torch_model",
    "from_torch_multimodal", "multimodal_embeds", "params_from_jax", "Runner", "init_params",
    "quantize_layer_int4", "quantize_params_int4", "quantize_params_int8", "VisionConfig",
    "VisionTower", "encode_images", "init_vision_params",
    "KVPressPipeline", "AdaKVPress", "BasePress", "CapPress", "CompactorPress", "CURPress",
    "ExpectedAttentionPress", "ExpectedAttentionStatsPress", "KeyDiffPress", "KnormPress",
    "KVzapPress", "LagKVPress", "LayerCtx", "LeverageScorePress", "NonCausalAttnPress",
    "ObservedAttentionPress", "PyramidKVPress", "QFilterPress", "RandomPress", "ScorerPress",
    "SnapKVPress", "StreamingLLMPress", "TOVAPress", "collect_query_stats", "load_kvzap_model",
    "load_q_filters", "load_query_stats", "save_kvzap_model", "save_query_stats", "topk_keep",
    "BlockPress", "ChunkKVPress", "ChunkPress", "ComposedPress", "CriticalAdaKVPress",
    "CriticalKVPress", "KeyRerotationPress", "PerLayerCompressionPress", "ThinKPress",
    "masked_fraction", "compact_masked", "DuoSplitCache", "build_duo_split", "duo_decode_step",
    "DMSPress", "DuoAttentionPress", "FinchPress", "LUKVPress", "MergingPress",
    "SimLayerKVPress", "duo_attention_on_the_fly", "load_budget_curve", "load_duo_head_scores",
    "CAMPress", "CompressionRatioDecodingPress", "DecodingPress", "PrefillDecodingPress",
]
