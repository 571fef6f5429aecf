from .base import BasePress, LayerCtx, ScorerPress, topk_keep
from .knorm import KnormPress
from .random_press import RandomPress
from .snapkv import ObservedAttentionPress, PyramidKVPress, SnapKVPress, TOVAPress
from .streaming_llm import StreamingLLMPress
from .wrappers import AdaKVPress

__all__ = [
    "AdaKVPress", "BasePress", "LayerCtx", "ScorerPress", "topk_keep", "KnormPress",
    "RandomPress", "ObservedAttentionPress", "PyramidKVPress", "SnapKVPress", "TOVAPress",
    "StreamingLLMPress",
]
