from .base import BasePress, LayerCtx, ScorerPress, topk_keep
from .knorm import KnormPress

__all__ = ["BasePress", "LayerCtx", "ScorerPress", "topk_keep", "KnormPress"]
