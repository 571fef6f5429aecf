from .base import BasePress, LayerCtx, ScorerPress, topk_keep
from .cam import CAMPress
from .cap import CapPress
from .compactor import CompactorPress, LeverageScorePress, NonCausalAttnPress
from .cur import CURPress
from .decoding import CompressionRatioDecodingPress, DecodingPress, PrefillDecodingPress
from .dms import DMSPress
from .duo import DuoAttentionPress, duo_attention_on_the_fly, load_duo_head_scores
from .expected_attention import ExpectedAttentionPress
from .fastkvzip import (FastKVzipPress, gate_scores, init_random_gates, load_fastkvzip_gates,
                        save_fastkvzip_gates)
from .expected_attention_stats import (ExpectedAttentionStatsPress, collect_query_stats,
                                       load_query_stats, save_query_stats)
from .keydiff import KeyDiffPress
from .knorm import KnormPress
from .kvcompose import KVComposeCollector, KVComposePress
from .kvzap import KVzapPress, kvzap_apply, load_kvzap_model, save_kvzap_model
from .kvzip import KVzipChunkScorer, KVzipPress, subset_max_scores
from .finch import FinchPress
from .lagkv import LagKVPress
from .lukv import LUKVPress, load_budget_curve
from .merging import MergingPress
from .qfilter import QFilterPress, load_q_filters
from .random_press import RandomPress
from .restorekv import (RestoreKVPress, apply_lora, init_random_lora, load_restore_artifacts,
                        save_restore_artifacts)
from .simlayerkv import SimLayerKVPress
from .snapkv import ObservedAttentionPress, PyramidKVPress, SnapKVPress, TOVAPress
from .streaming_llm import StreamingLLMPress
from .wrappers import (AdaKVPress, BlockPress, ChunkKVPress, ChunkPress, ComposedPress,
                       CriticalAdaKVPress, CriticalKVPress, KeyRerotationPress,
                       PerLayerCompressionPress, ThinKPress)

__all__ = [
    "AdaKVPress", "BasePress", "LayerCtx", "ScorerPress", "topk_keep", "CapPress",
    "CompactorPress", "LeverageScorePress", "NonCausalAttnPress", "CURPress",
    "ExpectedAttentionPress", "ExpectedAttentionStatsPress", "collect_query_stats",
    "load_query_stats", "save_query_stats", "KeyDiffPress", "KnormPress", "KVzapPress",
    "kvzap_apply", "load_kvzap_model", "save_kvzap_model", "LagKVPress", "QFilterPress",
    "load_q_filters", "RandomPress", "ObservedAttentionPress", "PyramidKVPress", "SnapKVPress",
    "TOVAPress", "StreamingLLMPress", "BlockPress", "ChunkKVPress", "ChunkPress",
    "ComposedPress", "CriticalAdaKVPress", "CriticalKVPress", "KeyRerotationPress",
    "PerLayerCompressionPress", "ThinKPress", "DMSPress", "DuoAttentionPress",
    "duo_attention_on_the_fly", "load_duo_head_scores", "FinchPress", "LUKVPress",
    "load_budget_curve", "MergingPress", "SimLayerKVPress", "CAMPress",
    "CompressionRatioDecodingPress", "DecodingPress", "PrefillDecodingPress",
    "FastKVzipPress", "gate_scores", "init_random_gates", "load_fastkvzip_gates",
    "save_fastkvzip_gates", "KVComposeCollector", "KVComposePress", "KVzipChunkScorer",
    "KVzipPress", "subset_max_scores", "RestoreKVPress", "apply_lora", "init_random_lora",
    "load_restore_artifacts", "save_restore_artifacts",
]
