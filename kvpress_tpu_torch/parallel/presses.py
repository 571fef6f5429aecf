"""Which presses run under a mesh (tensor-parallel serving).

A press sees the rank's kv heads only. Three classes (``ROADMAP.md``,
"Presses under a mesh"):

- (a) shard-local: each kv head is scored from its own keys, values and
  group queries, and kept by its own top-k. These run as they are.
- (b) an artifact or a draw by global head index (query statistics,
  Q-filters, a surrogate's outputs, Duo's head pattern, gates, LoRA,
  random draws): the rank would have to read its slice of the head axis.
- (c) a decision across heads: ``AdaKVPress`` all-gathers its scores over
  "model" (``LayerCtx.shard``) and keeps its own heads' part; a compacted
  layer's length is the largest over the ranks (``Runner._layer_step``).

The presses of ``MESH_PRESSES`` are held against the JAX package under a
mesh; every other press raises ``NotImplementedError`` naming its ROADMAP
item, also as a stage of ``ComposedPress`` or inside another wrapper.
Class (a) reads the rank's shapes from its tensors and ``ctx.cfg`` (the
rank's ``local_config``): ``CriticalKVPress`` multiplies by the rank's rows
of ``wo`` (an int4 payload's repacked halves), ``BlockPress`` splits the
hidden size over every rank's kv heads and all-gathers the candidate sets,
and every rank of a rerotating or compacting press ends at one length.
``KVzapPress`` (class (b)) reads its rank's columns of the surrogate's
output layer; ``DMSPress`` thresholds each of the rank's heads on its own
(its prefill mask, its decode ring), and a ``compact=True`` layer is as
long as its longest head over every rank (``cache.compact_masked``).

Over a ``"seq"`` mesh (context parallelism, ``parallel/context_prefill.py``
and ``parallel/decode.py``) a press compresses each rank's block of the
sequence on its own: the single-device ``ChunkPress(press, S / N)``. It sees
its block's queries and no attention probabilities, and a decode-time press
its own shard with per-shard targets. ``SEQ_PRESSES`` (prefill) and
``SEQ_DECODE_PRESSES`` (decode) are held against the JAX package's
``context_parallel_prefill`` and ``context_parallel_decode_step``; every
other press raises ``NotImplementedError`` naming ROADMAP Queue A item 19.
"""

from __future__ import annotations

# Class (a), and the wrappers that run over them.
SCORERS = ("KnormPress", "SnapKVPress", "PyramidKVPress", "ObservedAttentionPress",
           "StreamingLLMPress", "ExpectedAttentionPress", "KeyDiffPress", "LagKVPress",
           "CapPress", "CURPress")
WRAPPERS = ("CriticalKVPress", "KeyRerotationPress", "PerLayerCompressionPress", "ThinKPress",
            "ChunkPress", "ComposedPress", "MergingPress", "BlockPress", "FinchPress")
DECODING = ("DecodingPress", "CompressionRatioDecodingPress")
MESH_PRESSES = SCORERS + WRAPPERS + DECODING + ("AdaKVPress", "PrefillDecodingPress",
                                                "BasePress", "DMSPress", "KVzapPress")

# ROADMAP Queue A item 18: one item a press, numbered in this order; the
# presses of MESH_PRESSES among them are done and left out of MESH_ITEMS.
_ITEM_ORDER = {name: f"18.{i}" for i, name in enumerate((
    # (a) shard-local arithmetic
    "CapPress", "CURPress", "CriticalKVPress", "KeyRerotationPress",
    "PerLayerCompressionPress", "ThinKPress", "ChunkPress", "ComposedPress", "MergingPress",
    "BlockPress", "FinchPress", "DMSPress",
    # (b) an artifact or a draw by global head index
    "RandomPress", "QFilterPress", "KVzapPress", "ExpectedAttentionStatsPress",
    "DuoAttentionPress", "FastKVzipPress", "RestoreKVPress",
    # (c) a decision across heads
    "TOVAPress", "CriticalAdaKVPress", "ChunkKVPress", "LUKVPress", "SimLayerKVPress",
    "CompactorPress", "LeverageScorePress", "NonCausalAttnPress", "CAMPress", "KVzipPress",
    "KVzipChunkScorer", "KVComposePress", "KVComposeCollector"), start=1)}
MESH_ITEMS = {name: item for name, item in _ITEM_ORDER.items() if name not in MESH_PRESSES}


def check_press(press) -> None:
    """Raise ``NotImplementedError`` unless ``press`` and every press it
    wraps (``ComposedPress``'s stages included) run under a mesh."""
    name = type(press).__name__
    if name not in MESH_PRESSES:
        raise NotImplementedError(f"{name} does not run under a mesh yet: ROADMAP Queue A item "
                                  f"{MESH_ITEMS.get(name, '18')} (presses under a mesh)")
    for attr in ("press", "base_press", "prefilling_press", "decoding_press"):
        inner = getattr(press, attr, None)
        if inner is not None:
            check_press(inner)
    for inner in getattr(press, "presses", ()):       # ComposedPress's stages
        check_press(inner)


# Context parallelism: the presses held against JAX's shard-local runs.
SEQ_PRESSES = ("KnormPress", "StreamingLLMPress", "SnapKVPress", "KeyDiffPress", "BasePress")
SEQ_DECODE_PRESSES = ("DecodingPress", "CompressionRatioDecodingPress")
SEQ_ITEM = "19"


def check_seq_press(press, decode: bool = False) -> None:
    """Raise ``NotImplementedError`` unless ``press`` runs shard-local over a
    ``"seq"`` mesh: a prefill press of ``SEQ_PRESSES``, or (``decode``) a
    decode-time press of ``SEQ_DECODE_PRESSES`` over one of them."""
    name = type(press).__name__
    allowed = SEQ_DECODE_PRESSES if decode else SEQ_PRESSES
    if name not in allowed:
        raise NotImplementedError(f"{name} does not run over a seq mesh yet: ROADMAP Queue A item "
                                  f"{SEQ_ITEM} (presses under context parallelism)")
    if decode:
        check_seq_press(press.base_press)
