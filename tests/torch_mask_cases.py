"""Shared cases of the mask, merge and head-split press parity tests of
kvpress_tpu_torch (tests/test_torch_mask_presses.py and
test_torch_chunked_mask_presses.py): Merging, LUKV, SimLayerKV, Finch,
DuoAttention and DMS in both packages by the same arguments, with seeded
stand-ins for their artifacts (a LU-KV budget curve, Duo head scores, a KVzap
surrogate).

The thresholds are set on the tiny models of ``torch_scorer_cases.tiny_models``
over a 72-token context: SimLayerKV's lazy scores there are 0.256 (layer 0)
and 0.270 (layer 1), so 0.263 makes layer 1 lazy alone; the median Knorm
score is about -3.86 and the linear KVzap surrogate's about 0 (-0.45 and
0.32), so DMS evicts about half of what lies outside its window."""

import numpy as np

import kvpress_tpu_torch as kt
from torch_scorer_cases import _surrogate

_rng = np.random.default_rng(21)
L, HKV = kt.tiny_config().num_layers, kt.tiny_config().num_kv_heads
CURVE = _rng.uniform(0.1, 0.9, (99, L, HKV)).astype(np.float32)
HEAD_SCORES = _rng.standard_normal((L, HKV)).astype(np.float32)
SNAP = dict(window_size=8, kernel_size=3)
LAZY = 0.263


def _ea(m, eps):
    return m.ExpectedAttentionPress(0.5, n_future_positions=16, epsilon=eps)


# name: press(module), made with the module's names: the registry's shapes
# (evaluation/registry.py) at the tiny config's scale.
PRESSES = {
    "merging_knorm": lambda m: m.MergingPress(m.KnormPress(0.5)),
    "merging_snapkv": lambda m: m.MergingPress(m.SnapKVPress(0.5, **SNAP)),
    "merging_expected_attention": lambda m: m.MergingPress(_ea(m, 1e-2)),
    "merging_fraction": lambda m: m.MergingPress(m.KnormPress(0.5), similarity_threshold=0.05,
                                                 merge_fraction=0.5),
    "lukv": lambda m: m.LUKVPress(_ea(m, 2e-2), compression_ratio=0.5, sink=4, window=1,
                                  budget_curves=CURVE),
    "lukv_knorm": lambda m: m.LUKVPress(m.KnormPress(0.3), compression_ratio=0.3, sink=2,
                                        window=4, budget_curves=CURVE),
    "simlayerkv": lambda m: m.SimLayerKVPress(lazy_threshold=LAZY, n_recent=16),
    "simlayerkv_all_lazy": lambda m: m.SimLayerKVPress(lazy_threshold=0.1, n_recent=16,
                                                       n_last=2),
    "finch": lambda m: m.FinchPress(0.5, window_size=12),
    "finch_chunks": lambda m: m.FinchPress(0.5, chunk_length=32, window_size=12,
                                           rerotate_keys=False, normalize_scores=False),
    "duo": lambda m: m.DuoAttentionPress(0.5, sink_size=4, recent_size=16,
                                         head_scores=HEAD_SCORES),
    "dms_kvzap": lambda m: m.DMSPress(m.KVzapPress(surrogate=_surrogate(m, "linear")),
                                      threshold=0.0, sliding_window_size=16),
    "dms_kvzap_mlp_compact": lambda m: m.DMSPress(m.KVzapPress(surrogate=_surrogate(m, "mlp")),
                                                  threshold=0.0, sliding_window_size=16,
                                                  compact=True),
    "dms_knorm": lambda m: m.DMSPress(m.KnormPress(), threshold=-3.86, sliding_window_size=16),
}
MERGING = [n for n in PRESSES if n.startswith("merging")]
# Merging's values: float32 sums whose order of accumulation differs from
# JAX's (index_add_ against a scatter-add).
MERGE_TOL = dict(atol=1e-5, rtol=1e-5)


def both(name):
    """(JAX press, port press) of one name."""
    from kvpress_tpu import presses as jp
    return PRESSES[name](jp), PRESSES[name](kt)

