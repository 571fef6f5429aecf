"""ExpectedAttentionStatsPress (reference expected_attention_with_stats.py;
port of ``kvpress_tpu/presses/expected_attention_stats.py``): ExpectedAttention
scoring with the query mean and covariance fitted offline on a calibration
set instead of the current prefill.

``collect_query_stats`` runs a collector press through ``Runner.prefill``
and sums each layer's Σq and Σqqᵀ over the samples on the host. Artifacts
are local ``.npz`` files.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .base import BasePress, LayerCtx, layer_tensor
from .expected_attention import ExpectedAttentionPress, _rotate_stats


@dataclasses.dataclass(frozen=True)
class ExpectedAttentionStatsPress(ExpectedAttentionPress):
    stats: Optional[dict] = None     # {"mu": (L, Hq, D), "cov": (L, Hq, D, D)}

    # The stats are arrays: presses compare and hash by identity.
    __eq__ = object.__eq__
    __hash__ = object.__hash__

    def query_statistics(self, ctx: LayerCtx):
        if self.stats is None:
            raise ValueError("stats not loaded; pass stats=load_query_stats(path)")
        dev = ctx.inv_freq.device
        mu = layer_tensor(self.stats["mu"], ctx.layer_idx, dev)[None]        # (1, Hq, D)
        cov = (layer_tensor(self.stats["cov"], ctx.layer_idx, dev)[None]
               if self.use_covariance else None)
        return _rotate_stats(ctx, mu, cov, ctx.seq_len, self.n_future_positions)


def save_query_stats(path: str, stats: dict) -> None:
    np.savez(path, mu=np.asarray(stats["mu"]), cov=np.asarray(stats["cov"]))


def load_query_stats(path: str) -> dict:
    d = np.load(path)
    return {"mu": d["mu"], "cov": d["cov"]}


@dataclasses.dataclass(frozen=True)
class _QueryStatsCollector(BasePress):
    """Each layer's Σq and Σqqᵀ of the pre-RoPE queries (sinks left out), as
    that layer's press state; the cache is left as it is."""

    n_sink: int = 4

    def init_state(self, cfg, batch: int, seq_len: int):
        return [None] * cfg.num_layers

    def layer_compress(self, ctx, keys, values, length, mask, state=None):
        q = ctx.queries_prerope[:, :, self.n_sink:].to(torch.float32)
        state = {"sum": q.sum(dim=(0, 2)), "sq": torch.einsum("bhsi,bhsj->hij", q, q),
                 "count": q.shape[0] * q.shape[2]}
        return keys, values, length, mask, state


@torch.no_grad()
def collect_query_stats(runner, params, samples, n_sink: int = 4) -> dict:
    """Fit the query mean and covariance of every layer over a list of (1, S)
    id tensors (the reference's calibration,
    expected_attention_with_stats.py:141-289). The prefills keep the
    parameters' dtype. Returns {"mu": (L, Hq, D), "cov": (L, Hq, D, D)},
    float64 numpy arrays."""
    cfg = runner.cfg
    L, Hq, D = cfg.num_layers, cfg.num_heads, cfg.head_dim
    total_sum, total_sq, total_n = np.zeros((L, Hq, D)), np.zeros((L, Hq, D, D)), 0
    collector = _QueryStatsCollector(n_sink=n_sink)
    for ids in samples:
        _, _, state = runner.prefill(params, ids, press=collector)
        total_sum += torch.stack([s["sum"] for s in state]).double().cpu().numpy()
        total_sq += torch.stack([s["sq"] for s in state]).double().cpu().numpy()
        total_n += state[0]["count"]
    mu = total_sum / total_n
    return {"mu": mu, "cov": total_sq / total_n - np.einsum("lhi,lhj->lhij", mu, mu)}
