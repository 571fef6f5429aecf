"""FastKVzipPress (reference fastkvzip_press.py, arXiv:2601.17668; port of
``kvpress_tpu/presses/fastkvzip.py``): learned per-layer gates (a
mini-attention against trained sink keys) estimate KVzip's importance in a
single prefill; the eviction is KVzip's global (or layerwise) bottom-k head
mask, set by the pipeline after the prefill (``apply_post_mask``).

The gates are a dict of arrays stacked over layers, read from the ``.npz``
that ``save_fastkvzip_gates`` writes (the JAX package's keys)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .base import BasePress, LayerCtx, layer_tensor
from .kvzip import KVzipPress


def gate_scores(gates: dict, layer_idx: int, hidden: torch.Tensor, eps: float = 1e-6):
    """One layer's gate forward (reference FastKVzipGate.forward, :54-73):
    hidden (1, S, E) -> scores (1, H_kv, S) float32."""
    h = hidden[0].float()                                      # (S, E)
    S = h.shape[0]
    g = lambda name: layer_tensor(gates[name], layer_idx, h.device)
    wq = g("wq")
    dg = gates["q_norm"].shape[-1]
    H = gates["k_base"].shape[1]
    G = (wq.shape[-1] // dg) // H

    def rms(x, w):
        return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w

    qg = rms((h @ wq + g("bq")).reshape(S, H, G, dg), g("q_norm"))
    kg = rms((h @ g("wk")).reshape(S, H, dg), g("k_norm"))
    d = float(np.sqrt(dg * 1.0))
    # logit[h, s, g] = <k_hs, q_hsg> / d + b_hg (reference :65)
    logit = torch.einsum("shd,shgd->shg", kg, qg) / d + g("b")[None, :, 0]
    logit = logit.permute(1, 0, 2)                             # (H, S, G)
    # base[h, s, k, g] = <k_base_hk, q_hsg> / d (reference :67)
    logit_base = torch.einsum("hkd,shgd->hskg", g("k_base")[:, 0], qg) / d
    # score = 1 / (1 + sum_k exp(base_k - logit)), mean over groups (:68-72)
    score = 1.0 / (1.0 + torch.exp(logit_base - logit[:, :, None, :]).sum(dim=2))
    return score.mean(dim=-1)[None]                            # (1, H, S)


def save_fastkvzip_gates(path: str, gates: dict) -> None:
    np.savez(path, **{k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                          else np.asarray(v)) for k, v in gates.items()})


def load_fastkvzip_gates(path: str, device: DeviceLike = "cuda") -> dict:
    device = resolve_device(device)
    d = np.load(path)
    return {k: torch.from_numpy(d[k]).to(device) for k in d.files}


def init_random_gates(generator: torch.Generator, cfg, output_dim: int = 16, sink: int = 16,
                      device: DeviceLike = "cuda") -> dict:
    """Random gates (the reference's test fixture builds fresh FastKVzipGate
    modules, tests/default_presses.py:58-71), drawn from ``generator`` (which
    must live on ``device``)."""
    device = resolve_device(device)
    E, H = cfg.hidden_size, cfg.num_kv_heads
    G = cfg.num_heads // H
    L = cfg.num_layers
    s = 0.02
    normal = lambda *shape: torch.randn(shape, generator=generator, device=device) * s
    return {"wq": normal(L, E, H * G * output_dim),
            "bq": torch.zeros((L, H * G * output_dim), device=device),
            "wk": normal(L, E, H * output_dim),
            "q_norm": torch.ones((L, output_dim), device=device),
            "k_norm": torch.ones((L, output_dim), device=device),
            "k_base": normal(L, H, 1, sink, output_dim),
            "b": torch.zeros((L, H, 1, G), device=device)}


def _gate_chunk_scores(arg, layer_idx, hidden, keys, values):
    """Per-token chunk scoring (prefill_chunked's collect protocol): a gate
    score reads only its token's hidden state. ``arg`` is the gates."""
    return gate_scores(arg, layer_idx, hidden)


@dataclasses.dataclass(frozen=True)
class FastKVzipPress(BasePress):
    compression_ratio: float = 0.0
    layerwise: bool = False
    n_sink: int = 4
    window_size: int = 4096
    window_ratio: float = 0.02
    gates: Optional[dict] = None
    # Head-wise compaction after the post-mask (cache.compact_masked).
    compact: bool = False

    post_mask = True            # the pipeline sets the cross-layer mask after the prefill
    compresses_prefill = True   # the scores are collected in the prefill
    writes_cache = False        # ... and the prefill's layers stay as they are
    chunk_score_fn = staticmethod(_gate_chunk_scores)

    # The gates are arrays: presses compare and hash by identity.
    __eq__ = object.__eq__
    __hash__ = object.__hash__

    @property
    def host_compact(self) -> bool:
        return self.compact

    @property
    def chunk_score_arg(self):
        return self.gates

    def init_state(self, cfg, batch, seq_len, dtype=None, device=None):
        """Per layer: {"scores": (B, H_kv, S) float32}, every layer's (a
        sliding layer's too: the eviction covers every layer, as in JAX)."""
        return [{"scores": torch.zeros((batch, cfg.num_kv_heads, seq_len), dtype=torch.float32,
                                       device=device)} for _ in range(cfg.num_layers)]

    def layer_compress(self, ctx: LayerCtx, keys, values, length, mask, state=None):
        if self.gates is None:
            raise ValueError("FastKVzip gates not loaded; pass gates=load_fastkvzip_gates(path)")
        S = ctx.hidden.shape[1]
        scores = gate_scores(self.gates, ctx.layer_idx, ctx.hidden)
        scores = torch.where(self._protected_slots(S, scores.device), 1.0, scores)
        return keys, values, length, mask, {"scores": scores}

    def _protected_slots(self, S: int, device=None) -> torch.Tensor:
        """The sink and recent window as an (S,) bool: the window is
        ``window_ratio`` of the context below 32,000 tokens, else
        ``window_size`` (reference fastkvzip_press.py:243-247)."""
        pos = torch.arange(S, device=device)
        window = int(S * self.window_ratio) if S < 32000 else self.window_size
        return (pos < self.n_sink) | (pos >= S - window)

    def protect_scores(self, scores: torch.Tensor, S: int) -> torch.Tensor:
        """The protected window over whole-context scores (L, B, H, S): the
        chunked prefill collects raw gate scores chunk by chunk and protects
        them once here, as ``layer_compress`` does over the whole context."""
        return torch.where(self._protected_slots(S, scores.device), 1.0, scores)

    def apply_post_mask(self, cache, state):
        """The cross-layer bottom-k keep-mask from the prefill's per-layer
        scores (reference compress_post, :255-280; KVzip's mechanics),
        ANDed into the cache's mask."""
        score_val = torch.stack([s["scores"] for s in state]).float().cpu().numpy()
        helper = KVzipPress(compression_ratio=self.compression_ratio,
                            layerwise=self.layerwise, n_sink=self.n_sink)
        keep = helper.head_mask_from_scores(score_val)          # (L, B, H, S_ctx)
        L, B, H, S_ctx = keep.shape
        keep_padded = np.ones((L, B, H, cache.max_size), dtype=bool)
        keep_padded[..., :S_ctx] = keep
        keep_t = torch.from_numpy(keep_padded).to(cache.keys.device)
        mask = keep_t if cache.mask is None else cache.mask & keep_t
        return dataclasses.replace(cache, mask=mask)
