"""DMSPress: threshold eviction behind a sliding protection window
(reference dms_press.py:69-130, arXiv:2506.05345, the dense-prefill variant;
port of the prefill side of ``kvpress_tpu/presses/dms.py``).

Eviction is head-wise and depends on the data (no fixed ratio), so it clears
keep-mask bits: a token's bit is cleared when it lies outside the protection
window of the last ``sliding_window_size`` slots with a score below
``threshold``. The press state of a layer is a ring of the window's scores
and the slot of the oldest one, for decode-time eviction, which comes with
ROADMAP Queue A item 12. ``compact=True`` has the pipeline move each head's
kept entries to the front of its buffer (``cache.compact_masked``)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .base import BasePress, ScorerPress
from .wrappers import _check_scorer, _refuse_bucket


@dataclasses.dataclass(frozen=True)
class DMSPress(BasePress):
    press: ScorerPress = None
    threshold: float = 0.0
    sliding_window_size: int = 128
    decoding: bool = False
    # Head-wise compaction of the prefill's mask (cache.compact_masked, by
    # the pipeline): prefill only, since the decode ring tracks absolute
    # slots, which compaction moves.
    compact: bool = False

    compresses_prefill = True

    def __post_init__(self):
        _check_scorer(self.press, "DMSPress")
        if self.compact and self.decoding:
            raise ValueError("DMSPress(compact=True) is prefill-only: decode-time threshold "
                             "eviction tracks absolute slot indices (first_slot), which "
                             "compaction remaps")
        if self.decoding:
            raise NotImplementedError("DMSPress(decoding=True): decode-time threshold eviction "
                                      "comes with ROADMAP Queue A item 12")

    @property
    def host_compact(self) -> bool:
        return self.compact

    @property
    def compresses_decode(self) -> bool:
        return self.decoding

    @property
    def compression_ratio(self):
        return 0.0   # measured (cache.masked_fraction), not set

    def init_state(self, cfg, batch: int, seq_len: int):
        """Per layer: {"scores": (B, H_kv, W) float32 ring, "count": buffered
        scores, "first_slot": the slot of the oldest}; the prefill refills
        each compressed layer's."""
        W = self.sliding_window_size
        return [{"scores": torch.zeros((batch, cfg.num_kv_heads, W), dtype=torch.float32),
                 "count": 0, "first_slot": 0} for _ in range(cfg.num_layers)]

    def _ring(self, scores: torch.Tensor, S: int) -> dict:
        """The state after a prefill of S slots: the last min(W, S) scores at
        the end of the ring."""
        W = self.sliding_window_size
        n_buf = min(W, S)
        buf = F.pad(scores[..., S - n_buf:S], (W - n_buf, 0))
        return {"scores": buf, "count": n_buf, "first_slot": S - n_buf}

    def _evict(self, scores: torch.Tensor, S: int, S_buf: int) -> torch.Tensor:
        """(..., S_buf) bool: slots before the protection window that score
        below the threshold (pads past S never)."""
        pos = torch.arange(S_buf, device=scores.device)
        if S_buf > S:
            scores = F.pad(scores, (0, S_buf - S), value=float("inf"))
        return (pos < S - self.sliding_window_size) & (scores < self.threshold)

    def layer_compress(self, ctx, keys, values, length, mask, state=None):
        """Score every slot; clear the bits of the below-threshold slots
        outside the protection window; keep the window's scores."""
        _refuse_bucket(self, ctx)
        S = keys.shape[2]
        scores = self.press.score(ctx, keys, values).to(torch.float32)
        if S > self.sliding_window_size:
            mask = mask & ~self._evict(scores, S, S)
        return keys, values, length, mask, self._ring(scores, S)

    def apply_chunked(self, scores: torch.Tensor, S: int, mask: torch.Tensor, sliding):
        """Chunked prefill's finish: ``scores`` (L, B, H, S) collected chunk
        by chunk through the wrapped press's ``chunk_score_fn`` (equal to its
        one-shot ``score`` for a per-token scorer); ``mask`` the cache's
        (L, B, H, S_buf) keep-mask; ``sliding`` (L,) the layers that are never
        compressed. Applies ``layer_compress``'s threshold and ring to every
        layer at once. Returns (mask, state: a list over layers)."""
        if S > self.sliding_window_size:
            evict = self._evict(scores, S, mask.shape[-1])
            evict &= ~torch.as_tensor(list(sliding), device=mask.device)[:, None, None, None]
            mask = mask & ~evict
        return mask, [self._ring(s, S) for s in scores]
