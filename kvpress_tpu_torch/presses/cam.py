"""CAMPress: cache merging during decoding (reference cam_press.py,
https://openreview.net/forum?id=LCTmppB165; port of
``kvpress_tpu/presses/cam.py``).

A DecodingPress that also sums, per kv head, the attention of each call's
last query over the cache (``attn_sum``). On each compression the top
``target_size`` slots by the mean score over the kv heads are kept, in slot
order; each of the top ``compression_interval`` evicted slots (by that score)
that arrived within the interval is merged, with a Bernoulli draw of
probability its summed attention over the mean of its window's, into the
``merge_budget`` kept slots after it: its value over the window's size is
added to each. Then the kept slots move to the front.

JAX draws the Bernoulli uniforms from ``fold_in(fold_in(PRNGKey(seed),
layer), rng_step)``; the port draws them from a ``torch.Generator`` seeded
from (seed, layer, rng_step) (``draw_uniforms``), so the two take other
draws; the merge takes the uniforms as an argument, so a test can hand it
JAX's. Its scatter-add is ``index_put_(accumulate=True)`` in float32, whose
order of summation may differ from XLA's.

Under a tensor-parallel mesh a rank holds some of the kv heads
(``LayerCtx.shard``): it gathers the scores of every rank's heads before
their mean, so every rank keeps the same slots, and draws the uniforms at
every kv head and keeps its rows. The attention sum and the merge are per
kv head, and each kv head's query heads are on its rank.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.attention import window_attention_probs
from .base import all_heads, layer_generator, local_heads, order_desc
from .decoding import DecodingPress
from .snapkv import group_mean


@dataclasses.dataclass(frozen=True)
class CAMPress(DecodingPress):
    merge_budget: int = 32
    seed: int = 0

    # CAM sums attention over dense keys every step and merges values: it
    # runs on the dequantized buffer, which the runner requantizes after.
    supports_quantized_decode = False

    def __post_init__(self):
        super().__post_init__()
        if self.merge_budget <= 0:
            raise ValueError("merge_budget must be positive")

    def init_state(self, cfg, batch: int, seq_len: int, dtype=None, device=None) -> list:
        states = super().init_state(cfg, batch, seq_len, dtype, device)
        for state in states:
            state["attn_sum"] = torch.zeros((batch, cfg.num_kv_heads, seq_len),
                                            dtype=torch.float32, device=device)
            state["rng_step"] = 0
        return states

    def draw_uniforms(self, layer_idx: int, rng_step: int, shape, device) -> torch.Tensor:
        """The merge's uniforms in [0, 1), from (seed, layer, rng_step);
        ``shape`` (B, H_kv, k) at every kv head of the model, under a mesh
        too."""
        gen = layer_generator(self.seed, layer_idx, device, rng_step)
        return torch.rand(shape, generator=gen, device=device, dtype=torch.float32)

    def decode_compress(self, ctx, keys, values, length: int, mask, state):
        B, H, S, _ = keys.shape
        attn_sum = state["attn_sum"]
        if attn_sum.shape[-1] != S:
            # The buffer was resized after the prefill (which sums nothing):
            # the sum restarts at the buffer's size.
            attn_sum = torch.zeros((B, H, S), dtype=torch.float32, device=keys.device)
        probs = window_attention_probs(ctx.queries[:, :, -1:], keys, ctx.scale, length - 1)
        valid = torch.arange(S, device=keys.device) < length
        attn_sum = attn_sum + torch.where(valid, group_mean(probs[:, :, 0], H), 0.0)
        buf, buf_len, steps, hit, n_top, target = self._advance(ctx, state, length, S)
        do = hit and length > target
        rng_step = state["rng_step"] + 1
        if do:
            scores = all_heads(ctx.shard, self._score_buffer(ctx, buf, keys, values, length))
            scores = scores.mean(dim=1)                                               # (B, S)
            kept = torch.sort(order_desc(scores, n_top), dim=-1).values              # (B, n)
            every = H if ctx.shard is None else H * ctx.shard.size
            uniforms = self.draw_uniforms(ctx.layer_idx, rng_step,
                                          (B, every, min(self.compression_interval, S)),
                                          keys.device)[:, local_heads(ctx.shard, H)]
            values = self.merge(keys, values, length, steps, scores, kept, attn_sum, uniforms)
            keys, values = (torch.cat([x.gather(2, kept[:, None, :, None].expand(
                B, H, n_top, x.shape[-1])), x[:, :, n_top:]], dim=2) for x in (keys, values))
            attn_sum = torch.cat([attn_sum.gather(2, kept[:, None].expand(B, H, n_top)),
                                  attn_sum.new_zeros((B, H, S - n_top))], dim=2)
            length = n_top
            mask = torch.ones((B, H, S), dtype=torch.bool, device=keys.device)
        state = self._finish_state(buf, buf_len, steps, do, hit, False)
        state.update(attn_sum=attn_sum, rng_step=rng_step)
        return keys, values, length, mask, state

    def merge(self, keys, values, length: int, steps: int, scores, kept, attn_sum, uniforms):
        """The values after the Bernoulli merge: ``scores`` (B, S) the mean
        scores (NEG_INF past ``length``), ``kept`` (B, n) the kept slots in
        order, ``uniforms`` (B, H_kv, k) the draws of the k candidates."""
        B, H, S, D = values.shape
        n_top, W = kept.shape[1], self.merge_budget
        slot = torch.arange(S, device=values.device)
        is_kept = torch.zeros((B, S), dtype=torch.bool, device=values.device)
        is_kept.scatter_(1, kept, True)
        evicted = (slot < length) & ~is_kept
        # Candidates: the top k evicted scores (JAX's float32 jitter toward
        # later slots, a no-op at most magnitudes, kept as JAX adds it).
        cand_key = torch.where(evicted, scores, float("-inf")) + slot.to(torch.float32) * 1e-12
        cand = order_desc(cand_key, uniforms.shape[-1])                          # (B, k)
        k = cand.shape[1]
        cand_ok = (torch.arange(k, device=values.device) < steps) & evicted.gather(1, cand)
        # Each candidate's window: the merge_budget kept slots after it.
        starts = torch.searchsorted(kept, cand.contiguous(), right=True)         # (B, k)
        widx = starts[..., None] + torch.arange(W, device=values.device)         # (B, k, W)
        w_valid = widx < n_top
        targets = kept.gather(1, widx.clamp(max=n_top - 1).reshape(B, -1)).reshape(B, k, W)
        budget = w_valid.sum(-1)                                                  # (B, k)
        wa = attn_sum.gather(2, targets.reshape(B, 1, -1).expand(B, H, k * W)).reshape(
            B, H, k, W) * w_valid[:, None]
        mean_attn = wa.sum(-1) / budget.clamp(min=1)[:, None]
        prob = attn_sum.gather(2, cand[:, None].expand(B, H, k)) / mean_attn
        prob = torch.nan_to_num(prob, nan=0.0, posinf=1.0).clamp(0.0, 1.0) * cand_ok[:, None]
        bern = (uniforms < prob).to(torch.float32)
        scale = torch.where(budget[:, None] == 0, 0.0, bern / budget.clamp(min=1)[:, None])
        cand_v = values.gather(2, cand[:, None, :, None].expand(B, H, k, D)).to(torch.float32)
        contrib = (cand_v * scale[..., None])[:, :, :, None, :] * w_valid[:, None, :, :, None]
        b = torch.arange(B, device=values.device)[:, None, None, None]
        h = torch.arange(H, device=values.device)[None, :, None, None]
        merged = values.to(torch.float32, copy=True)
        merged.index_put_((b, h, targets[:, None].expand(B, H, k, W)), contrib,
                          accumulate=True)
        return merged.to(keys.dtype)
