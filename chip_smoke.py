#!/usr/bin/env python3
"""Drive the PyTorch port (kvpress_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card

1. Device line: ``nvidia-smi --query-gpu=name,power.limit``; every time
   printed after it was taken on that card.
2. Build the six Hopper kernels (csrc/*.cu, one nvcc per source, in
   parallel; the two flash kernels, the column-sum library and the two
   decode libraries must spill nothing, and the wgmma kernels must hold
   wgmma instructions) and hold each against its plain PyTorch version on
   the card at the shapes the paths give it (GQA 32/8, head_dim 64), in
   bf16. The flash kernels are also held at the 32K prefill itself, at a
   question's shape over a half-live cache, at head_dim 128 and where their
   tile logic can go wrong, and at chunked prefill's shapes
   (``flash_attention_quant`` at int4: 8,192 queries over a 32K buffer after
   0, 8K, 16K and 24K slots; ``flash_attention``: the last 8,192-query chunk
   of the 32K flagship with no keep-mask and with every bit set, and of the
   8B-class body at head_dim 128 over 131,072 slots), the column-sum passes
   at 8K, a ragged 8,000 and the 32K prefill, the decode kernels at the
   pipeline's decode shapes (a half-live 33K buffer at B=1 and B=4; the
   8B-class body's int4 cache at head_dim 128, B=1 over 66K slots; path B's
   cache at B=4; the Duo split decode's retrieval and streaming buffers), and ``flash_attention``'s same-image or-mask at the
   Gemma-3-27B body's shape (GQA 32/16, head_dim 128, 8,192 queries holding
   4 images of 256 placeholders, with no window, a window of 1,024 and one
   of 128 that a span reaches behind; and over a 24,576-slot prior with an
   image in it); all are launched twice with equal bits. Each check must
   reject its planted faults (for the decode kernels: a skipped key run, one
   live step taken for dead, one key range or chunk dropped from the merge;
   for the or-mask: the key range not widened past the diagonal or behind
   the window, the gq >= 0 guard dropped). Then every head_dim-256
   instantiation at the Gemma-3-12B run's shapes (GQA 16/8): flash at the
   32K prefill, with the run's 4 images (no window and window 1,024), at a
   152-token question over a global layer's half-live 16K and a sliding
   layer's window, and where the 32-key tiles' logic can go wrong (every
   payload); flash_attention_quant at int8 at the questions and at int4 at
   a chunk's shape; decode at bf16, int8 and int4 and windowed; the column
   sums at 32K and a ragged 8,000; the head-wise decode over a synthetic
   path-B cache (B4, 16K, ragged), each with its planted faults. Then every
   head_dim-96 instantiation at the Phi-3-mini run's shapes (32 query heads,
   each its own kv head): flash at its 3,840-token prefill (masked, all live,
   and with the or-mask over 2 images), at 32K, at a 1,024-token chunk over
   3,072 slots (bf16, int8, int4) and at the 152-token question over a
   half-live cache (bf16, int8), the tile logic at every payload; decode at
   every payload over 4,096 half-live slots and int4 at B4 over 16K; the
   column sums at 8K and 32K; the head-wise decode (B4, 16K, ragged); each
   with its planted faults and two confined to channels 64-95.
3. The paths at full width, through ``KVPressPipeline`` on the 1B-class
   flagship shape (16 layers, seeded random weights), a 32,768-token context
   and two questions (one longer than 128 tokens):
   - ``KnormPress(0.5)`` with a bf16 KV cache, then int8 KV, then int4 KV
     with int8 weights;
   - path A, ``ObservedAttentionPress(0.5)``: the flash prefill gives the row
     LSE and the column-sum kernel scores from it;
   - path B, ``AdaKVPress(ObservedAttentionPress(0.5), compact=True)`` on a
     runner with ``headwise_kernel=True, decode_kernel=False``: both
     column-sum passes in prefill, then decode over per-head prefixes;
   - chunked prefill, ``context_chunk=8192``: Knorm with int8 KV (every
     chunk through ``flash_attention_quant``), SnapKV with int4 KV and int4
     weights (the dense route: ``flash_attention`` on each layer's
     dequantized buffer), compacting ``AdaKVPress(KnormPress(0.5))`` on the
     head-wise runner.
   Then the presses that score without a kernel through the pipeline at
   the same shape (``scorer_presses_run``): ExpectedAttention, its stats
   variant (statistics from ``collect_query_stats`` on the card), KeyDiff,
   LagKV, CUR, CAP, QFilter (a seeded filter bank), Compactor and KVzap (a
   seeded MLP surrogate), ExpectedAttention over int8 KV and
   AdaKV(ExpectedAttention) compact on the head-wise runner, each with one
   layer's scoring time; and
   bucketed prefill (``bucketed_check``): a 30,000-token context with
   ``context_bucket=4096`` under Knorm and ExpectedAttention, held against
   the exact prefill (equal lengths, logits within F32_RATIO times what bf16
   rounding alone moves). Then the wrapper presses at the same shape
   (``wrapper_presses_run``, the registry's shapes): CriticalKV over SnapKV
   and ExpectedAttention, CriticalAdaKV over ExpectedAttention (mask only)
   and SnapKV (compact, head-wise runner), KeyRerotation, Chunk (1,024),
   ChunkKV (20), Block (128), ThinK, SnapKV then ThinK, PerLayerCompression
   (ratios 0.25-0.75); chunked by 8,192 KeyRerotation and SnapKV-then-ThinK
   with int8 KV and CriticalAdaKV(Knorm) compact; each with its layer
   lengths (the keep-mask's count, ThinK's zero channels), one layer's
   ``layer_compress`` time, and after KeyRerotation the questions from the
   compressed length (``rerotation_check``); bucketed CriticalKV(SnapKV)
   against exact, and KeyRerotation refused under a bucket. Then the mask,
   merge and head-split presses at the same shape (``mask_presses_run``):
   Merging over Knorm, SnapKV and ExpectedAttention (the Knorm run's kept
   keys bit-equal to Knorm's), LUKV over a seeded budget curve read back from
   a ``.npy`` (the per-head counts), SimLayerKV with its threshold between
   the layers' lazy scores, Finch's query-aware form with its delimiter (the
   decode from the compressed length), Duo (its masked fraction's closed form;
   its split-cache decode against the masked decode, token for token),
   DMS(KVzap) mask only (``compact_masked`` over a grown cache) and compact
   on the head-wise runner; chunked by 8,192 Duo and DMS over int8 KV and
   SimLayerKV and Finch over bf16, each held against its one-shot run; the
   refusals (Merging chunked, each press under a bucket). Then the
   decode-time presses at the same shape with the 152-token question and 32
   new tokens (``decode_presses_run``): DecodingPress(Knorm, interval 16,
   target 16,384) over bf16, int8 and int4 KV (compressions after calls 16
   and 32; the kept payload and scales a gather of the pre-compression
   payload) and chunked by 8,192, CompressionRatioDecodingPress(0.5),
   PrefillDecodingPress(SnapKV(0.5), DecodingPress(Knorm, 8,192)),
   CAMPress(Knorm) over bf16 and int8 KV (the dense route), DMS(KVzap) with
   ``decoding=True`` over int8 KV one-shot and chunked (the masked fraction
   grows, every decode launch masked), the Gemma-3-12B body cut to 6 layers
   (the sliding layers whole), each with the device breakdown of a
   compressing and a plain step; the refusals (two questions,
   ``compact`` with ``decoding``, PrefillDecodingPress chunked).
   Then ``Runner.prefill_chunked`` at 32K over int4 KV on its fused route
   (``flash_attention_quant`` at 4 bits) held against its dense route
   (``fused_int4_check``; also the peak memory of chunked and one-shot
   prefill), and a Llama-3.1-8B-class body (32 layers, random int4 weights)
   through the pipeline with int4 KV, Knorm and a 131,072-token context in
   chunks of 8,192 (``long_context_run``). Then the other architectures at
   full width: the Qwen3-8B body (36 layers, bf16, q/k-norm; ``qwen3_run``)
   and the Gemma-3-27B body (int4, cut to 31 of its 62 layers, sliding
   layers with window 1,024, a SigLIP tower; ``gemma3_run``) through the
   pipeline at 32K,
   Knorm and bf16 KV (Qwen3 also ExpectedAttention), Gemma3 with 4 images
   one-shot and with ``context_chunk=8192``: the or-mask on every layer's prefill, the window
   on the sliding layers' flash and decode launches, the sliding layers
   uncompressed; each also held against the dense path (Qwen3 at depth 1
   and 36, Gemma3 cut to 6 layers at 4,096 tokens with two images), and
   Qwen3's decode rate and idle share. Then the Gemma-3-12B body (48
   layers, bf16, head_dim 256; ``gemma3_12b_run``) at 32K: Knorm with the
   4 images one-shot and chunked, ObservedAttention and
   AdaKV(ObservedAttention) without images, Knorm with int8 KV, every
   launch on a head_dim-256 instantiation; cut to 6 layers against the
   dense path at depth 1 and 6 with two images. Then the Phi-3-mini-4k body
   (32 layers, bf16, head_dim 96, 32/32 heads; ``phi3_run``) with a
   3,840-token context: Knorm with bf16, int8 and int4 KV (int4 weights),
   with int8 KV chunked by 1,024, and AdaKV(Knorm) compact on the head-wise
   runner, every launch on a head_dim-96 instantiation of the payload its
   options ask for; its prefill breakdown, decode rate and idle share; held
   against the dense path at depth 1 and 32. Every prefill's wall time and
   peak memory are printed. The launch counts are set to 0 before each run
   and read after it, and every kernel of a path must have been launched in
   it. A 2,048-token run of each kernel path is also held against the dense
   path on the same weights, stage by stage, at depth 1 and 16
   (``reference_check``: Knorm, paths A and B, ExpectedAttention,
   Compactor, KeyRerotation, CriticalAdaKV(SnapKV) compact, Duo and
   DMS(KVzap) compact; chunked prefill in chunks of 512 too), and each
   decode-time press (Decoding, DMS(KVzap) decoding, CAM) stage by stage
   through 16 decode steps past its compressions
   (``decode_reference_check``).
4. Timings: prefill at 32K under each press and chunked (int8 KV; int4 KV
   on both routes), and decode at batch 4 x 32K
   context, ratio 0.5 (Knorm: int4 KV + int8 weights, decode kernel on and
   off; path B: bf16 KV at batch 1 and 4, head-wise kernel against the dense
   route and the decode kernel over the same cache), on a synchronized host
   clock, medians, with profiler breakdowns (device busy time, idle share,
   largest kernels; no sort kernel may run in the decode-kernel step). Per
   kernel (phase 2): its device time from the profiler beside its bound,
   its plain version's time and, where one PyTorch call computes the same,
   that call's: ``scaled_dot_product_attention`` for the attention kernels,
   the row LSE of ``aten._scaled_dot_product_flash_attention`` for
   ``observed_lse`` (CUDA events).

The last two lines are the ``kernels`` JSON line and the result line
``{"ok": true, "device": {...}}``. Any failure exits non-zero with no result
line; so does a machine without a CUDA device.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import inspect
import json
import logging
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores
CONTEXT_TOKENS = 32768
CHUNK_TOKENS = 8192          # context_chunk of the chunked runs
# The Gemma-3-27B run's 4 images of 256 placeholders in its 32K context, at
# unaligned starts, two of them across a chunk edge.
GEMMA3_IMAGE_STARTS = (CONTEXT_TOKENS // 11, CHUNK_TOKENS - 256 // 3, CONTEXT_TOKENS * 6 // 11,
                       3 * CHUNK_TOKENS - 256 // 4)
LONG_CONTEXT_TOKENS = 131072   # the 8B-class body's context
# The Phi-3-mini-4k runs: a context, two questions (152 and 4 tokens) and 32
# new tokens within its 4,096 positions; the chunked run's chunk.
PHI3_CONTEXT_TOKENS = 3840
PHI3_CHUNK_TOKENS = 1024
DECODE_BATCH = 4
# Phase 2: a kernel passes when its worst output row (one query head at one
# position: D values) differs from the plain version's by at most ROW_LIMIT
# of that row's largest value. Rows are held to their own scale: a row over
# 16K keys is ~50x smaller than a row over 3. Every kernel reads about one
# bf16 ulp (2^-8 to 2^-7) and one skipped 256-key step reads 0.2 or more
# (PERF.md).
ROW_LIMIT = 2e-2
# The column-sum kernels give one number per slot, held to its own size: a
# row's logsumexp may differ by LSE_LIMIT (an absolute difference of a
# logarithm: the relative error of the row's sum), a column's sum by
# SUM_LIMIT of itself. Both are set from the readings: the kernels read about
# 1e-5 (the products are exact in float32; the sums are taken in another
# order and the kernel's exp is the fast one), one skipped 64-row tile 0.1
# or more, a diagonal tile or stage without its causal test more still
# (PERF.md).
LSE_LIMIT = 1e-3
SUM_LIMIT = 2e-3
LN2 = 0.6931471805599453


def llama31_8b_config(num_layers: int = 32):
    """Llama-3.1-8B body (GQA 32/8, head_dim 128, 4096 hidden; vocabulary
    trimmed to 32,768): the copy of ``tools/bench_8b.py:llama31_8b_config``
    that the port runs."""
    from kvpress_tpu_torch.config import ModelConfig

    return ModelConfig(vocab_size=32768, hidden_size=4096, intermediate_size=14336,
                       num_layers=num_layers, num_heads=32, num_kv_heads=8,
                       head_dim=128, rope_theta=500000.0)


def flagship_config(num_layers: int = 16):
    """Llama-3.2-1B-class architecture (GQA 32/8, 2048 hidden): the copy of
    ``__graft_entry__.flagship_config`` that the port runs."""
    from kvpress_tpu_torch.config import ModelConfig

    return ModelConfig(vocab_size=32768, hidden_size=2048, intermediate_size=8192,
                       num_layers=num_layers, num_heads=32, num_kv_heads=8,
                       head_dim=64, rope_theta=500000.0)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_kernels(fn, iters: int):
    """Run ``fn()`` ``iters`` times under torch.profiler. Returns (wall ms
    per call, {kernel name: (device ms per call, launches per call)}). The
    trace's kernel times are device-side: they leave out the host gaps and
    the wrapper's small PyTorch ops that CUDA events around ``fn`` include."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A trace now and then comes back without a single device event (seen once
    # in several hundred traces on the H100): that is the profiler's
    # failure, not a reading, and the trace is taken again.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
        kernels = {}
        for ev in prof.key_averages():
            dev = getattr(ev, "self_device_time_total", None)
            if dev is None:
                dev = getattr(ev, "self_cuda_time_total", 0.0)
            if dev > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
                kernels[ev.key] = (dev / 1e3 / iters, ev.count / iters)
        if kernels:
            break
    return wall, kernels


def kernel_ms(fn, symbol: str, iters: int) -> float:
    """Device milliseconds per call of the kernels whose name holds
    ``symbol`` (from the profiler trace). Each call launches each of them
    once (the kernel, and the merge of a split launch): a trace that holds
    another count lost or doubled events and is taken again (up to five
    times: a 32K or-mask launch once lost one of three in three traces in a
    row on the H100)."""
    found = {}
    for _ in range(5):
        _, kernels = device_kernels(fn, iters)
        found = {name: v for name, v in kernels.items() if symbol in name}
        if found and all(n == 1 for _, n in found.values()):
            return sum(ms for ms, _ in found.values())
    raise AssertionError(f"{symbol}: no profiler trace with one launch of each such kernel a "
                         f"call, launches a call { {k: n for k, (_, n) in found.items()} }")


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def visible_pairs(mask, prior: int, T: int, length: int | None = None,
                  window: int | None = None) -> int:
    """Sum over (batch, kv head, query row) of the keys that row may attend:
    causal (slot <= prior + t), inside ``window`` (slot > prior + t -
    window), below ``length``, keep-bit set."""
    import torch

    S = mask.shape[-1]
    live = mask.clone()
    if length is not None:
        live[..., length:] = False
    cum = torch.cumsum(live.to(torch.int64), dim=-1)              # (B, Hkv, S)
    slots = (prior + torch.arange(T, device=mask.device)).clamp(max=S - 1)
    seen = cum[..., slots]
    if window:
        low = slots - window                 # the last slot behind each row's window
        seen = seen - torch.where(low >= 0, cum[..., low.clamp(min=0)], 0)
    return int(seen.sum())


# --------------------------------------------------------------------- #
# Phase 2: each kernel against its plain version at the main-path shapes


def kernel_checks(kt, torch, report):
    from kvpress_tpu_torch.cache import dequantize_kv, quantize_kv
    from kvpress_tpu_torch.ops import decode as dec
    from kvpress_tpu_torch.ops.attention import (NEG_INF, attention_bias, gqa_attention,
                                                 quant_gqa_attention)
    from kvpress_tpu_torch.ops import decode_headwise as hw
    from kvpress_tpu_torch.ops import flash as fl
    from kvpress_tpu_torch.ops import observed_colsum as oc

    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    Hq, Hkv, D = 32, 8, 64
    G = Hq // Hkv
    scale = D ** -0.5
    results, failures = {}, []

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)

    def keep_mask(B, S, p=0.2, hkv=Hkv):
        m = torch.rand((B, hkv, S), generator=gen, device=dev) > p
        m[:, :, :8] = True
        return m

    def sdpa_ms(q, k, v, allowed, iters):
        G_ = q.shape[1] // k.shape[1]
        kr, vr = k.repeat_interleave(G_, 1), v.repeat_interleave(G_, 1)
        return cuda_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=allowed,
                                                              scale=q.shape[-1] ** -0.5), iters)

    def allowed_mask(mask, B, prior, T, S, length=None, window=None, hkv=Hkv, g=G):
        q_slot = prior + torch.arange(T, device=dev)[:, None]
        slot = torch.arange(S, device=dev)[None, :]
        ok = slot <= q_slot
        if window:
            ok &= slot > q_slot - window
        if length is not None:
            ok &= slot < length
        if mask is None:
            mask = torch.ones((B, hkv, S), dtype=torch.bool, device=dev)
        return ok[None, None] & mask.repeat_interleave(g, 1)[:, :, None, :]

    def fault_mask(mask, B, S, lo, n=256, hkv=Hkv):
        """The keep-mask with the keys of slots lo .. lo + n - 1 (all visible
        to every query row) cleared: what a kernel that skipped them would
        compute."""
        m = torch.ones((B, hkv, S), dtype=torch.bool, device=dev) if mask is None else mask.clone()
        m[:, :, lo:lo + n] = False
        return m

    def without_keys(q, k, lo, hi):
        """(q, k) with slots lo..hi-1 cut out of both: rows from hi on then
        see every earlier key but those."""
        return (torch.cat([q[:, :, :lo], q[:, :, hi:]], dim=2).contiguous(),
                torch.cat([k[:, :, :lo], k[:, :, hi:]], dim=2).contiguous())

    def upper_faults(plain_of_q, q, ref=None):
        """Head_dim 96 lays a row out as head_dim 128's two panels, the second
        half used (flash_sm90.cuh, observed_colsum.cu), and gives a decode
        lane 24 K and 12 V channels (decode_sm90.cuh). Two faults confined to
        channels 64-95: those channels left out of the logits (the plain
        version over Q with them zeroed), and, for a kernel with an output of
        D channels, those channels of the output left unwritten (0)."""
        q_low = q.clone()
        q_low[..., 64:] = 0
        faults = {"channels 64-95 left out of the logits": plain_of_q(q_low)}
        if ref is not None:
            cut = ref.clone()
            cut[..., 64:] = 0
            faults["output channels 64-95 not written"] = cut
        return faults

    def above_diagonal(q, k, run, softcap, axis, lse=None):
        """What a kernel that drops the causal test inside each aligned run of
        ``run`` keys adds: for a row i, the keys j > i of its run. "rows": the
        log of their sum of exp(s_ij) per query row; "columns": their sum of
        exp(s_ij - lse_i) per key (rows whose LSE is -inf add nothing)."""
        B_, Hq_, S_, D_ = q.shape
        Hkv_ = k.shape[1]
        pad = -S_ % run
        qp, kp = (F.pad(t, (0, 0, 0, pad)).float() for t in (q, k))
        nb = (S_ + pad) // run
        qb = qp.reshape(B_, Hkv_, Hq_ // Hkv_, nb, run, D_)
        kb = kp.reshape(B_, Hkv_, nb, run, D_)
        s_ = torch.einsum("bhgnid,bhnjd->bhgnij", qb, kb) * D_ ** -0.5
        if softcap is not None:
            s_ = torch.tanh(s_ / softcap) * softcap
        pos = torch.arange(S_ + pad, device=dev).reshape(nb, run)
        upper = (pos[:, None, :] > pos[:, :, None]) & (pos[:, None, :] < S_)   # (n, i, j): j > i
        if axis == "rows":
            s_ = s_.masked_fill(~upper, float("-inf"))
            return torch.logsumexp(s_, -1).reshape(B_, Hq_, S_ + pad)[..., :S_]
        l = F.pad(torch.where(torch.isinf(lse), float("inf"), lse), (0, pad), value=float("inf"))
        l = l.reshape(B_, Hkv_, Hq_ // Hkv_, nb, run, 1)
        e = torch.where(upper, torch.exp(s_ - l), 0.0)
        return e.sum(-2).reshape(B_, Hq_, S_ + pad)[..., :S_]

    def compare(got, ref):
        """(max |got - ref|, the worst row's max |got - ref| / max |ref|)."""
        got, ref = got.float(), ref.float()
        if not torch.isfinite(got).all():
            raise AssertionError("non-finite kernel output")
        diff = (got - ref).abs()
        rows = diff.amax(-1) / ref.abs().amax(-1).clamp_min(1e-3)
        return diff.max().item(), rows.max().item()

    def compare_lse(got, ref):
        """(max |got - ref|, the same): a logsumexp is held absolutely."""
        if not torch.isfinite(got).all():
            raise AssertionError("non-finite kernel output")
        err = (got - ref).abs().max().item()
        return err, err

    def compare_sums(got, ref):
        """(max |got - ref|, the worst entry's |got - ref| / |ref|)."""
        if not torch.isfinite(got).all():
            raise AssertionError("non-finite kernel output")
        diff = (got - ref).abs()
        return diff.max().item(), (diff / ref.abs().clamp_min(1e-12)).max().item()

    def record(name, variant, got, ref, faults, ms, plain, nb, flops, lib, limit=ROW_LIMIT,
               reading=compare, **extra):
        """Hold ``got`` against ``ref`` at the kernel's tolerance, and check
        that the tolerance rejects each of ``faults`` ({what was skipped: the
        plain version's result without it}). ``extra`` readings are kept
        beside the row (tools/compare_trees.py reads them)."""
        err, row = reading(got, ref)
        fault_rows = {what: reading(f, ref)[1] for what, f in faults.items()}
        b, by = bound_ms(nb, flops)
        results.setdefault(name, {})[variant] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
            **extra)
        report(f"  {name}[{variant}]: max_abs_err {err:.3e}, worst row {row:.3e} (limit {limit}; "
               + "; ".join(f"{what}: {x:.3e}" for what, x in fault_rows.items())
               + f"), kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms ({by}), "
               + ("no library call" if lib is None else f"library {lib:.4f} ms"))
        if not row <= limit:
            failures.append(f"{name}[{variant}] disagrees with its plain version: "
                            f"worst row {row:.3e} > {limit}")
        failures.extend(f"{name}[{variant}]: the limit passes {what} ({x:.3e} <= {limit})"
                        for what, x in fault_rows.items() if not x > limit)

    def timed(fn):
        """(fn(), its milliseconds on the card: one run, CUDA events)."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def plain_rows(plain, q, kv, prior, mask, lo, hi, chunk, **kw):
        """(out, lse) of query rows lo..hi-1 of a flash kernel's plain version,
        ``chunk`` rows at a time (the plain version holds a chunk's whole logit
        matrix), each over the slots its rows can see. ``kv`` are the
        arguments with the slot axis at dim 2."""
        outs, lses = [], []
        for r0 in range(lo, hi, chunk):
            r1 = min(hi, r0 + chunk)
            end = prior + r1
            o, l = plain(q[:, :, r0:r1], *(t[:, :, :end] for t in kv), prior + r0,
                         None if mask is None else mask[:, :, :end], return_lse=True, **kw)
            outs.append(o)
            lses.append(l)
        return torch.cat(outs, 2), torch.cat(lses, 2)

    def flash_case(name, variant, bits, q, kv, prior, mask, *, chunk, iters, lib_mask=True,
                   logic_faults=False, **kw):
        """One shape of a flash kernel: launched twice (equal bits), output and
        LSE against the plain version, the planted faults, and the times."""
        B, _, T, D_ = q.shape
        S = kv[0].shape[2]
        G_ = q.shape[1] // kv[0].shape[1]
        kw = dict(sm_scale=D_ ** -0.5, **kw)
        if bits is None:
            kernel, plain = fl.flash_attention, fl.flash_attention_plain
        else:
            kernel, plain, kw["bits"] = fl.flash_attention_quant, fl.flash_attention_quant_plain, bits
        call = lambda: kernel(q, *kv, prior, mask, return_lse=True, **kw)
        got, lse = call()
        torch.cuda.synchronize()
        again, lse_again = call()
        torch.cuda.synchronize()
        label = f"{name}[{variant}]"
        if not (torch.equal(got, again) and torch.equal(lse, lse_again)):
            failures.append(f"{label}: two launches differ")
        (ref, ref_lse), plain_ms = timed(
            lambda: plain_rows(plain, q, kv, prior, mask, 0, T, chunk, **kw))
        if chunk >= T:      # small enough to repeat: a median, as for the other kernels
            plain_ms = cuda_ms(lambda: plain(q, *kv, prior, mask, **kw), 3, 1)
        lse_err = (lse - ref_lse).abs().max().item()
        if not lse_err <= LSE_LIMIT:
            failures.append(f"{label}: row logsumexp differs by {lse_err:.3e} > {LSE_LIMIT}")

        def with_rows(lo, hi, rows):
            f = ref.clone()
            f[:, :, lo:hi] = rows
            return f

        # Fault: a 256-key step that every later row sees (with a window:
        # inside the windows of the rows read), skipped; read on the rows right
        # behind it, which it moves most. With a window, also the window not
        # applied.
        Hkv_, window = kv[0].shape[1], kw.get("window")
        if window and prior:    # a question over a windowed cache
            assert prior >= window >= 512 and T <= window // 4
            hole = prior - window // 2
        elif window:            # a windowed prefill: rows hole + 256 .. + 511 see the hole
            assert window >= 768 and T >= 2 * window
            hole = T // 2
        else:
            hole = prior // 2 if prior else min(512, T // 4)
        lo = max(0, hole + 256 - prior)
        hi = min(T, lo + 512)
        faults = {"one skipped key step": with_rows(lo, hi, plain_rows(
            plain, q, kv, prior, fault_mask(mask, B, S, hole, hkv=Hkv_), lo, hi, chunk, **kw)[0])}
        if window:
            faults["the window not applied"] = plain_rows(plain, q, kv, prior, mask, 0, T, chunk,
                                                          **{**kw, "window": None})[0]
        live = torch.ones((B, Hkv_, S), dtype=torch.bool, device=dev)
        if logic_faults:
            # Faults of the tile logic. A diagonal tile taken for an interior
            # one: the q-tile at row T/2 sees the whole key tile it sits in.
            # A clear keep-bit in an otherwise live tile taken for set.
            bq, nk = 128 // G_, fl.key_tile(D_)
            r0 = T // 2 // bq * bq
            end = ((prior + r0) // nk + 1) * nk
            assert end <= S
            m = mask[:, :, :end]
            bias = attention_bias(prior + r0, bq, end, head_mask=m, device=dev)
            bias[..., end - nk:] = torch.where(m[:, :, None, end - nk:], 0.0, NEG_INF)
            qr, kr = q[:, :, r0:r0 + bq], [t[:, :, :end] for t in kv]
            if bits is None:
                rows = gqa_attention(qr, *kr, bias, kw["sm_scale"])[0]
            else:
                rows = quant_gqa_attention(qr, *kr, bias, kw["sm_scale"], bits)
            faults["a diagonal tile taken for an interior one"] = with_rows(r0, r0 + bq, rows)
            faults["a clear keep-bit taken for set"] = plain_rows(
                plain, q, kv, prior, torch.ones_like(mask), 0, T, chunk, **kw)[0]
        if D_ == 96:
            faults.update(upper_faults(
                lambda q_: plain_rows(plain, q_, kv, prior, mask, 0, T, chunk, **kw)[0], q, ref))
        ms = kernel_ms(call, "flash_sm90", iters)
        lib = None
        if lib_mask:
            kd, vd = kv[:2] if bits is None else (
                dequantize_kv(kv[0], kv[2], bits, torch.bfloat16),
                dequantize_kv(kv[1], kv[3], bits, torch.bfloat16))
            if lib_mask == "window":    # all-live mask: one causal windowed mask for all heads
                allowed = allowed_mask(None, B, prior, T, S, window=window, hkv=1, g=1)
                kr, vr = kd.repeat_interleave(G_, 1), vd.repeat_interleave(G_, 1)
                lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, kr, vr, attn_mask=allowed, scale=kw["sm_scale"]), 3)
                del allowed, kr, vr
            elif lib_mask == "causal":  # all-live mask, no prior: the causal call is the same
                kr, vr = kd.repeat_interleave(G_, 1), vd.repeat_interleave(G_, 1)
                lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, kr, vr, is_causal=True, scale=kw["sm_scale"]), 3)
            elif lib_mask == "lower_right":
                # No keep-mask, a prior: the causal mask aligned to the last of
                # the slots the rows can see (prior + T) is the same.
                from torch.nn.attention.bias import causal_lower_right

                end = prior + T
                kr = kd[:, :, :end].repeat_interleave(G_, 1)
                vr = vd[:, :, :end].repeat_interleave(G_, 1)
                lower_right = causal_lower_right(T, end)
                lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, kr, vr, attn_mask=lower_right, scale=kw["sm_scale"]), 3)
            else:
                kr, vr = kd.repeat_interleave(G_, 1), vd.repeat_interleave(G_, 1)
                allowed = allowed_mask(mask, B, prior, T, S, window=window, hkv=Hkv_, g=G_)
                lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, kr, vr, attn_mask=allowed, scale=kw["sm_scale"]), 5)
        flops = 4 * D_ * G_ * visible_pairs(live if mask is None else mask, prior, T,
                                            window=window)
        moved = nbytes(q, *kv, mask, got)
        if window:      # K/V (payload, scales) of the slots some row's window holds
            seen = min(S, prior + T) - max(0, prior - window + 1)
            moved -= nbytes(*kv) * (S - seen) // S
        record(name, variant, got, ref, faults, ms, plain_ms, moved, flops, lib)
        report(f"    launched twice with equal bits; row logsumexp max_abs_err {lse_err:.3e} "
               f"(limit {LSE_LIMIT}); key ranges a q-tile: "
               f"{fl.flash_splits(B, kv[0].shape[1], G_, T, S, D_, prior, kw.get('window'))}")

    def quantized(kd, vd, bits):
        (kq, ks), (vq, vs) = quantize_kv(kd, bits), quantize_kv(vd, bits)
        return [kq, vq, ks, vs]

    # flash_attention: prefill-shaped, B=1, T=S=8192, random keep-mask (every
    # tile takes the keep-bit test).
    B, T = 1, 8192
    q, k, v = rnd(B, Hq, T, D), rnd(B, Hkv, T, D), rnd(B, Hkv, T, D)
    flash_case("flash_attention", "bf16 B1 T8192 S8192 masked", None, q, [k, v], 0,
               keep_mask(B, T), chunk=T, iters=10)
    del q, k, v
    torch.cuda.empty_cache()

    # Both flash kernels at the 32K prefill itself (all-live mask: only the
    # diagonal tiles take a test), at a question's shape (152 new tokens over
    # 16K slots of which half are live, as after a press without compaction),
    # and where the tile logic can go wrong (every keep-bit set but one).
    T = CONTEXT_TOKENS
    q, k, v = rnd(B, Hq, T, D), rnd(B, Hkv, T, D), rnd(B, Hkv, T, D)
    live = torch.ones((B, Hkv, T), dtype=torch.bool, device=dev)
    flash_case("flash_attention", "bf16 B1 T32768 S32768 all-live", None, q, [k, v], 0, live,
               chunk=1024, iters=3, lib_mask="causal")
    flash_case("flash_attention_quant", "int8 B1 T32768 S32768 all-live", 8, q,
               quantized(k, v, 8), 0, live, chunk=1024, iters=3, lib_mask="causal")
    del q, k, v, live
    torch.cuda.empty_cache()

    T, prior = 152, 16384
    S = prior + T
    q, kd, vd = rnd(B, Hq, T, D), rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    half = keep_mask(B, S, p=0.5)
    flash_case("flash_attention", f"bf16 B1 T{T} prior{prior} half live", None, q, [kd, vd],
               prior, half, chunk=T, iters=20)
    flash_case("flash_attention_quant", f"int8 B1 T{T} prior{prior} half live", 8, q,
               quantized(kd, vd, 8), prior, half, chunk=T, iters=20)

    T = 1024
    q, kd, vd = rnd(B, Hq, T, D), rnd(B, Hkv, T, D), rnd(B, Hkv, T, D)
    one_clear = torch.ones((B, Hkv, T), dtype=torch.bool, device=dev)
    one_clear[:, :, 5] = False
    flash_case("flash_attention", f"bf16 B1 T{T} S{T} one clear bit", None, q, [kd, vd], 0,
               one_clear, chunk=T, iters=10, logic_faults=True)
    for bits in (8, 4):
        flash_case("flash_attention_quant", f"int{bits} B1 T{T} S{T} one clear bit", bits, q,
                   quantized(kd, vd, bits), 0, one_clear, chunk=T, iters=10, logic_faults=True)

    # head_dim 128, G = 4 (the other instantiation: 64-key tiles, two panels).
    T, D2 = 4096, 128
    q, kd, vd = rnd(B, Hq, T, D2), rnd(B, Hkv, T, D2), rnd(B, Hkv, T, D2)
    mask = keep_mask(B, T)
    flash_case("flash_attention", f"bf16 B1 T{T} S{T} D128 masked", None, q, [kd, vd], 0, mask,
               chunk=1024, iters=5)
    flash_case("flash_attention_quant", f"int8 B1 T{T} S{T} D128 masked", 8, q,
               quantized(kd, vd, 8), 0, mask, chunk=1024, iters=5)
    del q, kd, vd
    torch.cuda.empty_cache()

    # The Qwen3-8B run's one-shot prefill (GQA 32/8, head_dim 128) at 32K,
    # all-live; then a Gemma-3-27B sliding layer's question forward (GQA
    # 32/16): 152 new tokens over the 32,768 slots it keeps, window 1,024.
    T = CONTEXT_TOKENS
    q, kd, vd = rnd(B, Hq, T, D2), rnd(B, Hkv, T, D2), rnd(B, Hkv, T, D2)
    live = torch.ones((B, Hkv, T), dtype=torch.bool, device=dev)
    flash_case("flash_attention", f"bf16 B1 T{T} S{T} D128 all-live", None, q, [kd, vd], 0,
               live, chunk=512, iters=3, lib_mask="causal")
    del q, kd, vd, live
    torch.cuda.empty_cache()
    T, prior = 152, CONTEXT_TOKENS
    S = prior + T
    q, kd, vd = rnd(B, 32, T, D2), rnd(B, 16, S, D2), rnd(B, 16, S, D2)
    flash_case("flash_attention", f"bf16 B1 T{T} prior{prior} D128 GQA 32/16 window 1024", None,
               q, [kd, vd], prior, torch.ones((B, 16, S), dtype=torch.bool, device=dev),
               chunk=T, iters=20, window=1024)
    del q, kd, vd

    # flash_attention_quant at int4 as chunked prefill launches it on its
    # fused route: 8,192 new queries over a 32K buffer of which ``prior``
    # slots came before, no keep-mask.
    T = CHUNK_TOKENS
    q = rnd(B, Hq, T, D)
    kd, vd = rnd(B, Hkv, CONTEXT_TOKENS, D), rnd(B, Hkv, CONTEXT_TOKENS, D)
    kv4 = quantized(kd, vd, 4)
    del kd, vd
    for prior in range(0, CONTEXT_TOKENS, CHUNK_TOKENS):
        flash_case("flash_attention_quant", f"int4 B1 T{T} prior{prior} S{CONTEXT_TOKENS} chunk",
                   4, q, kv4, prior, None, chunk=1024, iters=5, lib_mask="lower_right")
    del q, kv4

    # flash_attention as chunked prefill's dense route launches it: the last
    # chunk of 8,192 queries over the 24,576 slots before it, with no
    # keep-mask (int4 KV, dequantized) and with every keep-bit set (the
    # head-wise cache of AdaKV).
    prior = CONTEXT_TOKENS - T
    q = rnd(B, Hq, T, D)
    kd, vd = rnd(B, Hkv, CONTEXT_TOKENS, D), rnd(B, Hkv, CONTEXT_TOKENS, D)
    for label, mask in (("no mask", None),
                        ("all set", torch.ones((B, Hkv, CONTEXT_TOKENS), dtype=torch.bool,
                                               device=dev))):
        flash_case("flash_attention", f"bf16 B1 T{T} prior{prior} S{CONTEXT_TOKENS} chunk {label}",
                   None, q, [kd, vd], prior, mask, chunk=1024, iters=5, lib_mask="lower_right")
    del q, kd, vd, mask

    # The 8B-class body's last chunk (head_dim 128): 8,192 queries over the
    # 122,880 slots before them, the dense route's 131,072 dequantized slots,
    # no keep-mask.
    D2 = 128
    prior = LONG_CONTEXT_TOKENS - T
    q = rnd(B, Hq, T, D2)
    kd, vd = rnd(B, Hkv, LONG_CONTEXT_TOKENS, D2), rnd(B, Hkv, LONG_CONTEXT_TOKENS, D2)
    flash_case("flash_attention", f"bf16 B1 T{T} prior{prior} S{LONG_CONTEXT_TOKENS} D128 chunk",
               None, q, [kd, vd], prior, None, chunk=256, iters=3, lib_mask="lower_right")
    del q, kd, vd
    torch.cuda.empty_cache()

    def or_case(variant, q, k, v, prior, window, kg, span, chunk, iters, lower_fault=False):
        """flash_attention with the same-image or-mask (no keep-mask, as a
        prefill into an empty cache): launched twice (equal bits), output and
        row LSE against the plain version, the three planted faults of the
        kernel's or-mask (each read on every row), its time beside its bound
        over the pairs the or-mask makes visible, and
        ``scaled_dot_product_attention`` with the same boolean mask."""
        B, Hq_, T, D_ = q.shape
        Hkv_, S = k.shape[1], k.shape[2]
        G_ = Hq_ // Hkv_
        qg = kg[:, prior:prior + T].contiguous()
        kw = dict(sm_scale=D_ ** -0.5, window=window, or_span=span)
        call = lambda: fl.flash_attention(q, k, v, prior, None, qg, kg, return_lse=True, **kw)
        n_or = fl.flash_attention.launches_by_kind[D_, "or_mask"]
        got, lse = call()
        torch.cuda.synchronize()
        again, lse_again = call()
        torch.cuda.synchronize()
        label = f"flash_attention_or_mask[{variant}]"
        if fl.flash_attention.launches_by_kind[D_, "or_mask"] != n_or + 2:
            failures.append(f"{label}: the or-mask instantiation at head_dim {D_} was not "
                            f"launched")
        if not (torch.equal(got, again) and torch.equal(lse, lse_again)):
            failures.append(f"{label}: two launches differ")
        bq, nk = 128 // G_, fl.key_tile(D_)
        up = span - 1
        slot = torch.arange(S, device=dev)

        def allows(r0, r1):
            """(true or-mask, its three faults) of rows r0..r1-1, (B, rows, S)."""
            true = fl.same_image(qg[:, r0:r1], kg)
            t = torch.arange(r0, r1, device=dev)
            t0 = t // bq * bq
            last = torch.clamp(t0 + bq, max=T) - 1
            ceil = lambda x: (x + nk - 1) // nk * nk
            hi = ceil(torch.clamp(prior + last + 1 + up, max=S))          # loaded keys
            lo = (torch.clamp(prior + t0 - max(window - 1, up), min=0) // nk * nk
                  if window else torch.zeros_like(t0))
            faults = {"the upper range not widened":
                      true & (slot[None] < ceil(prior + last + 1)[:, None])[None]}
            if lower_fault:
                low = torch.clamp(prior + t0 - window + 1, min=0) // nk * nk
                faults["the lower range not widened"] = true & (slot[None] >= low[:, None])[None]
            loaded = (slot[None] >= lo[:, None]) & (slot[None] < hi[:, None])
            faults["the gq >= 0 guard dropped"] = true | (
                (qg[:, r0:r1, None] == kg[:, None, :]) & loaded[None])
            return true, faults

        def rows(allow_of, r0, r1):
            bias = attention_bias(prior + r0, r1 - r0, S, sliding_window=window,
                                  extra_allow=allow_of, device=dev)
            return gqa_attention(q[:, :, r0:r1], k, v, bias, kw["sm_scale"])[0]

        def plain_all(q=q):
            outs, lses = [], []
            for r0 in range(0, T, chunk):
                r1 = min(T, r0 + chunk)
                o, l = fl.flash_attention_plain(q[:, :, r0:r1], k, v, prior + r0, None,
                                                qg[:, r0:r1], kg, return_lse=True, **kw)
                outs.append(o)
                lses.append(l)
            return torch.cat(outs, 2), torch.cat(lses, 2)

        (ref, ref_lse), plain_ms = timed(plain_all)
        lse_err = (lse - ref_lse).abs().max().item()
        if not lse_err <= LSE_LIMIT:
            failures.append(f"{label}: row logsumexp differs by {lse_err:.3e} > {LSE_LIMIT}")
        faults, pairs = {}, 0
        for r0 in range(0, T, chunk):
            r1 = min(T, r0 + chunk)
            true, fault_allows = allows(r0, r1)
            q_slot = prior + torch.arange(r0, r1, device=dev)[:, None]
            vis = slot[None] <= q_slot
            if window:
                vis &= slot[None] > q_slot - window
            pairs += int((vis[None] | true).sum())
            for what, a in fault_allows.items():
                faults.setdefault(what, []).append(rows(a, r0, r1))
        faults = {what: torch.cat(parts, 2) for what, parts in faults.items()}
        if D_ == 96:
            faults.update(upper_faults(lambda q_: plain_all(q_)[0], q, ref))
        # Three readings of the launch, each beside the same launch without
        # image groups (what the or-mask costs); their medians are kept.
        plain_call = lambda: fl.flash_attention(q, k, v, prior, None, return_lse=True,
                                                sm_scale=kw["sm_scale"], window=window)
        readings = [(kernel_ms(call, "flash_sm90", iters), kernel_ms(plain_call, "flash_sm90",
                                                                     iters)) for _ in range(3)]
        ms = statistics.median(r[0] for r in readings)
        causal_ms = statistics.median(r[1] for r in readings)
        q_slot = prior + torch.arange(T, device=dev)[:, None]
        vis = slot[None] <= q_slot
        if window:
            vis &= slot[None] > q_slot - window
        allowed = (vis[None] | fl.same_image(qg, kg))[:, None]              # (B, 1, T, S)
        del vis
        kr, vr = k.repeat_interleave(G_, 1), v.repeat_interleave(G_, 1)
        try:
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=allowed,
                                                                 scale=kw["sm_scale"]), 3)
        except torch.cuda.OutOfMemoryError:
            lib = None      # the library's route for this mask holds the whole logit matrix
        del allowed, kr, vr
        torch.cuda.empty_cache()
        record("flash_attention_or_mask", variant, got, ref, faults, ms, plain_ms,
               nbytes(q, k, v, qg, kg, got), 4 * D_ * G_ * Hkv_ * pairs, lib,
               causal_ms=causal_ms, readings=readings)
        report(f"    launched twice with equal bits; readings (or-mask, without the groups) "
               + ", ".join(f"({a:.4f}, {b:.4f})" for a, b in readings) + " ms; "
               + ("the library call ran out of memory; " if lib is None else "")
               + f"row logsumexp max_abs_err {lse_err:.3e} "
               f"(limit {LSE_LIMIT}); key ranges a q-tile: "
               f"{fl.flash_splits(B, Hkv_, G_, T, S, D_, prior, window, span)}; visible "
               f"pairs a kv head {pairs}")

    def image_groups(S, starts, span=256):
        kg = torch.full((1, S), -1, dtype=torch.int32, device=dev)
        for g, s0 in enumerate(starts):
            kg[:, s0:s0 + span] = g
        return kg

    # The or-mask of flash_attention (Gemma3 multimodal prefill) at the
    # Gemma-3-27B body's attention shape (GQA 32/16, head_dim 128): 8,192
    # queries over their own keys holding 4 images of 256 placeholders at
    # unaligned starts, with no window (global layers), the sliding layers'
    # window of 1,024, and a window of 128 that the span reaches behind; then
    # the last chunk of a chunked prefill: 8,192 queries over the 24,576
    # slots before them, one image in the prior and one in the chunk.
    Hq2, Hkv2, D2, T = 32, 16, 128, CHUNK_TOKENS
    q, k, v = rnd(1, Hq2, T, D2), rnd(1, Hkv2, T, D2), rnd(1, Hkv2, T, D2)
    kg = image_groups(T, (37, 1301, 4099, 7001))
    for window in (None, 1024, 128):
        or_case(f"bf16 B1 T{T} S{T} D128 4 images" + (f" window {window}" if window else ""),
                q, k, v, 0, window, kg, 256, chunk=1024, iters=5, lower_fault=window == 128)
    del q, k, v
    torch.cuda.empty_cache()
    # The Gemma-3-27B run's one-shot prefill itself: 32,768 queries over
    # their own keys with its 4 images, on the global and the sliding layers.
    T = CONTEXT_TOKENS
    q, k, v = rnd(1, Hq2, T, D2), rnd(1, Hkv2, T, D2), rnd(1, Hkv2, T, D2)
    kg = image_groups(T, GEMMA3_IMAGE_STARTS)
    for window in (None, 1024):
        or_case(f"bf16 B1 T{T} S{T} D128 4 images" + (f" window {window}" if window else ""),
                q, k, v, 0, window, kg, 256, chunk=512, iters=3)
    del q, k, v, kg
    torch.cuda.empty_cache()
    T = CHUNK_TOKENS
    prior = CONTEXT_TOKENS - T
    q = rnd(1, Hq2, T, D2)
    k, v = rnd(1, Hkv2, CONTEXT_TOKENS, D2), rnd(1, Hkv2, CONTEXT_TOKENS, D2)
    or_case(f"bf16 B1 T{T} prior{prior} S{CONTEXT_TOKENS} D128 images in prior and chunk", q,
            k, v, prior, None, image_groups(CONTEXT_TOKENS, (9000, prior + 2345)), 256,
            chunk=512, iters=3)
    del q, k, v
    torch.cuda.empty_cache()

    # flash_attention_quant: question forward over a compressed cache.
    T, prior = 256, 16384
    S = prior + T
    q = rnd(B, Hq, T, D)
    kd, vd = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    mask = keep_mask(B, S)
    for bits in (8, 4):
        flash_case("flash_attention_quant", f"int{bits} B1 T{T} prior{prior}", bits, q,
                   quantized(kd, vd, bits), prior, mask, chunk=T, iters=20)

    def decode_case(variant, q, kd, vd, length, mask, bits, iters=50, window=None):
        """One shape of decode_attention: launched twice (equal bits), against
        its plain version with its planted faults (a 256-key run skipped, one
        kernel step taken for dead, one key range dropped from the merge, each
        inside the window if there is one; a window of 1,024 (at most half
        the length) applied where there is none; with a window, the window not applied and the step
        across its edge taken whole), timed beside its two bounds (the kept
        rows' bytes; the bytes of every slot of the live kernel steps) and the
        library call."""
        B_, Hq_, T_, D_ = q.shape
        Hkv_, S_ = kd.shape[1], kd.shape[2]
        G_ = Hq_ // Hkv_
        if bits is None:
            kk, vv, ks, vs = kd, vd, None, None
        else:
            (kk, ks), (vv, vs) = quantize_kv(kd, bits), quantize_kv(vd, bits)
        kw = dict(bits=bits, sm_scale=D_ ** -0.5, window=window)
        plain = lambda m=mask, **over: dec.decode_attention_plain(q, kk, vv, length, ks, vs, m,
                                                                  **{**kw, **over})
        call = lambda: dec.decode_attention(q, kk, vv, length, ks, vs, mask, **kw)
        got = call()
        torch.cuda.synchronize()
        if not torch.equal(got, call()):
            failures.append(f"decode_attention[{variant}]: two launches differ")
        ref = plain()
        nk = dec.step_keys(D_, bits)
        splits = dec.decode_splits(B_, Hkv_, G_, T_, S_, D_, length, nk)
        lo, hi = dec.decode_key_ranges(length, T_, window, nk, splits)[1 if splits > 1 else 0]
        hole, step = (length - window // 2, (length - 3 * window // 4) // nk * nk) if window \
            else (min(8192, length // 2), min(4096, length // 4) // nk * nk)
        faults = {"one skipped key step": fault_mask(mask, B_, S_, hole, hkv=Hkv_),
                  "one live step taken for dead": fault_mask(mask, B_, S_, step, nk, hkv=Hkv_),
                  "one key range dropped from the merge": fault_mask(mask, B_, S_, lo, hi - lo,
                                                                     hkv=Hkv_)}
        faults = {what: plain(m) for what, m in faults.items()}
        first = max(0, length - T_ - window + 1) if window else 0
        kfirst = first // nk * nk          # the kernel's first step
        if window:
            faults["the window not applied"] = plain(window=None)
            if first > kfirst:
                # row 0 then sees from the step's start: its window widened
                faults["the step across the window's edge taken whole"] = plain(
                    window=window + first - kfirst)
        else:
            # a window that cuts the earliest keys off the last row
            w = min(1024, length // 2)
            faults[f"a window of {w:,} applied"] = plain(window=w)
        if D_ == 96:
            faults.update(upper_faults(lambda q_: dec.decode_attention_plain(
                q_, kk, vv, length, ks, vs, mask, **kw), q, ref))
        ms = kernel_ms(call, "decode_kernel", iters)
        wrapper = cuda_ms(call, iters, 5)
        plain_ms = cuda_ms(plain, 10)
        kdq = kk if bits is None else dequantize_kv(kk, ks, bits, torch.bfloat16)
        vdq = vv if bits is None else dequantize_kv(vv, vs, bits, torch.bfloat16)
        lib = sdpa_ms(q, kdq, vdq, allowed_mask(mask, B_, length - T_, T_, S_, length, window,
                                                hkv=Hkv_, g=G_), 20)
        full = torch.ones((B_, Hkv_, S_), dtype=torch.bool, device=dev) if mask is None else mask
        pairs = visible_pairs(full, length - T_, T_, length, window)
        row = kk.shape[-1] * kk.element_size() + (0 if ks is None else 4)
        need = q.numel() * 2 * 2 + 2 * row * pairs // T_ + (0 if mask is None else mask.numel())
        live = full[..., kfirst:length]
        pad = -(length - kfirst) % nk
        steps = int(torch.nn.functional.pad(live, (0, pad)).reshape(B_, Hkv_, -1, nk).any(-1).sum())
        walk = q.numel() * 2 * 2 + 2 * row * steps * nk + (0 if mask is None else mask.numel())
        walk_ms = bound_ms(walk, 4 * D_ * G_ * pairs)[0]
        record("decode_attention", variant, got, ref, faults, ms, plain_ms, need,
               4 * D_ * G_ * pairs, lib, wrapper_ms=wrapper, steps_bound_ms=walk_ms)
        report(f"    launched twice with equal bits; {splits} key ranges a kv head; bound over "
               f"the live {nk}-key steps ({steps} of {B_ * Hkv_ * -(-(length - kfirst) // nk)}) "
               f"{walk_ms:.4f} ms; with the wrapper (CUDA events): {wrapper:.4f} ms")

    # decode_attention: B=4, T=1, 16K live slots (+1 new), masked and not.
    B, T = DECODE_BATCH, 1
    length = 16384 + T
    S = length + 63
    q = rnd(B, Hq, T, D)
    kd, vd = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    for masked in (False, True):
        mask = None
        if masked:
            mask = keep_mask(B, S, p=0.4)
            mask[:, :, length - T:length] = True
        for bits in (None, 8, 4):
            name = "bf16" if bits is None else f"int{bits}"
            decode_case(f"{name} B{B} 16K {'masked' if masked else 'unmasked'}", q, kd, vd,
                        length, mask, bits)
    # The pipeline's decode shapes: B=1 and B=4 over a 33K buffer of which
    # half the slots are live (a press that clears keep-bits without
    # compacting), bf16 and int4.
    length = 32768 + 1
    S = length + 255
    for B in (1, DECODE_BATCH):
        q = rnd(B, Hq, 1, D)
        kd, vd = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
        mask = keep_mask(B, S, p=0.5)
        mask[:, :, length - 1] = True
        for bits in (None, 4):
            name = "bf16" if bits is None else f"int{bits}"
            decode_case(f"{name} B{B} 33K half live", q, kd, vd, length, mask, bits, iters=20)
    # The 8B-class body's decode (head_dim 128): B=1 over the int4 cache that
    # Knorm leaves of 131,072 tokens (65,536 kept slots, compacted), a
    # 152-token question and the new token; room for 32 more.
    length = LONG_CONTEXT_TOKENS // 2 + 152 + 1
    S = length + 32
    q = rnd(1, Hq, 1, 128)
    kd, vd = rnd(1, Hkv, S, 128), rnd(1, Hkv, S, 128)
    decode_case("int4 B1 66K D128", q, kd, vd, length, None, 4, iters=20)
    # The Qwen3-8B run's decode (GQA 32/8, bf16): B=1 over the 16,384 slots
    # Knorm leaves of 32K, the question and the new token. A Gemma-3-27B
    # sliding layer's (GQA 32/16): over the 32,768 slots it keeps, the
    # question and 8 new tokens, window 1,024 (its edge inside a kernel step).
    length = CONTEXT_TOKENS // 2 + 152 + 1
    S = length + 31
    q = rnd(1, Hq, 1, 128)
    kd, vd = rnd(1, Hkv, S, 128), rnd(1, Hkv, S, 128)
    decode_case("bf16 B1 16K D128", q, kd, vd, length, None, None, iters=20)
    length = CONTEXT_TOKENS + 152 + 8
    S = length + 24
    q = rnd(1, 32, 1, 128)
    kd, vd = rnd(1, 16, S, 128), rnd(1, 16, S, 128)
    decode_case("bf16 B1 33K D128 GQA 32/16 window 1024", q, kd, vd, length,
                torch.ones((1, 16, S), dtype=torch.bool, device=dev), None, iters=20,
                window=1024)
    # The Duo split decode's two launches a layer (flagship, 32K, half of the
    # 128 heads streaming, room for 33 appends): a retrieval buffer of 5 of
    # the 8 kv heads (G 4) over the 32,768 context slots and the new token,
    # and a streaming buffer of 4 kv heads, sink 128 + recent 256 + 33 slots;
    # every slot below the length live, no mask.
    for heads, length, S, label in ((5, CONTEXT_TOKENS + 1, CONTEXT_TOKENS + 33,
                                     "bf16 B1 Duo retrieval 5/8 heads 32K"),
                                    (4, 384 + 1, 384 + 33, "bf16 B1 Duo streaming 4/8 heads 417")):
        q = rnd(1, heads * G, 1, D)
        kd, vd = rnd(1, heads, S, D), rnd(1, heads, S, D)
        decode_case(label, q, kd, vd, length, None, None, iters=20)
    del q, kd, vd, mask
    torch.cuda.empty_cache()

    def colsum_cases(S, softcaps, iters, hq=Hq, hkv=Hkv, d=D):
        """observed_lse / observed_colsums_flash: a prefill's queries against
        their own keys, B=1, GQA hq/hkv at head_dim d. The column sums are
        taken with the kernel's own LSE pass and with the flash prefill
        kernel's LSE."""
        B, g, sc = 1, hq // hkv, d ** -0.5
        q, k, v = rnd(B, hq, S, d), rnd(B, hkv, S, d), rnd(B, hkv, S, d)
        pairs = B * hq * S * (S + 1) // 2            # visible (query head, key) pairs
        kr, vr = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        tag = "" if d == D else f" D{d} GQA {hq}/{hkv}"
        for softcap in softcaps:
            kw = dict(sm_scale=sc, softcap=softcap)
            variant = f"B{B} S{S}{tag}" + ("" if softcap is None else f" softcap {softcap:g}")
            lse = oc.observed_lse(q, k, **kw)
            torch.cuda.synchronize()
            if not torch.equal(lse, oc.observed_lse(q, k, **kw)):
                failures.append(f"observed_lse[{variant}]: two launches differ")
            lse_ref, plain = timed(lambda: oc.observed_lse_plain(q, k, **kw))
            if S < CONTEXT_TOKENS:      # small enough to repeat: a median
                plain = cuda_ms(lambda: oc.observed_lse_plain(q, k, **kw), 3, 1)
            # Faults: keys 512..575 skipped (the rows below them, computed
            # without them); the key tile across each row's diagonal taken
            # whole (a diagonal tile without the causal test).
            skipped = oc.observed_lse_plain(*without_keys(q, k, 512, 576), **kw)
            lse_fault = lse_ref.clone()
            lse_fault[:, :, 576:] = skipped[:, :, 512:]
            faults = {"one skipped key tile": lse_fault,
                      "a diagonal tile taken for an interior one": torch.logaddexp(
                          lse_ref, above_diagonal(q, k, fl.key_tile(d), softcap, "rows"))}
            if d == 96:
                faults.update(upper_faults(lambda q_: oc.observed_lse_plain(q_, k, **kw), q))
            ms = kernel_ms(lambda: oc.observed_lse(q, k, **kw), "observed_lse_kernel", iters)
            lib = None
            if softcap is None:
                # One PyTorch call gives the same row LSE: the library's causal
                # flash attention (its output besides), natural log.
                sdpa = lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                    q, kr, vr, 0.0, True, False, scale=sc)
                lib_lse = sdpa()[1]
                lib_err = (lib_lse - lse_ref).abs().max().item()
                report(f"    library LSE (_scaled_dot_product_flash_attention, is_causal) against "
                       f"the plain version: {lib_err:.3e} natural-log units, "
                       f"{(lib_lse - lse_ref / LN2).abs().max().item():.3e} base-2 units")
                if not lib_err <= LSE_LIMIT:
                    failures.append(f"observed_lse[{variant}]: the library call is not the "
                                    f"same function ({lib_err:.3e})")
                lib = cuda_ms(sdpa, iters)
            record("observed_lse", variant, lse, lse_ref, faults, ms, plain, nbytes(q, k, lse),
                   2 * d * pairs, lib, LSE_LIMIT, compare_lse)
            del skipped, lse_fault, faults

            _, flash_lse = fl.flash_attention(q, k, v, 0, sm_scale=sc, softcap=softcap,
                                              return_lse=True)
            ms = kernel_ms(lambda: oc.observed_colsums_flash(q, k, flash_lse, **kw),
                           "observed_colsum_kernel", iters)
            for source, given, rows in (("own lse", None, lse_ref),
                                        ("flash lse", flash_lse, flash_lse)):
                got = oc.observed_colsums_flash(q, k, given, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, oc.observed_colsums_flash(q, k, given, **kw)):
                    failures.append(f"observed_colsum[{source}, {variant}]: two launches differ")
                ref, plain = timed(lambda: oc.observed_colsums_plain(q, k, rows, **kw))
                if S < CONTEXT_TOKENS:
                    plain = cuda_ms(lambda: oc.observed_colsums_plain(q, k, rows, **kw), 3, 1)
                # Faults: one tile of 64 query rows near the end skipped (rows
                # whose LSE is -inf add nothing); every query stage taken
                # without the causal test (each key also gathers the rows
                # before it in its 64-key run, a consumer warpgroup's keys).
                holed = rows.clone()
                holed[:, :, S - 128:S - 64] = float("-inf")
                faults = {"one skipped query tile": oc.observed_colsums_plain(q, k, holed, **kw),
                          "a diagonal stage taken for an interior one":
                              ref + above_diagonal(q, k, 64, softcap, "columns", rows)}
                if d == 96:
                    faults.update(upper_faults(
                        lambda q_: oc.observed_colsums_plain(q_, k, rows, **kw), q))
                record("observed_colsum", f"{source}, {variant}", got, ref, faults, ms, plain,
                       nbytes(q, k, rows, got), 2 * d * pairs, None, SUM_LIMIT, compare_sums)
                del got, ref, holed, faults
            del lse, lse_ref, flash_lse
        del q, k, v, kr, vr
        torch.cuda.empty_cache()

    # The column sums of the flagship's prefill, whole and ragged tiles, with
    # and without softcap, and the 32K prefill itself.
    for S, softcaps, iters in ((8192, (None, 30.0), 5), (8000, (None, 30.0), 5),
                               (CONTEXT_TOKENS, (None,), 3)):
        colsum_cases(S, softcaps, iters)

    def headwise_case(label, B, S, prefix, tail, Ts, hq=Hq, d=D):
        """decode_attention_headwise over a cache compacted head by head
        (``prefix`` (B, Hkv) kept slots, the longest head running into a tail
        of ``tail`` appended tokens, stale bits past the end), at each T of
        ``Ts``, hq query heads at head_dim d: launched twice (equal bits),
        against its plain version with its planted faults (the tail skipped;
        at T=1, where the dense decode reads the same mask, one kernel step
        and one chunk of a head dropped), timed beside its two bounds and the
        library call."""
        Hkv, G, D = prefix.shape[1], hq // prefix.shape[1], d
        scale = D ** -0.5
        tail_start = int(prefix.max())
        length = tail_start + tail
        col = torch.arange(S, device=dev)
        mask = col < prefix[..., None]
        mask[:, :, tail_start:length] = True
        mask[:, :, length:] = torch.rand((B, Hkv, S - length), generator=gen, device=dev) < 0.5
        k, v = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
        live = int((mask & (col < length)).sum())               # K/V rows the heads read
        nk = dec.step_keys(D, None)
        pfx, ts, tl = hw.prefix_tail_from_mask(mask, length)
        ranges_ms = cuda_ms(lambda: hw.prefix_tail_from_mask(mask, length), 50, 5)
        splits = dec.decode_splits(B, Hkv, G, 1, S, D, S, nk)
        chunk = hw.headwise_chunks(pfx, ts, tl, S, nk, splits)
        tail_n = (length - pfx.clamp(min=int(ts))).clamp(min=0)
        steps = int((-(-pfx // nk)).sum() + (-(-tail_n // nk)).sum())
        for T in Ts:
            q = rnd(B, hq, T, D)
            call = lambda: hw.decode_attention_headwise(
                q, k, v, *hw.prefix_tail_from_mask(mask, length), sm_scale=scale)
            kernel = lambda: hw.decode_attention_headwise(q, k, v, pfx, ts, tl, sm_scale=scale)
            got = kernel()
            torch.cuda.synchronize()
            if not torch.equal(got, kernel()):
                failures.append(f"decode_headwise[bf16 B{B} T{T} {label}]: two launches differ")
            ref = hw.decode_attention_headwise_plain(q, k, v, pfx, ts, tl, sm_scale=scale)
            faults = {"the tail skipped": hw.decode_attention_headwise_plain(
                q, k, v, pfx, ts, torch.zeros_like(tl), sm_scale=scale)}
            if D == 96:
                faults.update(upper_faults(lambda q_: hw.decode_attention_headwise_plain(
                    q_, k, v, pfx, ts, tl, sm_scale=scale), q, ref))
            if T == 1:      # the mask says what the ranges say: the dense decode reads it
                faults["one live step taken for dead"] = dec.decode_attention_plain(
                    q, k, v, length, mask=fault_mask(mask, B, S, 1024, nk, hkv=Hkv),
                    sm_scale=scale)
                faults["one chunk dropped from the merge"] = dec.decode_attention_plain(
                    q, k, v, length, mask=mask & (chunk != 1), sm_scale=scale)
            # The library call: SDPA with the plain version's live set as a
            # boolean mask (at T > 1 a prefix that absorbs the tail is
            # visible to every row: no causal mask says that).
            row_limit = ts + tl - T + torch.arange(T, device=dev)[:, None]
            in_tail = (col >= ts) & (col < ts + tl) & (col <= row_limit)
            live_set = (col < pfx[..., None])[:, :, None, :] | in_tail
            lib = sdpa_ms(q, k, v, live_set.repeat_interleave(G, 1), 20)
            ms = kernel_ms(kernel, "decode_headwise_kernel", 50)
            wrapper = cuda_ms(call, 50, 5)
            plain = cuda_ms(lambda: hw.decode_attention_headwise_plain(
                q, k, v, pfx, ts, tl, sm_scale=scale), 10)
            fixed = q.numel() * 2 * 2 + pfx.numel() * 4 + 8
            walk_ms = bound_ms(fixed + 2 * D * 2 * steps * nk, 4 * D * G * T * live)[0]
            record("decode_headwise", f"bf16 B{B} T{T} {label}", got, ref, faults, ms, plain,
                   fixed + 2 * D * 2 * live, 4 * D * G * T * live, lib, wrapper_ms=wrapper,
                   steps_bound_ms=walk_ms, ranges_ms=ranges_ms)
            report(f"    launched twice with equal bits; {splits} chunks a head; bound over the "
                   f"live {nk}-key steps ({steps}) {walk_ms:.4f} ms; prefix_tail_from_mask "
                   f"{ranges_ms:.4f} ms, with it and the wrapper (CUDA events): {wrapper:.4f} ms")

    # decode_attention_headwise: B=4, 16K slots, ragged prefixes (one head
    # empty, the longest running into the tail as after a compaction), a tail
    # of 33 appended tokens; T=1 as the runner routes it, and T=4. Then path
    # B's cache at B=4 as the pipeline leaves it (heads keep 16,009 to 16,854
    # of 32K slots on random weights, PERF.md; the buffer is the longest head,
    # 33 appended tokens and room for 32 more).
    prefix = torch.randint(2048, 16384, (DECODE_BATCH, Hkv), generator=gen, device=dev)
    prefix[0, 0], prefix[1, 1] = 0, 16384
    headwise_case("16K ragged", DECODE_BATCH, 16384 + 64, prefix, 33, (1, 4))
    prefix = torch.randint(16009, 16855, (DECODE_BATCH, Hkv), generator=gen, device=dev)
    headwise_case("path B cache", DECODE_BATCH, int(prefix.max()) + 33 + 32, prefix, 33, (1,))

    # Head_dim 256 at the Gemma-3-12B run's shapes (GQA 16/8): every
    # instantiation of the five kernels (flash_sm90.cuh's 32-key tiles,
    # decode_sm90.cuh's Q fragments in shared memory, the column sums' query
    # stages of 64 rows), each with the planted faults of its 64/128 checks.
    Hq3, Hkv3, D3 = 16, 8, 256
    tag = f"D{D3} GQA {Hq3}/{Hkv3}"
    # The 32K prefill without images (paths A and B, int8 KV) on a global
    # and a sliding layer (window 1,024), then with the run's 4 images.
    T = CONTEXT_TOKENS
    q, k, v = rnd(1, Hq3, T, D3), rnd(1, Hkv3, T, D3), rnd(1, Hkv3, T, D3)
    live = torch.ones((1, Hkv3, T), dtype=torch.bool, device=dev)
    flash_case("flash_attention", f"bf16 B1 T{T} S{T} {tag} all-live", None, q, [k, v], 0,
               live, chunk=512, iters=3, lib_mask="causal")
    flash_case("flash_attention", f"bf16 B1 T{T} S{T} {tag} all-live window 1024", None, q,
               [k, v], 0, live, chunk=512, iters=5, lib_mask="window", window=1024)
    del live
    kg = image_groups(T, GEMMA3_IMAGE_STARTS)
    for window in (None, 1024):
        or_case(f"bf16 B1 T{T} S{T} {tag} 4 images" + (f" window {window}" if window else ""),
                q, k, v, 0, window, kg, 256, chunk=512, iters=5)
    del q, k, v, kg
    torch.cuda.empty_cache()
    # The last chunk of the chunked image run: 8,192 queries over the 24,576
    # slots before them, one image in the prior and one in the chunk, on a
    # global and a sliding layer.
    T = CHUNK_TOKENS
    prior = CONTEXT_TOKENS - T
    q = rnd(1, Hq3, T, D3)
    k, v = rnd(1, Hkv3, CONTEXT_TOKENS, D3), rnd(1, Hkv3, CONTEXT_TOKENS, D3)
    kg = image_groups(CONTEXT_TOKENS, (9000, prior + 2345))
    for window in (None, 1024):
        or_case(f"bf16 B1 T{T} prior{prior} S{CONTEXT_TOKENS} {tag} images in prior and chunk"
                + (f" window {window}" if window else ""), q, k, v, prior, window, kg, 256,
                chunk=512, iters=3)
    del q, k, v, kg
    torch.cuda.empty_cache()
    # The question forwards: 152 tokens over a global layer's 16,384 kept
    # slots (half live, as after a press that does not compact; bf16 and
    # int8 KV) and over a sliding layer's 32,768 with its window.
    T = 152
    for prior, window, mask_of in ((16384, None, lambda S: keep_mask(1, S, p=0.5)),
                                   (CONTEXT_TOKENS, 1024, None)):
        S = prior + T
        q, kd, vd = rnd(1, Hq3, T, D3), rnd(1, Hkv3, S, D3), rnd(1, Hkv3, S, D3)
        mask = (mask_of(S) if mask_of else
                torch.ones((1, Hkv3, S), dtype=torch.bool, device=dev))
        label = f"B1 T{T} prior{prior} {tag}" + (f" window {window}" if window else " half live")
        flash_case("flash_attention", f"bf16 {label}", None, q, [kd, vd], prior, mask,
                   chunk=T, iters=20, window=window)
        flash_case("flash_attention_quant", f"int8 {label}", 8, q, quantized(kd, vd, 8), prior,
                   mask, chunk=T, iters=20, window=window)
        del q, kd, vd, mask
    # The tile logic at 32-key tiles, every payload.
    T = 1024
    q, kd, vd = rnd(1, Hq3, T, D3), rnd(1, Hkv3, T, D3), rnd(1, Hkv3, T, D3)
    one_clear = torch.ones((1, Hkv3, T), dtype=torch.bool, device=dev)
    one_clear[:, :, 5] = False
    flash_case("flash_attention", f"bf16 B1 T{T} S{T} {tag} one clear bit", None, q, [kd, vd],
               0, one_clear, chunk=T, iters=10, logic_faults=True)
    for bits in (8, 4):
        flash_case("flash_attention_quant", f"int{bits} B1 T{T} S{T} {tag} one clear bit", bits,
                   q, quantized(kd, vd, bits), 0, one_clear, chunk=T, iters=10,
                   logic_faults=True)
    del q, kd, vd
    # flash_attention_quant at int4 as chunked prefill's fused route would
    # launch it: the last 8,192-query chunk over a 32K buffer.
    T, prior = CHUNK_TOKENS, CONTEXT_TOKENS - CHUNK_TOKENS
    q = rnd(1, Hq3, T, D3)
    kd, vd = rnd(1, Hkv3, CONTEXT_TOKENS, D3), rnd(1, Hkv3, CONTEXT_TOKENS, D3)
    flash_case("flash_attention_quant", f"int4 B1 T{T} prior{prior} S{CONTEXT_TOKENS} {tag} chunk",
               4, q, quantized(kd, vd, 4), prior, None, chunk=1024, iters=3,
               lib_mask="lower_right")
    del q, kd, vd
    torch.cuda.empty_cache()
    # Decode: over a global layer's 16,384 kept slots, the question and the
    # new token (bf16 and int8 KV; int4 at B4), and over a sliding layer's
    # 32,768 with its window.
    length = CONTEXT_TOKENS // 2 + 152 + 1
    S = length + 31
    for B, bits in ((1, None), (1, 8), (DECODE_BATCH, 4)):
        q = rnd(B, Hq3, 1, D3)
        kd, vd = rnd(B, Hkv3, S, D3), rnd(B, Hkv3, S, D3)
        decode_case(f"{'bf16' if bits is None else f'int{bits}'} B{B} 16K {tag}", q, kd, vd,
                    length, None, bits, iters=20)
    length = CONTEXT_TOKENS + 152 + 8
    S = length + 24
    q = rnd(1, Hq3, 1, D3)
    kd, vd = rnd(1, Hkv3, S, D3), rnd(1, Hkv3, S, D3)
    decode_case(f"bf16 B1 33K {tag} window 1024", q, kd, vd, length,
                torch.ones((1, Hkv3, S), dtype=torch.bool, device=dev), None, iters=20,
                window=1024)
    del q, kd, vd
    torch.cuda.empty_cache()
    # The column sums at the 32K prefill and at a ragged length with softcap.
    colsum_cases(CONTEXT_TOKENS, (None,), 3, Hq3, Hkv3, D3)
    colsum_cases(8000, (30.0,), 5, Hq3, Hkv3, D3)
    # The head-wise decode (off on sliding models, so on no path at 256): a
    # synthetic path-B cache, B4, 16K, ragged.
    prefix = torch.randint(2048, 16384, (DECODE_BATCH, Hkv3), generator=gen, device=dev)
    prefix[0, 0], prefix[1, 1] = 0, 16384
    headwise_case(f"16K ragged {tag}", DECODE_BATCH, 16384 + 64, prefix, 33, (1,), Hq3, D3)

    # Head_dim 96 at the Phi-3-mini run's shapes (32 query heads, each its
    # own kv head): every instantiation of the five kernels (head_dim 128's
    # two panels with the second half used and 64-key flash tiles; decode
    # steps of 64 keys, 128 for int4, and lanes of 24 K and 12 V channels),
    # each with the planted faults of its 64/128 checks and two confined to
    # channels 64-95 (``upper_faults``).
    Hq4 = Hkv4 = 32
    D4, T4 = 96, PHI3_CONTEXT_TOKENS
    tag = f"D{D4} GQA {Hq4}/{Hkv4}"
    # The one-shot prefill of the run's 3,840-token context, under a random
    # keep-mask and all live; the same-image or-mask there (no model pairs
    # head_dim 96 with images: the instantiation is held all the same); and
    # the tile logic where it can go wrong, every payload.
    q, k, v = rnd(1, Hq4, T4, D4), rnd(1, Hkv4, T4, D4), rnd(1, Hkv4, T4, D4)
    flash_case("flash_attention", f"bf16 B1 T{T4} S{T4} {tag} masked", None, q, [k, v], 0,
               keep_mask(1, T4, hkv=Hkv4), chunk=1024, iters=10)
    flash_case("flash_attention", f"bf16 B1 T{T4} S{T4} {tag} all-live", None, q, [k, v], 0,
               torch.ones((1, Hkv4, T4), dtype=torch.bool, device=dev), chunk=1024, iters=10,
               lib_mask="causal")
    or_case(f"bf16 B1 T{T4} S{T4} {tag} 2 images", q, k, v, 0, None,
            image_groups(T4, (301, 2050)), 256, chunk=1024, iters=5)
    del q, k, v
    T = 1024
    q, kd, vd = rnd(1, Hq4, T, D4), rnd(1, Hkv4, T, D4), rnd(1, Hkv4, T, D4)
    one_clear = torch.ones((1, Hkv4, T), dtype=torch.bool, device=dev)
    one_clear[:, :, 5] = False
    flash_case("flash_attention", f"bf16 B1 T{T} S{T} {tag} one clear bit", None, q, [kd, vd],
               0, one_clear, chunk=T, iters=10, logic_faults=True)
    for bits in (8, 4):
        flash_case("flash_attention_quant", f"int{bits} B1 T{T} S{T} {tag} one clear bit", bits,
                   q, quantized(kd, vd, bits), 0, one_clear, chunk=T, iters=10,
                   logic_faults=True)
    del q, kd, vd
    # At 32K, all live, beside the other widths' rows of the table (SDPA
    # causal as the library call).
    T = CONTEXT_TOKENS
    q, k, v = rnd(1, Hq4, T, D4), rnd(1, Hkv4, T, D4), rnd(1, Hkv4, T, D4)
    flash_case("flash_attention", f"bf16 B1 T{T} S{T} {tag} all-live", None, q, [k, v], 0,
               torch.ones((1, Hkv4, T), dtype=torch.bool, device=dev), chunk=512, iters=3,
               lib_mask="causal")
    del q, k, v
    torch.cuda.empty_cache()
    # A chunk of chunked prefill by 1,024: 1,024 queries over the 3,072
    # slots before them, no keep-mask (bf16, and int8 as the chunked int8 run
    # takes it; int4 as a fused int4 chunk would).
    T, prior = PHI3_CHUNK_TOKENS, 3 * PHI3_CHUNK_TOKENS
    S = prior + T
    q = rnd(1, Hq4, T, D4)
    kd, vd = rnd(1, Hkv4, S, D4), rnd(1, Hkv4, S, D4)
    flash_case("flash_attention", f"bf16 B1 T{T} prior{prior} S{S} {tag} chunk", None, q,
               [kd, vd], prior, None, chunk=T, iters=10, lib_mask="lower_right")
    for bits in (8, 4):
        flash_case("flash_attention_quant", f"int{bits} B1 T{T} prior{prior} S{S} {tag} chunk",
                   bits, q, quantized(kd, vd, bits), prior, None, chunk=T, iters=10,
                   lib_mask="lower_right")
    del q, kd, vd
    # The 152-token question over a cache of 3,840 slots of which half are
    # live (a press that clears keep-bits without compacting), bf16 and int8.
    T, prior = 152, T4
    S = prior + T
    q, kd, vd = rnd(1, Hq4, T, D4), rnd(1, Hkv4, S, D4), rnd(1, Hkv4, S, D4)
    half = keep_mask(1, S, p=0.5, hkv=Hkv4)
    flash_case("flash_attention", f"bf16 B1 T{T} prior{prior} {tag} half live", None, q,
               [kd, vd], prior, half, chunk=T, iters=20)
    flash_case("flash_attention_quant", f"int8 B1 T{T} prior{prior} {tag} half live", 8, q,
               quantized(kd, vd, 8), prior, half, chunk=T, iters=20)
    del q, kd, vd, half
    # Decode: B1 over 4,096 slots of which half are live (the new token's
    # slot set), every payload; int4 at B4 over 16K live slots (the table's
    # row shared with the other widths).
    length = 4096
    S = length + 32
    q = rnd(1, Hq4, 1, D4)
    kd, vd = rnd(1, Hkv4, S, D4), rnd(1, Hkv4, S, D4)
    half = keep_mask(1, S, p=0.5, hkv=Hkv4)
    half[:, :, length - 1] = True
    for bits in (None, 8, 4):
        decode_case(f"{'bf16' if bits is None else f'int{bits}'} B1 4K half live {tag}", q, kd,
                    vd, length, half, bits, iters=20)
    length = 16384 + 1
    S = length + 63
    q = rnd(DECODE_BATCH, Hq4, 1, D4)
    kd, vd = rnd(DECODE_BATCH, Hkv4, S, D4), rnd(DECODE_BATCH, Hkv4, S, D4)
    decode_case(f"int4 B{DECODE_BATCH} 16K {tag}", q, kd, vd, length, None, 4, iters=20)
    del q, kd, vd, half
    torch.cuda.empty_cache()
    # The column sums and the row-logsumexp pass at 8,192 (with softcap too)
    # and 32,768 tokens: off the run's path (below chunked_threshold), held
    # all the same.
    colsum_cases(8192, (None, 30.0), 5, Hq4, Hkv4, D4)
    colsum_cases(CONTEXT_TOKENS, (None,), 3, Hq4, Hkv4, D4)
    # The head-wise decode: a synthetic path-B cache, B4, 16K, ragged.
    prefix = torch.randint(2048, 16384, (DECODE_BATCH, Hkv4), generator=gen, device=dev)
    prefix[0, 0], prefix[1, 1] = 0, 16384
    headwise_case(f"16K ragged {tag}", DECODE_BATCH, 16384 + 64, prefix, 33, (1,), Hq4, D4)
    if failures:
        raise AssertionError("; ".join(failures))
    return results


# --------------------------------------------------------------------- #
# Phase 3: the main path


class _LengthLog(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.compressed = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("Compressed Context Length: "):
            self.compressed.append(int(msg.rsplit(" ", 1)[1]))


def counters():
    from kvpress_tpu_torch.ops.decode import decode_attention
    from kvpress_tpu_torch.ops.decode_headwise import decode_attention_headwise
    from kvpress_tpu_torch.ops.flash import flash_attention, flash_attention_quant
    from kvpress_tpu_torch.ops.observed_colsum import observed_colsums_flash, observed_lse

    return {"flash_attention": flash_attention, "flash_attention_quant": flash_attention_quant,
            "decode_attention": decode_attention, "observed_lse": observed_lse,
            "observed_colsum": observed_colsums_flash,
            "decode_headwise": decode_attention_headwise}


# The launches that took a window, among a wrapper's: (wrapper, its count
# attribute).
SUB_COUNTS = {"flash_attention_windowed": ("flash_attention", "launches_windowed"),
              "decode_attention_windowed": ("decode_attention", "launches_windowed")}


def reset_counts():
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
        fn.launches_by_kind.update(dict.fromkeys(fn.launches_by_kind, 0))
    for name, attr in SUB_COUNTS.values():
        setattr(fns[name], attr, 0)


def read_counts():
    """Each wrapper's launches; as ``<name>_<kind>_d<head_dim>``, those of
    each kernel instantiation as the wrapper counted them where it launched
    (``launches_by_kind``; kind: bf16, int8, int4, or_mask); their sums over
    head_dims (``<name>_<kind>``) and over kinds (``<name>_d<head_dim>``);
    and the windowed launches (SUB_COUNTS)."""
    fns = counters()
    counts = {name: fn.launches for name, fn in fns.items()}
    counts.update({sub: getattr(fns[name], attr) for sub, (name, attr) in SUB_COUNTS.items()})
    for name, fn in fns.items():
        for (d, kind), n in fn.launches_by_kind.items():
            counts[f"{name}_{kind}_d{d}"] = n
            for total in (f"{name}_{kind}", f"{name}_d{d}"):
                counts[total] = counts.get(total, 0) + n
    return counts


QUESTIONS = ["summarise " + " ".join(f"w{i}" for i in range(0, 300, 2)) + " ?",   # 152 words
             "what follows w7 ?"]


def timed_runner(kt, torch, runner, log: list, summarize=None):
    """``runner`` with each prefill (one-shot or chunked) timed on a
    synchronized host clock and its peak device memory read: appends
    (seconds, peak bytes, bytes held before, the cache's layer lengths) to
    ``log``, and ``summarize(cache)`` when it is given (read after the
    clock stops)."""
    class Timed(type(runner)):
        def _measure(self, call):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            log.append((time.perf_counter() - start, torch.cuda.max_memory_allocated(), held,
                        out[1].length.tolist())
                       + (() if summarize is None else (summarize(out[1]),)))
            return out

        def prefill(self, *args, **kw):
            return self._measure(lambda: super(Timed, self).prefill(*args, **kw))

        def prefill_chunked(self, *args, **kw):
            return self._measure(lambda: super(Timed, self).prefill_chunked(*args, **kw))

    return Timed(**{f.name: getattr(runner, f.name) for f in dataclasses.fields(runner)})


def prefill_reading(log) -> str:
    seconds, peak, held = log[-1][:3]
    return (f"prefill {seconds * 1e3:.1f} ms, peak memory {peak / 2**30:.3f} GiB "
            f"({(peak - held) / 2**30:.3f} GiB over the {held / 2**30:.3f} GiB held before)")


def launched(counts):
    """The counts of ``read_counts`` that are not 0."""
    return {name: n for name, n in counts.items() if n}


def check_run(label, counts, needed, unwanted):
    """The kernels of a run that had to be launched were, and those that must
    not be were not."""
    for name in needed:
        if counts[name] == 0:
            raise AssertionError(f"{label}: {name} was never launched")
    for name in unwanted:
        if counts[name] != 0:
            raise AssertionError(f"{label}: {name} was launched {counts[name]} times")


def main_path(kt, torch, tokenizer_cls, report):
    """Every path once through the pipeline at 32K and full depth, the launch
    counts set to 0 before each run and read after it: the one-shot prefill
    (Knorm with bf16, int8 and int4 KV; paths A and B) and chunked prefill
    (``context_chunk=8192``: Knorm with int8 KV, SnapKV with int4 KV and int4
    weights, AdaKV(Knorm) compact on the head-wise runner)."""
    cfg = flagship_config(16)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = kt.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    params8 = kt.quantize_params_int8(params)
    params4 = kt.quantize_params_int4(params)
    tok = tokenizer_cls(vocab_size=cfg.vocab_size)
    context = " ".join(f"w{i}" for i in range(CONTEXT_TOKENS))
    questions = QUESTIONS
    lengths = _LengthLog()
    logging.getLogger("kvpress_tpu_torch.pipeline").addHandler(lengths)
    logging.getLogger("kvpress_tpu_torch.pipeline").setLevel(logging.DEBUG)

    runner = kt.Runner.create(cfg, device=dev)
    headwise = kt.Runner.create(cfg, decode_kernel=False, headwise_kernel=True, device=dev)
    knorm, observed = kt.KnormPress(0.5), kt.ObservedAttentionPress(0.5)
    half = CONTEXT_TOKENS // 2
    # label: (runner, params, press, pipeline options, kernels that must have
    # been launched, kernels that must not, the compressed length's range)
    runs = {
        "Knorm, bf16 KV": (runner, params, knorm, {},
                           ("flash_attention", "decode_attention"), (), (half, half)),
        "Knorm, int8 KV": (runner, params, knorm, dict(quantized=True, kv_bits=8),
                           ("flash_attention", "flash_attention_quant", "decode_attention"), (),
                           (half, half)),
        "Knorm, int4 KV + int8 weights": (runner, params8, knorm,
                                          dict(quantized=True, kv_bits=4),
                                          ("flash_attention", "decode_attention"), (),
                                          (half, half)),
        # Path A. The column-sum pass needs a row LSE: with no launch of the
        # kernel's own LSE pass, it was the flash prefill's.
        "path A, ObservedAttention": (runner, params, observed, {},
                                      ("flash_attention", "observed_colsum", "decode_attention"),
                                      ("observed_lse", "decode_headwise"), (half, half)),
        # Path B. The heads keep different numbers of entries: the cache is
        # as long as the longest head.
        "path B, AdaKV(ObservedAttention), compact": (
            headwise, params, kt.AdaKVPress(observed, compact=True), {},
            ("flash_attention", "observed_lse", "observed_colsum", "decode_headwise"),
            ("decode_attention",), (half, CONTEXT_TOKENS - 1)),
        # Chunked prefill. int8 chunks always take flash_attention_quant.
        "chunked, Knorm, int8 KV": (
            runner, params, knorm, dict(quantized=True, kv_bits=8, context_chunk=CHUNK_TOKENS),
            ("flash_attention_quant", "decode_attention"), (), (half, half)),
        # int4 chunks take the dense route here: the layer's dequantized
        # transient (2 x 2 B x 8 heads x 32,768 x 64 = 33.5 MB) is under 512 MiB.
        "chunked, SnapKV, int4 KV + int4 weights": (
            runner, params4, kt.SnapKVPress(0.5),
            dict(quantized=True, kv_bits=4, context_chunk=CHUNK_TOKENS),
            ("flash_attention", "decode_attention"), ("flash_attention_quant",), (half, half)),
        "chunked, AdaKV(Knorm), compact": (
            headwise, params, kt.AdaKVPress(knorm, compact=True),
            dict(context_chunk=CHUNK_TOKENS), ("flash_attention", "decode_headwise"),
            ("decode_attention",), (half, CONTEXT_TOKENS - 1)),
    }
    totals = {name: 0 for name in read_counts()}
    for label, (r, p, press, kw, needed, unwanted, (lo, hi)) in runs.items():
        prefills = []
        pipe = kt.KVPressPipeline(timed_runner(kt, torch, r, prefills), p, tok)
        reset_counts()
        t0 = time.perf_counter()
        out = pipe(context, questions=questions, press=press, max_new_tokens=32, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        for name, n in counts.items():
            totals[name] += n
        answers = out["answers"]
        report(f"  {label}: {seconds:.2f} s in all, {prefill_reading(prefills)}, compressed "
               f"length {lengths.compressed[-1]}, launches {launched(counts)}, answer tokens "
               f"{[len(a.split()) for a in answers]}")
        if not lo <= lengths.compressed[-1] <= hi:
            raise AssertionError(f"{label}: compressed length {lengths.compressed[-1]}")
        if len(answers) != 2 or not all(isinstance(a, str) and a for a in answers):
            raise AssertionError(f"{label}: bad answers {answers!r}")
        check_run(label, counts, needed, unwanted)
        if label.startswith("path") and counts["observed_colsum"] != cfg.num_layers:
            raise AssertionError(f"{label}: {counts['observed_colsum']} column-sum launches "
                                 f"for {cfg.num_layers} layers")
    return params, params8, totals


# Phase 3, chunked prefill's fused int4 route against its dense route at the
# 32K flagship: the two attend the same int4 values (the dense route rounds
# them to bf16 first), so they differ only by rounding. The limit is
# max |fused - dense| / max |dense| of the last position's logits after 16
# layers: the routes read 2.5e-2, the planted faults (every key step of
# slots 256-511 skipped) 0.20 (PERF.md).
FUSED_LIMIT = 5e-2


def fused_int4_check(kt, torch, params, report):
    """``Runner.prefill_chunked(..., quantized=True, kv_bits=4, fused_kv=True)``
    at 32K, Knorm(0.5), chunks of 8,192: flash_attention_quant must launch at
    4 bits (and flash_attention not at all). Held against ``fused_kv=False``
    on the same weights: equal compressed lengths, layer 0's kept payload equal
    bit for bit (its keys do not depend on attention), the last logits within
    FUSED_LIMIT, which the planted faults exceed. Then the peak memory of the
    chunked prefill against the one-shot ``prefill`` (int4 KV). Returns the
    fused run's launch counts."""
    cfg = flagship_config(16)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    ids = torch.randint(3, cfg.vocab_size, (1, CONTEXT_TOKENS), generator=gen, device=dev)
    runner = kt.Runner.create(cfg, device=dev)
    kw = dict(press=kt.KnormPress(0.5), chunk_size=CHUNK_TOKENS, compute_logits=True,
              quantized=True, kv_bits=4)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused, fused_cache, _ = runner.prefill_chunked(params, ids, fused_kv=True, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    report(f"  chunked, Knorm, int4 KV, fused_kv=True: {seconds:.2f} s, lengths "
           f"{sorted(set(fused_cache.length.tolist()))}, launches {launched(counts)}")
    check_run("fused int4 route", counts, ("flash_attention_quant",),
              ("flash_attention", "flash_attention_quant_int8"))
    dense, dense_cache, _ = runner.prefill_chunked(params, ids, fused_kv=False, **kw)
    with planted_faults(torch):
        fault, _, _ = runner.prefill_chunked(params, ids, fused_kv=True, **kw)

    def rel(a):
        if not torch.isfinite(a).all():
            raise AssertionError("non-finite logits on the fused route")
        return ((a - dense).abs().max() / dense.abs().max()).item()

    n = int(dense_cache.length[0])
    layer0_equal = all(torch.equal(getattr(fused_cache, f)[0, :, :, :n],
                                   getattr(dense_cache, f)[0, :, :, :n])
                       for f in ("keys", "values", "key_scales", "value_scales"))
    report(f"  fused against dense route: logits {rel(fused):.3e} (limit {FUSED_LIMIT}; planted "
           f"faults {rel(fault):.3e}); lengths equal "
           f"{torch.equal(fused_cache.length, dense_cache.length)}; layer 0's kept payload "
           f"equal {layer0_equal}")
    if not torch.equal(fused_cache.length, dense_cache.length):
        raise AssertionError(f"fused route lengths {fused_cache.length.tolist()} against "
                             f"{dense_cache.length.tolist()}")
    if not layer0_equal:
        raise AssertionError("fused route: layer 0 keeps another payload")
    if not rel(fused) <= FUSED_LIMIT < rel(fault):
        raise AssertionError(f"fused route: logits {rel(fused):.3e}, planted faults "
                             f"{rel(fault):.3e}, limit {FUSED_LIMIT}")
    del fused_cache, dense_cache
    torch.cuda.empty_cache()

    # Bounded activations: peak memory of the one-shot and the chunked prefill.
    log = []
    timed = timed_runner(kt, torch, runner, log)
    for label, call in (
            ("one-shot prefill", lambda: timed.prefill(params, ids, press=kw["press"],
                                                       compute_logits=True, quantized=True,
                                                       kv_bits=4)),
            ("chunked prefill", lambda: timed.prefill_chunked(params, ids, **kw))):
        call()
        report(f"  32K, Knorm, int4 KV, {label}: {prefill_reading(log)}")
        torch.cuda.empty_cache()
    return counts


# Phase 3, the scorer presses at the flagship shape.


def scorer_artifacts(kt, torch, runner, params, gen):
    """Seeded stand-ins for the trained artifacts, on the card: query
    statistics fitted by ``collect_query_stats`` over two 2,048-token samples,
    a (layers, kv heads, head_dim) Q-filter bank, a KVzap MLP surrogate
    (hidden 512, the trainer's default width)."""
    cfg = runner.cfg
    dev = runner.device
    L, Hkv, D, E = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
    samples = [torch.randint(3, cfg.vocab_size, (1, 2048), generator=gen, device=dev)
               for _ in range(2)]
    stats = kt.collect_query_stats(runner, params, samples)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    q_filters = rnd(L, Hkv, D)
    surrogate = {"w1": rnd(L, E, 512) * E ** -0.5, "b1": torch.zeros((L, 512), device=dev),
                 "w2": rnd(L, 512, Hkv) * 512 ** -0.5, "b2": torch.zeros((L, Hkv), device=dev)}
    return stats, q_filters, surrogate


def capture_layer(kt, torch, runner, params, ids, layer: int):
    """The (ctx, keys, values) a press scores in ``layer`` of a prefill of
    ``ids`` (copies, taken from a Knorm prefill)."""
    seen = {}

    class Capture(kt.KnormPress):
        def score(self, ctx, keys, values):
            if ctx.layer_idx == layer:
                seen["args"] = (ctx, keys.clone(), values.clone())
            return super().score(ctx, keys, values)

    runner.prefill(params, ids, press=Capture(0.5))
    return seen["args"]


def layer_reading(what: str, fn, num_layers: int, iters: int = 2) -> str:
    """One layer's press call on the card (``fn()`` on a captured 32K
    layer): its device ms from the profiler, by kernel name (no attention
    kernel runs in it), times the number of layers; its kernel launches and
    host wall ms a call."""
    wall, kernels = device_kernels(fn, iters)
    busy = sum(ms for ms, _ in kernels.values())
    launches = sum(n for _, n in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:3]
    return (f"{what} {busy:.3f} ms a layer on the device ({busy * num_layers:.1f} ms for "
            f"{num_layers} layers; {launches:.0f} launches, {wall:.2f} ms wall a call; largest: "
            + ", ".join(f"{name[:48]} {ms:.3f}" for name, (ms, _) in top) + ")")


def scorer_presses_run(kt, torch, tokenizer_cls, params, report):
    """Each press that scores without a kernel once through
    ``KVPressPipeline`` at the flagship shape (16 layers, bf16 weights), a
    32,768-token context, the two questions and 32 new tokens, ratio 0.5:
    ExpectedAttention, its stats variant (statistics from
    ``collect_query_stats`` on the card), KeyDiff, LagKV, CUR, CAP, QFilter
    (a seeded bank), Compactor, KVzap (a seeded MLP surrogate);
    ExpectedAttention with int8 KV; and
    ``AdaKVPress(ExpectedAttentionPress(0.5), compact=True)`` on the
    head-wise runner. The launch counts are set to 0 before each run and
    read after it; each run must keep 16,384 entries in every layer (AdaKV:
    the longest head). Each press's scoring time is read on a captured
    layer. Returns the summed launch counts."""
    import numpy as np

    cfg = flagship_config(16)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    tok = tokenizer_cls(vocab_size=cfg.vocab_size)
    context = " ".join(f"w{i}" for i in range(CONTEXT_TOKENS))
    runner = kt.Runner.create(cfg, device=dev)
    headwise = kt.Runner.create(cfg, decode_kernel=False, headwise_kernel=True, device=dev)
    t0 = time.perf_counter()
    stats, q_filters, surrogate = scorer_artifacts(kt, torch, runner, params, gen)
    report(f"  query statistics over two 2,048-token samples on the card: "
           f"{time.perf_counter() - t0:.2f} s; mu {tuple(stats['mu'].shape)}, cov "
           f"{tuple(stats['cov'].shape)}, finite {bool(np.isfinite(stats['cov']).all())}")
    if not (np.isfinite(stats["mu"]).all() and np.isfinite(stats["cov"]).all()):
        raise AssertionError("collect_query_stats: non-finite statistics")
    ea = kt.ExpectedAttentionPress(0.5)
    presses = {
        "ExpectedAttention": ea,
        "ExpectedAttentionStats": kt.ExpectedAttentionStatsPress(0.5, stats=stats),
        "KeyDiff": kt.KeyDiffPress(0.5),
        "LagKV": kt.LagKVPress(0.5),
        "CUR": kt.CURPress(0.5),
        "CAP": kt.CapPress(0.5),
        "QFilter": kt.QFilterPress(0.5, q_filters=q_filters),
        "Compactor": kt.CompactorPress(0.5),
        "KVzap": kt.KVzapPress(0.5, surrogate=surrogate),
    }
    half = CONTEXT_TOKENS // 2
    # label: (runner, press, options, needed, unwanted)
    runs = {label: (runner, press, {}, ("flash_attention", "decode_attention"),
                    ("decode_headwise", "observed_lse", "observed_colsum"))
            for label, press in presses.items()}
    runs["ExpectedAttention, int8 KV"] = (
        runner, ea, dict(quantized=True, kv_bits=8),
        ("flash_attention", "flash_attention_quant", "decode_attention"), ("decode_headwise",))
    runs["AdaKV(ExpectedAttention), compact"] = (
        headwise, kt.AdaKVPress(ea, compact=True), {}, ("flash_attention", "decode_headwise"),
        ("decode_attention",))
    ids = torch.randint(3, cfg.vocab_size, (1, CONTEXT_TOKENS), generator=gen, device=dev)
    layer_args = capture_layer(kt, torch, runner, params, ids, 1)
    totals = {name: 0 for name in read_counts()}
    for label, (r, press, kw, needed, unwanted) in runs.items():
        prefills = []
        pipe = kt.KVPressPipeline(timed_runner(kt, torch, r, prefills), params, tok)
        counts, _, lengths = pipeline_run(kt, torch, label, pipe, prefills, needed, unwanted,
                                          report, context=context, press=press, **kw)
        for name, n in counts.items():
            totals[name] += n
        want = {half} if label.startswith(tuple(presses)) else None
        if want is not None and set(lengths) != want:
            raise AssertionError(f"{label}: layer lengths {sorted(set(lengths))}, not {half}")
        if want is None and not half <= max(lengths) < CONTEXT_TOKENS:
            raise AssertionError(f"{label}: longest head {max(lengths)}")
        if label in presses:
            ctx, keys, values = layer_args
            report("    " + layer_reading("scoring", lambda: press.score(ctx, keys, values),
                                          cfg.num_layers))
        del pipe
        torch.cuda.empty_cache()
    del layer_args
    torch.cuda.empty_cache()
    return totals


# Phase 3, bucketed prefill at the flagship shape: a 30,000-token context
# padded to 32,768 (context_bucket=4096).
BUCKET_CONTEXT, BUCKET = 30000, 4096


def bucketed_check(kt, torch, tokenizer_cls, params, report, makes=None):
    """Bucketed prefill under each press of ``makes`` ({name: press of a
    ratio}; by default Knorm(0.5) and ExpectedAttention(0.5)). First
    ``Runner.prefill`` with ``valid_len`` against the exact prefill on the
    same ids: equal lengths (int(30,000 * 0.5) = 15,000 in every layer) and
    offsets, and the question's last-position logits over the two caches
    within F32_RATIO times what bf16 rounding alone moves (dense bf16 against
    dense float32 at 2,048 tokens, depth 16, as ``compare_paths`` reads it).
    Then each through ``KVPressPipeline`` with ``context_bucket=4096`` and
    without (the launch counts set to 0 before and read after each), all
    compressed to 15,000. Returns the bucketed runs' launch counts."""
    cfg = flagship_config(16)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    runner = kt.Runner.create(cfg, device=dev)
    want = int(BUCKET_CONTEXT * 0.5)
    padded = -(-BUCKET_CONTEXT // BUCKET) * BUCKET
    makes = makes or {"Knorm": kt.KnormPress, "ExpectedAttention": kt.ExpectedAttentionPress}
    failures = []

    # The runner: bucketed against exact on the same ids, then the 152-token
    # question over each compressed cache.
    ids = torch.randint(3, cfg.vocab_size, (1, BUCKET_CONTEXT), generator=gen, device=dev)
    ids_pad = torch.nn.functional.pad(ids, (0, padded - BUCKET_CONTEXT))
    question = torch.randint(3, cfg.vocab_size, (1, 152), generator=gen, device=dev)
    dense = kt.Runner.create(cfg, attn_impl="xla", decode_kernel=False, device=dev)
    r_ids = torch.randperm(cfg.vocab_size, generator=gen, device=dev)[:REF_CONTEXT][None]
    for name, make in makes.items():
        noise, _ = f32_noise(torch, f"{name}, depth 16, bf16 KV", lambda p, log: dense.prefill(
            p, r_ids, press=make(0.5), compute_logits=True), params, report)
        out = {}
        for label, kw in (("exact", dict(ids=ids)),
                          ("bucketed", dict(ids=ids_pad, valid_len=BUCKET_CONTEXT))):
            pre, cache, _ = runner.prefill(params, kw["ids"], press=make(0.5), compute_logits=True,
                                           valid_len=kw.get("valid_len"))
            cache = kt.resize(cache, int(cache.length.max()) + question.shape[1] + 1)
            q_logits, _, _ = runner.forward(params, question, cache, logits_last_only=True)
            out[label] = (pre, cache, q_logits)
        (pre_e, c_e, q_e), (pre_b, c_b, q_b) = out["exact"], out["bucketed"]
        read_q, read_pre = rel(torch, q_b, q_e), rel(torch, pre_b, pre_e)
        report(f"  {name}, runner, bucketed against exact: lengths "
               f"{sorted(set(c_b.length.tolist()))} / {sorted(set(c_e.length.tolist()))}, "
               f"offsets {int(c_b.offset)} / {int(c_e.offset)}; max |bucketed - exact| / "
               f"max |exact|: question logits {read_q:.3e}, prefill logits {read_pre:.3e} ({read_q / noise:.3f}x what bf16 "
               f"rounding alone moves at 2,048 tokens, {noise:.3e}; limit {F32_RATIO}x)")
        if not (torch.equal(c_b.length, c_e.length) and int(c_b.offset) == int(c_e.offset)
                == BUCKET_CONTEXT and set(c_b.length.tolist()) == {want}):
            failures.append(f"{name}: bucketed lengths {c_b.length.tolist()} offset "
                            f"{int(c_b.offset)} against {c_e.length.tolist()} {int(c_e.offset)}")
        if not max(read_q, read_pre) <= F32_RATIO * noise:
            failures.append(f"{name}: bucketed logits {read_q:.3e} / {read_pre:.3e} past "
                            f"{F32_RATIO} x {noise:.3e}")
        del out, c_e, c_b
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))

    tok = tokenizer_cls(vocab_size=cfg.vocab_size)
    context = " ".join(f"w{i}" for i in range(BUCKET_CONTEXT))
    totals = {name: 0 for name in read_counts()}
    for name, make in makes.items():
        for bucket in (BUCKET, None):
            prefills = []
            pipe = kt.KVPressPipeline(timed_runner(kt, torch, runner, prefills), params, tok)
            label = f"{name}, {BUCKET_CONTEXT} tokens, " + (
                f"context_bucket={bucket} (padded to {padded})" if bucket else "exact")
            counts, _, lengths = pipeline_run(
                kt, torch, label, pipe, prefills, ("flash_attention", "decode_attention"),
                ("flash_attention_quant", "decode_headwise"), report, context=context,
                press=make(0.5), context_bucket=bucket)
            if bucket:
                for n, c in counts.items():
                    totals[n] += c
            if set(lengths) != {want}:
                raise AssertionError(f"{label}: layer lengths {sorted(set(lengths))}, not {want}")
            del pipe
            torch.cuda.empty_cache()
    return totals


# Phase 3, the wrapper presses at the flagship shape.


def cache_summary(torch, cache):
    """Per layer: the keep-mask's kept slots over the kv heads (None without
    a mask), and per (layer, kv head) the key channels that are 0 in every
    valid slot."""
    kept = None if cache.mask is None else cache.mask.sum(dim=(1, 2, 3)).tolist()
    zero = [(cache.keys[l, :, :, :n] == 0).all(dim=2).sum(-1).flatten().tolist()
            for l, n in enumerate(cache.length.tolist())]
    return kept, zero


def wrapper_runs(kt, cfg):
    """{label: (runner kind, press, pipeline options, kernels that must have
    been launched, kernels that must not, check of (layer lengths, cache
    summary | None) -> the fault | None)}: the registry's wrapper presses
    (evaluation/registry.py) at ratio 0.5."""
    import numpy as np

    L, Hkv, S = cfg.num_layers, cfg.num_kv_heads, CONTEXT_TOKENS
    half = S // 2
    snap, knorm = kt.SnapKVPress(0.5), kt.KnormPress(0.5)
    ea = kt.ExpectedAttentionPress(0.5, use_vnorm=False)
    ratios = tuple(float(r) for r in np.linspace(0.25, 0.75, L))
    std, unwanted = ("flash_attention", "decode_attention"), ("decode_headwise",)
    hw, hw_unwanted = ("flash_attention", "decode_headwise"), ("decode_attention",)
    int8 = ("flash_attention_quant", "decode_attention")
    chunked8 = dict(context_chunk=CHUNK_TOKENS, quantized=True, kv_bits=8)

    def all_layers(*want):
        return lambda lengths, _: None if set(lengths) <= set(want) else (
            f"layer lengths {sorted(set(lengths))}, not {want}")

    def longest_head(lengths, _):
        return None if half <= max(lengths) < S else f"longest head {max(lengths)}"

    def mask_only(lengths, summary):
        kept = summary[0]
        if set(lengths) != {S} or kept != [half * Hkv] * L:
            return f"layer lengths {sorted(set(lengths))}, kept slots per layer {kept}"

    def think(lengths, summary):
        zero = summary[1]
        if set(lengths) != {S} or any(z != [32] * Hkv for z in zero):
            return f"layer lengths {sorted(set(lengths))}, zero key channels {zero}"

    def per_layer(lengths, _):
        want = [max(1, int(S * (1 - r))) for r in ratios]
        return None if lengths == want else f"layer lengths {lengths}, not {want}"

    rerotation = kt.KeyRerotationPress(knorm)
    snap_think = kt.ComposedPress((snap, kt.ThinKPress(0.5)))
    return {
        "critical_snapkv": ("standard", kt.CriticalKVPress(snap), {}, std, unwanted,
                            all_layers(half)),
        "critical_expected_attention": ("standard", kt.CriticalKVPress(ea), {}, std, unwanted,
                                        all_layers(half)),
        "critical_adakv_expected_attention": ("standard", kt.CriticalAdaKVPress(ea), {}, std,
                                              unwanted, mask_only),
        "critical_adakv_snapkv, compact": ("headwise",
                                           kt.CriticalAdaKVPress(snap, compact=True), {}, hw,
                                           hw_unwanted, longest_head),
        "key_rerotation": ("standard", rerotation, {}, std, unwanted, all_layers(half)),
        "chunk_knorm": ("standard", kt.ChunkPress(knorm, chunk_length=1024), {}, std, unwanted,
                        all_layers(half)),
        # 1,639 chunks of 20 (the last of 8 slots), 819 kept
        "chunkkv": ("standard", kt.ChunkKVPress(snap, chunk_length=20), {}, std, unwanted,
                    all_layers(16380, 16368)),
        "block_keydiff": ("standard", kt.BlockPress(kt.KeyDiffPress(0.5), block_size=128), {},
                          std, unwanted, all_layers(half)),
        "think": ("standard", kt.ThinKPress(key_channel_compression_ratio=0.5), {}, std,
                  unwanted, think),
        "snap_think": ("standard", snap_think, {}, std, unwanted, all_layers(half)),
        "per_layer": ("standard", kt.PerLayerCompressionPress(knorm, compression_ratios=ratios),
                      {}, std, unwanted, per_layer),
        "chunked key_rerotation, int8 KV": ("standard", rerotation, chunked8, int8, unwanted,
                                            all_layers(half)),
        "chunked snap_think, int8 KV": ("standard", snap_think, chunked8, int8, unwanted,
                                        all_layers(half)),
        "chunked critical_adakv_knorm, compact": (
            "headwise", kt.CriticalAdaKVPress(knorm, compact=True),
            dict(context_chunk=CHUNK_TOKENS), hw, hw_unwanted, longest_head),
    }


def wrapper_presses_run(kt, torch, tokenizer_cls, params, report, labels=None):
    """Each wrapper press of ``wrapper_runs`` (those of ``labels`` alone when
    it is given) once through ``KVPressPipeline`` at the flagship shape (16
    layers, bf16 weights), a 32,768-token context, the two questions and 32
    new tokens: the launch counts set to 0 before each run and read after
    it, its layer lengths (the keep-mask's count, ThinK's zero channels)
    checked, and after a rerotating press every question's forward must
    start from the compressed length. With every run: one layer's
    ``layer_compress`` on a captured 32K layer (profiler device ms by kernel
    name), then bucketed prefill under CriticalKV(SnapKV) held against the
    exact prefill (``bucketed_check``) and a ``context_bucket`` call with
    KeyRerotation, which must raise. Returns the summed launch counts."""
    cfg = flagship_config(16)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    tok = tokenizer_cls(vocab_size=cfg.vocab_size)
    context = " ".join(f"w{i}" for i in range(CONTEXT_TOKENS))
    runners = {"standard": kt.Runner.create(cfg, device=dev),
               "headwise": kt.Runner.create(cfg, decode_kernel=False, headwise_kernel=True,
                                            device=dev)}
    runs = wrapper_runs(kt, cfg)
    layer_args = None
    if labels is None:
        ids = torch.randint(3, cfg.vocab_size, (1, CONTEXT_TOKENS), generator=gen, device=dev)
        layer_args = capture_layer(kt, torch, runners["standard"], params, ids, 1)
    totals = {name: 0 for name in read_counts()}
    failures = []
    for label, (kind, press, kw, needed, unwanted, check) in runs.items():
        if labels is not None and label not in labels:
            continue
        prefills, log = [], []
        runner = decode_recorder(runners[kind], log)
        summarize = (lambda cache: cache_summary(torch, cache)) if label in (
            "think", "critical_adakv_expected_attention") else None
        pipe = kt.KVPressPipeline(timed_runner(kt, torch, runner, prefills, summarize), params,
                                  tok)
        counts, _, lengths = pipeline_run(kt, torch, label, pipe, prefills, needed, unwanted,
                                          report, context=context, press=press, **kw)
        for name, n in counts.items():
            totals[name] += n
        summary = prefills[-1][4] if summarize else None
        if label == "think":
            report(f"    key channels 0 in every valid slot, per layer and head: "
                   f"{sorted({z for zs in summary[1] for z in zs})}")
        elif summary is not None:
            report(f"    keep-mask slots per layer (8 heads): {summary[0]}")
        fault = check(lengths, summary)
        # each question's forward (a decode-phase call of more than one token)
        offsets = [e["offset"] for e in log if e["T"] > 1]
        if getattr(press, "rerotates", False) and offsets != [max(lengths)] * len(QUESTIONS):
            fault = (f"the questions start from offsets {offsets}, not from the compressed "
                     f"length {max(lengths)}")
        if fault:
            failures.append(f"{label}: {fault}")
        if layer_args is not None:
            ctx, keys, values = layer_args
            mask = torch.ones(keys.shape[:3], dtype=torch.bool, device=dev)
            report("    " + layer_reading(
                "layer_compress", lambda: press.layer_compress(ctx, keys, values,
                                                               keys.shape[2], mask),
                cfg.num_layers, iters=1))
        del pipe
        torch.cuda.empty_cache()
    del layer_args
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    if labels is not None:
        return totals
    for name, n in bucketed_check(
            kt, torch, tokenizer_cls, params, report,
            makes={"CriticalKV(SnapKV)": lambda r: kt.CriticalKVPress(kt.SnapKVPress(r))}).items():
        totals[name] += n
    pipe = kt.KVPressPipeline(runners["standard"], params, tok)
    try:
        pipe(" ".join(f"w{i}" for i in range(BUCKET_CONTEXT)), question="what follows w7 ?",
             press=kt.KeyRerotationPress(kt.KnormPress(0.5)), context_bucket=BUCKET,
             max_new_tokens=2)
    except ValueError as e:
        report(f"  KeyRerotation, context_bucket={BUCKET}: refused ({e})")
    else:
        raise AssertionError("KeyRerotationPress took a bucketed prefill")
    return totals


def rerotation_check(kt, torch, tokenizer_cls, params, report):
    """KeyRerotationPress(KnormPress(0.5)) through the pipeline at 32K: after
    the prefill the cache's offset is the compressed length (16,384), and
    each question's forward starts from it."""
    return wrapper_presses_run(kt, torch, tokenizer_cls, params, report,
                               labels=("key_rerotation",))


# Phase 3, the mask, merge and head-split presses at the flagship shape.

DUO_SINK, DUO_RECENT, DUO_STEPS = 128, 256, 32
LAZY_KEEP = 4 + 1023        # a lazy layer's sink and recent slots (SimLayerKV's defaults)


def decode_recorder(runner, log: list):
    """``runner`` that appends to ``log``, for each decode-phase forward, its
    new tokens, the offset it starts from, the cache's layer lengths before
    and after it, its wall ms on a synchronized host clock, the cache it was
    given, and the cache and a copy of the press state it returned; the
    first decode-phase call also starts the peak-memory reading
    (``log[0]["held"]``)."""
    import torch

    class Recording(type(runner)):
        def forward(self, params, ids, cache, *args, **kw):
            if kw.get("phase") != "decode":
                return super().forward(params, ids, cache, *args, **kw)
            torch.cuda.synchronize()
            held = None
            if not log:
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = super().forward(params, ids, cache, *args, **kw)
            torch.cuda.synchronize()
            log.append(dict(T=ids.shape[1], offset=int(cache.offset),
                            lengths=cache.length.tolist(), after=out[1].length.tolist(),
                            ms=(time.perf_counter() - t0) * 1e3, cache=cache, out=out[1],
                            state=None if out[2] is None else [dict(s) for s in out[2]],
                            held=held))
            return out

    return Recording(**{f.name: getattr(runner, f.name) for f in dataclasses.fields(runner)})


def decode_reading(torch, label, runner, params, log, report):
    """A pipeline run's decode rate (its one-token steps on the host clock)
    and one step's device breakdown over its last cache (idle share)."""
    steps = [e for e in log if e["T"] == 1]
    rate = len(steps) / (sum(e["ms"] for e in steps) / 1e3)
    report(f"    decode {rate:.1f} tok/s over {len(steps)} steps (host clock)")
    cache = log[-1]["cache"]
    tok = torch.full((cache.keys.shape[1], 1), 7, dtype=torch.long, device=cache.keys.device)
    breakdown(f"  {label}, one decode step", lambda: runner.forward(
        params, tok, cache, logits_last_only=True), 4, report, top=2)


def kvzap_surrogate(torch, cfg, gen, hidden: int = 512):
    """A seeded KVzap MLP surrogate (the trainer's default width) on the card."""
    L, E, Hkv = cfg.num_layers, cfg.hidden_size, cfg.num_kv_heads
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=gen.device,
                                     dtype=torch.float32)
    return {"w1": rnd(L, E, hidden) * E ** -0.5,
            "b1": torch.zeros((L, hidden), device=gen.device),
            "w2": rnd(L, hidden, Hkv) * hidden ** -0.5,
            "b2": torch.zeros((L, Hkv), device=gen.device)}


def layer0_scores(kt, cfg, params, ids, surrogate):
    """A KVzap surrogate's scores of layer 0 (B, H_kv, S): layer 0's post-ln1
    hidden states read only the embedding."""
    from kvpress_tpu_torch.models.llama import embed_tokens, rms_norm

    h = rms_norm(embed_tokens(params, ids, cfg), params.layers[0].ln1, cfg.rms_norm_eps,
                 cfg.rms_one_offset)
    return kt.presses.kvzap_apply(surrogate, 0, h)


def widest_gap(scores) -> float:
    """The midpoint of the widest gap between the sorted scores."""
    s = sorted(scores)
    return max((b - a, (a + b) / 2) for a, b in zip(s, s[1:]))[1]


def duo_split_decode(kt, torch, params, ids, duo, report):
    """Duo's split-cache decode against its masked decode over one 32K
    prefill: 32 greedy steps of the masked decode (the decode kernel over the
    keep-mask), the same steps over ``build_duo_split``'s two buffers
    (``duo_decode_step``, teacher-forced on the masked tokens), whose tokens
    must be the masked decode's and whose logits must lie within the depth-16
    limit of the kernel-against-dense checks; the split's decode launches and
    each route's step time. Returns the failures."""
    cfg = flagship_config(16)
    runner = kt.Runner.create(cfg, device=params.device)
    _, cache, _ = runner.prefill(params, ids, press=duo)
    cache = kt.resize(cache, cache.max_size + DUO_STEPS + 1)
    ds = kt.build_duo_split(cache, duo.streaming_mask(), DUO_SINK, DUO_RECENT, DUO_STEPS + 1)
    report(f"  duo split: retrieval buffer {tuple(ds.keys_r.shape)}, streaming buffer "
           f"{tuple(ds.keys_s.shape)}")
    masked, tok = clone_cache(cache), ids[:, -1:]
    toks, want = [], []
    for _ in range(DUO_STEPS):
        logits, masked, _ = runner.forward(params, tok, masked, logits_last_only=True)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        toks.append(tok)
        want.append(logits[:, -1])
    reset_counts()
    got, nexts = [], []
    for t in [ids[:, -1:]] + toks[:-1]:
        nxt, logits, ds = kt.duo_decode_step(params, t, ds, runner=runner)
        got.append(logits)
        nexts.append(nxt)
    torch.cuda.synchronize()
    launches = read_counts()
    read = rel(torch, torch.stack(got), torch.stack(want))
    same = sum(torch.equal(a, b) for a, b in zip(nexts, toks))
    report(f"  duo split decode, 32 steps: tokens equal to the masked decode's {same} of "
           f"{DUO_STEPS}; logits max |split - masked| / max |masked| {read:.3e} (limit "
           f"{REF_LIMIT[16]}); decode_attention launches {launches['decode_attention']} "
           f"({2 * cfg.num_layers} a step), decode_headwise {launches['decode_headwise']}")
    masked_ms = cuda_ms(lambda: runner.forward(params, tok, masked, logits_last_only=True), 8)
    split_ms = cuda_ms(lambda: kt.duo_decode_step(params, tok, ds, runner=runner), 8)
    report(f"  duo decode step (CUDA events): masked {masked_ms:.3f} ms, split {split_ms:.3f} ms")
    breakdown("duo masked decode step", lambda: runner.forward(
        params, tok, masked, logits_last_only=True), 4, report, top=2)
    breakdown("duo split decode step", lambda: kt.duo_decode_step(params, tok, ds,
                                                                 runner=runner), 4, report, top=2)
    failures = []
    if same != DUO_STEPS or not read <= REF_LIMIT[16]:
        failures.append(f"duo split decode: {same} of {DUO_STEPS} tokens equal, logits {read:.3e}")
    if launches["decode_attention"] != 2 * cfg.num_layers * DUO_STEPS:
        failures.append(f"duo split decode: {launches['decode_attention']} decode launches")
    return failures


def mask_presses_run(kt, torch, tokenizer_cls, params, report, labels=None):
    """The mask, merge and head-split presses through ``KVPressPipeline`` at
    the flagship shape (16 layers, bf16 weights), a 32,768-token context, the
    two questions and 32 new tokens (the runs of ``labels`` alone when it is
    given), each run's launch counts set to 0 before it and read after it:

    - Merging over Knorm, SnapKV and ExpectedAttention at 0.5 (the registry's
      ``merging_*``): 16,384 a layer, the Knorm run's kept keys bit-equal to
      KnormPress(0.5)'s, a merged value in every layer; the peak memory of
      one layer's merge;
    - LUKV over ExpectedAttention with a seeded (99, 16, 8) budget curve
      written to a ``.npy`` and read back by ``load_budget_curve``: the
      per-head kept counts equal ``_head_keep_counts``;
    - SimLayerKV with its threshold in the widest gap between the layers'
      lazy scores on this context: lazy layers keep 1,027, the others all;
    - Finch in the query-aware form (context, delimiter, the 152-token
      question; no question): window 152, keys rerotated, the kept count its
      ``max_kept``, the first decode step from the compressed length;
    - Duo with seeded (16, 8) head scores at 0.5, sink 128, recent 256: the
      masked fraction its closed form; its split-cache decode against the
      masked decode (``duo_split_decode``);
    - DMS over a seeded KVzap MLP surrogate, the threshold the median of
      layer 0's scores: mask only on the standard runner (``compact_masked``
      over the cache grown by 64 slots keeps each layer's longest head), and
      ``compact=True`` on the head-wise runner (each layer as long as its
      longest head; decode on ``decode_headwise``);
    - chunked by 8,192: Duo over int8 KV (its mask bit-equal to one-shot),
      DMS(KVzap) over int8 KV (layer 0's mask bit-equal to one-shot; the
      deeper layers' score drift within the depth-16 limit, the flips
      counted), SimLayerKV over bf16 (the same lazy layers), Finch over bf16
      (the same kept count; the overlap of the kept slots);
    - the refusals (``mask_press_refusals``).
    Each run prints its prefill wall and peak memory, one layer's
    ``layer_compress`` on a captured 32K layer (profiler device ms), its
    decode rate and one decode step's idle share. Returns the summed launch
    counts."""
    import numpy as np

    cfg = flagship_config(16)
    L, Hkv, S = cfg.num_layers, cfg.num_kv_heads, CONTEXT_TOKENS
    half = S // 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    rng = np.random.default_rng(14)
    tok = tokenizer_cls(vocab_size=cfg.vocab_size)
    context = " ".join(f"w{i}" for i in range(S))
    runners = {"standard": kt.Runner.create(cfg, device=dev),
               "headwise": kt.Runner.create(cfg, decode_kernel=False, headwise_kernel=True,
                                            device=dev)}
    want = lambda label: labels is None or label in labels
    totals = {name: 0 for name in read_counts()}
    failures = []
    # the pipeline's context ids (the BOS joins the first word)
    ids = torch.tensor([tok.encode(tok.bos_token + context)], device=dev)
    layer_args = None
    if labels is None:
        layer_args = capture_layer(kt, torch, runners["standard"], params, ids, 1)

    def run(label, kind, press, needed, unwanted, summarize=None, **kw):
        """One pipeline run with its readings; returns (the prefill's log
        entry, the decode log)."""
        prefills, log = [], []
        runner = decode_recorder(runners[kind], log)
        pipe = kt.KVPressPipeline(timed_runner(kt, torch, runner, prefills, summarize), params,
                                  tok)
        kw.setdefault("context", context)
        if "question" in kw:
            reset_counts()
            t0 = time.perf_counter()
            answer = pipe(press=press, max_new_tokens=32, **kw)["answer"]
            torch.cuda.synchronize()
            counts = read_counts()
            report(f"  {label}: {time.perf_counter() - t0:.2f} s in all, "
                   f"{prefill_reading(prefills)}, layer lengths {sorted(set(prefills[-1][3]))}, "
                   f"launches {launched(counts)}, answer tokens {len(answer.split())}")
            if not answer:
                raise AssertionError(f"{label}: empty answer")
            check_run(label, counts, needed, unwanted)
        else:
            counts, _, _ = pipeline_run(kt, torch, label, pipe, prefills, needed, unwanted,
                                        report, press=press, **kw)
        for name, n in counts.items():
            totals[name] += n
        if layer_args is not None and not kw.get("context_chunk"):
            ctx, keys, values = layer_args
            mask = torch.ones(keys.shape[:3], dtype=torch.bool, device=dev)
            p = press.with_window(152) if hasattr(press, "with_window") else press
            report("    " + layer_reading("layer_compress", lambda: p.layer_compress(
                ctx, keys, values, keys.shape[2], mask), L, iters=1))
        decode_reading(torch, label, runner, params, log, report)
        return prefills[-1], log

    # the kernels each run must launch, on the payload its options ask for,
    # and those it must not
    std = ("flash_attention_bf16", "decode_attention_bf16")
    std_no = ("decode_headwise", "flash_attention_quant", "decode_attention_int8",
              "decode_attention_int4")
    hw, hw_no = ("flash_attention_bf16", "decode_headwise_bf16"), ("decode_attention",)
    int8 = ("flash_attention_quant_int8", "decode_attention_int8")
    int8_no = ("decode_headwise", "flash_attention_quant_int4", "decode_attention_bf16",
               "decode_attention_int4")
    chunked8 = dict(context_chunk=CHUNK_TOKENS, quantized=True, kv_bits=8)

    # Merging
    for name, inner in (("merging_knorm", kt.KnormPress(0.5)),
                        ("merging_snapkv", kt.SnapKVPress(0.5)),
                        ("merging_expected_attention",
                         kt.ExpectedAttentionPress(0.5, epsilon=1e-2))):
        if not want(name):
            continue
        press = kt.MergingPress(inner)
        pre, _ = run(name, "standard", press, std, std_no,
                     summarize=lambda c: (c.keys[:, :, :, :half].clone(),
                                          c.values[:, :, :, :half].clone()))
        if set(pre[3]) != {half}:
            failures.append(f"{name}: layer lengths {sorted(set(pre[3]))}")
        k_m, v_m = pre[4]
        if name == "merging_knorm":
            _, c, _ = runners["standard"].prefill(params, ids, press=kt.KnormPress(0.5))
            same = torch.equal(k_m, c.keys[:, :, :, :half])
            changed = (v_m != c.values[:, :, :, :half]).any(-1).any(-1).any(-1)
            del c
            report(f"    kept keys bit-equal to KnormPress(0.5)'s: {same}; layers with a "
                   f"merged value {int(changed.sum())} of {L}")
            if not same or not bool(changed.all()):
                failures.append(f"{name}: kept keys equal {same}, layers with a merged value "
                                f"{changed.tolist()}")
        if layer_args is not None:
            ctx, keys, values = layer_args
            mask = torch.ones(keys.shape[:3], dtype=torch.bool, device=dev)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            merged = press.layer_compress(ctx, keys, values, S, mask)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - held
            plain = inner.layer_compress(ctx, keys, values, S, mask)
            n_changed = int((merged[1][:, :, :half] != plain[1][:, :, :half]).any(-1).sum())
            report(f"    one layer's merge at 32K: peak {peak / 2**30:.3f} GiB over the "
                   f"{held / 2**30:.3f} GiB held (similarity slices of "
                   f"{kt.presses.merging.SIM_BYTES >> 20} MiB); {n_changed} of {Hkv * half} "
                   f"kept values merged in the captured layer")
            if n_changed == 0:
                failures.append(f"{name}: no kept value of the captured layer changed")
            del merged, plain
        del k_m, v_m
        torch.cuda.empty_cache()

    # LUKV: a seeded stand-in for the paper's curve, read back from a .npy
    if want("lukv"):
        path = ROOT / "build" / "lukv_budget_curve.npy"
        path.parent.mkdir(parents=True, exist_ok=True)
        np.save(path, rng.uniform(0.2, 0.8, (99, L, Hkv)).astype(np.float32))
        press = kt.LUKVPress(kt.ExpectedAttentionPress(0.5, epsilon=2e-2), compression_ratio=0.5,
                             sink=4, window=1, budget_curves=kt.load_budget_curve(str(path)))
        pre, _ = run("lukv", "standard", press, std, std_no,
                     summarize=lambda c: (c.mask.sum(-1)[:, 0].cpu(),
                                          float(kt.masked_fraction(c))))
        counts, fraction = pre[4]
        expect = torch.stack([press._head_keep_counts(l, S, Hkv) for l in range(L)])
        report(f"    masked fraction {fraction:.6f}; kept per head in layer 0 "
               f"{counts[0].tolist()} (_head_keep_counts {expect[0].tolist()})")
        if not torch.equal(counts, expect):
            failures.append(f"lukv: kept per head {counts.tolist()} against _head_keep_counts "
                            f"{expect.tolist()}")

    # SimLayerKV: each layer's lazy score on this context; the threshold in
    # the widest gap
    if want("simlayerkv") or want("chunked simlayerkv"):
        scores = []

        class RecordingLazy(kt.SimLayerKVPress):
            def lazy_score(self, ctx, keys, length):
                s = super().lazy_score(ctx, keys, length)
                scores.append(float(s))
                return s

        runners["standard"].prefill(params, ids, press=RecordingLazy(0.5))
        threshold = widest_gap(scores)
        lazy_lengths = [LAZY_KEEP if s > threshold else S for s in scores]
        report(f"  SimLayerKV lazy scores per layer {[round(s, 4) for s in scores]}; threshold "
               f"{threshold:.4f} (the widest gap); lazy layers "
               f"{[l for l, n in enumerate(lazy_lengths) if n == LAZY_KEEP]}")
        if LAZY_KEEP not in lazy_lengths or S not in lazy_lengths:
            failures.append(f"simlayerkv: no mix of lazy and whole layers ({lazy_lengths})")
        press = kt.SimLayerKVPress(threshold)
        for label, kw in (("simlayerkv", {}),
                          ("chunked simlayerkv", dict(context_chunk=CHUNK_TOKENS))):
            if want(label):
                pre, _ = run(label, "standard", press, std, std_no, **kw)
                if pre[3] != lazy_lengths:
                    failures.append(f"{label}: layer lengths {pre[3]}, not {lazy_lengths}")
        torch.cuda.empty_cache()

    # Finch, query-aware: the context, the delimiter, the 152-token question;
    # no question
    finch_keep = {}
    window = len(QUESTIONS[0].split())
    n_ctx = S + window                   # the delimiter stripped
    for label, kw in (("finch", {}), ("chunked finch", dict(context_chunk=CHUNK_TOKENS))):
        if not want(label):
            continue

        class RecordingFinch(kt.FinchPress):
            def score(self, ctx, keys, values):
                s = super().score(ctx, keys, values)
                finch_keep.setdefault(label, []).append(
                    torch.zeros_like(s, dtype=torch.bool).scatter_(
                        -1, kt.presses.base.order_desc(s.float(), self.max_kept(keys.shape[2],
                                                                                None)), True))
                return s

            def _chunked_keep(self, ctx, keys, length):
                keep, total = super()._chunked_keep(ctx, keys, length)
                finch_keep.setdefault(label, []).append(keep[..., :n_ctx].clone())
                return keep, total

        press = RecordingFinch(0.5, delimiter_token_id=tok.eos_token_id)
        kept = press.with_window(window).max_kept(n_ctx, cfg)
        pre, log = run(label, "standard", press, std, std_no,
                       context=context + f" {tok.eos_token} " + QUESTIONS[0], question="", **kw)
        report(f"    window {window}, kept {sorted(set(pre[3]))} of {n_ctx} (max_kept {kept}); "
               f"the first decode step from offset {log[0]['offset']}")
        if set(pre[3]) != {kept} or log[0]["offset"] != kept:
            failures.append(f"{label}: lengths {sorted(set(pre[3]))}, first decode offset "
                            f"{log[0]['offset']}, not {kept}")
    if len(finch_keep) == 2:
        overlap = [int((a & b).sum()) / int(a.sum())
                   for a, b in zip(finch_keep["finch"][:L], finch_keep["chunked finch"])]
        report(f"  Finch, chunked against one-shot: share of the one-shot kept slots kept, per "
               f"layer {[round(o, 4) for o in overlap]}")
    del finch_keep

    # Duo: masked decode through the pipeline, then the split-cache decode
    duo = kt.DuoAttentionPress(0.5, sink_size=DUO_SINK, recent_size=DUO_RECENT,
                               head_scores=rng.standard_normal((L, Hkv)).astype(np.float32))
    n_stream = int(duo.streaming_mask().sum())
    duo_mask = None
    if want("duo"):
        pre, _ = run("duo", "standard", duo, std, std_no,
                     summarize=lambda c: (c.mask.clone(), float(kt.masked_fraction(c))))
        duo_mask, fraction = pre[4]
        closed = n_stream * (S - DUO_SINK - DUO_RECENT) / (L * Hkv * S)
        report(f"    masked fraction {fraction:.7f}, closed form {closed:.7f} ({n_stream} "
               f"streaming heads of {L * Hkv})")
        if abs(fraction - closed) > 1e-6:
            failures.append(f"duo: masked fraction {fraction} against {closed}")
    if want("duo") or want("duo split"):
        failures += duo_split_decode(kt, torch, params, ids, duo, report)
        torch.cuda.empty_cache()
    if want("chunked duo, int8 KV"):
        pre, _ = run("chunked duo, int8 KV", "standard", duo, int8, int8_no,
                     summarize=lambda c: c.mask.clone(), **chunked8)
        same = None if duo_mask is None else torch.equal(pre[4], duo_mask)
        report(f"    chunked mask bit-equal to one-shot: {same}")
        if same is False:
            failures.append("chunked duo: the mask differs from one-shot")
    del duo_mask
    torch.cuda.empty_cache()

    # DMS over a seeded KVzap surrogate, the threshold the median of layer 0
    surrogate = kvzap_surrogate(torch, cfg, gen)
    threshold = float(layer0_scores(kt, cfg, params, ids, surrogate).median())
    report(f"  DMS(KVzap): threshold {threshold:.6f}, the median of layer 0's scores")

    def dms(log, compact=False):
        class RecordingDMS(kt.DMSPress):
            def _evict(self, scores, S_, S_buf):
                log.append(scores)
                return super()._evict(scores, S_, S_buf)

        return RecordingDMS(kt.KVzapPress(surrogate=surrogate), threshold=threshold,
                            compact=compact)

    def compacted(cache):
        """(the prefill's mask, each layer's longest head, compact_masked's
        lengths over the cache grown by 64 slots, mask True past length)."""
        valid = torch.arange(cache.max_size, device=dev) < cache.length.to(dev)[:, None,
                                                                                None, None]
        longest = (cache.mask & valid).sum(-1).amax(dim=(1, 2)).tolist()
        grown = kt.compact_masked(kt.resize(clone_cache(cache), cache.max_size + 64))
        return cache.mask.clone(), longest, grown.length.tolist()

    one_shot = {}
    if want("dms"):
        log = []
        pre, _ = run("dms", "standard", dms(log), std, std_no, summarize=compacted)
        one_shot = dict(mask=pre[4][0], scores=torch.stack(log[:L]))
        _, longest, lengths = pre[4]
        report(f"    masked fraction {1 - one_shot['mask'].float().mean().item():.4f}; "
               f"compact_masked over the grown cache: layer lengths {lengths}")
        if lengths != longest:
            failures.append(f"compact_masked: layer lengths {lengths}, longest heads {longest}")
    if want("dms, compact"):
        pre, log = run("dms, compact", "headwise", dms([], compact=True), hw, hw_no,
                       summarize=compacted)
        _, longest, _ = pre[4]
        report(f"    layer lengths after compact_masked {log[0]['lengths']} (each layer's "
               f"longest head)")
        if log[0]["lengths"] != longest:
            failures.append(f"dms compact: layer lengths {log[0]['lengths']}, longest heads "
                            f"{longest}")
    if want("chunked dms, int8 KV"):
        log = []
        pre, _ = run("chunked dms, int8 KV", "standard", dms(log), int8, int8_no,
                     summarize=lambda c: c.mask.clone(), **chunked8)
        if one_shot:
            failures += dms_flips(torch, one_shot, pre[4], log[0], threshold, report)
    del one_shot
    torch.cuda.empty_cache()

    if labels is None:
        failures += mask_press_refusals(kt, torch, tok, params, runners["standard"], report)
    del layer_args
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return totals


def dms_flips(torch, one_shot, mask, scores, threshold, report):
    """Chunked DMS (int8 KV) against one-shot (bf16 KV): layer 0's mask must
    be bit-equal (its hidden states read only the embedding); deeper, the
    chunks' hidden states move with the quantized KV and the rounding, so a
    bit may flip where the score moved across the threshold: the flips are
    counted and the scores' drift, max |chunked - one-shot| / max |one-shot|,
    must stay within the depth-16 limit. Returns the failures."""
    W = 128
    S = scores.shape[-1]
    s1 = one_shot["scores"]
    drift = ((scores - s1).abs().amax(dim=(1, 2, 3)) / s1.abs().amax(dim=(1, 2, 3))).tolist()
    flips = (mask[..., :S - W] != one_shot["mask"][..., :S - W]).sum(dim=(1, 2, 3)).tolist()
    near = ((s1[..., :S - W] - threshold).abs() <= (scores - s1)[..., :S - W].abs()).sum(
        dim=(1, 2, 3)).tolist()
    report(f"    chunked against one-shot: flipped bits per layer {flips} (slots whose one-shot "
           f"score lies within its drift of the threshold: {near}); score drift per layer "
           f"{[f'{d:.2e}' for d in drift]} (limit {REF_LIMIT[16]})")
    failures = []
    if flips[0] != 0:
        failures.append(f"chunked dms: layer 0's mask differs from one-shot ({flips[0]} bits)")
    if not max(drift) <= REF_LIMIT[16]:
        failures.append(f"chunked dms: score drift {max(drift):.3e}")
    return failures


def mask_press_refusals(kt, torch, tok, params, runner, report):
    """MergingPress under context_chunk (TypeError) and each press of this
    slice under context_bucket (ValueError, raised in layer 0's
    layer_compress). Returns the failures."""
    import numpy as np

    failures = []
    pipe = kt.KVPressPipeline(runner, params, tok)
    context = " ".join(f"w{i}" for i in range(BUCKET_CONTEXT))
    knorm = kt.KnormPress(0.5)
    cases = [("Merging under context_chunk", TypeError, lambda: pipe(
        context, question=QUESTIONS[1], press=kt.MergingPress(knorm),
        context_chunk=CHUNK_TOKENS, max_new_tokens=2))]
    cfg = runner.cfg
    for name, press in (
            ("Merging", kt.MergingPress(knorm)),
            ("LUKV", kt.LUKVPress(knorm, compression_ratio=0.5, budget_curves=np.full(
                (99, cfg.num_layers, cfg.num_kv_heads), 0.5, np.float32))),
            ("SimLayerKV", kt.SimLayerKVPress(0.5)),
            ("Finch", kt.FinchPress(0.5, window_size=8)),
            ("Duo", kt.DuoAttentionPress(0.5, head_scores=np.arange(
                cfg.num_layers * cfg.num_kv_heads, dtype=np.float32).reshape(cfg.num_layers, -1))),
            ("DMS", kt.DMSPress(knorm))):
        cases.append((f"{name} under context_bucket={BUCKET}", ValueError,
                      lambda p=press: pipe(context, question=QUESTIONS[1], press=p,
                                           context_bucket=BUCKET, max_new_tokens=2)))
    for label, error, call in cases:
        try:
            call()
        except error as e:
            report(f"  {label}: refused ({type(e).__name__}: {str(e)[:110]})")
        else:
            failures.append(f"{label} was not refused")
        torch.cuda.empty_cache()
    return failures


def compact_masked_check(kt, torch, tokenizer_cls, params, report):
    """DMS(KVzap) mask only through the pipeline at 32K: ``compact_masked``
    over its cache grown by 64 slots must keep each layer's longest head."""
    return mask_presses_run(kt, torch, tokenizer_cls, params, report, labels=("dms",))


def duo_split_check(kt, torch, tokenizer_cls, params, report):
    """Duo's split-cache decode against its masked decode at 32K."""
    return mask_presses_run(kt, torch, tokenizer_cls, params, report, labels=("duo split",))


# --------------------------------------------------------------------- #
# Phase 3, the decode-time presses at the flagship shape.

DEC_INTERVAL, DEC_TARGET, DEC_BUFFER = 16, 16384, 256
# The dense-path check's scale (2,048 tokens): interval 8, target 1,024, and
# 16 teacher-forced steps after the 150-token question (call 1), so that
# calls 8 and 16 compress.
DEC_REF_INTERVAL, DEC_REF_TARGET, DEC_REF_STEPS = 8, 1024, 16


def compressed_calls(log) -> list[int]:
    """The 1-based decode-phase calls (1: the question forward) after which
    some layer is shorter than before plus its new tokens."""
    return [i + 1 for i, e in enumerate(log)
            if any(a < b + e["T"] for a, b in zip(e["after"], e["lengths"]))]


def step_readings(torch, label, runner, params, log, press, report, interval=None,
                  plain=False):
    """Readings of a decode-time run: the decode steps' host ms with and
    without a compression in them (the pipeline's own steps), the peak memory
    of the decode over what was held, and the device breakdown (profiler:
    busy ms, idle share, the largest kernels) of one step that compresses
    and, with ``plain``, of one that does not, taken from the run's last
    cache and state (``steps`` set to ``interval - 1`` and to 0; DMS evicts
    in every step)."""
    steps = [e for e in log if e["T"] == 1]
    hit = set(compressed_calls(log))
    with_c = [e["ms"] for i, e in enumerate(log) if e["T"] == 1 and i + 1 in hit]
    without = [e["ms"] for i, e in enumerate(log) if e["T"] == 1 and i + 1 not in hit]
    peak = torch.cuda.max_memory_allocated() - log[0]["held"]
    med = lambda xs: f"{statistics.median(xs):.2f} ms (n={len(xs)})" if xs else "none"
    report(f"    decode steps (host clock): {len(steps)}, with a compression {med(with_c)}, "
           f"without {med(without)}; the question forward {log[0]['ms']:.2f} ms; decode peak "
           f"{peak / 2**30:.3f} GiB over the {log[0]['held'] / 2**30:.3f} GiB held")
    cache, state = log[-1]["out"], log[-1]["state"]
    tok = torch.full((cache.keys.shape[1], 1), 7, dtype=torch.long, device=cache.keys.device)
    forms = {"a step that compresses": interval and interval - 1}
    if plain:
        forms["a step that does not"] = 0
    if interval is None:
        forms = {"a step (it evicts)": None}
    for what, n in forms.items():
        def fn(n=n):
            st = [dict(s) if n is None else dict(s, steps=n) for s in state]
            return runner.forward(params, tok, cache, press=press, press_state=st,
                                  phase="decode", logits_last_only=True)
        did = any(a <= b for a, b in zip(fn()[1].length.tolist(), cache.length.tolist()))
        if n and not did:
            what += " (it did not: the target no longer binds at this length)"
        breakdown(f"  {label}, {what}", fn, 3, report, top=4)


def recording_cam(kt, log: list, **kw):
    """A CAMPress whose merges append, without a device sync, whether they
    changed a value."""
    class Recording(kt.CAMPress):
        def merge(self, keys, values, *args):
            merged = super().merge(keys, values, *args)
            log.append((merged != values).any())
            return merged

    return Recording(**kw)


def gather_check(kt, torch, runner, params, cache, state, press, report):
    """One compressing step over a quantized cache (from the run's last cache
    and state, ``steps`` at ``interval - 1``): in every layer the kept
    payload and scale rows must be bit-equal to a gather of the
    pre-compression payload (the appended token included) at the kept slots,
    those of ``order_desc`` of the press's scores. Returns the failures."""
    from kvpress_tpu_torch.presses.base import order_desc

    seen, equal = [], []

    class Checking(type(press)):
        def _score_buffer(self, *args):
            scores = super()._score_buffer(*args)
            seen.append(scores)
            return scores

        def decode_compress_quantized(self, ctx, keys, values, ks, vs, bits, length, mask,
                                      st):
            before = [t.clone() for t in (keys, values, ks, vs)]
            out = super().decode_compress_quantized(ctx, keys, values, ks, vs, bits, length,
                                                    mask, st)
            n = out[4]
            idx = order_desc(seen.pop(), n)
            for got, src in zip(out[:4], before):
                want = torch.gather(src, 2, idx[..., None].expand(*idx.shape, src.shape[-1]))
                equal.append(torch.equal(got[:, :, :n], want))
            return out

    checking = Checking(**{f.name: getattr(press, f.name) for f in dataclasses.fields(press)})
    tok = torch.full((cache.keys.shape[1], 1), 7, dtype=torch.long, device=cache.keys.device)
    st = [dict(s, steps=press.compression_interval - 1) for s in state]
    runner.forward(params, tok, clone_cache(cache), press=checking, press_state=st,
                   phase="decode", logits_last_only=True)
    L = runner.cfg.num_layers
    report(f"    gather check, int{cache.bits}: kept payload and scale rows bit-equal to the "
           f"gather at the kept slots in {sum(equal)} of {4 * L} (layer, tensor) pairs")
    return [] if len(equal) == 4 * L and all(equal) else [
        f"gather check int{cache.bits}: {sum(equal)} of {len(equal)} equal"]


def masked_launches(torch):
    """A context manager under which each ``decode_attention`` launch of the
    runner appends to the returned list whether its keep-mask had a clear
    bit among its valid slots (a device tensor: no sync)."""
    from kvpress_tpu_torch.models import llama

    seen = []
    original = llama.decode_attention

    @contextlib.contextmanager
    def patched():
        def wrapper(q, k, v, length, *args, **kw):
            mask = kw.get("mask", args[2] if len(args) > 2 else None)
            seen.append(torch.zeros((), dtype=torch.bool, device=q.device) if mask is None
                        else ~mask[..., :int(length)].all())
            return original(q, k, v, length, *args, **kw)

        llama.decode_attention = wrapper
        try:
            yield seen
        finally:
            llama.decode_attention = original

    return patched()


def decode_presses_run(kt, torch, tokenizer_cls, params, report):
    """The decode-time presses through ``KVPressPipeline`` at the flagship
    shape (16 layers, bf16 weights), a 32,768-token context, the 152-token
    question and 32 new tokens (a decode-time press takes one question), each
    run's launch counts set to 0 before it and read after it:

    (a) DecodingPress(Knorm, interval 16, target 16,384, buffer 256), bf16 KV:
        compressions after calls 16 and 32 (call 1 the question forward),
        every layer at 16,384 after each and in [16,384, 16,400) at the end;
    (b) the same over int8 and int4 KV, with ``gather_check``;
    (c) CompressionRatioDecodingPress(Knorm, 0.5, interval 16): after each
        compression every layer at ``float32_budget`` of the tokens seen;
    (d) PrefillDecodingPress(SnapKV(0.5), DecodingPress(Knorm, interval 16,
        target 8,192)): 16,384 after the prefill, [8,192, 8,208) at the end;
    (e) CAMPress(Knorm, interval 16, target 16,384, merge budget 32), bf16 and
        int8 KV (the dense route: the layer requantized every step): a merged
        value in every compressing call;
    (f) DMS(KVzap MLP surrogate) with ``decoding=True``, the threshold the
        median of layer 0's scores, int8 KV, one-shot and chunked by 8,192:
        the masked fraction grows in the decode, every decode launch masked;
    (g) (a)'s press chunked by 8,192 with bf16 KV;
    (h) the Gemma-3-12B body cut to 6 layers (five sliding, one global) with
        (a)'s press: the sliding layers keep every token, the global one
        compresses;
    then the refusals (``decode_press_refusals``). Each run prints its launches
    by kernel, its prefill wall and peak, the decode steps' host ms with and
    without a compression, the decode's peak over what was held, and the
    device breakdown and idle share of a compressing and a plain step. Returns
    the summed launch counts."""
    from kvpress_tpu_torch.presses.base import float32_budget

    cfg = flagship_config(16)
    L, S = cfg.num_layers, CONTEXT_TOKENS
    dev = params.device
    gen = torch.Generator(device=dev).manual_seed(16)
    tok = tokenizer_cls(vocab_size=cfg.vocab_size)
    context = " ".join(f"w{i}" for i in range(S))
    question = QUESTIONS[0]
    runner = kt.Runner.create(cfg, device=dev)
    totals = {name: 0 for name in read_counts()}
    failures = []

    def decoding(target=DEC_TARGET):
        return kt.DecodingPress(kt.KnormPress(), compression_interval=DEC_INTERVAL,
                                target_size=target, hidden_states_buffer_size=DEC_BUFFER)

    def run(label, press, expect, r=runner, p=params, t=tok, interval=DEC_INTERVAL,
            summarize=None, plain=False, **kw):
        """One pipeline run; ``expect(n_steps)`` gives the launch counts it must
        read exactly, and every kernel it does not name must not launch; with
        ``plain`` a step without a compression is profiled too. Returns (the
        prefill's log entry, the decode log, the answer)."""
        prefills, log = [], []
        rec = decode_recorder(r, log)
        pipe = kt.KVPressPipeline(timed_runner(kt, torch, rec, prefills, summarize), p, t)
        reset_counts()
        t0 = time.perf_counter()
        answer = pipe(context, question=question, press=press, max_new_tokens=32,
                      **kw)["answer"]
        torch.cuda.synchronize()
        counts = read_counts()
        n_steps = sum(e["T"] == 1 for e in log)
        report(f"  {label}: {time.perf_counter() - t0:.2f} s in all, "
               f"{prefill_reading(prefills)}, layer lengths after the prefill "
               f"{sorted(set(prefills[-1][3]))}, after the last call "
               f"{sorted(set(log[-1]['after']))}, compressed after calls "
               f"{compressed_calls(log)}, launches {launched(counts)}, answer tokens "
               f"{len(answer.split())}")
        if not answer:
            raise AssertionError(f"{label}: empty answer")
        want = expect(n_steps)
        failures.extend(f"{label}: {name} launched {counts[name]}, not {n}"
                        for name, n in want.items() if counts[name] != n)
        failures.extend(f"{label}: {name} launched {counts[name]} times" for name in counters()
                        if name not in want and counts[name])
        for name, n in counts.items():
            totals[name] += n
        step_readings(torch, label, r, p, log, press, report,
                      interval=interval if hasattr(press, "compression_interval")
                      or hasattr(press, "decoding_press") else None, plain=plain)
        return prefills[-1], log, answer

    def lengths_in(label, log, lo, hi, layers=None):
        final = log[-1]["after"]
        layers = range(len(final)) if layers is None else layers
        if not all(lo <= final[l] < hi for l in layers):
            failures.append(f"{label}: final layer lengths {final}, not in [{lo}, {hi})")

    def at_calls(label, log, want_calls):
        """Compressions after calls 16 and 32 (those reached: an EOS may end
        the answer first)."""
        reached = [c for c in want_calls if c <= len(log)]
        got = compressed_calls(log)
        report(f"    layer lengths after each compression: "
               + "; ".join(f"call {c}: {sorted(set(log[c - 1]['after']))}" for c in got))
        if got != reached:
            failures.append(f"{label}: compressed after calls {got}, not {reached}")

    bf16 = lambda n: {"flash_attention_bf16": 2 * L, "flash_attention": 2 * L,
                      "decode_attention_bf16": n * L, "decode_attention": n * L}
    calls = (DEC_INTERVAL, 2 * DEC_INTERVAL)

    # (a), (b): DecodingPress over bf16, int8 and int4 KV
    for label, kw, expect in (
            ("(a) DecodingPress(Knorm), bf16 KV", {}, bf16),
            ("(b) DecodingPress(Knorm), int8 KV", dict(quantized=True, kv_bits=8),
             lambda n: {"flash_attention_quant_int8": 2 * L, "flash_attention_quant": 2 * L,
                        "decode_attention_int8": n * L, "decode_attention": n * L}),
            ("(b) DecodingPress(Knorm), int4 KV", dict(quantized=True, kv_bits=4),
             lambda n: {"flash_attention_bf16": 2 * L, "flash_attention": 2 * L,
                        "decode_attention_int4": n * L, "decode_attention": n * L})):
        press = decoding()
        _, log, _ = run(label, press, expect, plain=not kw, **kw)
        at_calls(label, log, calls)
        for c in compressed_calls(log):
            if set(log[c - 1]["after"]) != {DEC_TARGET}:
                failures.append(f"{label}: lengths {log[c - 1]['after']} after call {c}")
        lengths_in(label, log, DEC_TARGET, DEC_TARGET + DEC_INTERVAL)
        if kw:
            failures += gather_check(kt, torch, runner, params, log[-1]["out"],
                                     log[-1]["state"], press, report)
        del log
        torch.cuda.empty_cache()

    # (c) CompressionRatioDecodingPress
    label = "(c) CompressionRatioDecodingPress(Knorm, 0.5)"
    _, log, _ = run(label, kt.CompressionRatioDecodingPress(
        kt.KnormPress(), target_compression_ratio=0.5, compression_interval=DEC_INTERVAL), bf16)
    at_calls(label, log, calls)
    for c in compressed_calls(log):
        e = log[c - 1]
        want = float32_budget(e["offset"] + e["T"], 0.5)
        report(f"    call {c}: {e['offset'] + e['T']} tokens seen, target {want}")
        if set(e["after"]) != {want}:
            failures.append(f"{label}: lengths {e['after']} after call {c}, not {want}")
    del log

    # (d) PrefillDecodingPress: SnapKV in the prefill, Knorm in the decode
    half = DEC_TARGET // 2
    label = f"(d) PrefillDecodingPress(SnapKV(0.5), DecodingPress(Knorm, {half}))"
    pre, log, _ = run(label, kt.PrefillDecodingPress(kt.SnapKVPress(0.5), decoding(half)), bf16)
    at_calls(label, log, calls)
    if set(pre[3]) != {S // 2}:
        failures.append(f"{label}: prefill lengths {sorted(set(pre[3]))}")
    lengths_in(label, log, half, half + DEC_INTERVAL)
    del log
    torch.cuda.empty_cache()

    # (e) CAM over bf16 and int8 KV
    for label, kw, expect in (
            ("(e) CAMPress(Knorm), bf16 KV", {}, bf16),
            ("(e) CAMPress(Knorm), int8 KV (dense route)", dict(quantized=True, kv_bits=8),
             lambda n: {"flash_attention_quant_int8": L, "flash_attention_quant": L,
                        "flash_attention_bf16": L, "flash_attention": L,
                        "decode_attention_int8": n * L, "decode_attention": n * L})):
        merges = []
        press = recording_cam(kt, merges, base_press=kt.KnormPress(),
                              compression_interval=DEC_INTERVAL, target_size=DEC_TARGET,
                              merge_budget=32)
        _, log, _ = run(label, press, expect, plain=True, **kw)
        at_calls(label, log, calls)
        lengths_in(label, log, DEC_TARGET, DEC_TARGET + DEC_INTERVAL)
        n_merged = int(torch.stack(merges[:L * len(compressed_calls(log))]).sum())
        report(f"    compressions with a merged value: {n_merged} of "
               f"{L * len(compressed_calls(log))} (layer, call) pairs")
        if n_merged == 0:
            failures.append(f"{label}: no value merged")
        del log
        torch.cuda.empty_cache()

    # (f) DMS(KVzap) decoding, int8 KV, one-shot and chunked
    ids = torch.tensor([tok.encode(tok.bos_token + context)], device=dev)
    surrogate = kvzap_surrogate(torch, cfg, gen)
    threshold = float(layer0_scores(kt, cfg, params, ids, surrogate).median())
    report(f"  DMS(KVzap), decoding: threshold {threshold:.6f}, the median of layer 0's scores")
    dms = kt.DMSPress(kt.KVzapPress(surrogate=surrogate), threshold=threshold, decoding=True)
    def masked_slots(c):
        """(the masked fraction, the masked slots below the lengths)."""
        valid = torch.arange(c.max_size, device=dev) < c.length.to(dev)[:, None, None, None]
        return float(kt.masked_fraction(c)), int((valid & ~c.mask).sum())

    for label, kw, expect in (
            ("(f) DMS(KVzap), decoding, int8 KV", dict(quantized=True, kv_bits=8),
             lambda n: {"flash_attention_bf16": 2 * L, "flash_attention": 2 * L,
                        "decode_attention_int8": n * L, "decode_attention": n * L}),
            ("(f) DMS(KVzap), decoding, int8 KV, chunked", dict(
                quantized=True, kv_bits=8, context_chunk=CHUNK_TOKENS),
             lambda n: {"flash_attention_quant_int8": (S // CHUNK_TOKENS) * L,
                        "flash_attention_quant": (S // CHUNK_TOKENS) * L,
                        "flash_attention_bf16": L, "flash_attention": L,
                        "decode_attention_int8": n * L, "decode_attention": n * L})):
        with masked_launches(torch) as masked:
            pre, log, _ = run(label, dms, expect, summarize=masked_slots, **kw)
        (f0, before), (f1, after) = pre[4], masked_slots(log[-1]["out"])
        left = sum(e["T"] for e in log) * L * cfg.num_kv_heads
        n_masked = int(torch.stack(masked).sum()) if masked else 0
        report(f"    masked slots after the prefill {before} (fraction {f0:.6f}), after the "
               f"decode {after} ({f1:.6f}): {after - before} of the {left} (layer, head) slots "
               f"that left the window were evicted in the decode; decode launches with a clear "
               f"keep bit {n_masked} of {len(masked)}")
        if not after > before or not masked or n_masked != len(masked):
            failures.append(f"{label}: masked slots {before} -> {after}, masked launches "
                            f"{n_masked} of {len(masked)}")
        del log
        torch.cuda.empty_cache()

    # (g) DecodingPress chunked, bf16 KV
    label = "(g) DecodingPress(Knorm), bf16 KV, chunked"
    n_chunks = S // CHUNK_TOKENS
    _, log, _ = run(label, decoding(), lambda n: {
        "flash_attention_bf16": (n_chunks + 1) * L, "flash_attention": (n_chunks + 1) * L,
        "decode_attention_bf16": n * L, "decode_attention": n * L},
        context_chunk=CHUNK_TOKENS)
    at_calls(label, log, calls)
    lengths_in(label, log, DEC_TARGET, DEC_TARGET + DEC_INTERVAL)
    del log
    torch.cuda.empty_cache()

    # (h) a sliding body: Gemma-3-12B cut to 6 layers
    gcfg = gemma3_12b_config(6)
    ggen = torch.Generator(device=dev).manual_seed(12)
    gparams = kt.init_params(gcfg, ggen, dtype=torch.bfloat16, device=dev)
    spread_norms(torch, gparams, gcfg, ggen)
    sliding = gcfg.sliding_flags()
    n_sl = sum(sliding)
    label = "(h) DecodingPress(Knorm), Gemma-3-12B cut to 6 layers"
    _, log, _ = run(label, decoding(), lambda n: {
        "flash_attention_bf16_d256": 12, "flash_attention": 12,
        "decode_attention_bf16_d256": 6 * n, "decode_attention": 6 * n,
        "flash_attention_windowed": 2 * n_sl, "decode_attention_windowed": n_sl * n},
        r=kt.Runner.create(gcfg, device=dev), p=gparams,
        t=tokenizer_cls(vocab_size=gcfg.vocab_size))
    whole = S + len(question.split()) + sum(e["T"] == 1 for e in log)
    final = log[-1]["after"]
    report(f"    sliding layers {[l for l, s in enumerate(sliding) if s]} at "
           f"{sorted({final[l] for l, s in enumerate(sliding) if s})} (every token: {whole}); "
           f"global at {[final[l] for l, s in enumerate(sliding) if not s]}")
    if any(final[l] != whole for l, s in enumerate(sliding) if s):
        failures.append(f"{label}: sliding layers at {final}, not {whole}")
    lengths_in(label, log, DEC_TARGET, DEC_TARGET + DEC_INTERVAL,
               [l for l, s in enumerate(sliding) if not s])
    del log, gparams
    torch.cuda.empty_cache()

    failures += decode_press_refusals(kt, torch, tok, params, runner, report)
    if failures:
        raise AssertionError("; ".join(failures))
    return totals


def decode_press_refusals(kt, torch, tok, params, runner, report):
    """A decode-time press with two questions (ValueError: its compression
    rewrites slots below the length the rollback restores),
    ``DMSPress(compact=True, decoding=True)`` (ValueError: compaction moves
    the slots the ring tracks) and ``PrefillDecodingPress`` under
    ``context_chunk`` (TypeError, as JAX's assertion). Returns the
    failures."""
    pipe = kt.KVPressPipeline(runner, params, tok)
    context = " ".join(f"w{i}" for i in range(BUCKET_CONTEXT))
    knorm = kt.KnormPress()
    decoding = kt.DecodingPress(knorm, compression_interval=4, target_size=1024)
    cases = [
        ("DecodingPress with two questions", ValueError,
         lambda: pipe(context, questions=QUESTIONS, press=decoding, max_new_tokens=2)),
        ("CAMPress with two questions", ValueError,
         lambda: pipe(context, questions=QUESTIONS, press=kt.CAMPress(knorm),
                      max_new_tokens=2)),
        ("DMSPress(compact=True, decoding=True)", ValueError,
         lambda: kt.DMSPress(knorm, decoding=True, compact=True)),
        ("PrefillDecodingPress under context_chunk", TypeError, lambda: pipe(
            context, question=QUESTIONS[1], press=kt.PrefillDecodingPress(
                kt.KnormPress(0.5), decoding), context_chunk=CHUNK_TOKENS, max_new_tokens=2))]
    failures = []
    for label, error, call in cases:
        try:
            call()
        except error as e:
            report(f"  {label}: refused ({type(e).__name__}: {str(e)[:110]})")
        else:
            failures.append(f"{label} was not refused")
        torch.cuda.empty_cache()
    return failures


def decode_reference_paths(kt, torch, cfg, ids):
    """{path: press} of the dense-path check: (a)'s press scaled to 2,048
    tokens, (f)'s (its threshold the median of layer 0's scores of ``ids``),
    (e)'s scaled (the same draws on both routes: they come from (seed, layer,
    step))."""
    surrogate = kvzap_surrogate(torch, cfg, torch.Generator(device=ids.device).manual_seed(15))
    return {
        "DecodingPress(Knorm)": kt.DecodingPress(
            kt.KnormPress(), compression_interval=DEC_REF_INTERVAL, target_size=DEC_REF_TARGET,
            hidden_states_buffer_size=DEC_BUFFER),
        "DMS(KVzap), decoding": lambda params: kt.DMSPress(
            kt.KVzapPress(surrogate=surrogate),
            threshold=float(layer0_scores(kt, cfg, params, ids, surrogate).median()),
            decoding=True),
        "CAMPress(Knorm)": kt.CAMPress(
            kt.KnormPress(), compression_interval=DEC_REF_INTERVAL, target_size=DEC_REF_TARGET,
            hidden_states_buffer_size=DEC_BUFFER, merge_budget=32),
    }


def _state_as(state, dtype):
    """A copy of a press state with its hidden-state ring in ``dtype`` (the
    attention sum and the score ring stay float32, as the presses keep
    them)."""
    return [{k: v.to(dtype, copy=True) if k == "buffer" else v for k, v in s.items()}
            for s in state]


def _kept(cache):
    """(each layer's length, each layer's kept count: the keep bits set
    below its length)."""
    import torch

    if cache.mask is None:
        return cache.length.tolist(), None
    valid = torch.arange(cache.max_size, device=cache.mask.device) < cache.length.to(
        cache.mask.device)[:, None, None, None]
    return cache.length.tolist(), (cache.mask & valid).sum(dim=(1, 2, 3)).tolist()


def decode_reference_check(kt, torch, params, report):
    """Each decode-time press on the kernel path (flash, the decode kernel)
    against the dense path (``attn_impl="xla"``, ``decode_kernel=False``) on
    the same weights, cut to their first layer and whole, with a 2,048-token
    context, the 150-token question and 16 teacher-forced steps, stage by
    stage, each stage starting both paths from one state (the kernel path's
    cache and press state): the prefill's last logits, the question
    forward's logits, the steps' logits. Every stage must read at most
    REF_LIMIT[depth], and at full depth at most F32_RATIO times what bf16
    rounding alone moves in the same stage (the dense path in float32 from
    the same state). The layer lengths must be equal after every stage; under
    DMS the keep bits of layer 0 too, and the deeper layers' kept counts may
    differ by at most F32_RATIO times as much as dense bf16 and float32
    differ (compare_paths' yardstick for kept slots)."""
    dev = params.device
    gen = torch.Generator(device=dev).manual_seed(7)
    vocab = flagship_config().vocab_size
    ids = torch.randperm(vocab, generator=gen, device=dev)[:REF_CONTEXT][None]
    question = torch.randperm(vocab, generator=gen, device=dev)[:REF_QUESTION][None]
    size = REF_CONTEXT + REF_QUESTION + DEC_REF_STEPS + 1
    failures = []

    def as32(cache):
        return dataclasses.replace(clone_cache(cache), keys=cache.keys.float(),
                                   values=cache.values.float())

    def question_stage(r, p, press, cache, state, dtype):
        logits, cache, state = r.forward(p, question, clone_cache(cache), press=press,
                                         press_state=_state_as(state, dtype), phase="decode")
        return logits, cache, state

    def decode_stage(r, p, press, cache, state, dtype):
        cache, state, out, kept = clone_cache(cache), _state_as(state, dtype), [], []
        for i in range(DEC_REF_STEPS):
            logits, cache, state = r.forward(p, question[:, i:i + 1], cache, press=press,
                                             press_state=state, phase="decode",
                                             logits_last_only=True)
            out.append(logits)
            kept.append(_kept(cache))
        return torch.cat(out, dim=1), kept

    def count_diff(a, b):
        """Per layer, the summed |kept-count difference| of two kept logs."""
        pairs = [(x[1], y[1]) for x, y in zip(a, b) if x[1] is not None]
        return [sum(abs(u[l] - v[l]) for u, v in pairs) for l in range(len(a[0][0]))]

    for depth in (1, 16):
        cfg = flagship_config(depth)
        p = first_layers(params, depth) if depth < len(params.layers) else params
        p32 = copy.deepcopy(p).float() if depth == 16 else None
        kernel = kt.Runner.create(cfg, device=dev)
        dense = kt.Runner.create(cfg, attn_impl="xla", decode_kernel=False, device=dev)
        bf16 = torch.bfloat16
        for path, make in decode_reference_paths(kt, torch, cfg, ids).items():
            press = make(p) if callable(make) else make
            label = f"{path}, depth {depth}"
            kw = dict(press=press, max_size=size, compute_logits=True)
            pre_k, cache, state = kernel.prefill(p, ids, **kw)
            pre_d, cache_d, _ = dense.prefill(p, ids, **kw)
            q_k, cache_q, state_q = question_stage(kernel, p, press, cache, state, bf16)
            q_d, cache_qd, _ = question_stage(dense, p, press, cache, state, bf16)
            d_k, kept_k = decode_stage(kernel, p, press, cache_q, state_q, bf16)
            d_d, kept_d = decode_stage(dense, p, press, cache_q, state_q, bf16)
            kept = {"kernel": [_kept(cache), _kept(cache_q)] + kept_k,
                    "dense": [_kept(cache_d), _kept(cache_qd)] + kept_d}
            read = {"prefill": rel(torch, pre_k, pre_d), "question": rel(torch, q_k, q_d),
                    "decode": rel(torch, d_k, d_d)}
            noise = noise_kept = None
            if p32 is not None:
                pre_32, cache_32, _ = dense.prefill(p32, ids, dtype=torch.float32, **kw)
                q_32, cache_q32, _ = question_stage(dense, p32, press, as32(cache), state,
                                                    torch.float32)
                d_32, kept_32 = decode_stage(dense, p32, press, as32(cache_q), state_q,
                                             torch.float32)
                noise = {"prefill": rel(torch, pre_d, pre_32), "question": rel(torch, q_d, q_32),
                         "decode": rel(torch, d_d, d_32)}
                noise_kept = count_diff(kept["dense"],
                                        [_kept(cache_32), _kept(cache_q32)] + kept_32)
                del pre_32, cache_32, q_32, cache_q32, d_32
            diff = count_diff(kept["kernel"], kept["dense"])
            lengths_equal = all(a[0] == b[0] for a, b in zip(kept["kernel"], kept["dense"]))
            report(f"  {label}: max |kernel - dense| / max |dense|: "
                   + ", ".join(f"{s} {x:.3e}" for s, x in read.items())
                   + f" (limit {REF_LIMIT[depth]})"
                   + ("" if noise is None else "; dense bf16 against float32: "
                      + ", ".join(f"{s} {x:.3e}" for s, x in noise.items()))
                   + f"; layer lengths after the prefill {sorted(set(kept['kernel'][0][0]))}, "
                   f"the question {sorted(set(kept['kernel'][1][0]))}, the last step "
                   f"{sorted(set(kept['kernel'][-1][0]))}, equal on both paths: "
                   f"{lengths_equal}"
                   + ("" if kept["kernel"][0][1] is None else
                      f"; kept-count differences per layer over the stages {diff}"
                      + ("" if noise_kept is None else f" (bf16 against float32: {noise_kept})")))
            failures += [f"{label}: {s} reads {x:.3e} > {REF_LIMIT[depth]}"
                         for s, x in read.items() if not x <= REF_LIMIT[depth]]
            if noise is not None:
                failures += [f"{label}: {s} reads {read[s]:.3e}, over {F32_RATIO} x "
                             f"{noise[s]:.3e}" for s in read if not read[s] <= F32_RATIO * noise[s]]
            if not lengths_equal:
                failures.append(f"{label}: layer lengths differ between the paths")
            if diff[0] or (noise_kept is not None
                           and sum(diff) > F32_RATIO * max(sum(noise_kept), 1)):
                failures.append(f"{label}: kept counts differ by {diff} (bf16 against float32: "
                                f"{noise_kept})")
            del cache, cache_d, cache_q, cache_qd, state, state_q
        del kernel, dense, p32
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))


def long_context_run(kt, torch, tokenizer_cls, report):
    """The Llama-3.1-8B-class body at full width and depth (seeded random
    weights, int4) through ``KVPressPipeline`` with int4 KV, Knorm(0.5) and a
    131,072-token context in chunks of 8,192, two questions with 32 new
    tokens. At exactly 131,072 tokens the dense transient is 2^29 bytes, not
    over it, so the int4 chunks take the dense route (flash_attention).
    Prints the prefill's wall time and peak memory. Returns the launch counts."""
    cfg = llama31_8b_config()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    t0 = time.perf_counter()
    params = kt.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    params4 = kt.quantize_params_int4(params)
    del params
    torch.cuda.empty_cache()
    report(f"  8B-class body, int4 weights: made in {time.perf_counter() - t0:.1f} s, "
           f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prefills = []
    runner = kt.Runner.create(cfg, device=dev)
    pipe = kt.KVPressPipeline(timed_runner(kt, torch, runner, prefills), params4,
                              tokenizer_cls(vocab_size=cfg.vocab_size))
    context = " ".join(f"w{i}" for i in range(LONG_CONTEXT_TOKENS))
    lengths = _LengthLog()
    logging.getLogger("kvpress_tpu_torch.pipeline").addHandler(lengths)
    reset_counts()
    t0 = time.perf_counter()
    out = pipe(context, questions=QUESTIONS, press=kt.KnormPress(0.5), max_new_tokens=32,
               quantized=True, kv_bits=4, context_chunk=CHUNK_TOKENS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    logging.getLogger("kvpress_tpu_torch.pipeline").removeHandler(lengths)
    counts = read_counts()
    answers = out["answers"]
    report(f"  8B-class, 131,072 tokens, int4 KV + int4 weights, Knorm, context_chunk "
           f"{CHUNK_TOKENS}: {seconds:.2f} s in all, {prefill_reading(prefills)} "
           f"({LONG_CONTEXT_TOKENS / prefills[-1][0]:.0f} tok/s); compressed length "
           f"{lengths.compressed[-1]}, launches {launched(counts)}, answer tokens "
           f"{[len(a.split()) for a in answers]}")
    if lengths.compressed[-1] != LONG_CONTEXT_TOKENS // 2:
        raise AssertionError(f"8B-class run: compressed length {lengths.compressed[-1]}")
    if len(answers) != 2 or not all(isinstance(a, str) and a for a in answers):
        raise AssertionError(f"8B-class run: bad answers {answers!r}")
    check_run("8B-class run", counts, ("flash_attention", "decode_attention"),
              ("flash_attention_quant",))
    del pipe, out
    torch.cuda.empty_cache()
    # Where the prefill's time goes, on the body cut to 4 of its 32 layers
    # (every layer does the same work).
    depth = 4
    cut = kt.Runner.create(llama31_8b_config(depth), device=dev)
    p_cut = first_layers(params4, depth)
    ids = torch.randint(3, cfg.vocab_size, (1, LONG_CONTEXT_TOKENS), generator=gen, device=dev)
    breakdown(f"prefill 131,072 tokens, 8B-class cut to {depth} layers, chunked, int4",
              lambda: cut.prefill_chunked(p_cut, ids, press=kt.KnormPress(0.5),
                                          chunk_size=CHUNK_TOKENS, compute_logits=True,
                                          quantized=True, kv_bits=4), 1, report, top=8)
    del params4, p_cut
    torch.cuda.empty_cache()
    return counts


def clone_cache(cache):
    """A copy of ``cache`` that a forward may write into."""
    fields = ("keys", "values", "mask", "key_scales", "value_scales", "length", "offset")
    return dataclasses.replace(cache, **{f: getattr(cache, f).clone() for f in fields
                                         if getattr(cache, f) is not None})


def dequantized_cache(kt, cache, dtype):
    """The same state with ``dtype`` buffers. A >128-token forward over an
    int4 cache attends just that on the kernel path: the dequantized buffer,
    with the new block at full precision (``Runner._layer_step``)."""
    return dataclasses.replace(
        clone_cache(cache),
        keys=kt.dequantize_kv(cache.keys, cache.key_scales, cache.bits, dtype),
        values=kt.dequantize_kv(cache.values, cache.value_scales, cache.bits, dtype),
        key_scales=None, value_scales=None)


def first_layers(params, n: int):
    """The model cut to its first ``n`` layers (same tensors)."""
    from kvpress_tpu_torch.models.llama import LlamaModel

    layers = [{name: p.data for name, p in layer.named_parameters(recurse=False)}
              for layer in params.layers[:n]]
    head = params.get("lm_head")
    return LlamaModel(params.embed.data, layers, params.ln_f.data,
                      None if head is None else head.data)


def recording_scorer(torch, base, log: list):
    """``base(0.5)``, a ScorerPress that appends, per layer, its kept slots as
    a (B, Hkv, S) bool mask (the same top-k as ``topk_keep``)."""
    from kvpress_tpu_torch.presses.base import order_desc

    class Recording(base):
        def score(self, ctx, keys, values):
            s = super().score(ctx, keys, values).to(torch.float32)
            idx = order_desc(s, self.n_kept(s.shape[-1]))
            log.append(torch.zeros_like(s, dtype=torch.bool).scatter_(-1, idx, True))
            return s

    return Recording(0.5)


def recording_adakv(kt, inner, log: list, base=None):
    """``AdaKVPress(inner, compact=True)`` (or ``base``, another head-wise
    press) that appends, per layer, the kept slots of every head (before
    they are compacted) as a (B, Hkv, S) mask."""
    from kvpress_tpu_torch.presses.wrappers import compact_headwise

    class Recording(base or kt.AdaKVPress):        # compact=False: compacted below
        def layer_compress(self, ctx, keys, values, length, mask, state=None):
            keys, values, length, keep, state = super().layer_compress(
                ctx, keys, values, length, mask, state)
            log.append(keep)
            return (*compact_headwise(keys, values, keep), state)

    return Recording(inner)


def reference_paths(kt, torch):
    """{path: (kernel runner options, press for the kernel path, press for the
    dense path, KV variants)}; a press is made by ``make(log)``."""
    import numpy as np

    from kvpress_tpu_torch.ops.attention import chunked_observed_colsums

    class Chunked(kt.ObservedAttentionPress):
        """Takes the long-context route (no probs: flash LSE and the
        column-sum kernel) at the check's 2,048 tokens too."""
        chunked_threshold = 0

    class PlainSums(kt.ObservedAttentionPress):
        """Column sums by the plain chunked sweep, on the card too."""
        def column_sums(self, ctx, keys):
            return chunked_observed_colsums(ctx.queries, keys, ctx.scale,
                                            softcap=ctx.cfg.logit_softcap, chunk=128)

    all_kv = ((False, 8, None), (True, 8, None), (True, 4, None))
    scorer = lambda base: lambda log: recording_scorer(torch, base, log)
    # KeyRerotation keeps its scorer's top n_kept: the scorer's log is its.
    rerotation = lambda log: kt.KeyRerotationPress(recording_scorer(torch, kt.KnormPress, log))
    critical_adakv = lambda log: recording_adakv(kt, kt.SnapKVPress(0.5), log,
                                                 base=kt.CriticalAdaKVPress)
    cfg = flagship_config(16)
    head_scores = np.random.default_rng(15).standard_normal(
        (cfg.num_layers, cfg.num_kv_heads)).astype(np.float32)
    surrogate = kvzap_surrogate(torch, cfg, torch.Generator(device="cuda").manual_seed(15))

    def mask_log(base, *args, **kw):
        """``base(*args, **kw)`` that appends each layer's keep-mask."""
        class Recording(base):
            def layer_compress(self, ctx, keys, values, length, mask, state=None):
                out = super().layer_compress(ctx, keys, values, length, mask, state)
                log.append(out[3])
                return out

        log = kw.pop("log")
        return Recording(*args, **kw)

    # Duo's keep-mask reads positions alone; DMS's layer-0 scores the
    # embedding alone. DMS compact: compact_masked after the prefill (as the
    # pipeline runs it), then the head-wise runner.
    duo = lambda log: mask_log(kt.DuoAttentionPress, 0.5, sink_size=DUO_SINK,
                               recent_size=DUO_RECENT, head_scores=head_scores, log=log)
    dms = lambda log: mask_log(kt.DMSPress, kt.KVzapPress(surrogate=surrogate), threshold=0.0,
                               compact=True, log=log)
    return {
        "Knorm": ({}, scorer(kt.KnormPress), scorer(kt.KnormPress), all_kv),
        # Scored from the layer's queries and keys alone: the same on both
        # paths up to rounding, which the kept slots past layer 0 show.
        "ExpectedAttention": ({}, scorer(kt.ExpectedAttentionPress),
                              scorer(kt.ExpectedAttentionPress), all_kv[:1]),
        "Compactor": ({}, scorer(kt.CompactorPress), scorer(kt.CompactorPress), all_kv[:1]),
        # dense path: the probabilities the dense attention materializes
        "path A": ({}, lambda log: recording_scorer(torch, Chunked, log),
                   lambda log: recording_scorer(torch, kt.ObservedAttentionPress, log),
                   all_kv[:1]),
        "path B": (dict(decode_kernel=False, headwise_kernel=True),
                   lambda log: recording_adakv(kt, kt.ObservedAttentionPress(0.5), log),
                   lambda log: recording_adakv(kt, PlainSums(0.5), log), all_kv[:1]),
        # Rerotated keys through flash (the question) and decode: the
        # question continues from the compressed length (reference_check).
        "KeyRerotation": ({}, rerotation, rerotation, all_kv[:1]),
        # A critical head-wise cache through decode_headwise.
        "CriticalAdaKV(SnapKV)": (dict(decode_kernel=False, headwise_kernel=True),
                                  critical_adakv, critical_adakv, all_kv[:1]),
        "Duo": ({}, duo, duo, all_kv[:1]),
        "DMS(KVzap), compact": (dict(decode_kernel=False, headwise_kernel=True), dms, dms,
                                all_kv[:1]),
    }


def chunked_reference_paths(kt, torch):
    """The chunked-prefill counterpart of ``reference_paths``: Knorm with bf16
    and int8 KV, and int4 KV on both attention routes (fused_kv False: the
    layer dequantized for flash_attention; True: flash_attention_quant)."""
    def knorm(log):
        return recording_scorer(torch, kt.KnormPress, log)

    return {"Knorm, chunked": ({}, knorm, knorm, ((False, 8, None), (True, 8, None),
                                                  (True, 4, False), (True, 4, True)))}


REF_CONTEXT, REF_QUESTION, REF_STEPS = 2048, 150, 4
REF_CHUNK = 512
# Phase 3 limits on max |kernel - dense| / max |dense| per model depth. The
# logits come out of a bf16 product, so one ulp of the largest is 2^-8 to
# 2^-7 of it; depth 1 reads about one ulp (PERF.md).
REF_LIMIT = {1: 2.5e-2, 16: 1e-1}
# At full depth bf16 rounding alone moves the logits and the kept slots
# (dense bf16 against dense float32). The two bf16 paths may differ from each
# other by at most this many times as much.
F32_RATIO = 2.0
# Layer 0's keys do not depend on attention: Knorm keeps the same slots on
# both paths. The attention-reading presses score layer 0 from sums taken in
# another order, so two slots whose scores are float-equal may swap: the
# readings are 0 of the 8 x 2,048 slots, the planted faults move 270 and 432
# (PERF.md), and the limit allows one swapped pair.
LAYER0_SLOTS = {"Knorm": 0, "path A": 2, "path B": 2, "Knorm, chunked": 0,
                "ExpectedAttention": 0, "Compactor": 0, "KeyRerotation": 0,
                "CriticalAdaKV(SnapKV)": 0, "Duo": 0, "DMS(KVzap), compact": 0}
# Paths whose kept slots cannot move: Duo's keep-mask reads positions alone,
# so neither rounding nor a planted fault moves it (it must stay equal).
KEPT_FIXED = ("Duo",)


@contextlib.contextmanager
def planted_faults(torch, lo: int = 256):
    """Planted faults, all at once: every attention kernel wrapper the runner
    calls ignores slots lo .. lo + 255 (their keep bits cleared), as a kernel
    that skipped that key step would compute; the column-sum kernel skips the
    query rows 1024-1087 (their LSE set to -inf); the head-wise decode skips
    the tail."""
    from kvpress_tpu_torch.models import llama
    from kvpress_tpu_torch.ops.observed_colsum import observed_lse
    from kvpress_tpu_torch.presses import snapkv

    mask_args = {"flash_attention": "head_mask", "flash_attention_quant": "head_mask",
                 "decode_attention": "mask"}
    originals = {(llama, name): getattr(llama, name) for name in mask_args}
    originals[(llama, "decode_attention_headwise")] = llama.decode_attention_headwise
    originals[(snapkv, "observed_colsums_flash")] = snapkv.observed_colsums_flash

    def skipping(fn, mask_arg):
        sig = inspect.signature(fn)

        def wrapper(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            mask = bound.arguments.get(mask_arg)
            if mask is None:        # every slot live (the chunk forward passes none)
                k = bound.arguments["k"]
                mask = torch.ones(k.shape[:3], dtype=torch.bool, device=k.device)
            mask = mask.clone()
            mask[..., lo:lo + 256] = False
            bound.arguments[mask_arg] = mask
            return fn(*bound.args, **bound.kwargs)
        return wrapper

    def without_tail(q, k, v, prefix_lens, tail_start, tail_len, **kw):
        return originals[(llama, "decode_attention_headwise")](
            q, k, v, prefix_lens, tail_start, torch.zeros_like(tail_len), **kw)

    def without_query_tile(q, k, lse=None, **kw):
        lse = (observed_lse(q, k, **kw) if lse is None else lse).clone()
        lse[:, :, 1024:1088] = float("-inf")
        return originals[(snapkv, "observed_colsums_flash")](q, k, lse, **kw)

    for name, arg in mask_args.items():
        setattr(llama, name, skipping(originals[(llama, name)], arg))
    llama.decode_attention_headwise = without_tail
    snapkv.observed_colsums_flash = without_query_tile
    try:
        yield
    finally:
        for (module, name), fn in originals.items():
            setattr(module, name, fn)


def rel(torch, a, b) -> float:
    """max |a - b| / max |b|; ``a`` (the kernel path's) must be finite."""
    if not torch.isfinite(a).all():
        raise AssertionError("non-finite logits on the kernel path")
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def differing(a_log, b_log) -> list[int]:
    """Slots kept by one and not the other, per layer (of two kept-slot logs)."""
    return [int((a != b).sum()) // 2 for a, b in zip(a_log, b_log)]


def f32_noise(torch, label, prefill, params, report, **f32_kw):
    """What bf16 rounding alone moves: the dense prefill ``prefill(params,
    log, **kw)`` with ``params`` against the same in float32 (``f32_kw``:
    the float32 forms of other inputs). Returns (the last logits' rel,
    kept slots differing per layer)."""
    p32 = copy.deepcopy(params).float()
    kept_32, kept_16 = [], []
    pre_32, _, _ = prefill(p32, kept_32, **f32_kw)
    del p32
    torch.cuda.empty_cache()
    pre_16, _, _ = prefill(params, kept_16)
    noise = (rel(torch, pre_16, pre_32), differing(kept_16, kept_32))
    report(f"  {label} prefill, dense bf16 against dense float32: logits {noise[0]:.3e}; kept "
           f"slots differing per layer {noise[1]}")
    return noise


def compare_paths(kt, torch, label, runners, params, prefills, question, limit, report, *,
                  dequantize=False, fault_lo=256, layer0_slots=None, layer0_faults=False,
                  noise=None, kept_fixed=False):
    """One kernel path against the dense path, stage by stage, each stage
    starting both from one state so that no difference carries from one
    stage into the next:
      prefill:  the last position's logits, and every compressed layer's
                kept slots;
      question: all logits of a ``question`` forward over the kernel path's
                compressed cache (dequantized for the dense path with
                ``dequantize``);
      decode:   REF_STEPS teacher-forced steps over the kernel path's cache
                after the question.
    ``runners`` is (kernel, dense); ``prefills`` (kernel, dense) of
    ``f(log)``, a prefill that appends each layer's kept slots to ``log``.
    Every stage must read at most ``limit`` and its planted faults (keys
    fault_lo .. fault_lo + 255) above it. The first compressed layer keeps at
    most ``layer0_slots`` other slots (its keys do not depend on attention),
    and with ``layer0_faults`` the planted faults must move more. With
    ``noise`` (``f32_noise``), the prefill's logits and kept slots may differ
    by at most F32_RATIO times what bf16 rounding alone moves, and the
    planted faults by more; with ``kept_fixed`` the kept slots must be equal
    and no fault is asked to move them. Returns (failures, the kept-slot
    logs)."""
    kernel, dense = runners

    def steps(r, cache):
        out = []
        for i in range(REF_STEPS):
            logits, cache, _ = r.forward(params, question[:, i:i + 1], cache,
                                         logits_last_only=True)
            out.append(logits)
        return torch.cat(out, dim=1)

    kept = {"kernel": [], "dense": [], "fault": []}
    pre_k, cache, _ = prefills[0](kept["kernel"])
    pre_d, _, _ = prefills[1](kept["dense"])
    shared = kt.resize(cache, int(cache.length.max()) + question.shape[1] + REF_STEPS)
    ref_cache = dequantized_cache(kt, shared, torch.bfloat16) if dequantize else shared
    q_k, after_q, _ = kernel.forward(params, question, clone_cache(shared))
    q_d, _, _ = dense.forward(params, question, clone_cache(ref_cache))
    d_k = steps(kernel, clone_cache(after_q))
    d_d = steps(dense, clone_cache(after_q))
    with planted_faults(torch, fault_lo):
        pre_f, _, _ = prefills[0](kept["fault"])
        q_f, _, _ = kernel.forward(params, question, clone_cache(shared))
        d_f = steps(kernel, clone_cache(after_q))
    read = {"prefill": rel(torch, pre_k, pre_d), "question": rel(torch, q_k, q_d),
            "decode": rel(torch, d_k, d_d)}
    fault = {"prefill": rel(torch, pre_f, pre_d), "question": rel(torch, q_f, q_d),
             "decode": rel(torch, d_f, d_d)}
    diff = differing(kept["kernel"], kept["dense"])
    diff_f = differing(kept["fault"], kept["dense"])
    report(f"  {label}: max |kernel - dense| / max |dense|: "
           + ", ".join(f"{s} {x:.3e}" for s, x in read.items())
           + f" (limit {limit}; planted faults: "
           + ", ".join(f"{s} {x:.3e}" for s, x in fault.items())
           + f"); kept slots differing per layer {diff} (planted faults: {diff_f}); layer "
           f"lengths {sorted(set(cache.length.tolist()))}")
    failures = [f"{label}: {s} reads {x:.3e} > {limit}" for s, x in read.items()
                if not x <= limit]
    failures += [f"{label}: the limit passes the planted faults at {s} ({x:.3e})"
                 for s, x in fault.items() if not x > limit]
    if layer0_slots is not None and diff[0] > layer0_slots:
        failures.append(f"{label}: layer 0 keeps different slots ({diff[0]})")
    if layer0_faults and not diff_f[0] > layer0_slots:
        failures.append(f"{label}: layer 0's limit passes the planted faults ({diff_f[0]})")
    if noise is not None:
        noise_logits, noise_kept = noise
        ratios = {"logits": read["prefill"] / noise_logits,
                  "kept slots": sum(diff) / max(sum(noise_kept), 1)}
        ratios_f = {"logits": fault["prefill"] / noise_logits,
                    "kept slots": sum(diff_f) / max(sum(noise_kept), 1)}
        report("    prefill, kernel against dense over dense bf16 against float32: "
               + ", ".join(f"{s} {x:.3f}" for s, x in ratios.items())
               + f" (limit {F32_RATIO}; planted faults: "
               + ", ".join(f"{s} {x:.3f}" for s, x in ratios_f.items()) + ")")
        failures += [f"{label}: {s} ratio {x:.3f} > {F32_RATIO}"
                     for s, x in ratios.items() if not x <= F32_RATIO]
        failures += [f"{label}: the ratio passes the planted faults at {s} ({x:.3f})"
                     for s, x in ratios_f.items()
                     if not x > F32_RATIO and not (kept_fixed and s == "kept slots")]
    if kept_fixed and sum(diff):
        failures.append(f"{label}: position-only kept slots differ ({diff})")
    return failures, kept


def reference_check(kt, torch, params, report, chunk=None):
    """Each kernel path (attn_impl "flash"; the decode kernel, or for path B
    the head-wise kernel) against the dense path (attn_impl "xla", the routes
    the runner takes on the CPU, scoring from materialized probabilities or
    the plain chunked sweep) on the same full-width weights, cut to their
    first layer and whole, with a 2,048-token context at ratio 0.5
    (``compare_paths``): Knorm for bf16, int8 and int4 KV, paths A and B,
    ExpectedAttention, Compactor, KeyRerotation(Knorm) (the question from the
    kept length, as the pipeline runs it), CriticalAdaKV(SnapKV) compact on
    the head-wise runner, Duo (its kept slots fixed by position) and
    DMS(KVzap) compact (``compact_masked`` after the prefill, the head-wise
    runner) for bf16 KV. With ``chunk``, the prefill
    is ``prefill_chunked`` in chunks of that many tokens instead: Knorm for
    bf16 and int8 KV and for int4 KV on both attention routes
    (``chunked_reference_paths``). The question runs on flash (flash_quant
    for int8 KV). Layer 0's kept slots must be equal
    (LAYER0_SLOTS). At full depth, dense bf16 against dense float32 sets the
    scale of what bf16 rounding alone moves."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    vocab = flagship_config().vocab_size
    ids = torch.randperm(vocab, generator=gen, device=dev)[:REF_CONTEXT][None]
    question = torch.randperm(vocab, generator=gen, device=dev)[:REF_QUESTION][None]
    failures = []
    paths = reference_paths(kt, torch) if chunk is None else chunked_reference_paths(kt, torch)

    def prefill(r, p, press, quantized=False, bits=8, fused=None):
        kw = dict(max_size=REF_CONTEXT, compute_logits=True, quantized=quantized,
                  kv_bits=bits)
        if chunk is None:
            logits, cache, state = r.prefill(p, ids, press=press, **kw)
        else:
            logits, cache, state = r.prefill_chunked(p, ids, press=press, chunk_size=chunk,
                                                     fused_kv=fused, **kw)
        if getattr(press, "host_compact", False):
            cache = kt.compact_masked(cache)        # as the pipeline does
        if getattr(press, "rerotates", False):
            # as the pipeline does: the question continues from the kept length
            cache = dataclasses.replace(cache, offset=torch.tensor(int(cache.length.max()),
                                                                   dtype=torch.int32))
        return logits, cache, state

    def head_counts(a_log, b_log):
        """Largest difference of a head's kept count, per layer."""
        return [int((a.sum(-1) - b.sum(-1)).abs().max()) for a, b in zip(a_log, b_log)]

    # bf16 rounding alone: dense bf16 against dense float32, full depth, with
    # bf16 KV. Chunked, for each KV variant: an int4 chunk attends a bf16
    # transient of its layer on one route and payload x scale on the other,
    # and the rounding of the model's K and V moves their int4 codes.
    dense = kt.Runner.create(flagship_config(), attn_impl="xla", decode_kernel=False,
                             device=dev)
    noise = {}
    for path, (_, _, dense_press, variants) in paths.items():
        for variant in (variants if chunk else [None]):
            kw = {} if variant is None else dict(zip(("quantized", "bits", "fused"), variant))
            noise[path, variant] = f32_noise(
                torch, f"{path}, depth 16, {variant or 'bf16 KV'}",
                lambda p, log: prefill(dense, p, dense_press(log), **kw), params, report)
    del dense
    torch.cuda.empty_cache()

    for depth in (1, 16):
        cfg = flagship_config(depth)
        p = first_layers(params, depth) if depth < len(params.layers) else params
        dense = kt.Runner.create(cfg, attn_impl="xla", decode_kernel=False, device=dev)
        for path, (options, kernel_press, dense_press, variants) in paths.items():
            kernel = kt.Runner.create(cfg, device=dev, **options)
            for quantized, bits, fused in variants:
                label = (f"{path}, depth {depth}, {f'int{bits}' if quantized else 'bf16'} KV"
                         + ("" if fused is None else f", fused_kv={fused}"))
                kw = dict(quantized=quantized, bits=bits, fused=fused)
                found, kept = compare_paths(
                    kt, torch, label, (kernel, dense), p,
                    (lambda log: prefill(kernel, p, kernel_press(log), **kw),
                     lambda log: prefill(dense, p, dense_press(log), **kw)),
                    question, REF_LIMIT[depth], report, dequantize=quantized and bits == 4,
                    layer0_slots=LAYER0_SLOTS[path], layer0_faults=path.startswith("path"),
                    noise=noise[path, (quantized, bits, fused) if chunk else None]
                    if depth == 16 else None, kept_fixed=path in KEPT_FIXED)
                failures += found
                if path == "path B":
                    report(f"    largest difference of a head's kept count per layer "
                           f"{head_counts(kept['kernel'], kept['dense'])} (planted faults: "
                           f"{head_counts(kept['fault'], kept['dense'])}); kept per head in "
                           f"layer 0: {kept['kernel'][0].sum(-1).flatten().tolist()}")
            del kernel
        del dense
    if failures:
        raise AssertionError("; ".join(failures))


# --------------------------------------------------------------------- #
# Phase 3: the other architectures at full width


def qwen3_8b_config(num_layers: int = 36):
    """Qwen3-8B (``Qwen/Qwen3-8B`` config.json: vocab 151,936, hidden 4,096,
    FFN 12,288, 36 layers, 32 query / 8 kv heads, head_dim 128, q/k-norm,
    rope_theta 1e6, rms eps 1e-6, untied head), written out by hand."""
    from kvpress_tpu_torch.config import ModelConfig

    return ModelConfig(vocab_size=151936, hidden_size=4096, intermediate_size=12288,
                       num_layers=num_layers, num_heads=32, num_kv_heads=8, head_dim=128,
                       rms_norm_eps=1e-6, rope_theta=1e6, qk_norm=True,
                       tie_word_embeddings=False, max_position_embeddings=40960,
                       model_type="qwen3")


GEMMA3_IMAGE_TOKEN = 262144


def gemma3_27b_config(num_layers: int = 62):
    """The text decoder of Gemma-3-27B (``google/gemma-3-27b-it`` config.json,
    text_config: vocab 262,208, hidden 5,376, FFN 21,504, 62 layers, every
    sixth global and the rest sliding with window 1,024, 32 query / 16 kv
    heads, head_dim 128, query_pre_attn_scalar 168, rope_theta 1e6 with
    linear scaling 8, rope_local_base_freq 1e4, q/k-norm, post-norms, (1 + w)
    norms, scaled embeddings, gelu-tanh, tied head), written out by hand."""
    from kvpress_tpu_torch.config import ModelConfig

    return ModelConfig(vocab_size=262208, hidden_size=5376, intermediate_size=21504,
                       num_layers=num_layers, num_heads=32, num_kv_heads=16, head_dim=128,
                       rms_norm_eps=1e-6, rope_theta=1e6,
                       rope_scaling={"rope_type": "linear", "factor": 8.0}, qk_norm=True,
                       tie_word_embeddings=True, sliding_window=1024,
                       layer_is_sliding=tuple((i + 1) % 6 != 0 for i in range(num_layers)),
                       act="gelu_tanh", max_position_embeddings=131072, scale_embeddings=True,
                       post_norms=True, rms_one_offset=True, query_pre_attn_scalar=168.0,
                       rope_local_base_freq=10000.0, model_type="gemma3_text")


def gemma3_12b_config(num_layers: int = 48):
    """The text decoder of Gemma-3-12B (``google/gemma-3-12b-it`` config.json,
    text_config: hidden 3,840, FFN 15,360, 48 layers, 16 query / 8 kv heads,
    sliding window 1,024, rope linear scaling 8; the fields it leaves to the
    ``Gemma3TextConfig`` defaults, which are the model's: head_dim 256,
    query_pre_attn_scalar 256, vocab 262,208, rope_theta 1e6,
    rope_local_base_freq 1e4, every sixth layer global and the rest sliding;
    q/k-norm, post-norms, (1 + w) norms, scaled embeddings, gelu-tanh, tied
    head), written out by hand. Its vision tower is ``gemma3_vision_config``."""
    return dataclasses.replace(
        gemma3_27b_config(num_layers), hidden_size=3840, intermediate_size=15360,
        num_heads=16, num_kv_heads=8, head_dim=256, query_pre_attn_scalar=256.0)


def gemma3_vision_config():
    """Gemma-3-27B's SigLIP tower (``google/gemma-3-27b-it`` config.json,
    vision_config: hidden 1,152, FFN 4,304, 27 layers, 16 heads, image 896,
    patch 14; mm_tokens_per_image 256)."""
    from kvpress_tpu_torch.models.siglip import VisionConfig

    return VisionConfig(hidden_size=1152, intermediate_size=4304, num_layers=27, num_heads=16,
                        image_size=896, patch_size=14, mm_tokens_per_image=256)


def int4_body(kt, torch, cfg, gen, dev):
    """Random weights as ``init_params`` draws them, each layer quantized to
    int4 before the next is drawn, so that the bf16 model never exists
    whole; the embedding (tied head) stays bf16."""
    from kvpress_tpu_torch.models.llama import LlamaModel, init_layer

    layers = [kt.quantize_layer_int4(init_layer(cfg, gen, torch.bfloat16, dev))
              for _ in range(cfg.num_layers)]
    embed = (torch.randn((cfg.vocab_size, cfg.hidden_size), generator=gen, device=dev)
             * 0.02).to(torch.bfloat16)
    assert cfg.tie_word_embeddings
    return LlamaModel(embed, layers, torch.ones(cfg.hidden_size, dtype=torch.bfloat16,
                                                device=dev))


def spread_norms(torch, params, cfg, gen):
    """q/k-norm weights drawn around their unit value (1 + w: around w = 0):
    with every one at its init value, all keys of a layer have the same norm
    and KnormPress would choose among ties."""
    for layer in params.layers:
        for name in ("q_norm", "k_norm"):
            w = layer.get(name)
            noise = torch.randn(w.shape, generator=gen, device=w.device) * 0.3
            w.data.copy_((noise if cfg.rms_one_offset else 1.0 + noise).to(w.dtype))


def image_context(words: int, starts, span: int) -> str:
    """A toy-tokenizer context of ``words`` tokens (the bos token joins the
    first word) with ``span`` image placeholders from each position in
    ``starts``."""
    toks = [f"w{i}" for i in range(words)]
    for s0 in starts:
        toks[s0:s0 + span] = ["<image>"] * span
    return " ".join(toks)


def image_tokenizer(tokenizer_cls, vocab_size):
    """The toy tokenizer with the word ``<image>`` as Gemma3's placeholder."""
    class ImageTokenizer(tokenizer_cls):
        def _tok2id(self, tok):
            return GEMMA3_IMAGE_TOKEN if tok == "<image>" else super()._tok2id(tok)

    return ImageTokenizer(vocab_size=vocab_size)


def pipeline_run(kt, torch, label, pipe, prefills, needed, unwanted, report, **kw):
    """One pipeline call with the launch counts set to 0 before it and read
    after it. Returns (counts, the answers, the prefill's layer lengths)."""
    reset_counts()
    t0 = time.perf_counter()
    out = pipe(questions=QUESTIONS, max_new_tokens=32, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    answers = out["answers"]
    report(f"  {label}: {seconds:.2f} s in all, {prefill_reading(prefills)}, layer lengths "
           f"{sorted(set(prefills[-1][3]))}, launches {launched(counts)}, answer tokens "
           f"{[len(a.split()) for a in answers]}")
    if len(answers) != 2 or not all(isinstance(a, str) and a for a in answers):
        raise AssertionError(f"{label}: bad answers {answers!r}")
    check_run(label, counts, needed, unwanted)
    return counts, answers, prefills[-1][3]


def qwen3_run(kt, torch, tokenizer_cls, report):
    """The Qwen3-8B body at full width and depth (seeded random bf16 weights,
    q/k-norm spread) through ``KVPressPipeline`` with Knorm(0.5) and with
    ExpectedAttention(0.5), bf16 KV, a 32,768-token context, the two
    questions and 32 new tokens; then its
    decode rate and idle share over the compressed cache, and the kernel
    path against the dense path at depth 1 and 36. Returns the launch
    counts."""
    cfg = qwen3_8b_config()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(36)
    t0 = time.perf_counter()
    params = kt.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    spread_norms(torch, params, cfg, gen)
    report(f"  Qwen3-8B body: made in {time.perf_counter() - t0:.1f} s, "
           f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prefills = []
    runner = kt.Runner.create(cfg, device=dev)
    pipe = kt.KVPressPipeline(timed_runner(kt, torch, runner, prefills), params,
                              tokenizer_cls(vocab_size=cfg.vocab_size))
    context = " ".join(f"w{i}" for i in range(CONTEXT_TOKENS))
    counts, _, lengths = pipeline_run(
        kt, torch, "Qwen3-8B, 32K, Knorm, bf16 KV", pipe, prefills,
        ("flash_attention", "decode_attention"), ("flash_attention_quant", "decode_headwise"),
        report, context=context, press=kt.KnormPress(0.5))
    if set(lengths) != {CONTEXT_TOKENS // 2}:
        raise AssertionError(f"Qwen3-8B run: layer lengths {sorted(set(lengths))}")
    # The configuration kvpress's public leaderboard reports for its headline
    # press: its pre-RoPE queries are post q/k-norm.
    counts_ea, _, lengths = pipeline_run(
        kt, torch, "Qwen3-8B, 32K, ExpectedAttention, bf16 KV", pipe, prefills,
        ("flash_attention", "decode_attention"), ("flash_attention_quant", "decode_headwise"),
        report, context=context, press=kt.ExpectedAttentionPress(0.5))
    if set(lengths) != {CONTEXT_TOKENS // 2}:
        raise AssertionError(f"Qwen3-8B ExpectedAttention run: layer lengths "
                             f"{sorted(set(lengths))}")
    counts = {name: n + counts_ea[name] for name, n in counts.items()}
    del pipe
    torch.cuda.empty_cache()

    # Where the prefill's time goes, on the body cut to 4 of its 36 layers
    # (every layer does the same work); then decode over the compressed
    # cache: tok/s (B=1, 32 steps, median of 3 passes) and one step's device
    # breakdown (idle share).
    ids = torch.randint(3, cfg.vocab_size, (1, CONTEXT_TOKENS), generator=gen, device=dev)
    cut, p_cut = kt.Runner.create(qwen3_8b_config(4), device=dev), first_layers(params, 4)
    breakdown("Qwen3-8B prefill 32K cut to 4 layers, Knorm, bf16 KV",
              lambda: cut.prefill(p_cut, ids, press=kt.KnormPress(0.5), compute_logits=True),
              1, report, top=6)
    del cut, p_cut
    torch.cuda.empty_cache()
    _, cache, _ = runner.prefill(params, ids, press=kt.KnormPress(0.5))
    steps = 32
    cache = kt.resize(cache, CONTEXT_TOKENS // 2 + steps + 1)
    base_len, base_off = cache.length, cache.offset
    rates = []
    for _ in range(3):
        c, tok = dataclasses.replace(cache, length=base_len, offset=base_off), ids[:, -1:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, c, _ = runner.forward(params, tok, c, logits_last_only=True)
            tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        torch.cuda.synchronize()
        rates.append(steps / (time.perf_counter() - t0))
    report(f"  Qwen3-8B decode B=1 over a 32K context at ratio 0.5, bf16 KV: "
           f"{statistics.median(rates):.1f} tok/s (passes {[round(r, 1) for r in rates]})")
    c = dataclasses.replace(cache, length=base_len, offset=base_off)
    breakdown("Qwen3-8B decode step", lambda: runner.forward(params, ids[:, -1:], c,
                                                             logits_last_only=True),
              8, report, top=4)
    del cache, c
    torch.cuda.empty_cache()
    for depth in (1, cfg.num_layers):
        model_reference_check(kt, torch, f"Qwen3-8B, depth {depth}", qwen3_8b_config(depth),
                              first_layers(params, depth), report, layer0_equal=True)
    del params
    torch.cuda.empty_cache()
    return counts


# The Gemma-3-27B pipeline runs' depth: 31 of its 62 layers (26 sliding, 5
# global) keep the whole script near 700 s since the decode-time phase came.
GEMMA3_27B_RUN_LAYERS = 31


def gemma3_run(kt, torch, tokenizer_cls, report):
    """The Gemma-3-27B body at full width, cut to its first
    ``GEMMA3_27B_RUN_LAYERS`` of 62 layers (for the whole script's time; its
    pattern of five sliding layers to one global kept), with random int4
    weights drawn and quantized layer by layer (the bf16 model never exists
    whole) and its SigLIP tower (bf16), through ``KVPressPipeline`` with
    ``pixel_values``: a 32,768-token context holding 4 images of 256
    placeholders at unaligned positions, Knorm(0.5), bf16 KV, one-shot and
    with ``context_chunk=8192`` (two images straddle chunk edges, so the
    chunk starts move). Every layer's prefill runs flash_attention with the
    or-mask (windowed on the sliding layers), the decode kernel runs windowed
    on the sliding layers, flash_attention_quant never; the global layers
    keep half the context and the sliding layers all of it. Then the body cut
    to 6 layers (5 sliding, 1 global) against the dense path at 4,096 tokens
    with two images. Returns the launch counts of both runs."""
    cfg, vcfg = gemma3_27b_config(GEMMA3_27B_RUN_LAYERS), gemma3_vision_config()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    t0 = time.perf_counter()
    params = int4_body(kt, torch, cfg, gen, dev)
    spread_norms(torch, params, cfg, gen)
    tower = kt.init_vision_params(vcfg, gen, torch.bfloat16, dev,
                                  text_hidden_size=cfg.hidden_size)
    torch.cuda.empty_cache()
    report(f"  Gemma-3-27B body (int4) and tower: made in {time.perf_counter() - t0:.1f} s, "
           f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    span, starts = vcfg.mm_tokens_per_image, GEMMA3_IMAGE_STARTS
    context = image_context(CONTEXT_TOKENS, starts, span)
    prefills = []
    runner = kt.Runner.create(cfg, device=dev)
    tok = image_tokenizer(tokenizer_cls, GEMMA3_IMAGE_TOKEN)      # text ids below the placeholder
    pipe = kt.KVPressPipeline(timed_runner(kt, torch, runner, prefills), params, tok,
                              vision_params=tower, vision_cfg=vcfg,
                              image_token_id=GEMMA3_IMAGE_TOKEN)
    ids = torch.tensor([pipe.preprocess(context, [""])[0]], device=dev)
    tt = (ids == GEMMA3_IMAGE_TOKEN).to(torch.int32)
    if ids.shape[1] != CONTEXT_TOKENS or int(tt.sum()) != 4 * span:
        raise AssertionError(f"Gemma3 context: {ids.shape[1]} tokens, {int(tt.sum())} "
                             f"placeholders")
    chunk_starts = kt.Runner.chunk_starts(CONTEXT_TOKENS, CHUNK_TOKENS, tt)
    report(f"  images at {starts}; chunk starts {chunk_starts}")
    if chunk_starts == kt.Runner.chunk_starts(CONTEXT_TOKENS, CHUNK_TOKENS):
        raise AssertionError("no chunk start moved around an image")
    px = torch.rand((4, 3, vcfg.image_size, vcfg.image_size), generator=gen, device=dev) * 2 - 1
    n_global = cfg.num_layers - sum(cfg.sliding_flags())
    totals = {}
    for label, kw, n_chunks in (("one-shot", {}, 1),
                                ("context_chunk 8192", dict(context_chunk=CHUNK_TOKENS),
                                 len(chunk_starts))):
        counts, _, lengths = pipeline_run(
            kt, torch, f"Gemma-3-27B, 32K with 4 images, Knorm, bf16 KV, {label}", pipe,
            prefills, ("flash_attention", "flash_attention_or_mask", "flash_attention_windowed",
                       "decode_attention", "decode_attention_windowed"),
            ("flash_attention_quant", "decode_headwise"), report, context=context,
            press=kt.KnormPress(0.5), pixel_values=px, **kw)
        want = [CONTEXT_TOKENS if s else CONTEXT_TOKENS // 2 for s in cfg.sliding_flags()]
        if lengths != want:
            raise AssertionError(f"Gemma3 {label}: layer lengths {lengths}")
        if counts["flash_attention_or_mask"] != cfg.num_layers * n_chunks:
            raise AssertionError(f"Gemma3 {label}: {counts['flash_attention_or_mask']} or-mask "
                                 f"launches for {cfg.num_layers} layers x {n_chunks} chunks")
        report(f"    global layers {n_global}, sliding {cfg.num_layers - n_global}; windowed "
               f"launches: flash {counts['flash_attention_windowed']}, decode "
               f"{counts['decode_attention_windowed']} of {counts['decode_attention']}")
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n
        torch.cuda.empty_cache()
    del pipe
    torch.cuda.empty_cache()

    # Where the prefill's time goes, on the body cut to its first 6 layers (5
    # sliding, 1 global: the pattern of the whole), the 32K context with its
    # images.
    depth = 6
    cut = dataclasses.replace(cfg, num_layers=depth, layer_is_sliding=cfg.layer_is_sliding[:depth])
    p_cut = first_layers(params, depth)
    embeds = kt.multimodal_embeds(p_cut, cut, ids, tower(px), GEMMA3_IMAGE_TOKEN)
    cut_runner = kt.Runner.create(cut, device=dev)
    breakdown(f"Gemma-3-27B prefill 32K with 4 images cut to {depth} layers, Knorm, bf16 KV",
              lambda: cut_runner.prefill(p_cut, None, press=kt.KnormPress(0.5),
                                         compute_logits=True, inputs_embeds=embeds,
                                         token_types=tt, image_span=span), 1, report, top=8)
    del embeds
    torch.cuda.empty_cache()

    T = 4096
    ids = torch.randint(3, GEMMA3_IMAGE_TOKEN, (1, T), generator=gen, device=dev)
    for s0 in (501, 2222):
        ids[:, s0:s0 + span] = GEMMA3_IMAGE_TOKEN
    embeds = kt.multimodal_embeds(p_cut, cut, ids, tower(px[:2]), GEMMA3_IMAGE_TOKEN)
    model_reference_check(kt, torch, f"Gemma-3-27B with 2 images, depth {depth}", cut, p_cut,
                          report, ids=ids, inputs_embeds=embeds,
                          token_types=(ids == GEMMA3_IMAGE_TOKEN).to(torch.int32),
                          image_span=span)
    del params, p_cut, tower, embeds
    torch.cuda.empty_cache()
    return totals


def gemma3_12b_run(kt, torch, tokenizer_cls, report):
    """The Gemma-3-12B body at full width and depth (48 layers, seeded random
    bf16 weights, head_dim 256) with its SigLIP tower, through
    ``KVPressPipeline`` at 32,768 tokens, two questions and 32 new tokens:
    (a) Knorm(0.5), bf16 KV, the 4 images of the Gemma-3-27B run, one-shot
    and with ``context_chunk=8192`` (flash with the or-mask at 256, windowed
    on the sliding layers, and the decode kernel at 256); (b)
    ObservedAttention(0.5) and AdaKV(ObservedAttention(0.5)) on a text
    context (the column sums, and the row-logsumexp pass, at 256); (c) Knorm
    with int8 KV (the 152-token question forward on flash_attention_quant at
    256). Every launch of these runs must be a head_dim-256 one. The
    head-wise kernel is off on sliding models and the int4 chunks of a 32K
    context take the dense route, so neither runs here (phase 2 holds them).
    Then where the prefill's time goes on the body cut to 6 layers, and the
    cut body against the dense path at 4,096 tokens with two images, at
    depth 1 and 6. Returns the launch counts of the runs."""
    cfg, vcfg = gemma3_12b_config(), gemma3_vision_config()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    t0 = time.perf_counter()
    params = kt.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    spread_norms(torch, params, cfg, gen)
    tower = kt.init_vision_params(vcfg, gen, torch.bfloat16, dev,
                                  text_hidden_size=cfg.hidden_size)
    torch.cuda.empty_cache()
    report(f"  Gemma-3-12B body (bf16) and tower: made in {time.perf_counter() - t0:.1f} s, "
           f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    span = vcfg.mm_tokens_per_image
    images = image_context(CONTEXT_TOKENS, GEMMA3_IMAGE_STARTS, span)
    text = " ".join(f"w{i}" for i in range(CONTEXT_TOKENS))
    prefills = []
    tok = image_tokenizer(tokenizer_cls, GEMMA3_IMAGE_TOKEN)
    pipe = kt.KVPressPipeline(timed_runner(kt, torch, kt.Runner.create(cfg, device=dev), prefills),
                              params, tok, vision_params=tower, vision_cfg=vcfg,
                              image_token_id=GEMMA3_IMAGE_TOKEN)
    image_ids = torch.tensor([pipe.preprocess(images, [""])[0]], device=dev)
    tt = (image_ids == GEMMA3_IMAGE_TOKEN).to(torch.int32)
    n_chunks = len(kt.Runner.chunk_starts(CONTEXT_TOKENS, CHUNK_TOKENS, tt))
    px = torch.rand((4, 3, vcfg.image_size, vcfg.image_size), generator=gen, device=dev) * 2 - 1
    compressed = [CONTEXT_TOKENS if s else CONTEXT_TOKENS // 2 for s in cfg.sliding_flags()]
    n_global = cfg.num_layers - sum(cfg.sliding_flags())
    observed = kt.ObservedAttentionPress(0.5)
    kernels = ("flash_attention", "flash_attention_quant", "decode_attention", "observed_lse",
               "observed_colsum", "decode_headwise")
    image_run = (("flash_attention", "flash_attention_or_mask", "flash_attention_windowed",
                  "decode_attention", "decode_attention_windowed"),
                 ("flash_attention_quant", "decode_headwise", "observed_lse", "observed_colsum"))
    # label: (pipeline options, kernels that must have been launched, kernels
    # that must not, the layer lengths, or-mask launches)
    runs = {
        "32K with 4 images, Knorm, bf16 KV, one-shot": (
            dict(context=images, press=kt.KnormPress(0.5), pixel_values=px), *image_run,
            compressed, cfg.num_layers),
        "32K with 4 images, Knorm, bf16 KV, context_chunk 8192": (
            dict(context=images, press=kt.KnormPress(0.5), pixel_values=px,
                 context_chunk=CHUNK_TOKENS), *image_run, compressed, cfg.num_layers * n_chunks),
        "32K, ObservedAttention, bf16 KV": (
            dict(context=text, press=observed),
            ("flash_attention", "observed_colsum", "decode_attention"),
            ("observed_lse", "flash_attention_quant", "decode_headwise",
             "flash_attention_or_mask"), compressed, 0),
        # AdaKV without compaction keeps each layer's buffer and clears keep-bits
        "32K, AdaKV(ObservedAttention), bf16 KV": (
            dict(context=text, press=kt.AdaKVPress(observed)),
            ("flash_attention", "observed_lse", "observed_colsum", "decode_attention"),
            ("flash_attention_quant", "decode_headwise", "flash_attention_or_mask"),
            [CONTEXT_TOKENS] * cfg.num_layers, 0),
        "32K, Knorm, int8 KV": (
            dict(context=text, press=kt.KnormPress(0.5), quantized=True, kv_bits=8),
            ("flash_attention", "flash_attention_quant", "decode_attention"),
            ("decode_headwise", "observed_lse", "observed_colsum", "flash_attention_or_mask"),
            compressed, 0),
    }
    totals = {}
    for label, (kw, needed, unwanted, lengths, n_or) in runs.items():
        counts, _, got = pipeline_run(kt, torch, f"Gemma-3-12B, {label}", pipe, prefills, needed,
                                      unwanted, report, **kw)
        if got != lengths:
            raise AssertionError(f"Gemma-3-12B {label}: layer lengths {got}")
        if counts["flash_attention_or_mask"] != n_or:
            raise AssertionError(f"Gemma-3-12B {label}: {counts['flash_attention_or_mask']} "
                                 f"or-mask launches, not {n_or}")
        for name in ("observed_lse", "observed_colsum"):
            if counts[name] not in (0, n_global):
                raise AssertionError(f"Gemma-3-12B {label}: {counts[name]} {name} launches for "
                                     f"{n_global} global layers")
        for name in kernels:       # every launch took a head_dim-256 instantiation
            if counts[f"{name}_d256"] != counts[name]:
                raise AssertionError(f"Gemma-3-12B {label}: {name} launched "
                                     f"{counts[name] - counts[f'{name}_d256']} times at another "
                                     f"head_dim")
        # the KV payload the options ask for is the one every launch took
        payload = "int8" if kw.get("kv_bits") == 8 else "bf16"
        for name, kind in (("decode_attention", payload),
                           ("flash_attention_quant", "int8")):
            if counts[f"{name}_{kind}_d256"] != counts[name]:
                raise AssertionError(f"Gemma-3-12B {label}: {name} launched "
                                     f"{counts[name] - counts[f'{name}_{kind}_d256']} times on "
                                     f"another payload than {kind}")
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n
        torch.cuda.empty_cache()
    report("    launches of the head_dim-256 instantiations in these runs: "
           f"{launched({k: n for k, n in totals.items() if k.endswith('_d256')})}")
    del pipe
    torch.cuda.empty_cache()

    # Where the prefill's time goes, on the body cut to its first 6 layers (5
    # sliding, 1 global), the 32K context with its images.
    depth = 6
    cut = dataclasses.replace(cfg, num_layers=depth, layer_is_sliding=cfg.layer_is_sliding[:depth])
    p_cut = first_layers(params, depth)
    embeds = kt.multimodal_embeds(p_cut, cut, image_ids, tower(px), GEMMA3_IMAGE_TOKEN)
    cut_runner = kt.Runner.create(cut, device=dev)
    breakdown(f"Gemma-3-12B prefill 32K with 4 images cut to {depth} layers, Knorm, bf16 KV",
              lambda: cut_runner.prefill(p_cut, None, press=kt.KnormPress(0.5),
                                         compute_logits=True, inputs_embeds=embeds,
                                         token_types=tt, image_span=span), 1, report, top=8)
    del embeds, cut_runner
    torch.cuda.empty_cache()

    T = 4096
    ids = torch.randint(3, GEMMA3_IMAGE_TOKEN, (1, T), generator=gen, device=dev)
    for s0 in (501, 2222):
        ids[:, s0:s0 + span] = GEMMA3_IMAGE_TOKEN
    for d in (1, depth):
        c = dataclasses.replace(cfg, num_layers=d, layer_is_sliding=cfg.layer_is_sliding[:d])
        p_d = first_layers(params, d)
        embeds = kt.multimodal_embeds(p_d, c, ids, tower(px[:2]), GEMMA3_IMAGE_TOKEN)
        model_reference_check(kt, torch, f"Gemma-3-12B with 2 images, depth {d}", c, p_d, report,
                              ids=ids, inputs_embeds=embeds,
                              token_types=(ids == GEMMA3_IMAGE_TOKEN).to(torch.int32),
                              image_span=span)
        del embeds, p_d
    del params, p_cut, tower
    torch.cuda.empty_cache()
    return totals


def phi3_mini_4k_config(num_layers: int = 32):
    """Phi-3-mini-4k (``microsoft/Phi-3-mini-4k-instruct`` config.json: vocab
    32,064, hidden 3,072, FFN 8,192, 32 layers, 32 query / 32 kv heads, so
    head_dim 96, rms eps 1e-5, rope_theta 1e4 without scaling,
    max_position_embeddings 4,096, untied head, silu), written out by hand.
    Its sliding_window of 2,047 is dropped, as ``ModelConfig.from_hf_config``
    drops it for a Phi3 config: every layer is global."""
    from kvpress_tpu_torch.config import ModelConfig

    return ModelConfig(vocab_size=32064, hidden_size=3072, intermediate_size=8192,
                       num_layers=num_layers, num_heads=32, num_kv_heads=32, head_dim=96,
                       rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False,
                       max_position_embeddings=4096, model_type="phi3")


def phi3_run(kt, torch, tokenizer_cls, report):
    """The Phi-3-mini-4k body at full width and depth (32 layers, seeded
    random bf16 weights, head_dim 96, one query head per kv head) through
    ``KVPressPipeline`` with a 3,840-token context, the two questions (152
    and 4 tokens) and 32 new tokens, within its 4,096 positions: (a) Knorm,
    bf16 KV; (b) Knorm, int8 KV (the 152-token question on
    flash_attention_quant); (c) Knorm, int4 KV and int4 weights; (d) Knorm,
    int8 KV, ``context_chunk=1024``; (e) AdaKV(Knorm, compact) on a runner
    with the head-wise decode. Every launch must be a head_dim-96 one, on the
    payload its options ask for, and the layer lengths right. Then the
    prefill's device breakdown, decode tok/s at B=1 with its idle share, and
    the kernel path against the dense path at depth 1 and 32. Returns the
    launch counts of the runs."""
    cfg = phi3_mini_4k_config()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(96)
    t0 = time.perf_counter()
    params = kt.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    params4 = kt.quantize_params_int4(params)
    report(f"  Phi-3-mini-4k body (bf16, and int4): made in {time.perf_counter() - t0:.1f} s, "
           f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    T = PHI3_CONTEXT_TOKENS
    context = " ".join(f"w{i}" for i in range(T))
    tok = tokenizer_cls(vocab_size=cfg.vocab_size)
    prefills = []
    runner = timed_runner(kt, torch, kt.Runner.create(cfg, device=dev), prefills)
    headwise = timed_runner(kt, torch, kt.Runner.create(cfg, decode_kernel=False,
                                                        headwise_kernel=True, device=dev),
                            prefills)
    knorm = kt.KnormPress(0.5)
    kernels = ("flash_attention", "flash_attention_quant", "decode_attention", "observed_lse",
               "observed_colsum", "decode_headwise")
    never = ("observed_lse", "observed_colsum", "flash_attention_or_mask")
    half = [T // 2] * cfg.num_layers
    # label: (runner, params, pipeline options, kernels that must have been
    # launched, kernels that must not, the KV payload, the layer lengths or
    # None for AdaKV's: from T // 2 to T - 1, the longest head of each layer)
    runs = {
        "(a) Knorm, bf16 KV": (runner, params, dict(press=knorm),
                               ("flash_attention", "decode_attention"),
                               ("flash_attention_quant", "decode_headwise"), "bf16", half),
        "(b) Knorm, int8 KV": (runner, params, dict(press=knorm, quantized=True, kv_bits=8),
                               ("flash_attention", "flash_attention_quant", "decode_attention"),
                               ("decode_headwise",), "int8", half),
        "(c) Knorm, int4 KV + int4 weights": (
            runner, params4, dict(press=knorm, quantized=True, kv_bits=4),
            ("flash_attention", "decode_attention"), ("flash_attention_quant", "decode_headwise"),
            "int4", half),
        # int8 chunks always take flash_attention_quant
        f"(d) Knorm, int8 KV, context_chunk {PHI3_CHUNK_TOKENS}": (
            runner, params, dict(press=knorm, quantized=True, kv_bits=8,
                                 context_chunk=PHI3_CHUNK_TOKENS),
            ("flash_attention_quant", "decode_attention"), ("decode_headwise",), "int8", half),
        "(e) AdaKV(Knorm), compact, head-wise decode": (
            headwise, params, dict(press=kt.AdaKVPress(knorm, compact=True)),
            ("flash_attention", "decode_headwise"), ("decode_attention", "flash_attention_quant"),
            "bf16", None),
    }
    totals = {}
    for label, (r, p, kw, needed, unwanted, payload, lengths) in runs.items():
        pipe = kt.KVPressPipeline(r, p, tok)
        counts, _, got = pipeline_run(kt, torch, f"Phi-3-mini, {label}", pipe, prefills, needed,
                                      unwanted + never, report, context=context, **kw)
        if lengths is not None and got != lengths:
            raise AssertionError(f"Phi-3-mini {label}: layer lengths {got}")
        if lengths is None and not all(T // 2 <= n < T for n in got):
            raise AssertionError(f"Phi-3-mini {label}: layer lengths {got}")
        for name in kernels:       # every launch took a head_dim-96 instantiation
            if counts[f"{name}_d96"] != counts[name]:
                raise AssertionError(f"Phi-3-mini {label}: {name} launched "
                                     f"{counts[name] - counts[f'{name}_d96']} times at another "
                                     f"head_dim")
        # the instantiation the options ask for is the one every launch took
        for name, kind in (("decode_attention", payload), ("flash_attention_quant", "int8"),
                           ("decode_headwise", "bf16"), ("flash_attention", "bf16")):
            if counts[f"{name}_{kind}_d96"] != counts[name]:
                raise AssertionError(f"Phi-3-mini {label}: {name} launched "
                                     f"{counts[name] - counts[f'{name}_{kind}_d96']} times on "
                                     f"another payload than {kind}")
        for name in needed:
            kind = {"decode_attention": payload, "flash_attention_quant": "int8"}.get(name, "bf16")
            if counts[f"{name}_{kind}_d96"] == 0:
                raise AssertionError(f"Phi-3-mini {label}: {name} at {kind}, head_dim 96, was "
                                     f"never launched")
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n
        del pipe
        torch.cuda.empty_cache()
    report("    launches of the head_dim-96 instantiations in these runs: "
           f"{launched({k: n for k, n in totals.items() if k.endswith('_d96')})}")
    del params4
    torch.cuda.empty_cache()

    # Where the prefill's time goes (all 32 layers), then decode over the
    # compressed cache: tok/s (B=1, 32 steps, median of 3 passes) and one
    # step's device breakdown (idle share).
    ids = torch.randint(3, cfg.vocab_size, (1, T), generator=gen, device=dev)
    plain_runner = kt.Runner.create(cfg, device=dev)
    breakdown("Phi-3-mini prefill 3,840 tokens, Knorm, bf16 KV",
              lambda: plain_runner.prefill(params, ids, press=knorm, compute_logits=True), 3,
              report, top=6)
    _, cache, _ = plain_runner.prefill(params, ids, press=knorm)
    steps = 32
    cache = kt.resize(cache, T // 2 + steps + 1)
    base_len, base_off = cache.length, cache.offset
    rates = []
    for _ in range(3):
        c, tok_ = dataclasses.replace(cache, length=base_len, offset=base_off), ids[:, -1:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, c, _ = plain_runner.forward(params, tok_, c, logits_last_only=True)
            tok_ = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        torch.cuda.synchronize()
        rates.append(steps / (time.perf_counter() - t0))
    report(f"  Phi-3-mini decode B=1 over a 3,840-token context at ratio 0.5, bf16 KV: "
           f"{statistics.median(rates):.1f} tok/s (passes {[round(x, 1) for x in rates]})")
    c = dataclasses.replace(cache, length=base_len, offset=base_off)
    breakdown("Phi-3-mini decode step", lambda: plain_runner.forward(params, ids[:, -1:], c,
                                                                     logits_last_only=True),
              8, report, top=4)
    del cache, c
    torch.cuda.empty_cache()
    for depth in (1, cfg.num_layers):
        model_reference_check(kt, torch, f"Phi-3-mini, depth {depth}", phi3_mini_4k_config(depth),
                              first_layers(params, depth), report, layer0_equal=True)
    del params
    torch.cuda.empty_cache()
    return totals


def model_reference_check(kt, torch, label, cfg, params, report, ids=None, inputs_embeds=None,
                          token_types=None, image_span=None, layer0_equal=False):
    """The kernel path against the dense path (attn_impl "xla") on one model
    (``compare_paths``): a Knorm(0.5) prefill (``ids``, or 2,048 random
    tokens; with images through ``inputs_embeds`` and ``token_types``), a
    150-token question, 4 decode steps. The first compressed layer keeps the
    same slots with ``layer0_equal`` (its keys do not depend on attention).
    Limits: REF_LIMIT at depth 1; deeper, its deepest and the F32_RATIO gate
    over dense bf16 against dense float32 at the same depth. The planted
    faults (on a model with sliding layers, in slots their windows see from
    the end of the context) must read above them."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    if ids is None:
        ids = torch.randperm(cfg.vocab_size, generator=gen, device=dev)[:REF_CONTEXT][None]
    question = torch.randint(3, min(cfg.vocab_size, GEMMA3_IMAGE_TOKEN), (1, REF_QUESTION),
                             generator=gen, device=dev)
    kernel = kt.Runner.create(cfg, device=dev)
    dense = kt.Runner.create(cfg, attn_impl="xla", decode_kernel=False, device=dev)
    S = ids.shape[1]

    def prefill(r, p, log, embeds=inputs_embeds):
        return r.prefill(p, None if embeds is not None else ids,
                         press=recording_scorer(torch, kt.KnormPress, log), max_size=S,
                         compute_logits=True, inputs_embeds=embeds, token_types=token_types,
                         image_span=image_span)

    noise = None
    if cfg.num_layers > 1:
        noise = f32_noise(torch, label, lambda p, log, **kw: prefill(dense, p, log, **kw),
                          params, report, **({} if inputs_embeds is None else
                                             {"embeds": inputs_embeds.float()}))
    failures, _ = compare_paths(
        kt, torch, f"{label}, {S} tokens", (kernel, dense), params,
        (lambda log: prefill(kernel, params, log), lambda log: prefill(dense, params, log)),
        question, REF_LIMIT[1] if cfg.num_layers == 1 else max(REF_LIMIT.values()), report,
        fault_lo=S - 768 if cfg.sliding_window else 256, layer0_slots=0 if layer0_equal else None,
        noise=noise)
    if failures:
        raise AssertionError("; ".join(failures))


# --------------------------------------------------------------------- #
# Phase 4: timings


def timings(kt, torch, params, params8, report):
    cfg = flagship_config(16)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    runner = kt.Runner.create(cfg, device=dev)
    press = kt.KnormPress(0.5)

    ids = torch.randint(3, cfg.vocab_size, (1, CONTEXT_TOKENS), generator=gen, device=dev)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.prefill(params, ids, press=press, compute_logits=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    prefill_ms = statistics.median(times) * 1e3
    report(f"  prefill 32K (bf16 KV, Knorm 0.5, B=1): median {prefill_ms:.1f} ms "
           f"({CONTEXT_TOKENS / prefill_ms * 1e3:.0f} tok/s) over {[round(t, 3) for t in times]} s")
    breakdown("prefill 32K", lambda: runner.prefill(params, ids, press=press,
                                                    compute_logits=True), 1, report)
    params4 = kt.quantize_params_int4(params)
    for label, p, kv in (("int8 KV", params, dict(quantized=True, kv_bits=8)),
                         ("int4 KV + int4 weights, dense route", params4,
                          dict(quantized=True, kv_bits=4, fused_kv=False)),
                         ("int4 KV + int4 weights, fused route", params4,
                          dict(quantized=True, kv_bits=4, fused_kv=True))):
        def call():
            return runner.prefill_chunked(p, ids, press=press, chunk_size=CHUNK_TOKENS,
                                          compute_logits=True, **kv)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = statistics.median(times) * 1e3
        report(f"  prefill 32K chunked by {CHUNK_TOKENS} (Knorm 0.5, {label}, B=1): median "
               f"{ms:.1f} ms over {[round(t, 3) for t in times]} s")
        breakdown(f"prefill 32K chunked, {label}", call, 1, report, top=8)
    del params4

    B, steps = DECODE_BATCH, 32
    ids = torch.randint(3, cfg.vocab_size, (B, CONTEXT_TOKENS), generator=gen, device=dev)
    _, cache, _ = runner.prefill(params8, ids, press=press, quantized=True, kv_bits=4)
    cache = kt.resize(cache, CONTEXT_TOKENS // 2 + steps + 1)
    base_len, base_off = cache.length, cache.offset
    tok0 = ids[:, -1:]
    decode = {}
    for decode_kernel in (True, False, True, False):
        r = kt.Runner.create(cfg, decode_kernel=decode_kernel, device=dev)
        rates = []
        for _ in range(3):
            c = dataclasses.replace(cache, length=base_len, offset=base_off)
            tok = tok0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, c, _ = r.forward(params8, tok, c, logits_last_only=True)
                tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            torch.cuda.synchronize()
            rates.append(B * steps / (time.perf_counter() - t0))
        decode.setdefault(decode_kernel, []).append(statistics.median(rates))
    for k, v in decode.items():
        report(f"  decode B={B} x 32K ctx, ratio 0.5, int4 KV + int8 weights, "
               f"decode_kernel={k}: {statistics.median(v):.1f} tok/s (per-pass medians {v})")
    for decode_kernel in (True, False):
        r = kt.Runner.create(cfg, decode_kernel=decode_kernel, device=dev)
        c = dataclasses.replace(cache, length=base_len, offset=base_off)
        names = breakdown(f"decode step (decode_kernel={decode_kernel})",
                          lambda: r.forward(params8, tok0, c, logits_last_only=True), 8, report)
        # The decode kernel finds its live steps itself: no sort in the step.
        sorts = [name for name in names if "sort" in name.lower()]
        if decode_kernel and sorts:
            raise AssertionError(f"a sort ran in the decode-kernel step: {sorts}")

    # Paths A and B: the prefill under each press, then path B's decode over
    # per-head prefixes against the same cache decoded by the dense route
    # (attn_impl "xla") and by the decode kernel (live steps of the keep-mask).
    del cache, c
    torch.cuda.empty_cache()
    headwise = kt.Runner.create(cfg, decode_kernel=False, headwise_kernel=True, device=dev)
    observed = kt.ObservedAttentionPress(0.5)
    adakv = kt.AdaKVPress(observed, compact=True)
    ids = torch.randint(3, cfg.vocab_size, (1, CONTEXT_TOKENS), generator=gen, device=dev)
    for label, r, scorer in (("path A, ObservedAttention(0.5)", runner, observed),
                         ("path B, AdaKV(ObservedAttention(0.5), compact)", headwise, adakv)):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.prefill(params, ids, press=scorer, compute_logits=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = statistics.median(times) * 1e3
        report(f"  prefill 32K ({label}, bf16 KV, B=1): median {ms:.1f} ms "
               f"({CONTEXT_TOKENS / ms * 1e3:.0f} tok/s) over {[round(t, 3) for t in times]} s")
        breakdown(f"prefill 32K, {label}",
                  lambda: r.prefill(params, ids, press=scorer, compute_logits=True), 1, report)

    routes = {"head-wise kernel": headwise,
              "dense route": kt.Runner.create(cfg, attn_impl="xla", decode_kernel=False,
                                              device=dev),
              "decode kernel": runner}
    for B in (1, DECODE_BATCH):
        ids = torch.randint(3, cfg.vocab_size, (B, CONTEXT_TOKENS), generator=gen, device=dev)
        _, cache, _ = headwise.prefill(params, ids, press=adakv)
        kept = cache.mask.sum(-1)                          # (L, B, Hkv)
        report(f"  path B cache, B={B}: longest head per layer {cache.length.tolist()}, "
               f"heads keep {int(kept.min())} to {int(kept.max())} of {CONTEXT_TOKENS}")
        cache = kt.resize(cache, int(cache.length.max()) + steps + 1)
        base_len, base_off = cache.length, cache.offset
        tok0 = ids[:, -1:]
        decode = {name: [] for name in routes}
        for _ in range(2):
            for name, r in routes.items():
                rates = []
                for _ in range(3):
                    c = dataclasses.replace(cache, length=base_len, offset=base_off)
                    tok = tok0
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(steps):
                        logits, c, _ = r.forward(params, tok, c, logits_last_only=True)
                        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
                    torch.cuda.synchronize()
                    rates.append(B * steps / (time.perf_counter() - t0))
                decode[name].append(statistics.median(rates))
        for name, v in decode.items():
            report(f"  decode B={B} x 32K ctx, path B cache, bf16 KV, {name}: "
                   f"{statistics.median(v):.1f} tok/s (per-pass medians {v})")
        for name, r in routes.items():
            c = dataclasses.replace(cache, length=base_len, offset=base_off)
            breakdown(f"decode step, B={B}, path B cache, {name}",
                      lambda: r.forward(params, tok0, c, logits_last_only=True), 8, report, top=4)
        del cache, c
        torch.cuda.empty_cache()


def breakdown(label, fn, iters, report, top=6):
    """Where one call's time goes on the card: wall time, the device's busy
    time (sum of kernel times; kernels do not overlap on one stream), its idle
    share, and the kernels that take the most time. Returns the names of
    every kernel it ran."""
    wall, kernels = device_kernels(fn, iters)
    busy = sum(ms for ms, _ in kernels.values())
    launches = sum(n for _, n in kernels.values())
    report(f"  {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
           f"{1 - busy / wall:.3f}, {launches:.0f} kernel launches")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        report(f"    {ms:8.3f} ms  x{n:<5.0f} {name[:90]}")
    return list(kernels)


# --------------------------------------------------------------------- #


_CSRC = "kvpress_tpu_torch/csrc/"
# The kernels line, one entry per instantiation that phase 2 holds against
# its plain version: (the check it reads, source, the TPU kernel it
# replaces, the check's variant, the main path's launch count it takes).
SOURCES = {
    "flash_attention": ("flash_attention", _CSRC + "flash.cu", "kvpress_tpu/ops/flash.py:154",
                        "bf16 B1 T8192 S8192 masked", "flash_attention_d64"),
    "flash_attention_quant": ("flash_attention_quant", _CSRC + "flash_quant.cu",
                              "kvpress_tpu/ops/flash.py:435", "int8 B1 T256 prior16384",
                              "flash_attention_quant_d64"),
    "decode_attention": ("decode_attention", _CSRC + "decode.cu", "kvpress_tpu/ops/decode.py:212",
                         "int4 B4 16K unmasked", "decode_attention_d64"),
    "observed_lse": ("observed_lse", _CSRC + "observed_colsum.cu",
                     "kvpress_tpu/ops/observed_colsum.py:34", "B1 S8192", "observed_lse_d64"),
    "observed_colsum": ("observed_colsum", _CSRC + "observed_colsum.cu",
                        "kvpress_tpu/ops/observed_colsum.py:87", "flash lse, B1 S8192",
                        "observed_colsum_d64"),
    "decode_headwise": ("decode_headwise", _CSRC + "decode_headwise.cu",
                        "kvpress_tpu/ops/decode_headwise.py:236", "bf16 B4 T1 16K ragged",
                        "decode_headwise_d64"),
    # the Duo split decode's two buffers (flagship, 32K)
    "decode_attention_duo_retrieval": ("decode_attention", _CSRC + "decode.cu",
                                       "kvpress_tpu/ops/decode.py:212",
                                       "bf16 B1 Duo retrieval 5/8 heads 32K",
                                       "decode_attention_bf16_d64"),
    "decode_attention_duo_streaming": ("decode_attention", _CSRC + "decode.cu",
                                       "kvpress_tpu/ops/decode.py:212",
                                       "bf16 B1 Duo streaming 4/8 heads 417",
                                       "decode_attention_bf16_d64"),
    # head_dim 128 (the 8B-class, Qwen3-8B and Gemma-3-27B bodies)
    "flash_attention_d128": ("flash_attention", _CSRC + "flash.cu", "kvpress_tpu/ops/flash.py:154",
                             "bf16 B1 T32768 S32768 D128 all-live",
                             "flash_attention_bf16_d128"),
    # the or-mask branch of flash_attention: its own instantiation of the loop
    "flash_attention_or_mask": ("flash_attention_or_mask", _CSRC + "flash.cu",
                                "kvpress_tpu/ops/flash.py:106",
                                "bf16 B1 T8192 S8192 D128 4 images window 1024",
                                "flash_attention_or_mask_d128"),
    "flash_attention_quant_d128": ("flash_attention_quant", _CSRC + "flash_quant.cu",
                                   "kvpress_tpu/ops/flash.py:435", "int8 B1 T4096 S4096 D128 masked",
                                   "flash_attention_quant_d128"),
    "decode_attention_d128": ("decode_attention", _CSRC + "decode.cu",
                              "kvpress_tpu/ops/decode.py:212", "bf16 B1 16K D128",
                              "decode_attention_d128"),
    # head_dim 256 (the Gemma-3-12B body)
    "flash_attention_d256": ("flash_attention", _CSRC + "flash.cu", "kvpress_tpu/ops/flash.py:154",
                             "bf16 B1 T32768 S32768 D256 GQA 16/8 all-live",
                             "flash_attention_bf16_d256"),
    "flash_attention_or_mask_d256": ("flash_attention_or_mask", _CSRC + "flash.cu",
                                     "kvpress_tpu/ops/flash.py:106",
                                     "bf16 B1 T32768 S32768 D256 GQA 16/8 4 images window 1024",
                                     "flash_attention_or_mask_d256"),
    "flash_attention_quant_int8_d256": ("flash_attention_quant", _CSRC + "flash_quant.cu",
                                        "kvpress_tpu/ops/flash.py:435",
                                        "int8 B1 T152 prior16384 D256 GQA 16/8 half live",
                                        "flash_attention_quant_int8_d256"),
    "flash_attention_quant_int4_d256": ("flash_attention_quant", _CSRC + "flash_quant.cu",
                                        "kvpress_tpu/ops/flash.py:435",
                                        "int4 B1 T8192 prior24576 S32768 D256 GQA 16/8 chunk",
                                        "flash_attention_quant_int4_d256"),
    "decode_attention_d256": ("decode_attention", _CSRC + "decode.cu",
                              "kvpress_tpu/ops/decode.py:212", "bf16 B1 16K D256 GQA 16/8",
                              "decode_attention_bf16_d256"),
    "decode_attention_int8_d256": ("decode_attention", _CSRC + "decode.cu",
                                   "kvpress_tpu/ops/decode.py:212", "int8 B1 16K D256 GQA 16/8",
                                   "decode_attention_int8_d256"),
    "decode_attention_int4_d256": ("decode_attention", _CSRC + "decode.cu",
                                   "kvpress_tpu/ops/decode.py:212", "int4 B4 16K D256 GQA 16/8",
                                   "decode_attention_int4_d256"),
    "observed_lse_d256": ("observed_lse", _CSRC + "observed_colsum.cu",
                          "kvpress_tpu/ops/observed_colsum.py:34", "B1 S32768 D256 GQA 16/8",
                          "observed_lse_d256"),
    "observed_colsum_d256": ("observed_colsum", _CSRC + "observed_colsum.cu",
                             "kvpress_tpu/ops/observed_colsum.py:87",
                             "flash lse, B1 S32768 D256 GQA 16/8", "observed_colsum_d256"),
    "decode_headwise_d256": ("decode_headwise", _CSRC + "decode_headwise.cu",
                             "kvpress_tpu/ops/decode_headwise.py:236",
                             "bf16 B4 T1 16K ragged D256 GQA 16/8", "decode_headwise_d256"),
    # head_dim 96 (the Phi-3-mini body, 32 query heads on 32 kv heads)
    "flash_attention_d96": ("flash_attention", _CSRC + "flash.cu", "kvpress_tpu/ops/flash.py:154",
                            "bf16 B1 T3840 S3840 D96 GQA 32/32 all-live",
                            "flash_attention_bf16_d96"),
    "flash_attention_or_mask_d96": ("flash_attention_or_mask", _CSRC + "flash.cu",
                                    "kvpress_tpu/ops/flash.py:106",
                                    "bf16 B1 T3840 S3840 D96 GQA 32/32 2 images",
                                    "flash_attention_or_mask_d96"),
    "flash_attention_quant_int8_d96": ("flash_attention_quant", _CSRC + "flash_quant.cu",
                                       "kvpress_tpu/ops/flash.py:435",
                                       "int8 B1 T152 prior3840 D96 GQA 32/32 half live",
                                       "flash_attention_quant_int8_d96"),
    "flash_attention_quant_int4_d96": ("flash_attention_quant", _CSRC + "flash_quant.cu",
                                       "kvpress_tpu/ops/flash.py:435",
                                       "int4 B1 T1024 prior3072 S4096 D96 GQA 32/32 chunk",
                                       "flash_attention_quant_int4_d96"),
    "decode_attention_d96": ("decode_attention", _CSRC + "decode.cu",
                             "kvpress_tpu/ops/decode.py:212", "bf16 B1 4K half live D96 GQA 32/32",
                             "decode_attention_bf16_d96"),
    "decode_attention_int8_d96": ("decode_attention", _CSRC + "decode.cu",
                                  "kvpress_tpu/ops/decode.py:212",
                                  "int8 B1 4K half live D96 GQA 32/32",
                                  "decode_attention_int8_d96"),
    "decode_attention_int4_d96": ("decode_attention", _CSRC + "decode.cu",
                                  "kvpress_tpu/ops/decode.py:212",
                                  "int4 B1 4K half live D96 GQA 32/32",
                                  "decode_attention_int4_d96"),
    "observed_lse_d96": ("observed_lse", _CSRC + "observed_colsum.cu",
                         "kvpress_tpu/ops/observed_colsum.py:34", "B1 S32768 D96 GQA 32/32",
                         "observed_lse_d96"),
    "observed_colsum_d96": ("observed_colsum", _CSRC + "observed_colsum.cu",
                            "kvpress_tpu/ops/observed_colsum.py:87",
                            "flash lse, B1 S32768 D96 GQA 32/32", "observed_colsum_d96"),
    "decode_headwise_d96": ("decode_headwise", _CSRC + "decode_headwise.cu",
                            "kvpress_tpu/ops/decode_headwise.py:236",
                            "bf16 B4 T1 16K ragged D96 GQA 32/32", "decode_headwise_d96"),
}


# The kernels built on wgmma, by library: every instantiation of each must
# hold HGMMA instructions in its own machine code.
WGMMA_KERNELS = {"flash": ("flash_sm90_kernel",), "flash_quant": ("flash_sm90_kernel",),
                 "observed_colsum": ("observed_colsum_kernel", "observed_lse_kernel")}


def hgmma_by_function(sass: str) -> dict:
    """The number of HGMMA instructions in each function of a library's
    ``cuobjdump -sass`` listing, by mangled name."""
    counts, function = {}, None
    for line in sass.splitlines():
        header = re.match(r"\s*Function : (\S+)", line)
        if header:
            function = header.group(1)
            counts[function] = 0
        elif function is not None and "HGMMA" in line:
            counts[function] += 1
    return counts


def build_report(_build, report):
    """What the compiler said of each kernel: registers, shared memory and
    spills, and every ptxas remark about wgmma (it says so when it has to
    serialise ``wgmma.mma_async``). The kernels built on wgmma (the two flash
    kernels and the two column-sum passes) and the two decode kernels must
    spill nothing, and every instantiation of the wgmma kernels must hold
    wgmma instructions (HGMMA in its own machine code)."""
    wgmma_libs = tuple(WGMMA_KERNELS)
    no_spill = wgmma_libs + ("decode", "decode_headwise")
    failures = []
    for log in sorted(_build.build_dir().glob("*.log")):
        name = log.stem.split("-")[0].removeprefix("lib")
        function = name
        for line in log.read_text().splitlines():
            if "Function properties for" in line:
                function = line.rsplit(" ", 1)[-1]
            if any(word in line for word in ("registers", "spill", "wgmma", "serialized")):
                report(f"  {name}: {function}: {line.strip()[:300]}")
            spilled = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if name in no_spill and spilled and any(int(x) for x in spilled.groups()):
                failures.append(f"{name} spills in {function}: {line.strip()}")
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    for name in wgmma_libs:
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build._library_path(name))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        counts = hgmma_by_function(sass)
        for kernel in WGMMA_KERNELS[name]:
            mine = {fn: n for fn, n in counts.items() if kernel in fn}
            report(f"  {name}: {sum(mine.values())} wgmma instructions (HGMMA) in the machine "
                   f"code of {len(mine)} instantiations of {kernel}")
            if not mine:
                failures.append(f"{name} holds no function {kernel}")
            failures += [f"{name}: {fn} holds no wgmma instruction"
                         for fn, n in mine.items() if n == 0]
    if failures:
        raise AssertionError("; ".join(failures))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import kvpress_tpu_torch as kt
    from kvpress_tpu_torch.ops import _build
    from toy_tokenizer import ToyTokenizer

    t_start = time.perf_counter()

    def report(msg):
        print(f"[{time.perf_counter() - t_start:7.1f}s] {msg}", flush=True)

    card = device_line()
    print(card, flush=True)
    report(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    report("phase 2: build kernels")
    built = _build.build()
    report(f"  nvcc seconds (parallel): { {k: round(v, 1) for k, v in built.items()} }")
    build_report(_build, report)
    report(f"phase 2: kernels vs plain on {card}")
    checks = kernel_checks(kt, torch, report)

    report("phase 3: KVPressPipeline at the flagship shape, 32K: KnormPress(0.5), path A "
           "(ObservedAttentionPress), path B (AdaKVPress(ObservedAttentionPress), compact)")
    params, params8, launches = main_path(kt, torch, ToyTokenizer, report)
    report("phase 3: the scorer presses at the flagship shape, 32K: ExpectedAttention (bf16 and "
           "int8 KV, stats, AdaKV compact), KeyDiff, LagKV, CUR, CAP, QFilter, Compactor, KVzap")
    for name, n in scorer_presses_run(kt, torch, ToyTokenizer, params, report).items():
        launches[name] += n
    report(f"phase 3: bucketed prefill at the flagship shape: {BUCKET_CONTEXT} tokens, "
           f"context_bucket={BUCKET}, Knorm and ExpectedAttention")
    for name, n in bucketed_check(kt, torch, ToyTokenizer, params, report).items():
        launches[name] += n
    report("phase 3: the wrapper presses at the flagship shape, 32K: CriticalKV, CriticalAdaKV, "
           "KeyRerotation, Chunk, ChunkKV, Block, ThinK, Composed, PerLayerCompression (one-shot "
           "and chunked), bucketed CriticalKV")
    for name, n in wrapper_presses_run(kt, torch, ToyTokenizer, params, report).items():
        launches[name] += n
    report("phase 3: the mask, merge and head-split presses at the flagship shape, 32K: Merging, "
           "LUKV, SimLayerKV, Finch, Duo (and its split-cache decode), DMS(KVzap) mask only and "
           "compact (one-shot and chunked), the refusals")
    for name, n in mask_presses_run(kt, torch, ToyTokenizer, params, report).items():
        launches[name] += n
    report("phase 3: the decode-time presses at the flagship shape, 32K: DecodingPress (bf16, "
           "int8, int4 KV; chunked), CompressionRatioDecodingPress, PrefillDecodingPress, "
           "CAMPress (bf16, int8 KV), DMS(KVzap) decoding (one-shot, chunked), a sliding body, "
           "the refusals")
    t_phase = time.perf_counter()
    for name, n in decode_presses_run(kt, torch, ToyTokenizer, params, report).items():
        launches[name] += n
    report(f"  the decode-time phase took {time.perf_counter() - t_phase:.1f} s")
    report("phase 3: chunked prefill's int4 routes at the flagship shape, 32K")
    for name, n in fused_int4_check(kt, torch, params, report).items():
        launches[name] += n
    report("phase 3: the 8B-class body at 131,072 tokens, chunked")
    for name, n in long_context_run(kt, torch, ToyTokenizer, report).items():
        launches[name] += n
    report("phase 3: the Qwen3-8B body at full width and depth, 32K")
    for name, n in qwen3_run(kt, torch, ToyTokenizer, report).items():
        launches[name] += n
    report(f"phase 3: the Gemma-3-27B body (int4, {GEMMA3_27B_RUN_LAYERS} of 62 layers) with 4 "
           "images, 32K, one-shot and "
           "chunked")
    for name, n in gemma3_run(kt, torch, ToyTokenizer, report).items():
        launches[name] += n
    report("phase 3: the Gemma-3-12B body (bf16, 48 layers, head_dim 256): 4 images one-shot and "
           "chunked, paths A and AdaKV(Observed), int8 KV, 32K")
    for name, n in gemma3_12b_run(kt, torch, ToyTokenizer, report).items():
        launches[name] += n
    report("phase 3: the Phi-3-mini-4k body (bf16, 32 layers, head_dim 96, 32/32 heads), "
           f"{PHI3_CONTEXT_TOKENS} tokens: Knorm with bf16, int8 and int4 KV, chunked by "
           f"{PHI3_CHUNK_TOKENS}, AdaKV(Knorm) compact")
    for name, n in phi3_run(kt, torch, ToyTokenizer, report).items():
        launches[name] += n
    reference_check(kt, torch, params, report)
    report(f"phase 3: chunked prefill (chunks of {REF_CHUNK}) against the dense path")
    reference_check(kt, torch, params, report, chunk=REF_CHUNK)
    report("phase 3: the decode-time presses against the dense path")
    decode_reference_check(kt, torch, params, report)

    report(f"phase 4: timings on {card}")
    timings(kt, torch, params, params8, report)

    kernels = []
    for name, (check, src, replaces, variant, count) in SOURCES.items():
        row = checks[check][variant]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[count],
                        **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")}})
    report(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
