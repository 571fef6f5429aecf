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
   8B-class body at head_dim 128 over 131,072 slots; and, with the row
   LSE, KVCompose's re-feed chunk: 8,192 queries over 57,344 of 65,536
   slots, ``flash_attention`` and ``flash_attention_quant`` at int8), the
   column-sum passes
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
   ``compact`` with ``decoding``, PrefillDecodingPress chunked). Then the
   multi-pass presses at the same shape (``multipass_presses_run``):
   KVzipPress over bf16 KV one-shot (the cache grown for its 16 repeat
   passes), compact on the head-wise runner, over int8 KV chunked by 8,192
   (presized: no grow), KVzip+ over bf16 and int8 KV (the scorer route),
   RestoreKVPress (16 restore embeddings and a rank-8 LoRA read back from
   their ``.npz``), FastKVzipPress (seeded gates) one-shot, chunked and
   compact, KVComposePress structured and unstructured chunked by 8,192 (the
   re-feed over a 65,536-slot buffer), structured over int8 KV, and one-shot
   at 4,096 tokens; each with its scoring passes' wall and peak, the kept
   entries per layer (KVzip's and FastKVzip's masked share exact, RestoreKV
   budget-matched, KVCompose's lengths its budgets and its rebuilt layers the
   context's kept entries in position order), the context's slots, length
   and offset bit-equal through the scoring passes, every launch count exact.
   Then ``Runner.prefill_chunked`` at 32K over int4 KV on its fused route
   (``flash_attention_quant`` at 4 bits) held against its dense route
   (``fused_int4_check``; also the peak memory of chunked and one-shot
   prefill), and a Llama-3.1-8B-class body (8 of 32 layers, random int4 weights)
   through the pipeline with int4 KV, Knorm and a 131,072-token context in
   chunks of 8,192 (``long_context_run``). Then the other architectures at
   full width: the Qwen3-8B body (18 of 36 layers, bf16, q/k-norm;
   ``qwen3_run``) and the Gemma-3-27B body (int4, cut to 18 of its 62 layers, sliding
   layers with window 1,024, a SigLIP tower; ``gemma3_run``) through the
   pipeline at 32K,
   Knorm and bf16 KV (Qwen3 also ExpectedAttention), Gemma3 with 4 images
   one-shot and with ``context_chunk=8192``: the or-mask on every layer's prefill, the window
   on the sliding layers' flash and decode launches, the sliding layers
   uncompressed; each also held against the dense path (Qwen3 at depth 1
   and 18, Gemma3 cut to 6 layers at 4,096 tokens with two images), and
   Qwen3's decode rate and idle share. Then the Gemma-3-12B body (12 of
   its 48 layers, bf16, head_dim 256; ``gemma3_12b_run``) at 32K: Knorm with the
   4 images one-shot and chunked, ObservedAttention and
   AdaKV(ObservedAttention) without images, Knorm with int8 KV, every
   launch on a head_dim-256 instantiation; cut to 6 layers against the
   dense path at depth 1 and 6 with two images. Then the Phi-3-mini-4k body
   (16 of 32 layers, bf16, head_dim 96, 32/32 heads; ``phi3_run``) with a
   3,840-token context: Knorm with bf16, int8 and int4 KV (int4 weights),
   with int8 KV chunked by 1,024, and AdaKV(Knorm) compact on the head-wise
   runner, every launch on a head_dim-96 instantiation of the payload its
   options ask for; its prefill breakdown, decode rate and idle share; held
   against the dense path at depth 1 and 16. Every prefill's wall time and
   peak memory are printed. The launch counts are set to 0 before each run
   and read after it, and every kernel of a path must have been launched in
   it. A 2,048-token run of each kernel path is also held against the dense
   path on the same weights, stage by stage, at depth 1 and 16
   (``reference_check``: Knorm, paths A and B, ExpectedAttention,
   Compactor, KeyRerotation, CriticalAdaKV(SnapKV) compact, Duo and
   DMS(KVzap) compact; chunked prefill in chunks of 512 too), and each
   decode-time press (Decoding, DMS(KVzap) decoding, CAM) stage by stage
   through 16 decode steps past its compressions
   (``decode_reference_check``), and KVzip, FastKVzip and chunked KVCompose
   stage by stage through their scoring passes
   (``multipass_reference_check``). The continuous-batching engine
   (``serving_run``): ``ServingEngine`` at the flagship shape with 8 slots,
   Knorm over bf16, int8 and int4 slots (16 requests of 8,192 and 16,384
   tokens, 64 new tokens each), PrefillDecodingPress with per-slot decode
   compression, chunked interleaved admission with the context LRU,
   ``KVPressPipeline.batch()``, 1 slot against 8, and sampling; answers
   teacher-forced against the single-request path, the pool's rows, host
   lengths, LRU entries, launch counts and the in-step kernel against its
   plain version checked, each check with its planted fault; phase 2 also
   holds ``decode_attention`` at the slot step's ragged shape (8 slots of
   8,449, each slot's causality and window in the mask). Tensor-parallel
   serving (``tp_serving_run``): 4 requests of S2's mix through ``ServingEngine(mesh=)``
   over a world of one over NCCL in this process, its answers, host lengths
   and offsets and every pool tensor identical to the single-process
   engine's (a world of one sums over one rank), decode 16 a slot step and
   flash 16 + ``flash_attention_quant`` 16 an admission; the same for each
   shard-local press of ROADMAP items 18.1-18.11 (two requests of 2,048 and
   4,096 tokens a press), with its prefill timed on the rank's runner and
   on one process, and CriticalKV's ``||Wo v||`` per rank against the
   single device's heads (bf16 and int4 weights, two planted faults); then
   a world of two spawned ranks sharing the card over gloo (NCCL refuses two
   ranks on one device; gloo takes CUDA tensors) with a ``model=2`` and a
   ``data=2`` mesh, 4 requests of 2,048 and 4,096 tokens each (``model=2``
   also CriticalKV, KeyRerotation, Composed(Knorm, ThinK) and Block(Knorm),
   2 requests each):
   every answer teacher-forced against the single-process runner, host
   lengths, each rank's launches and the (16, 4) or (32, 8) heads its
   kernels took. Context parallelism (``cp_run``):
   ``context_parallel_generate`` at the flagship shape over a world of one
   over NCCL at 32K (Knorm 0.5, 32 new tokens, bf16 then int8 shards): flash
   16 a prefill, lengths and layer 0's kept keys the single-process
   prefill's, tokens teacher-forced against it, the wall time, peak memory
   and a decode step's busy time and idle share beside the single-process
   step's; then a 4-rank world sharing the card over gloo (gloo's send and
   recv do not take CUDA tensors: each ring block goes through host
   memory), seq 4 over 16,384 tokens (bf16, int8, and fused: the host
   loop's tokens) and model 2 x seq 2 over 8,192, teacher-forced against
   ``ChunkPress(Knorm(0.5), 4096)``, with each rank's flash launches (16
   (r + 1) on seq rank r), lengths and heads. Phase 2 holds flash at the
   ring's block shapes (prior 4,096, 8,192, 12,288 over 4,096 keys; a
   window of 1,024 at head_dim 64 and 256, with rows that see no key, and
   the LSE combine with the diagonal block against the dense attention).
   KVzap training and its surrogate served (``kvzap_run``, phase "KZ"): (a)
   ``init_params_int8`` at Llama-3.1-8B's published shape (32 layers,
   128,256 words, untied; int4 layers, int8 embedding and head) with its
   time and peak (the weights alone), then one pipeline call at 8,192
   tokens (Knorm 0.5, int4 KV, both questions, 16 new; flash and int4
   ``decode_attention`` counted exactly); (b) ``collect_scores`` at the
   flagship's width over 16 repeat prompts of synthetic 1,024-word
   documents (a chat-template stub tokenizer), 256 tokens each, document
   0's layers 0 and 15 held against their float64 recomputation from the
   captured probabilities, hidden states and values, X against the hidden
   states; (c) ``train_linear`` (R^2 > 0) and ``train_mlp`` at its defaults
   (the validation loss falls); (d) the trained MLP through the pipeline over
   an 8,192-word document: KVzap(0.5), DMS(KVzap) at the median target mask
   only and with ``decoding=True`` (masked slots grow through the steps),
   the surrogate through ``save_kvzap_model`` / ``load_kvzap_model`` and the
   int8 params through ``utils.save_params`` / ``load_params`` (bit-equal,
   the same answers), a decode step under ``utils.profile_trace`` (the trace
   names the decode kernel); (e) DMS(KVzap) compact served under a mesh: 2
   requests of 2,048 tokens through the world of one over NCCL (identical to
   one process) and the ``model=2`` gloo world (heads (16, 4), answers
   teacher-forced, the compacted lengths the reference's).
4. Timings: prefill at 32K under each press and chunked (int8 KV; int4 KV
   on both routes), and decode at batch 4 x 32K
   context, ratio 0.5 (Knorm: int4 KV + int8 weights, decode kernel on and
   off; path B: bf16 KV at batch 1 and 4, head-wise kernel against the dense
   route and the decode kernel over the same cache), on a synchronized host
   clock, medians (decode: of DECODE_REPS loops of DECODE_STEPS a pass), with profiler
   breakdowns (device busy time, idle share,
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


def kernel_checks(kt, torch, report, ring_only: bool = False):
    """Phase 2; ``ring_only``: the context-parallel ring's block shapes alone."""
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
        else:                   # a ring block behind the diagonal (prior >= S) too
            hole = min(prior, S) // 2 if prior else min(512, T // 4)
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
            elif lib_mask == "full":    # a ring block behind the diagonal: every key seen
                kr, vr = kd.repeat_interleave(G_, 1), vd.repeat_interleave(G_, 1)
                lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, kr, vr, scale=kw["sm_scale"]), 5)
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

    def ring_window_case(variant, q, k, v, prior, window, iters=5):
        """A sliding layer's ring block one behind the diagonal: T = S,
        ``prior`` >= S and a window shorter than the block, so rows from
        ``S - 1 + window - prior`` on see no key of it. The live rows against
        the plain version (output and LSE); the dead rows must store 0 and LSE
        -inf (the plain version's LSE is finite, near -2e38); then the block
        combined by ``lse_combine`` with its diagonal block, from the kernel
        and from the plain version, against the dense windowed attention over
        both blocks, and the combine with the block's weight taken as 1
        rejected."""
        from kvpress_tpu_torch.parallel.ring import lse_combine

        B_, Hq_, T_, D_ = q.shape
        Hkv_, S_ = k.shape[1], k.shape[2]
        G_ = Hq_ // Hkv_
        kw = dict(sm_scale=D_ ** -0.5, window=window)
        label = f"flash_attention[{variant}]"
        call = lambda: fl.flash_attention(q, k, v, prior, return_lse=True, **kw)
        got, lse = call()
        torch.cuda.synchronize()
        again, lse_again = call()
        torch.cuda.synchronize()
        if not (torch.equal(got, again) and torch.equal(lse, lse_again)):
            failures.append(f"{label}: two launches differ")
        plain = fl.flash_attention_plain
        (ref, ref_lse), plain_ms = timed(
            lambda: plain_rows(plain, q, [k, v], prior, None, 0, T_, 1024, **kw))
        n_live = max(0, min(T_, S_ - 1 + window - prior))
        dead_ok = (bool((got[:, :, n_live:] == 0).all())
                   and bool((lse[..., n_live:] == float("-inf")).all())
                   and bool((ref_lse[..., n_live:] < -1e37).all()))
        if not (0 < n_live < T_ and dead_ok):
            failures.append(f"{label}: rows {n_live}.. with no visible key are not 0 with LSE "
                            "-inf (the plain version's LSE finite below -1e37)")
        lse_err = (lse[..., :n_live] - ref_lse[..., :n_live]).abs().max().item()
        if not lse_err <= LSE_LIMIT:
            failures.append(f"{label}: row logsumexp differs by {lse_err:.3e} > {LSE_LIMIT}")
        live = lambda t: t[:, :, :n_live]
        hole = S_ - window // 2           # slots every row 0 .. 511 sees
        faults = {"the window not applied": live(plain_rows(
                      plain, q, [k, v], prior, None, 0, T_, 1024, **{**kw, "window": None})[0]),
                  "one skipped key step": live(torch.cat([plain_rows(
                      plain, q, [k, v], prior, fault_mask(None, B_, S_, hole, hkv=Hkv_), 0, 512,
                      512, **kw)[0], ref[:, :, 512:]], 2))}
        ms = kernel_ms(call, "flash_sm90", iters)
        kr, vr = k.repeat_interleave(G_, 1), v.repeat_interleave(G_, 1)
        allowed = allowed_mask(None, B_, prior, T_, S_, window=window, hkv=1, g=1)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=allowed,
                                                             scale=kw["sm_scale"]), 3)
        del kr, vr, allowed
        seen = torch.clamp(S_ - 1 + window - prior - torch.arange(T_), 0, S_)
        flops = 4 * D_ * G_ * B_ * Hkv_ * int(seen.sum())
        moved = nbytes(q, got, lse) + nbytes(k, v) * (S_ - max(0, prior - window + 1)) // S_
        record("flash_attention", variant, live(got), live(ref), faults, ms, plain_ms, moved,
               flops, lib)

        # The ring's combine: the diagonal block (prior 0) first, then this one.
        kd2, vd2 = rnd(B_, Hkv_, T_, D_), rnd(B_, Hkv_, T_, D_)
        dense = plain_rows(plain, q, [torch.cat([k, kd2], 2), torch.cat([v, vd2], 2)], S_,
                           None, 0, T_, 1024, **kw)[0]
        start = (torch.zeros((B_, Hq_, T_, D_), device=dev),
                 torch.full((B_, Hq_, T_), float("-inf"), device=dev))
        diag = fl.flash_attention(q, kd2, vd2, 0, return_lse=True, **kw)
        diag_plain = plain_rows(plain, q, [kd2, vd2], 0, None, 0, T_, 1024, **kw)
        ring_out = lse_combine(*lse_combine(*start, *diag), got, lse)[0].to(q.dtype)
        ring_plain = lse_combine(*lse_combine(*start, *diag_plain), ref, ref_lse)[0].to(q.dtype)
        out1, lse1 = lse_combine(*start, *diag)
        weight_one = (torch.exp(lse1 - torch.logaddexp(lse1, lse))[..., None] * out1
                      + got.float()).to(q.dtype)
        rows = {what: compare(x, dense)[1] for what, x in (
            ("kernel blocks", ring_out), ("plain blocks", ring_plain),
            ("planted: the block's weight taken as 1", weight_one))}
        report(f"    ring combine with the diagonal block against the dense windowed attention "
               f"over both: worst row {rows}; {T_ - n_live} rows of the block see no key")
        if not (rows["kernel blocks"] <= ROW_LIMIT and rows["plain blocks"] <= ROW_LIMIT
                and rows["planted: the block's weight taken as 1"] > ROW_LIMIT):
            failures.append(f"{label}: the ring's combine over the block: worst rows {rows} "
                            f"(limit {ROW_LIMIT})")

    def ring_blocks():
        """Context parallelism (parallel/ring.py): each ring step launches
        flash_attention on a block of T = S = Sl queries and keys with
        ``prior`` = (query block - key block) * Sl, a block wholly in the
        past at prior >= S, which chunked prefill never launches (S = prior
        + T there). The gloo world's seq 4 blocks of the flagship (Sl 4,096)
        at prior 4,096, 8,192 and 12,288, each with its row LSE; a sliding
        layer's block behind the diagonal (window 1,024: rows with no
        visible key) at head_dim 64 and at Gemma-3-12B's 256 (GQA 16/8)."""
        B, T = 1, CP_BLOCK
        q, kd, vd = rnd(B, Hq, T, D), rnd(B, Hkv, T, D), rnd(B, Hkv, T, D)
        for prior in (T, 2 * T, 3 * T):
            flash_case("flash_attention", f"bf16 B1 T{T} S{T} prior{prior} ring block", None, q,
                       [kd, vd], prior, None, chunk=1024, iters=5, lib_mask="full")
        ring_window_case(f"bf16 B1 T{T} S{T} prior{T} ring block window 1024", q, kd, vd, T,
                         1024)
        del q, kd, vd
        q, kd, vd = rnd(B, 16, T, 256), rnd(B, 8, T, 256), rnd(B, 8, T, 256)
        flash_case("flash_attention", f"bf16 B1 T{T} S{T} prior{T} D256 GQA 16/8 ring block",
                   None, q, [kd, vd], T, None, chunk=1024, iters=5, lib_mask="full")
        ring_window_case(f"bf16 B1 T{T} S{T} prior{T} D256 GQA 16/8 ring block window 1024", q,
                         kd, vd, T, 1024)
        del q, kd, vd
        torch.cuda.empty_cache()

    if ring_only:
        ring_blocks()
        if failures:
            raise AssertionError("; ".join(failures))
        return results

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

    # KVCompose's chunked re-feed (multipass_presses_run (g), (h)): its last
    # chunk of 8,192 queries over the 57,344 slots before it in the doubled
    # 65,536-slot buffer, no keep-mask, with the row LSE the column sweep
    # reads; bf16, and int8 through flash_attention_quant.
    S = 2 * CONTEXT_TOKENS
    prior = S - T
    q = rnd(B, Hq, T, D)
    kd, vd = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    flash_case("flash_attention", f"bf16 B1 T{T} prior{prior} S{S} re-feed", None, q, [kd, vd],
               prior, None, chunk=512, iters=5, lib_mask="lower_right")
    flash_case("flash_attention_quant", f"int8 B1 T{T} prior{prior} S{S} re-feed", 8, q,
               quantized(kd, vd, 8), prior, None, chunk=512, iters=5, lib_mask="lower_right")
    del q, kd, vd
    torch.cuda.empty_cache()

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

    ring_blocks()

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
    # The serving engine's slot step (8 slots of 8,449, batch()'s capacity for
    # the serving phase's S1): each slot's causality, keep bits (and a window
    # of 1,024, folded in) in the mask; lengths ragged from 1 to S; the
    # launch's length the longest slot's, no window argument.
    B, S = SV_SLOTS, 8449
    q = rnd(B, Hq, 1, D)
    kd, vd = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    clen = torch.linspace(0, S - 1, B, device=dev).long()
    slot = torch.arange(S, device=dev)
    for window in (None, 1024):
        allowed = slot[None] <= clen[:, None]
        if window:
            allowed &= slot[None] > clen[:, None] - window
        mask = keep_mask(B, S, p=0.2) & allowed[:, None]
        mask[torch.arange(B, device=dev), :, clen] = True
        for bits in (None, 8, 4):
            name = "bf16" if bits is None else f"int{bits}"
            decode_case(f"{name} B{B} slots of {S} ragged" + (f", window {window} in the mask"
                                                             if window else ""),
                        q, kd, vd, S, mask, bits, iters=20)
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
            # The scatter-adds sum in index order: a second call gives the
            # same bits (the world of one's engine runs rely on it).
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            again = press.layer_compress(ctx, keys, values, S, mask)
            end.record()
            torch.cuda.synchronize()
            same = torch.equal(again[1], merged[1])
            report(f"    one layer's merge at 32K: peak {peak / 2**30:.3f} GiB over the "
                   f"{held / 2**30:.3f} GiB held (similarity slices of "
                   f"{kt.presses.merging.SIM_BYTES >> 20} MiB); {n_changed} of {Hkv * half} "
                   f"kept values merged in the captured layer; a second call "
                   f"{start.elapsed_time(end):.2f} ms, "
                   f"{'bit-equal' if same else 'different values'}")
            if n_changed == 0:
                failures.append(f"{name}: no kept value of the captured layer changed")
            if not same:
                failures.append(f"{name}: two merges of one layer differ")
            del merged, plain, again
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


# --------------------------------------------------------------------- #
# Phase 3, the multi-pass presses at the flagship shape.

MP_SMALL_CONTEXT = 4096     # one-shot KVCompose: (B, Hq, S, 2S) float32 probabilities a layer
MP_RESTORE_TOKENS, MP_LORA_RANK = 16, 8
MP_GATE_DIM, MP_GATE_SINK = 16, 16
MP_CHUNK = 2048             # KVzip's repeat chunk (the press's default)
# The dense-path check: 2,048 tokens, repeat chunks and re-feed chunks of 512.
MP_REF_CHUNK = 512


def context_snapshot(cache, n: int):
    """Copies of the first ``n`` slots (payloads, scales) and the length and
    offset of ``cache``."""
    return ([None if t is None else t[:, :, :, :n].clone()
             for t in (cache.keys, cache.values, cache.key_scales, cache.value_scales)],
            cache.length.clone(), cache.offset.clone())


def context_equal(torch, cache, snap) -> bool:
    """Whether ``cache`` holds the snapshot's slots, length and offset, bit
    for bit."""
    tensors, length, offset = snap
    n = tensors[0].shape[3]
    return (all(b is None or torch.equal(t[:, :, :, :n], b) for t, b in zip(
        (cache.keys, cache.values, cache.key_scales, cache.value_scales), tensors))
        and torch.equal(cache.length, length) and torch.equal(cache.offset, offset))


def kept_per_layer(torch, cache):
    """Each layer's kept entries: the keep bits set below its length (every
    slot below it without a mask), summed over batch and heads."""
    L, B, H, S = cache.keys.shape[:4]
    valid = torch.arange(S, device=cache.keys.device) < cache.length.to(
        cache.keys.device)[:, None, None, None]
    if cache.mask is not None:
        valid = valid & cache.mask
    return valid.sum(dim=(1, 2, 3)).tolist()


@contextlib.contextmanager
def multipass_recorder(kt, torch, log: dict):
    """While active, the pipeline's scoring stages (KVzip's repeat passes,
    ``_kvzip_scores``; KVCompose's re-feed, ``_kvcompose_scores``) append to
    ``log["scoring"]`` their wall ms on a synchronized host clock, their peak
    memory over what was held, and whether the context's slots, length and
    offset came back bit-equal; each ``grow`` of the cache appends to
    ``log["grows"]``; KVCompose's budgets and keep-mask go to
    ``log["budgets"]``; its structured rebuild appends whether every layer's
    kept entries are those of the context at the kept slots in position order
    (``log["rebuild"]``); and the compressed cache handed to
    ``_generate_answer`` gives ``log["kept"]`` (kept entries per layer) and
    ``log["masked"]`` (``masked_fraction``)."""
    from kvpress_tpu_torch import pipeline as tp

    P = kt.KVPressPipeline
    originals = {(P, name): getattr(P, name)
                 for name in ("_kvzip_scores", "_kvcompose_scores", "_kvcompose_compress")}
    originals[(tp, "grow")] = tp.grow
    originals[(tp, "_generate_answer")] = tp._generate_answer
    originals[(kt.KVComposePress, "budgets_and_masks")] = kt.KVComposePress.budgets_and_masks
    snaps = []

    def scoring(name):
        def wrapper(self, cache, context_ids, *args, **kw):
            n = len(context_ids)
            snap = context_snapshot(cache, n)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cache, scores = originals[(P, name)](self, cache, context_ids, *args, **kw)
            torch.cuda.synchronize()
            log["scoring"].append(dict(
                ms=(time.perf_counter() - t0) * 1e3,
                peak=torch.cuda.max_memory_allocated() - held, held=held,
                unchanged=context_equal(torch, cache, snap)))
            snaps.append(snap)
            return cache, scores
        return wrapper

    def compress(self, cache, scores, press, ctx_len):
        out = originals[(P, "_kvcompose_compress")](self, cache, scores, press, ctx_len)
        if press.structured:
            # the rebuilt prefix of each layer: the context's entries at the
            # kept slots, in position order (each head keeps the layer's budget)
            budgets, keep = log["budgets"][-1]
            tensors = snaps[-1][0]
            keep_t = torch.from_numpy(keep).to(cache.keys.device)
            same = True
            for l, n in enumerate(budgets.tolist()):
                idx = keep_t[l].nonzero()[:, 1].reshape(keep.shape[1], n)       # (H, n)
                for got, src in zip((out.keys, out.values, out.key_scales, out.value_scales),
                                    tensors):
                    if src is not None:
                        want = torch.gather(src[l], 2, idx[None, :, :, None].expand(
                            1, *idx.shape, src.shape[-1]))
                        same = same and torch.equal(got[l, :, :, :n], want)
            log["rebuild"].append(same)
        return out

    def budgets(self, scores, values):
        out = originals[(kt.KVComposePress, "budgets_and_masks")](self, scores, values)
        log["budgets"].append(out)
        return out

    def growing(cache, extra):
        log["grows"].append((cache.max_size, cache.max_size + extra))
        return originals[(tp, "grow")](cache, extra)

    def probe(runner, params, q, cache, *args, **kw):
        log["kept"].append(kept_per_layer(torch, cache))
        log["masked"].append(float(kt.masked_fraction(cache)) if cache.mask is not None else 0.0)
        return originals[(tp, "_generate_answer")](runner, params, q, cache, *args, **kw)

    for key in ("scoring", "grows", "budgets", "rebuild", "kept", "masked"):
        log.setdefault(key, [])
    P._kvzip_scores = scoring("_kvzip_scores")
    P._kvcompose_scores = scoring("_kvcompose_scores")
    P._kvcompose_compress = compress
    tp.grow = growing
    tp._generate_answer = probe
    kt.KVComposePress.budgets_and_masks = budgets
    try:
        yield log
    finally:
        for (owner, name), fn in originals.items():
            setattr(owner, name, fn)


def restore_artifacts(kt, torch, cfg, gen, path):
    """RestoreKV's artifacts drawn from ``gen``: 16 restore embeddings and a
    rank-8 LoRA on wq/wk/wv/wo (``init_random_lora``'s A, and B drawn too:
    a zero B merges nothing), written with ``save_restore_artifacts`` and
    read back with ``load_restore_artifacts``."""
    emb = torch.randn((MP_RESTORE_TOKENS, cfg.hidden_size), generator=gen,
                      device=gen.device) * 0.02
    lora = kt.init_random_lora(gen, cfg, rank=MP_LORA_RANK, device=gen.device)
    for ab in lora.values():
        ab["b"] = torch.randn(ab["b"].shape, generator=gen, device=gen.device) * 0.01
    kt.save_restore_artifacts(path, emb, lora, scaling=2.0)
    return kt.load_restore_artifacts(path, device=gen.device)


def multipass_presses_run(kt, torch, tokenizer_cls, params, report, labels=None):
    """The multi-pass presses through ``KVPressPipeline`` at the flagship
    shape (16 layers, bf16 weights), a 32,768-token context, the 152-token
    question and 32 new tokens, ratio 0.5, each run's launch counts set to 0
    before it and read after it and held exactly to its prediction
    (``expect(n)``, n the decode steps; PERF.md):

    (a) KVzipPress, bf16 KV, one-shot (the cache grown for the repeat passes);
    (b) KVzipPress(compact=True) on the head-wise runner;
    (c) KVzipPress over int8 KV, chunked by 8,192, presized: no grow;
    (d) KVzipPress(kvzip_plus_normalization=True), the scorer route through
        ``Runner.forward``, bf16 and int8 KV (its layer must not be
        requantized);
    (e) RestoreKVPress with 16 restore embeddings and a rank-8 LoRA on
        wq/wk/wv/wo, round-tripped through the artifacts' ``.npz``;
    (f) FastKVzipPress with random gates (output_dim 16, sink 16): one-shot,
        chunked by 8,192, and compact on the head-wise runner;
    (g) KVComposePress structured and unstructured, chunked by 8,192: the
        re-feed over a 65,536-slot buffer;
    (h) the structured press over int8 KV, chunked: ``flash_attention_quant``
        with its row LSE;
    (i) one-shot structured KVCompose at 4,096 tokens (the collector's
        probabilities, 4.3 GB a layer).

    Each run prints its prefill wall and peak, its scoring passes' wall and
    peak, the kept entries per layer, the masked fraction, the decode rate
    and the launches. Each checks that the scoring passes left the context's
    slots, length and offset bit-equal; KVzip's masked entries are the
    ratio's share of the context's (RestoreKV's budget-matched); KVCompose's
    layer lengths are its budgets and a structured layer's kept entries are
    the context's at the kept slots in position order; (c) took no grow.
    ``labels`` runs those runs alone (their label's start). Returns the
    summed launch counts."""
    import tempfile

    cfg = flagship_config(16)
    L, S, H = cfg.num_layers, CONTEXT_TOKENS, cfg.num_kv_heads
    dev = params.device
    gen = torch.Generator(device=dev).manual_seed(14)
    tok = tokenizer_cls(vocab_size=cfg.vocab_size)
    context = " ".join(f"w{i}" for i in range(S))
    small = " ".join(f"w{i}" for i in range(MP_SMALL_CONTEXT))
    question = QUESTIONS[0]
    runner = kt.Runner.create(cfg, device=dev)
    headwise = kt.Runner.create(cfg, decode_kernel=False, headwise_kernel=True, device=dev)
    gates = kt.init_random_gates(gen, cfg, output_dim=MP_GATE_DIM, sink=MP_GATE_SINK, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        emb, lora, scaling = restore_artifacts(kt, torch, cfg, gen, f"{tmp}/restore.npz")
    totals = {name: 0 for name in read_counts()}
    failures = []
    n_rep = -(-S // MP_CHUNK)               # repeat passes
    n_chunks = S // CHUNK_TOKENS            # prefill chunks, and re-feed chunks

    def kind(name, payload, n):
        return {f"{name}_{payload}_d64": n, f"{name}_{payload}": n, name: n}

    def flash(n, payload="bf16"):
        return kind("flash_attention" if payload == "bf16" else "flash_attention_quant",
                    payload, n)

    def decode(n, payload="bf16"):
        return kind("decode_attention", payload, n)

    def run(label, press, expect, r=runner, ctx=context, masked_share=None, **kw):
        """One pipeline run; ``expect(n_steps)`` gives the launch counts it
        must read exactly (every other kernel must not launch);
        ``masked_share`` the exact share of the context's (layer, head,
        slot) entries whose keep bit is cleared."""
        if labels is not None and not label.startswith(tuple(labels)):
            return None
        prefills, steps, log = [], [], {}
        rec = decode_recorder(r, steps)
        pipe = kt.KVPressPipeline(timed_runner(kt, torch, rec, prefills), params, tok)
        with multipass_recorder(kt, torch, log):
            reset_counts()
            t0 = time.perf_counter()
            try:
                answer = pipe(ctx, question=question, press=press, max_new_tokens=32,
                              **kw)["answer"]
            except Exception as e:      # the phase fails, after the other runs
                failures.append(f"{label}: {type(e).__name__}: {e}")
                report(f"  {label}: FAILED ({type(e).__name__}: {str(e)[:200]})")
                torch.cuda.empty_cache()
                return None
            torch.cuda.synchronize()
            counts = read_counts()
        n_ctx = len(ctx.split())
        n = sum(e["T"] == 1 for e in steps)
        one = [e["ms"] for e in steps if e["T"] == 1]
        passes = log["scoring"]
        report(f"  {label}: {time.perf_counter() - t0:.2f} s in all, {prefill_reading(prefills)}; "
               + (f"scoring passes {passes[0]['ms']:.1f} ms, peak {passes[0]['peak'] / 2**30:.3f} "
                  f"GiB over the {passes[0]['held'] / 2**30:.3f} GiB held; " if passes else "")
               + f"kept per layer {log['kept'][-1]}, masked fraction {log['masked'][-1]:.6f}; "
               + (f"decode {len(one) / (sum(one) / 1e3):.1f} tok/s over {len(one)} steps (host "
                  f"clock); " if one else "no decode step; ")
               + f"grows {log['grows']}; launches {launched(counts)}; answer tokens "
               f"{len(answer.split())}")
        if not answer:
            failures.append(f"{label}: empty answer")
        want = expect(n)
        failures.extend(f"{label}: {name} launched {counts[name]}, not {k}"
                        for name, k in want.items() if counts[name] != k)
        failures.extend(f"{label}: {name} launched {counts[name]} times" for name in counters()
                        if name not in want and counts[name])
        for name, k in counts.items():
            totals[name] += k
        if not all(p["unchanged"] for p in passes):
            failures.append(f"{label}: a scoring pass moved the context's slots, length or "
                            "offset")
        if masked_share is not None:
            valid = n_ctx * L * H
            want_masked = int(valid * masked_share)
            got_masked = valid + extra_kept(press, L, H) - sum(log["kept"][-1])
            report(f"    masked context entries {got_masked} of {valid} (the press's share: "
                   f"{want_masked})")
            if got_masked != want_masked:
                failures.append(f"{label}: {got_masked} masked entries, not {want_masked}")
        if log["budgets"]:
            budgets = log["budgets"][-1][0].tolist()
            lengths = log["kept"][-1] if press.structured else None
            report(f"    budgets (important_per_layer) {budgets}")
            if press.structured and [k // H for k in lengths] != budgets:
                failures.append(f"{label}: layer lengths {lengths} are not the budgets "
                                f"{budgets} x {H} heads")
            if log["rebuild"] and not all(log["rebuild"]):
                failures.append(f"{label}: the rebuilt layers are not the context's kept "
                                "entries in position order")
        del steps, prefills, pipe
        torch.cuda.empty_cache()
        return log

    def extra_kept(press, L_, H_):
        """Entries kept past the context: RestoreKV's restore slots."""
        return getattr(press, "num_restore_tokens", 0) * L_ * H_

    # (a) KVzip, bf16 KV, one-shot: the prefill, the repeat passes, the
    # question over flash_attention; the steps over the decode kernel.
    run("(a) KVzip, bf16 KV, one-shot", kt.KVzipPress(0.5),
        lambda n: {**flash((2 + n_rep) * L), **decode(n * L)}, masked_share=0.5)
    # (b) compact on the head-wise runner: one-token steps take the head-wise
    # kernel over each head's kept prefix.
    run("(b) KVzip compact, head-wise runner", kt.KVzipPress(0.5, compact=True),
        lambda n: {**flash((2 + n_rep) * L), "decode_headwise": n * L,
                   "decode_headwise_bf16_d64": n * L}, r=headwise, masked_share=0.5)
    # (c) int8 KV chunked and presized: every chunk, pass and the question
    # through flash_attention_quant at int8.
    log = run("(c) KVzip, int8 KV, chunked", kt.KVzipPress(0.5),
              lambda n: {**flash((n_chunks + n_rep + 1) * L, "int8"), **decode(n * L, "int8")},
              masked_share=0.5, quantized=True, kv_bits=8, context_chunk=CHUNK_TOKENS)
    if log is not None and log["grows"]:
        failures.append(f"(c) grew the presized cache: {log['grows']}")
    # (d) KVzip+: the repeat prompts through Runner.forward with the scorer
    # (flash_attention over the dense buffer: a press scores dense K/V).
    run("(d) KVzip+, bf16 KV", kt.KVzipPress(0.5, kvzip_plus_normalization=True),
        lambda n: {**flash((2 + n_rep) * L), **decode(n * L)}, masked_share=0.5)
    run("(d) KVzip+, int8 KV", kt.KVzipPress(0.5, kvzip_plus_normalization=True),
        lambda n: {**flash(n_rep * L), **flash(2 * L, "int8"), **decode(n * L, "int8")},
        masked_share=0.5, quantized=True, kv_bits=8)
    # (e) RestoreKV: the restore pass's 16 tokens take the decode kernel.
    restore = kt.RestoreKVPress(0.5, restore_embeddings=emb, lora=lora, lora_scaling=scaling)
    run("(e) RestoreKV, bf16 KV", restore,
        lambda n: {**flash((2 + n_rep) * L), **decode((n + 1) * L)},
        masked_share=min(0.999999, 0.5 + MP_RESTORE_TOKENS / S))
    # (f) FastKVzip: gate scores in the prefill, the post-mask after it.
    fast = dict(gates=gates, n_sink=4)
    run("(f) FastKVzip, one-shot", kt.FastKVzipPress(0.5, **fast),
        lambda n: {**flash(2 * L), **decode(n * L)}, masked_share=0.5)
    run("(f) FastKVzip, chunked", kt.FastKVzipPress(0.5, **fast),
        lambda n: {**flash((n_chunks + 1) * L), **decode(n * L)}, masked_share=0.5,
        context_chunk=CHUNK_TOKENS)
    run("(f) FastKVzip compact, head-wise runner", kt.FastKVzipPress(0.5, compact=True, **fast),
        lambda n: {**flash(2 * L), "decode_headwise": n * L, "decode_headwise_bf16_d64": n * L},
        r=headwise, masked_share=0.5)
    # (g), (h) KVCompose chunked: the prefill's chunks, the re-feed's chunks
    # (with the row LSE), the question; (i) one-shot at 4,096 tokens: the
    # collector's re-feed on the dense route (no kernel).
    for structured in (True, False):
        run(f"(g) KVCompose {'structured' if structured else 'unstructured'}, chunked",
            kt.KVComposePress(structured=structured, compression_ratio=0.5),
            lambda n: {**flash((2 * n_chunks + 1) * L), **decode(n * L)},
            masked_share=None if structured else 0.5, context_chunk=CHUNK_TOKENS)
    run("(h) KVCompose structured, int8 KV, chunked", kt.KVComposePress(compression_ratio=0.5),
        lambda n: {**flash((2 * n_chunks + 1) * L, "int8"), **decode(n * L, "int8")},
        quantized=True, kv_bits=8, context_chunk=CHUNK_TOKENS)
    run(f"(i) KVCompose structured, one-shot, {MP_SMALL_CONTEXT} tokens",
        kt.KVComposePress(compression_ratio=0.5),
        lambda n: {**flash(2 * L), **decode(n * L)}, ctx=small)
    if failures:
        raise AssertionError("; ".join(failures))
    return totals


def kvzip_context_check(kt, torch, tokenizer_cls, params, report):
    """KVzip over int8 KV at 32K, chunked and presized: its repeat passes must
    leave the context's payload, scales, length and offset bit-equal."""
    return multipass_presses_run(kt, torch, tokenizer_cls, params, report,
                                 labels=("(c) KVzip, int8",))


def kvcompose_rebuild_check(kt, torch, tokenizer_cls, params, report):
    """Structured KVCompose chunked at 32K: each rebuilt layer must hold the
    context's entries at the kept slots in position order."""
    return multipass_presses_run(kt, torch, tokenizer_cls, params, report,
                                 labels=("(g) KVCompose structured",))


def multipass_reference_check(kt, torch, tokenizer_cls, params, report):
    """KVzip, FastKVzip and chunked structured KVCompose on the kernel path
    (flash, the decode kernel) against the dense path (``attn_impl="xla"``,
    ``decode_kernel=False``) on the same weights, cut to their first layer
    and whole, with a 2,048-token context (repeat and re-feed chunks of 512),
    the 150-token question and 4 teacher-forced steps, stage by stage, each
    stage starting both paths from the kernel path's state:
      prefill:  the last logits (FastKVzip: and its gate scores);
      scores:   the scoring passes' scores over the kernel path's prefilled
                cache (FastKVzip: the prefill's gate scores);
      kept:     the kept entries per layer of the mask or rebuild each path's
                scores give;
      question: the question forward's logits over the kernel path's
                compressed cache;
      decode:   the steps' logits after it.
    Every stage must read at most REF_LIMIT[depth], and at full depth at most
    F32_RATIO times what bf16 rounding alone moves in the same stage (the
    dense path in float32 from the same state). Layer 0's scores must be
    bit-equal on both paths for KVzip and FastKVzip (its queries and keys do
    not depend on attention), and at depth 1 its kept entries too; at full
    depth the kept entries per layer may differ by at most F32_RATIO times
    what dense bf16 and float32 differ (a global bottom-k or budget ranks
    every layer's scores together)."""
    dev = params.device
    gen = torch.Generator(device=dev).manual_seed(7)
    cfg16 = flagship_config()
    vocab = cfg16.vocab_size
    ids = torch.randperm(vocab, generator=gen, device=dev)[:REF_CONTEXT][None]
    question = torch.randperm(vocab, generator=gen, device=dev)[:REF_QUESTION][None]
    ctx_ids = ids[0].tolist()
    gates16 = kt.init_random_gates(torch.Generator(device=dev).manual_seed(17), cfg16,
                                   output_dim=MP_GATE_DIM, sink=MP_GATE_SINK, device=dev)
    tok = tokenizer_cls(vocab_size=cfg16.vocab_size)
    size = 2 * REF_CONTEXT + REF_QUESTION + REF_STEPS + 1
    failures = []

    def as32(cache):
        return dataclasses.replace(clone_cache(cache), keys=cache.keys.float(),
                                   values=cache.values.float())

    def steps(r, p, cache):
        out = []
        for i in range(REF_STEPS):
            logits, cache, _ = r.forward(p, question[:, i:i + 1], cache, logits_last_only=True)
            out.append(logits)
        return torch.cat(out, dim=1)

    def stages(path, r, p, press, kernel_state=None, f32=False):
        """One path's stages: (readings {stage: tensor}, kept per layer, the
        state the next path starts from). ``kernel_state`` (the kernel path's
        prefilled cache and compressed cache) starts this path's scoring and
        question stages; None makes this the kernel path."""
        pipe = kt.KVPressPipeline(r, p, tok)
        dtype = torch.float32 if f32 else torch.bfloat16
        conv = as32 if f32 else clone_cache
        if path == "KVCompose, chunked":
            pre, cache, _ = r.prefill_chunked(p, ids, chunk_size=MP_REF_CHUNK, max_size=size,
                                              compute_logits=True, dtype=dtype)
        else:
            pre, cache, state = r.prefill(p, ids, press=press if path == "FastKVzip" else None,
                                          max_size=size, compute_logits=True, dtype=dtype)
        base = cache if kernel_state is None else kernel_state[0]
        if path == "KVzip":
            _, sc = pipe._kvzip_scores(conv(base), ctx_ids, press)
            keep = press.head_mask_from_scores(sc)
            scores = torch.from_numpy(sc)
            compressed = lambda c: pipe._apply_keep_mask(c, keep)
        elif path == "FastKVzip":
            scores = torch.stack([s["scores"] for s in state]).float().cpu()
            compressed = lambda c: press.apply_post_mask(c, state)
        else:
            _, sc = pipe._kvcompose_scores(conv(base), ctx_ids, press, MP_REF_CHUNK)
            scores = torch.from_numpy(sc)
            compressed = lambda c: pipe._kvcompose_compress(c, sc, press, REF_CONTEXT)
        kept = kept_per_layer(torch, compressed(conv(base)))
        after = compressed(clone_cache(base)) if kernel_state is None else kernel_state[1]
        q_logits, after_q, _ = r.forward(p, question, conv(after))
        d_logits = steps(r, p, conv(after_q) if kernel_state is None else conv(kernel_state[2]))
        if kernel_state is None:
            kernel_state = (cache, after, after_q)
        return ({"prefill": pre, "scores": scores, "question": q_logits, "decode": d_logits},
                kept, kernel_state)

    for depth in (1, 16):
        cfg = flagship_config(depth)
        p = first_layers(params, depth) if depth < len(params.layers) else params
        p32 = copy.deepcopy(p).float() if depth == 16 else None
        kernel = kt.Runner.create(cfg, device=dev)
        dense = kt.Runner.create(cfg, attn_impl="xla", decode_kernel=False, device=dev)
        presses = {"KVzip": kt.KVzipPress(0.5, chunk_size=MP_REF_CHUNK),
                   "FastKVzip": kt.FastKVzipPress(0.5, gates={k: v[:depth]
                                                              for k, v in gates16.items()}),
                   "KVCompose, chunked": kt.KVComposePress(compression_ratio=0.5)}
        for path, press in presses.items():
            label = f"{path}, depth {depth}"
            k_read, k_kept, state = stages(path, kernel, p, press)
            d_read, d_kept, _ = stages(path, dense, p, press, state)
            read = {s: rel(torch, k_read[s], d_read[s]) for s in k_read}
            diff = [abs(a - b) for a, b in zip(k_kept, d_kept)]
            noise = noise_kept = None
            if p32 is not None:
                f_read, f_kept, _ = stages(path, dense, p32, press, state, f32=True)
                noise = {s: rel(torch, d_read[s], f_read[s]) for s in d_read}
                noise_kept = [abs(a - b) for a, b in zip(d_kept, f_kept)]
            same0 = path == "KVCompose, chunked" or torch.equal(k_read["scores"][0],
                                                                d_read["scores"][0])
            report(f"  {label}: max |kernel - dense| / max |dense|: "
                   + ", ".join(f"{s} {x:.3e}" for s, x in read.items())
                   + f" (limit {REF_LIMIT[depth]})"
                   + ("" if noise is None else "; dense bf16 against float32: "
                      + ", ".join(f"{s} {x:.3e}" for s, x in noise.items()))
                   + f"; kept per layer {k_kept}, differences {diff}"
                   + ("" if noise_kept is None else f" (bf16 against float32: {noise_kept})")
                   + ("" if path == "KVCompose, chunked" else
                      f"; layer 0's scores bit-equal: {same0}"))
            failures += [f"{label}: {s} reads {x:.3e} > {REF_LIMIT[depth]}"
                         for s, x in read.items() if not x <= REF_LIMIT[depth]]
            if noise is not None:
                failures += [f"{label}: {s} reads {read[s]:.3e}, over {F32_RATIO} x "
                             f"{noise[s]:.3e}" for s in read if not read[s] <= F32_RATIO * noise[s]]
                if sum(diff) > F32_RATIO * max(sum(noise_kept), 1):
                    failures.append(f"{label}: kept entries differ by {diff} (bf16 against "
                                    f"float32: {noise_kept})")
            elif diff[0]:
                failures.append(f"{label}: layer 0 keeps {diff[0]} other entries")
            if not same0:
                failures.append(f"{label}: layer 0's scores differ between the paths")
            del state
        del kernel, dense, p32
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))


# --------------------------------------------------------------------- #
# Phase 3: the continuous-batching ServingEngine and KVPressPipeline.batch()

SV_CONTEXTS = (8192, 16384)   # S1-S4: the requests alternate these context lengths
SV_QUESTIONS = (24, 152)      # and, two by two, these question lengths
SV_REQUESTS = 16
SV_NEW = 64                   # new tokens a request
SV_SLOTS = 8
SV_QUESTION_BUCKET = 64
SV_FETCH_LAG = 4
SV_CHUNK = 4096               # S5's context_chunk
SV_SMALL_CONTEXT = 2048       # the sampling check's contexts and the bf16 reading's
SV_TF = 4                     # requests teacher-forced in each run but S1 (all of them)
SV_INTERVAL = 16              # S4's compression interval
SV_SAMPLE_NEW = 32            # new tokens a request of the sampling check
SV_S7_ONE = 4                 # S7's requests at one slot (8 at eight)
# A served token is the single-request path's argmax, or within a tie limit
# of it in that path's logits: F32_RATIO x 2 x what bf16 rounding alone moves
# the two largest logits of the single-request path (its dense route in bf16
# against float32, read in the same run: the engine and the reference are
# each about that far from float32, and a flip trades the top two). At most a
# third of a request's tokens may be such near-tie flips (JAX's
# tests/test_serving.py). The rows the engine appended
# to a slot (question and answer) may differ from the reference's by
# SV_ROW_LIMIT of a row's scale (a quantized row by one code more); the kept
# context's rows are bit-equal (the same prefill call).
SV_ROW_LIMIT = 1e-1          # REF_LIMIT at depth 16


def serving_requests(gen, vocab: int, contexts, n_new: int = None):
    """(context ids, question ids, max_new_tokens), random ids drawn from the
    CPU generator ``gen``, one per context length; questions of SV_QUESTIONS
    tokens, two by two."""
    import torch

    def ids(n):
        return torch.randint(3, vocab, (n,), generator=gen).tolist()

    return [(ids(c), ids(SV_QUESTIONS[(i // 2) % 2]), n_new or SV_NEW)
            for i, c in enumerate(contexts)]


def serving_capacity(cfg, press, reqs) -> int:
    """``KVPressPipeline.batch()``'s default capacity for ``reqs``: the kept
    bound of the longest context, the bucketed longest question, the
    generation room and the final-logits slot."""
    longest = max(len(r[0]) for r in reqs)
    kept = longest if press is None else press.max_kept(longest, cfg)
    max_q = max(len(r[1]) for r in reqs)
    return (kept + -(-max_q // SV_QUESTION_BUCKET) * SV_QUESTION_BUCKET
            + max(r[2] for r in reqs) + 1)


def must_reject(what, check, *args):
    """A check must raise on its planted fault."""
    try:
        check(*args)
    except AssertionError:
        return
    raise AssertionError(f"a serving check passed its planted fault: {what}")


_NOISE: dict = {}      # id(params): (params, serving_noise's reading)


def serving_noise(kt, torch, params, report) -> float:
    """What bf16 rounding alone moves the two largest logits of the
    single-request path: a SV_SMALL_CONTEXT-token request (Knorm 0.5, a
    24-token question, 32 steps fed the bf16 path's greedy tokens) on the
    dense route in bf16 against float32. Returns the largest |difference| of
    the float32 path's two largest logits over the steps; measured once for
    a params object (the phases that read it share the reading)."""
    held = _NOISE.get(id(params))
    if held is not None and held[0] is params:
        return held[1]
    eps = _serving_noise(kt, torch, params, report)
    _NOISE[id(params)] = (params, eps)
    return eps


def _serving_noise(kt, torch, params, report) -> float:
    cfg = flagship_config(16)
    dev = params.device
    dense = kt.Runner.create(cfg, attn_impl="xla", decode_kernel=False, device=dev)
    ctx, q, _ = serving_requests(torch.Generator().manual_seed(41), cfg.vocab_size,
                                 [SV_SMALL_CONTEXT], 32)[0]

    def replay(p, tokens):
        """The last logits of the question and of each step; the steps fed
        ``tokens``, or the greedy ones (returned)."""
        logits, cache, _ = dense.prefill(p, torch.tensor([ctx], device=dev),
                                         press=kt.KnormPress(0.5), compute_logits=True)
        cache = kt.resize(cache, int(cache.length.max()) + len(q) + 32)
        logits, cache, _ = dense.forward(p, torch.tensor([q], device=dev), cache,
                                         logits_last_only=True, valid_len=len(q))
        rows, fed = [logits[0, -1].float()], []
        for i in range(31):
            fed.append(int(torch.argmax(rows[-1])) if tokens is None else tokens[i])
            logits, cache, _ = dense.forward(p, torch.tensor([[fed[-1]]], device=dev), cache,
                                             logits_last_only=True)
            rows.append(logits[0, -1].float())
        return torch.stack(rows), fed

    bf16, tokens = replay(params, None)
    p32 = copy.deepcopy(params).float()
    f32, _ = replay(p32, tokens)
    del p32
    torch.cuda.empty_cache()
    top2 = f32.topk(2, dim=-1)
    eps = (bf16.gather(1, top2.indices) - top2.values).abs().max().item()
    gaps = (top2.values[:, 0] - top2.values[:, 1]).sort().values
    report(f"  the single-request path, dense bf16 against dense float32 ({SV_SMALL_CONTEXT} "
           f"tokens, a 24-token question, 32 steps): the two largest logits move by at most "
           f"{eps:.4f}, any logit by {(bf16 - f32).abs().max().item():.4f} (the largest logit "
           f"{f32.abs().max().item():.3f}; top-2 gaps: median "
           f"{gaps[len(gaps) // 2].item():.4f}, smallest {gaps[0].item():.4f})")
    return eps


def serving_reference(kt, torch, runner, params, press, req, got, quantized=False, kv_bits=8,
                      chunk=None, decode_press=None):
    """``got`` replayed through the single-request path on ``runner``: the
    prefill with the press (whole, or in chunks of ``chunk``), the question
    forward, one forward a token (with ``decode_press`` compressing in the
    decode phase from the prefill's state). Returns (the tokens off the
    reference's argmax, the largest such gap, the reference's cache, its
    per-layer kept context)."""
    ctx, q = req[0], req[1]
    dev = params.device
    ids = torch.tensor([ctx], device=dev)
    kw = dict(press=press, compute_logits=True, quantized=quantized, kv_bits=kv_bits)
    if chunk:
        logits, cache, state = runner.prefill_chunked(
            params, ids, chunk_size=chunk, max_size=-(-len(ctx) // chunk) * chunk, **kw)
    else:
        logits, cache, state = runner.prefill(params, ids, **kw)
    kept = cache.length.clone()
    if getattr(press, "rerotates", False):
        # Rerotated keys sit at positions 0..n-1: the engine continues from
        # the kept length.
        cache = dataclasses.replace(cache, offset=torch.tensor(int(kept.max()),
                                                               dtype=torch.int32))
    cache = kt.resize(cache, int(kept.max()) + len(q) + len(got) + 1)
    if q:
        logits, cache, _ = runner.forward(params, torch.tensor([q], device=dev), cache,
                                          logits_last_only=True, valid_len=len(q))
    gaps = []
    for tok in got:
        row = logits[0, -1].float()
        gaps.append(row.max() - row[tok])
        logits, cache, state = runner.forward(
            params, torch.tensor([[tok]], device=dev), cache, logits_last_only=True,
            press=decode_press, press_state=state if decode_press else None,
            phase="decode" if decode_press else "none")
    gaps = torch.stack(gaps).cpu()
    return int((gaps > 0).sum()), float(gaps.max()), cache, kept


def check_teacher_forced(label, flips, worst, n, tie):
    if worst > tie or flips > max(1, n // 3):
        raise AssertionError(f"{label}: {flips} of {n} tokens off the single-request path's "
                             f"argmax, the largest gap {worst:.4f} (limit {tie:.4f})")


def check_slot_rows(torch, label, sc, slot, cache, kept, n_rows):
    """The pool's rows of ``slot`` against the reference's cache: the kept
    context bit-equal, the next ``n_rows`` (question and answer) within
    SV_ROW_LIMIT of each row's scale (one code more on a quantized pool)."""
    from kvpress_tpu_torch.cache import dequantize_kv

    pairs = [(sc.keys, cache.keys, sc.key_scales, cache.key_scales),
             (sc.values, cache.values, sc.value_scales, cache.value_scales)]
    for l, k in enumerate(kept.tolist()):
        for got, want, got_s, want_s in pairs:
            got, want = got[l, slot, :, :k + n_rows], want[l, 0, :, :k + n_rows]
            if not torch.equal(got[:, :k], want[:, :k]):
                raise AssertionError(f"{label}: layer {l}'s kept context is not the "
                                     "reference prefill's")
            got, want, limit = got[:, k:], want[:, k:], SV_ROW_LIMIT
            if got_s is not None:
                got = dequantize_kv(got, got_s[l, slot, :, k:k + n_rows], sc.bits, torch.float32)
                want = dequantize_kv(want, want_s[l, 0, :, k:k + n_rows], sc.bits,
                                     torch.float32)
                limit += 1 / (127 if sc.bits == 8 else 7)
            err = ((got.float() - want.float()).abs().amax(-1)
                   / want.float().abs().amax(-1).clamp_min(1e-3)).max().item()
            if not err <= limit:
                raise AssertionError(f"{label}: layer {l}'s appended rows differ from the "
                                     f"reference's by {err:.3e} of their scale (limit "
                                     f"{limit:.3e})")


def check_host_lengths(label, lengths, offsets, served, reqs, answers, kept_of,
                       rerotates=False):
    """Each slot's host lengths and offset after the run: the kept context,
    the question and the tokens appended (every generated token but the
    last) of the last request it served. A ``rerotates`` press's offset
    continues from the kept length."""
    for s, r in served.items():
        ctx, q = reqs[r][0], reqs[r][1]
        n = len(answers[r]) - 1
        want = [kept_of(len(ctx)) + len(q) + n] * lengths.shape[0]
        offset = (want[0] if rerotates else len(ctx) + len(q) + n)
        if lengths[:, s].tolist() != want or int(offsets[s]) != offset:
            raise AssertionError(f"{label}: slot {s} (request {r}) holds lengths "
                                 f"{lengths[:, s].tolist()}, offset {int(offsets[s])}; the "
                                 f"request needs {want[0]} and {offset}")


def check_serving_launches(label, counts, steps, kind, flash, quant, L):
    """decode_attention exactly L times a slot step, on the instantiation of
    the pool's payload only; the flash kernels as many times as predicted."""
    want = {"decode_attention": L * steps, f"decode_attention_{kind}_d64": L * steps,
            "flash_attention": flash, "flash_attention_quant": quant, "decode_headwise": 0,
            "observed_lse": 0, "observed_colsum": 0}
    got = {name: counts[name] for name in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, predicted {want}")


@contextlib.contextmanager
def serving_probe(kt):
    """Records, on ``kt.ServingEngine``: the engines that ran, each decode
    step's tokens with a copy (the tokens contract: nothing writes them after
    the step returned them), and the last request each slot served."""
    rec = dict(engines=[], steps=[], served={})
    cls = kt.ServingEngine
    run, complete, step = cls.run, cls._complete_admission, cls._step

    def running(self, *a, **kw):
        rec["engines"].append(self)
        return run(self, *a, **kw)

    def completing(self, adm):
        complete(self, adm)
        if self.live[adm["slot"]] and self.slots[adm["slot"]].req_idx == adm["req_idx"]:
            rec["served"][adm["slot"]] = adm["req_idx"]

    def stepping(self):
        tokens = step(self)
        rec["steps"].append((tokens, tokens.clone()))
        return tokens

    cls.run, cls._complete_admission, cls._step = running, completing, stepping
    try:
        yield rec
    finally:
        cls.run, cls._complete_admission, cls._step = run, complete, step


def serving_once(kt, torch, label, call, report):
    """``call()`` (one engine run, or one ``batch()``) with the launch counts
    set to 0 before it and read after it, the tokens contract held, and its
    readings printed: wall time, generated and processed tok/s, slot steps
    and their utilization, inter-token gaps, TTFT, peak memory over what was
    held. Returns (answers, counts, the engine, {slot: last request})."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with serving_probe(kt) as rec:
        answers = call()
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    for i, (tokens, kept) in enumerate(rec["steps"]):
        if not torch.equal(tokens, kept):
            raise AssertionError(f"{label}: the tokens of slot step {i} were written after it")
    eng = rec["engines"][-1]
    st = eng.last_stats
    sc = eng.sc
    report(f"  {label}: {st['requests']} requests in {st['wall_s']:.2f} s; generated "
           f"{st['generated_tokens']} tokens ({st['generated_tok_s']:.1f} tok/s), processed "
           f"{st['processed_tokens']} ({st['processed_tok_s']:.0f} tok/s); {st['decode_steps']} "
           f"slot steps of {eng.n_slots}, utilization {st['slot_step_utilization']:.3f}; "
           f"inter-token gap p50 / p99 / max {st.get('p50_intertoken_gap_s', 0) * 1e3:.1f} / "
           f"{st.get('p99_intertoken_gap_s', 0) * 1e3:.1f} / "
           f"{st.get('max_intertoken_gap_s', 0) * 1e3:.1f} ms; TTFT p50 / p99 / max "
           f"{st.get('p50_ttft_s', 0):.3f} / {st.get('p99_ttft_s', 0):.3f} / "
           f"{st.get('max_ttft_s', 0):.3f} s; peak {(peak - held) / 2**30:.3f} GiB over the "
           f"{held / 2**30:.3f} GiB held (the pool "
           f"{nbytes(sc.keys, sc.values, sc.mask, sc.key_scales, sc.value_scales) / 2**30:.3f} "
           f"GiB at capacity {eng.capacity}); context hits {st['ctx_hits']}; launches "
           f"{launched(counts)}")
    return answers, counts, eng, dict(rec["served"])


@contextlib.contextmanager
def slot_attention_probe(kt, torch, at_call: int):
    """At the ``at_call``-th decode_attention launch of the slot steps: the
    kernel's output, decode_attention_plain's on the same pool state, and the
    plain version with one live 256-slot run of the longer slots taken for
    dead (the planted fault)."""
    from kvpress_tpu_torch import serving as sv
    from kvpress_tpu_torch.ops import decode as dec

    original = sv.decode_attention
    seen, calls = {}, [0]

    def probe(q, k, v, length, k_scales=None, v_scales=None, mask=None, **kw):
        out = original(q, k, v, length, k_scales, v_scales, mask, **kw)
        calls[0] += 1
        if calls[0] == at_call:
            kw.pop("block_k", None)
            fault = mask.clone()
            lo = length // 2 // 256 * 256
            fault[..., lo:lo + 256] = False
            seen.update(got=out.clone(), length=length, live=int(mask.sum()),
                        ref=dec.decode_attention_plain(q, k, v, length, k_scales, v_scales, mask,
                                                       **kw),
                        fault=dec.decode_attention_plain(q, k, v, length, k_scales, v_scales,
                                                         fault, **kw))
        return out

    sv.decode_attention = probe
    try:
        yield seen
    finally:
        sv.decode_attention = original


def worst_row(torch, got, ref) -> float:
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite output")
    return ((got - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-3)).max().item()


@contextlib.contextmanager
def lru_probe(kt):
    """Clones of each entry the engines store in their context LRU, by key."""
    stored = {}
    cls = kt.ServingEngine
    original = cls._lru_store

    def store(self, key, cache, pre_row):
        stored[key] = {name: getattr(cache, name).clone() for name in
                       ("keys", "values", "mask", "key_scales", "value_scales")
                       if getattr(cache, name) is not None}
        return original(self, key, cache, pre_row)

    cls._lru_store = store
    try:
        yield stored
    finally:
        cls._lru_store = original


def check_lru_entries(torch, label, lru, stored):
    """Each entry left in the LRU bit-equal, below its per-layer lengths, to
    what was stored."""
    for key, (cache, _) in lru.items():
        for name, t in stored[key].items():
            for l, n in enumerate(cache.length.tolist()):
                if not torch.equal(getattr(cache, name)[l, :, :, :n], t[l, :, :, :n]):
                    raise AssertionError(f"{label}: an LRU entry's {name} changed in layer {l}")


def serving_run(kt, torch, tokenizer_cls, params, report, labels=None):
    """The continuous-batching engine at the flagship shape (all 16 layers,
    8 slots, 64 new tokens a request), each run's launch counts set to 0
    before it and read after it:
      S1  KnormPress(0.5) over bf16 slots: 16 requests, 8 of 8,192 and 8 of
          16,384 tokens, questions of 24 and 152 tokens, batch()'s default
          capacity (8,449);
      S2, S3  S1 over int8 and int4 slots;
      S4  PrefillDecodingPress(Knorm(0.5), CompressionRatioDecodingPress(
          Knorm, interval 16, ratio 0.5)): every slot compressed in the step;
      S5  context_chunk 4,096, interleave, context_cache 2: 16 requests over 4
          contexts of 16,384 tokens, 12 LRU hits;
      S6  KVPressPipeline.batch() on 8 strings of 8,192 words;
      S7  8 requests of 8,192 tokens at 8 slots, the first 4 at 1: the
          batching reading;
    and the sampling check (4 requests of 2,048 tokens). Checks: answers
    teacher-forced against the single-request path (all of S1, SV_TF of each
    other run), the pool rows of each such request that was last in its slot
    against the reference's cache, host lengths, the LRU entries bit-equal
    after their hits, decode_attention exactly 16 times a slot step on the
    payload's instantiation, flash launches per admission as predicted, the
    slot step's kernel attention against decode_attention_plain inside a
    step, the tokens contract; each with its planted fault. ``labels``
    restricts the runs (the mutation checks). Returns the launch counts."""
    cfg = flagship_config(16)
    dev = params.device
    L, V = cfg.num_layers, cfg.vocab_size
    gen = torch.Generator().manual_seed(15)
    runner = kt.Runner.create(cfg, attn_impl="flash", decode_kernel=True, device=dev)
    knorm = kt.KnormPress(0.5)
    kept_knorm = knorm.exact_kept
    totals = {}
    failures = []

    def wanted(label):
        return labels is None or label in labels

    def add(counts):
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n

    tie = F32_RATIO * 2 * serving_noise(kt, torch, params, report)

    def teacher_force(label, reqs, answers, eng, served, idx, press=knorm, **kw):
        """Teacher-force requests ``idx``; the pool rows of those last in
        their slot too. Returns the flips."""
        last = {r: s for s, r in served.items()}
        flips, widest = [], 0.0
        for i in idx:
            n_flip, worst, cache, kept = serving_reference(kt, torch, runner, params, press,
                                                           reqs[i], answers[i], **kw)
            flips.append(n_flip)
            widest = max(widest, worst)
            check_teacher_forced(f"{label} request {i}", n_flip, worst, len(answers[i]), tie)
            if i in last and "decode_press" not in kw:
                check_slot_rows(torch, f"{label} request {i}", eng.sc, last[i], cache, kept,
                                len(reqs[i][1]) + len(answers[i]) - 1)
            del cache
        report(f"    teacher-forced against the single-request path: requests {list(idx)}, "
               f"near-tie flips {flips} of {[len(answers[i]) for i in idx][0]}, the widest "
               f"{widest:.4f} (limit {tie:.4f}); the pool rows of requests "
               f"{[i for i in idx if i in last and 'decode_press' not in kw]} against the "
               "reference's")

    def engine(**kw):
        return kt.ServingEngine(runner, params, n_slots=SV_SLOTS, question_bucket=SV_QUESTION_BUCKET,
                                fetch_lag=SV_FETCH_LAG, **kw)

    reqs = serving_requests(gen, V, [SV_CONTEXTS[i % 2] for i in range(SV_REQUESTS)])
    cap = serving_capacity(cfg, knorm, reqs)
    n_adm = len(reqs)

    # S1, S2, S3: Knorm over bf16, int8 and int4 slots.
    for label, kv, kind, flash, quant in (
            ("S1", {}, "bf16", 2 * L * n_adm, 0),
            ("S2", dict(quantized=True, kv_bits=8), "int8", L * n_adm, L * n_adm),
            ("S3", dict(quantized=True, kv_bits=4), "int4", 2 * L * n_adm, 0)):
        if not wanted(label):
            continue
        eng = engine(capacity=cap, press=knorm, **kv)
        at_call = L * 9 + L              # the last layer of the 10th slot step
        probe = slot_attention_probe(kt, torch, at_call) if label == "S1" else \
            contextlib.nullcontext({})
        with probe as seen:
            answers, counts, eng, served = serving_once(
                kt, torch, f"{label}, Knorm(0.5), {kind} slots",
                lambda: eng.run([kt.Request(*r) for r in reqs]), report)
        add(counts)
        steps = eng.last_stats["decode_steps"]
        check_serving_launches(label, counts, steps, kind, flash, quant, L)
        check_host_lengths(label, eng.sc.lengths, eng.sc.offsets, served, reqs, answers,
                           kept_knorm)
        idx = list(range(len(reqs))) if label == "S1" else sorted(served.values())[:SV_TF]
        q = dict(quantized=bool(kv), kv_bits=kv.get("kv_bits", 8))
        teacher_force(label, reqs, answers, eng, served, idx, **q)
        if label == "S1":
            row = worst_row(torch, seen["got"], seen["ref"])
            fault = worst_row(torch, seen["fault"], seen["ref"])
            report(f"    slot step 10, layer {L - 1}: decode_attention against "
                   f"decode_attention_plain over the pool ({seen['live']} live (slot, head) "
                   f"keys, length {seen['length']}): worst row {row:.3e} (limit {ROW_LIMIT}; one "
                   f"live 256-key run taken for dead: {fault:.3e})")
            if not row <= ROW_LIMIT:
                failures.append(f"S1: the slot step's decode_attention differs from its plain "
                                f"version by {row:.3e}")
            if not fault > ROW_LIMIT:
                failures.append("S1: the in-step check passes a live run taken for dead")
            # the planted faults of the other checks
            s0, r0 = next(iter(served.items()))
            other = next(r for r in range(len(reqs)) if r != r0)
            n_flip, worst, _, _ = serving_reference(kt, torch, runner, params, knorm, reqs[r0],
                                                    answers[other])
            must_reject("another request's answer", check_teacher_forced, "planted", n_flip,
                        worst, len(answers[other]), tie)
            _, _, cache, kept = serving_reference(kt, torch, runner, params, knorm, reqs[r0],
                                                  answers[r0])
            shifted = dataclasses.replace(eng.sc, keys=eng.sc.keys.clone())
            n_rows = len(reqs[r0][1]) + len(answers[r0]) - 1
            for l, k in enumerate(kept.tolist()):   # an append at length + 1
                shifted.keys[l, s0, :, k + 1:k + n_rows + 1] = \
                    eng.sc.keys[l, s0, :, k:k + n_rows].clone()
            must_reject("the rows appended one slot late", check_slot_rows, torch, "planted",
                        shifted, s0, cache, kept, n_rows)
            del cache, shifted
            advanced = eng.sc.lengths.clone()
            advanced[:, s0] += 1                    # a dead lane's advance
            must_reject("one slot's lengths advanced once more", check_host_lengths, "planted",
                        advanced, eng.sc.offsets, served, reqs, answers, kept_knorm)
            must_reject("one slot step more", check_serving_launches, "planted",
                        dict(counts, decode_attention=counts["decode_attention"] + L),
                        steps, kind, flash, quant, L)
            # Where a slot step's time goes: one step with every slot live.
            eng.live[:] = True
            names = breakdown(f"{label}: one slot step, 8 slots live (lengths up to "
                              f"{int(eng.sc.lengths.max())} of {eng.capacity})", eng._step, 1,
                              report, top=3)
            if any("sort" in name.lower() for name in names):
                failures.append(f"S1: a sort ran in the slot step: {names}")
        del eng
        torch.cuda.empty_cache()

    if wanted("S4"):
        decoding = kt.CompressionRatioDecodingPress(
            base_press=kt.KnormPress(), compression_interval=SV_INTERVAL,
            target_compression_ratio=0.5)
        press = kt.PrefillDecodingPress(prefilling_press=knorm, decoding_press=decoding)
        eng = engine(capacity=serving_capacity(cfg, press, reqs), press=press)
        answers, counts, eng, served = serving_once(
            kt, torch, "S4, PrefillDecodingPress(Knorm(0.5), CompressionRatioDecodingPress("
            f"Knorm, interval {SV_INTERVAL}, 0.5)), bf16 slots",
            lambda: eng.run([kt.Request(*r) for r in reqs]), report)
        add(counts)
        check_serving_launches("S4", counts, eng.last_stats["decode_steps"], "bf16",
                               2 * L * n_adm, 0, L)
        target = decoding.target_value_vec(eng.sc.offsets - 1, eng.sc.lengths[0])
        for s, r in served.items():
            whole = kept_knorm(len(reqs[r][0])) + len(reqs[r][1]) + len(answers[r]) - 1
            got = eng.sc.lengths[:, s]
            if not (got <= int(target[s]) + SV_INTERVAL + SV_FETCH_LAG).all() or \
                    not (got < whole).all():
                raise AssertionError(f"S4: slot {s}'s lengths {got.tolist()}: the target is "
                                     f"{int(target[s])}, uncompressed {whole}")
        report(f"    slot lengths after the run {eng.sc.lengths[0].tolist()} (targets "
               f"{target.tolist()}; uncompressed they would be "
               f"{[kept_knorm(len(reqs[r][0])) + len(reqs[r][1]) + len(answers[r]) - 1 for s, r in sorted(served.items())]})")
        teacher_force("S4", reqs, answers, eng, served, sorted(served.values())[:SV_TF],
                      press=press, decode_press=press)
        del eng
        torch.cuda.empty_cache()

    if wanted("S5"):
        contexts = serving_requests(gen, V, [SV_CONTEXTS[1]] * 4)
        reqs5 = [(contexts[i // 4][0],
                  torch.randint(3, V, (SV_QUESTIONS[i % 2],), generator=gen).tolist(), SV_NEW)
                 for i in range(SV_REQUESTS)]
        eng = engine(capacity=serving_capacity(cfg, knorm, reqs5), press=knorm,
                     context_chunk=SV_CHUNK, interleave=True, context_cache=2)
        with lru_probe(kt) as stored:
            answers, counts, eng, served = serving_once(
                kt, torch, f"S5, Knorm(0.5), context_chunk {SV_CHUNK}, interleave, "
                "context_cache 2, 4 contexts", lambda: eng.run([kt.Request(*r) for r in reqs5]),
                report)
        add(counts)
        misses = 4
        chunks = SV_CONTEXTS[1] // SV_CHUNK
        check_serving_launches("S5", counts, eng.last_stats["decode_steps"], "bf16",
                               L * (misses * chunks + len(reqs5)), 0, L)
        if eng.last_stats["ctx_hits"] != len(reqs5) - misses:
            raise AssertionError(f"S5: {eng.last_stats['ctx_hits']} context hits")
        check_host_lengths("S5", eng.sc.lengths, eng.sc.offsets, served, reqs5, answers,
                           kept_knorm)
        check_lru_entries(torch, "S5", eng._ctx_lru, stored)
        key = next(iter(eng._ctx_lru))
        flipped = {name: t.clone() for name, t in stored[key].items()}
        flipped["keys"][0, 0, 0, 0] += 1
        must_reject("an LRU entry's key changed", check_lru_entries, torch, "planted",
                    {key: eng._ctx_lru[key]}, {key: flipped})
        report(f"    LRU: {len(eng._ctx_lru)} entries of {[e.max_size for e, _ in eng._ctx_lru.values()]} "
               f"slots ({eng.last_stats['lru_bytes'] / 2**30:.3f} GiB), bit-equal below their "
               "lengths after their hits")
        teacher_force("S5", reqs5, answers, eng, served, sorted(served.values())[:SV_TF],
                      chunk=SV_CHUNK)
        del eng
        torch.cuda.empty_cache()

    if wanted("S6"):
        tok = tokenizer_cls(vocab_size=V)
        pipe = kt.KVPressPipeline(runner, params, tok)
        texts = [" ".join(f"w{i}x{j}" for i in range(SV_CONTEXTS[0])) for j in range(8)]
        questions = [QUESTIONS[j % 2] for j in range(8)]
        streamed = {}
        answers_s, counts, eng, served = serving_once(
            kt, torch, f"S6, KVPressPipeline.batch() on 8 strings of {SV_CONTEXTS[0]:,} words, "
            "Knorm(0.5)",
            lambda: pipe.batch(texts, questions, press=knorm, max_new_tokens=SV_NEW,
                               n_slots=SV_SLOTS, on_token=lambda i, t, n: streamed.setdefault(
                                   i, []).append(t)), report)
        add(counts)
        reqs6 = []
        for text, question in zip(texts, questions):
            ctx_ids, q_ids = pipe.preprocess(text, [question])
            reqs6.append((ctx_ids, q_ids[0], SV_NEW))
        answers = [streamed[i] for i in range(len(texts))]
        if [tok.decode(a, skip_special_tokens=True) for a in answers] != answers_s:
            raise AssertionError("S6: the streamed tokens are not the answers")
        check_serving_launches("S6", counts, eng.last_stats["decode_steps"], "bf16",
                               2 * L * len(texts), 0, L)
        full = {s: r for s, r in served.items() if len(answers[r]) == SV_NEW}
        check_host_lengths("S6", eng.sc.lengths, eng.sc.offsets, full, reqs6, answers,
                           kept_knorm)
        teacher_force("S6", reqs6, answers, eng, served, sorted(full.values())[:SV_TF])
        del eng, pipe
        torch.cuda.empty_cache()

    if wanted("S7"):
        all7 = serving_requests(gen, V, [SV_CONTEXTS[0]] * 8)
        rates = {}
        for n_slots in (1, SV_SLOTS):
            # One slot serves its requests one after the other at one rate:
            # the first SV_S7_ONE of them, for the script's time.
            reqs7 = all7[:SV_S7_ONE] if n_slots == 1 else all7
            eng = kt.ServingEngine(runner, params, n_slots=n_slots, question_bucket=SV_QUESTION_BUCKET,
                                   fetch_lag=SV_FETCH_LAG, press=knorm,
                                   capacity=serving_capacity(cfg, knorm, reqs7))
            answers, counts, eng, served = serving_once(
                kt, torch, f"S7, {len(reqs7)} requests of {SV_CONTEXTS[0]:,} tokens, Knorm(0.5), "
                f"{n_slots} slot{'s' if n_slots > 1 else ''}",
                lambda: eng.run([kt.Request(*r) for r in reqs7]), report)
            add(counts)
            rates[n_slots] = eng.last_stats["generated_tok_s"]
            check_serving_launches(f"S7 ({n_slots})", counts, eng.last_stats["decode_steps"],
                                   "bf16", 2 * L * len(reqs7), 0, L)
            check_host_lengths(f"S7 ({n_slots})", eng.sc.lengths, eng.sc.offsets, served, reqs7,
                               answers, kept_knorm)
            last = sorted(served.values())
            idx = (last + [r for r in range(len(reqs7)) if r not in last])[:SV_TF]
            teacher_force(f"S7 ({n_slots})", reqs7, answers, eng, served, idx)
            del eng
            torch.cuda.empty_cache()
        report(f"    8 slots against 1: {rates[SV_SLOTS] / rates[1]:.2f}x the generated tok/s")

    if wanted("sampling"):
        # bf16 logits tie at the top now and then: a draw at temperature 1e-4
        # must be one of its row's largest logits, ties included (greedy
        # takes the first of them).
        from kvpress_tpu_torch import serving as sv

        reqs_s = serving_requests(gen, V, [SV_SMALL_CONTEXT] * 4, SV_SAMPLE_NEW)
        runs, draws = {}, []
        sample = sv._sample_rows

        def recording(logits, generator, temperature, top_p):
            out = sample(logits, generator, temperature, top_p)
            draws.append((logits.gather(-1, out[..., None])[..., 0] == logits.amax(-1),
                          (logits == logits.amax(-1, keepdim=True)).sum(-1) > 1))
            return out

        for name, kw in (("greedy", {}), ("temperature 1e-4", dict(do_sample=True,
                                                                    temperature=1e-4, seed=7)),
                         ("seed 1", dict(do_sample=True, temperature=1.0, top_p=0.95, seed=1)),
                         ("seed 1 again", dict(do_sample=True, temperature=1.0, top_p=0.95,
                                               seed=1)),
                         ("seed 2", dict(do_sample=True, temperature=1.0, top_p=0.95, seed=2))):
            eng = kt.ServingEngine(runner, params, n_slots=4, question_bucket=SV_QUESTION_BUCKET,
                                   press=knorm, capacity=serving_capacity(cfg, knorm, reqs_s),
                                   **kw)
            sv._sample_rows = recording if name == "temperature 1e-4" else sample
            try:
                reset_counts()
                runs[name] = eng.run([kt.Request(*r) for r in reqs_s])
                add(read_counts())
            finally:
                sv._sample_rows = sample
            del eng
        top = torch.cat([t.reshape(-1) for t, _ in draws])
        tied = torch.cat([t.reshape(-1) for _, t in draws])
        differ = sum(a != b for x, y in zip(runs["seed 1"], runs["seed 2"]) for a, b in zip(x, y))
        report(f"  sampling, 4 requests of {SV_SMALL_CONTEXT:,} tokens, {SV_SAMPLE_NEW} new: at "
               f"temperature 1e-4, {int(top.sum())} of {top.numel()} draws (first tokens and "
               f"slot-step rows) a largest logit of their row, {int(tied.sum())} rows with a "
               f"tie at the top; the answers "
               f"{'equal' if runs['temperature 1e-4'] == runs['greedy'] else 'differ from'} "
               f"greedy's; seed 1 "
               f"{'reproduces' if runs['seed 1'] == runs['seed 1 again'] else 'does not reproduce'}"
               f"; seeds 1 and 2 differ in {differ} of {4 * SV_SAMPLE_NEW} tokens")
        if not bool(top.all()):
            failures.append("sampling: a draw at temperature 1e-4 is not a largest logit")
        if runs["temperature 1e-4"] != runs["greedy"] and not bool(tied.any()):
            failures.append("sampling: temperature 1e-4 differs from greedy without a tie")
        if runs["seed 1"] != runs["seed 1 again"] or runs["seed 1"] == runs["seed 2"]:
            failures.append("sampling: a seed does not reproduce, or two seeds agree")
    if failures:
        raise AssertionError("; ".join(failures))
    return totals


def serving_check(kt, torch, tokenizer_cls, params, report):
    """S1 and S5 (the serving mutants' check: S5's admissions land while other
    slots decode, so its dead lanes take steps)."""
    return serving_run(kt, torch, tokenizer_cls, params, report, labels=("S1", "S5"))


# --------------------------------------------------------------------- #
# Tensor-parallel serving: parallel/, ServingEngine(mesh=)


TP_CONTEXTS = SV_CONTEXTS     # the world of one: S2's contexts (int8 slots)
TP_REQUESTS = SV_REQUESTS // 4     # the first 4 requests of S2's mix, for the script's time
TP_NEW = SV_NEW
TP_GLOO_CONTEXTS = (2048, 4096)   # the 2-rank worlds over gloo: short contexts
TP_GLOO_REQUESTS = 4
TP_GLOO_NEW = 16
# The 2-rank worlds share the one card over gloo (NCCL refuses two ranks on
# one device); gloo takes CUDA tensors for all_reduce and all_gather.
TP_GLOO_WORLDS = {"model2": {"data": 1, "model": 2}, "data2": {"data": 2, "model": 1}}
# The shard-local presses of ROADMAP Queue A items 18.1-18.11 under a mesh:
# each over a world of one (int8 slots), two requests a press; four of them
# also in the model 2 gloo world (Block there all-gathers its candidate sets
# at four kv heads of eight a rank).
TP_LOCAL_CONTEXTS = (2048, 4096)
TP_LOCAL_NEW = 16
TP_LOCAL_PRESSES = {
    "CAP": lambda kt, L: kt.CapPress(0.5),
    "CUR": lambda kt, L: kt.CURPress(0.5, use_random_leverage=True),
    "CriticalKV(Knorm)": lambda kt, L: kt.CriticalKVPress(kt.KnormPress(0.5)),
    "KeyRerotation(Knorm)": lambda kt, L: kt.KeyRerotationPress(kt.KnormPress(0.5)),
    "PerLayerCompression(Knorm)": lambda kt, L: kt.PerLayerCompressionPress(
        kt.KnormPress(0.5), compression_ratios=tuple(0.25 + 0.5 * (l % 2) for l in range(L))),
    "ThinK": lambda kt, L: kt.ThinKPress(0.5, window_size=32),
    "Chunk(Knorm)": lambda kt, L: kt.ChunkPress(kt.KnormPress(0.5), chunk_length=1024),
    "Composed(Knorm, ThinK)": lambda kt, L: kt.ComposedPress(
        (kt.KnormPress(0.5), kt.ThinKPress(0.5, window_size=32))),
    "Merging(Knorm)": lambda kt, L: kt.MergingPress(kt.KnormPress(0.5)),
    "Block(Knorm)": lambda kt, L: kt.BlockPress(kt.KnormPress(0.5), block_size=512),
    "Finch": lambda kt, L: kt.FinchPress(0.5, window_size=64),
}
TP_LOCAL_GLOO = ("CriticalKV(Knorm)", "KeyRerotation(Knorm)", "Composed(Knorm, ThinK)",
                 "Block(Knorm)")


TP_RANK_TIMEOUT = 600         # seconds for a 2-rank world, and for a collective in it


def tp_press(kt, spec=None):
    """The press of a tensor-parallel run: Knorm(0.5); (``spec`` a name) a
    press of TP_LOCAL_PRESSES at the flagship's depth; or (``spec`` a dict)
    DMS over the KVzap surrogate of the ``.npz`` at ``spec["path"]`` with
    its threshold and ``compact``."""
    if spec is None:
        return kt.KnormPress(0.5)
    if isinstance(spec, str):
        return TP_LOCAL_PRESSES[spec](kt, flagship_config(16).num_layers)
    return kt.DMSPress(kt.KVzapPress(surrogate=kt.load_kvzap_model(spec["path"])),
                       threshold=spec["threshold"], compact=spec["compact"])


def tp_rank(rank: int, world: int, d: str):
    """One rank of a 2-rank world on the one card (its own process, started
    by ``tp_gloo_world``): gloo through a FileStore under ``d``, the
    flagship's params drawn as ``main_path`` draws them, one engine run over
    bf16 slots for each of the runs of ``d/job.json`` (a mesh shape of
    TP_GLOO_WORLDS, a press and its requests; a mesh made once a shape).
    Each rank writes, for each run, its answers, host lengths and offsets,
    launch counts and the (query, kv) head counts its kernels took to
    ``d/rank<r>.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    import kvpress_tpu_torch as kt
    from kvpress_tpu_torch import serving as sv
    from kvpress_tpu_torch.models import llama as ll
    from kvpress_tpu_torch.parallel import make_mesh

    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank}: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with open(f"{d}/job.json") as f:
        job = json.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(f"{d}/store", world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TP_RANK_TIMEOUT))
    try:
        meshes = {}
        cfg = flagship_config(16)
        params = kt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                dtype=torch.bfloat16, device=dev)
        runner = kt.Runner.create(cfg, attn_impl="flash", decode_kernel=True, device=dev)
        heads = {}

        def recording(name, fn):
            def wrapped(q, k, *a, **kw):
                heads.setdefault(name, set()).add((q.shape[1], k.shape[1]))
                return fn(q, k, *a, **kw)
            return wrapped

        ll.flash_attention = recording("flash_attention", ll.flash_attention)
        ll.flash_attention_quant = recording("flash_attention_quant", ll.flash_attention_quant)
        sv.decode_attention = recording("decode_attention", sv.decode_attention)
        outs = []
        for run in job["runs"]:
            if run["world"] not in meshes:
                meshes[run["world"]] = make_mesh(**TP_GLOO_WORLDS[run["world"]],
                                                 device_type="cuda")
            heads.clear()
            eng = kt.ServingEngine(runner, params, n_slots=SV_SLOTS, capacity=run["cap"],
                                   press=tp_press(kt, run["press"]),
                                   question_bucket=SV_QUESTION_BUCKET, fetch_lag=SV_FETCH_LAG,
                                   mesh=meshes[run["world"]])
            torch.cuda.synchronize()
            reset_counts()
            answers = eng.run([kt.Request(*r) for r in run["reqs"]])
            torch.cuda.synchronize()
            outs.append(dict(answers=answers, lengths=eng.sc.lengths.tolist(),
                             offsets=eng.sc.offsets.tolist(), counts=launched(read_counts()),
                             heads={k: sorted(v) for k, v in heads.items()},
                             local_pool=list(eng.sc.keys.shape),
                             own=[eng.own.start, eng.own.stop],
                             stats={k: v for k, v in eng.last_stats.items()
                                    if not isinstance(v, list)}))
            del eng
            torch.cuda.empty_cache()
        with open(f"{d}/rank{rank}.json", "w") as f:
            json.dump(outs, f)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def nccl_world_of_one():
    """A world of one over NCCL in this process (its store under the
    git-ignored ``build/``), and its ("data" 1, "model" 1) mesh."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from kvpress_tpu_torch.parallel import make_mesh

    store = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group("nccl", init_method=f"file://{store}/nccl", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=TP_RANK_TIMEOUT))
    try:
        yield make_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def tp_world_of_one(kt, torch, params, report, press=None, reqs=None, label="TP", mesh=None):
    """The flagship engine (8 slots, int8 slots, ``press``: Knorm(0.5) unless
    given) over a world of one over NCCL (``mesh``, or one made here),
    against the single-process engine on the same card and requests (S2's
    mix unless given): with a world of one a shard is the whole and an
    all-reduce a copy, so the answers, the host lengths and offsets and
    every pool tensor must be identical. Returns the mesh run's launch
    counts."""
    import torch.distributed as dist

    cfg = flagship_config(16)
    L, dev = cfg.num_layers, params.device
    runner = kt.Runner.create(cfg, attn_impl="flash", decode_kernel=True, device=dev)
    press = press or kt.KnormPress(0.5)
    reqs = reqs or serving_requests(torch.Generator().manual_seed(16), cfg.vocab_size,
                                    [TP_CONTEXTS[i % 2] for i in range(TP_REQUESTS)], TP_NEW)
    kw = dict(n_slots=SV_SLOTS, capacity=serving_capacity(cfg, press, reqs), press=press,
              quantized=True, kv_bits=8, question_bucket=SV_QUESTION_BUCKET,
              fetch_lag=SV_FETCH_LAG)
    names = ("keys", "values", "key_scales", "value_scales", "mask", "lengths", "offsets")

    def run(label, mesh=None):
        eng = kt.ServingEngine(runner, params, mesh=mesh, **kw)
        answers, counts, eng, _ = serving_once(
            kt, torch, label, lambda: eng.run([kt.Request(*r) for r in reqs]), report)
        pool = {n: getattr(eng.sc, n).clone() for n in names}
        return answers, counts, eng.last_stats["decode_steps"], pool

    ref = run(f"{label} reference: the single-process engine, int8 slots")
    world = contextlib.nullcontext(mesh) if mesh is not None else nccl_world_of_one()
    with world as mesh:
        got = run(f"{label} world of one over {dist.get_backend()} (mesh "
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}), int8 slots", mesh)

    def identical(label, a, b):
        if a[0] != b[0]:
            raise AssertionError(f"{label}: the answers differ")
        for n in names:
            if not torch.equal(a[3][n], b[3][n]):
                raise AssertionError(f"{label}: the pool's {n} differ")

    identical(f"{label} world of one", ref, got)
    planted = (ref[0], ref[1], ref[2], dict(ref[3], keys=ref[3]["keys"].clone()))
    planted[3]["keys"].view(-1)[12345] += 1
    must_reject("one pool code moved", identical, "planted", planted, got)
    steps, n_adm = got[2], len(reqs)
    check_serving_launches(f"{label} world of one", got[1], steps, "int8", L * n_adm,
                           L * n_adm, L)
    report(f"  {label} world of one: answers, host lengths and offsets and the pool "
           f"({', '.join(names[:5])}) identical to the single-process engine's; launches per "
           f"rank: decode_attention {got[1]['decode_attention'] / steps:g} a slot step, flash "
           f"{(got[1]['flash_attention'] + got[1]['flash_attention_quant']) / n_adm:g} an "
           f"admission ({got[1]['flash_attention'] / n_adm:g} flash_attention + "
           f"{got[1]['flash_attention_quant'] / n_adm:g} flash_attention_quant)")
    return got[1]


def tp_gloo_world(kt, torch, params, report, tie: float, runs, label="TP"):
    """A 2-rank world on the one card over gloo, one engine run for each of
    ``runs`` (``(name, spec, reqs)``: the mesh ``TP_GLOO_WORLDS[name]``; the
    press, ``tp_press``; the requests, TP_GLOO_REQUESTS of TP_GLOO_CONTEXTS
    when None): the ranks' answers teacher-forced against the
    single-process runner (the bf16 tie limit of the serving phase), their
    host lengths, the launch counts per rank, and the head counts each
    rank's kernels took."""
    import tempfile

    cfg = flagship_config(16)
    runs = [(name, spec, reqs or serving_requests(
        torch.Generator().manual_seed(17), cfg.vocab_size,
        [TP_GLOO_CONTEXTS[i % 2] for i in range(TP_GLOO_REQUESTS)], TP_GLOO_NEW))
        for name, spec, reqs in runs]
    d = tempfile.mkdtemp(dir=ROOT / "build")
    with open(f"{d}/job.json", "w") as f:
        json.dump(dict(runs=[
            dict(world=name, press=spec, reqs=reqs,
                 cap=serving_capacity(cfg, tp_press(kt, spec), reqs))
            for name, spec, reqs in runs]), f)
    start = time.perf_counter()
    # Each rank is a fresh interpreter that imports this file (not a fork,
    # and not a re-run of whatever script imported it); a rank that fails
    # ends the world.
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'tests')!r}]; "
            f"import chip_smoke; chip_smoke.tp_rank(int(sys.argv[1]), 2, {d!r})")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=ROOT) for r in range(2)]
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                raise AssertionError(f"{label}: a rank failed (exit codes "
                                     f"{[p.poll() for p in procs]})")
            if time.perf_counter() - start > TP_RANK_TIMEOUT:
                raise AssertionError(f"{label}: the world did not end in {TP_RANK_TIMEOUT} s")
            time.sleep(0.2)
        if any(p.returncode != 0 for p in procs):
            raise AssertionError(f"{label}: a rank failed (exit codes "
                                 f"{[p.returncode for p in procs]})")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - start
    ranks = [json.load(open(f"{d}/rank{r}.json")) for r in range(2)]
    runner = kt.Runner.create(cfg, attn_impl="flash", decode_kernel=True, device=params.device)
    for i, (name, spec, reqs) in enumerate(runs):
        tp_gloo_check(kt, torch, params, report, runner, name, tie, spec, reqs,
                      [r[i] for r in ranks], f"{label} {spec}" if isinstance(spec, str)
                      else label)
    report(f"  {label}: {len(runs)} run{'s' if len(runs) > 1 else ''} "
           f"({', '.join(sorted({name for name, _, _ in runs}))}) in a world of {wall:.1f} s "
           "(spawn and weights included; gloo through the host: no multi-card speed)")


def tp_gloo_check(kt, torch, params, report, runner, name, tie, spec, reqs, ranks, label):
    """One run of a gloo world (``ranks``: each rank's output) against the
    single-process runner: equal host states on the ranks, answers within
    the tie limit, host lengths (a compacting press's: its reference
    layers'), launches and head counts per rank."""
    cfg = flagship_config(16)
    L, tp = cfg.num_layers, TP_GLOO_WORLDS[name]["model"]
    press = tp_press(kt, spec)
    answers = ranks[0]["answers"]
    for r in ranks[1:]:
        if r["answers"] != answers or r["lengths"] != ranks[0]["lengths"]:
            raise AssertionError(f"{label} {name}: the ranks' host states differ")
    flips, widest, kept = [], 0.0, []
    for req, got in zip(reqs, answers):
        n_flip, worst, cache, _ = serving_reference(kt, torch, runner, params, press, req, got)
        check_teacher_forced(f"{label} {name}", n_flip, worst, len(got), tie)
        flips.append(n_flip)
        widest = max(widest, worst)
        # A compacting press's layers keep their longest head's count.
        n = len(req[0])
        kept.append(cache.mask[:, 0, :, :n].sum(-1).amax(-1).tolist())
        del cache
    served = {s: r for s, r in enumerate(range(len(reqs)))}
    lengths, offsets = torch.tensor(ranks[0]["lengths"]), torch.tensor(ranks[0]["offsets"])
    if not isinstance(spec, dict):
        check_host_lengths(f"{label} {name}", lengths, offsets, served, reqs, answers,
                           press.exact_kept, rerotates=getattr(press, "rerotates", False))
    else:
        for s, r in served.items():
            want = [k + len(reqs[r][1]) + len(answers[r]) - 1 for k in kept[r]]
            if lengths[:, s].tolist() != want:
                raise AssertionError(f"{label} {name}: slot {s} holds lengths "
                                     f"{lengths[:, s].tolist()}, the reference's compacted "
                                     f"layers need {want}")
    steps = ranks[0]["stats"]["decode_steps"]
    want_heads = [[cfg.num_heads // tp, cfg.num_kv_heads // tp]]
    for r, out in enumerate(ranks):
        c = out["counts"]
        check_serving_launches(f"{label} {name} rank {r}", dict.fromkeys(counters(), 0) | c,
                               steps, "bf16", 2 * L * len(reqs), 0, L)
        if any(v != want_heads for v in out["heads"].values()):
            raise AssertionError(f"{label} {name} rank {r}: the kernels took heads "
                                 f"{out['heads']}, not {want_heads[0]}")
        report(f"  {label} {name} rank {r} (gloo, CUDA tensors, one card): pool "
               f"{out['local_pool']} "
               f"holding slots {out['own']}; launches: decode_attention "
               f"{c['decode_attention'] / steps:g} a slot step, flash_attention "
               f"{c['flash_attention'] / len(reqs):g} an admission; (query, kv) heads "
               f"{out['heads']}")
    st = ranks[0]["stats"]
    report(f"  {label} {name}: {len(reqs)} requests of {sorted({len(r[0]) for r in reqs})} "
           f"tokens, {reqs[0][2]} new, "
           f"teacher-forced against the single-process runner: near-tie flips {flips}, the "
           f"widest {widest:.4f} (limit {tie:.4f}); host lengths as predicted; {steps} slot "
           f"steps, inter-token gap p50 / max {st['p50_intertoken_gap_s'] * 1e3:.1f} / "
           f"{st['max_intertoken_gap_s'] * 1e3:.1f} ms, TTFT p50 {st['p50_ttft_s']:.3f} s, "
           f"the run {st['wall_s']:.2f} s")


def critical_norm_check(kt, torch, cfg, layer, values, size=2, rows=None, read_global=False):
    """CriticalKV's ||Wo_h v||_1 on each rank of a model ``size`` mesh (the
    local config, the rank's rows of ``wo`` from ``shard_layer``) against
    the single-device norm's slice of the rank's kv heads (both float32
    products of the same weights and values: within 1e-5 of the scale).
    Planted faults: ``rows(r)`` a rank takes another rank's rows;
    ``read_global`` the rank reads the global head count and ``wo``."""
    from kvpress_tpu_torch.parallel.mesh import local_config, shard_layer

    def norm(cfg, tensors, v):
        ctx = type("Ctx", (), dict(cfg=cfg, layer_params=tensors))()
        return kt.CriticalKVPress.vwl1norm(ctx, v)

    want = norm(cfg, layer, values)
    n = cfg.num_kv_heads // size
    local = local_config(cfg, size)
    worst = 0.0
    for r in range(size):
        mine = values[:, r * n:(r + 1) * n]
        if read_global:
            got = norm(cfg, layer, mine)
        else:
            got = norm(local, shard_layer(layer, r if rows is None else rows(r), size), mine)
        err = ((got - want[:, r * n:(r + 1) * n]).abs().max()
               / want.abs().max().clamp_min(1e-6)).item()
        if not err <= 1e-5:
            raise AssertionError(f"rank {r} of {size}: ||Wo v|| {err:.3e} of its scale off the "
                                 "single device's heads")
        worst = max(worst, err)
    return worst


def tp_critical_norm_run(kt, torch, params, report):
    """``critical_norm_check`` on the flagship's layer 0 in bf16 and in int4
    (the repacked row-parallel halves), model 2 and 4, over 4,096 bf16
    values; each planted fault rejected."""
    from kvpress_tpu_torch.models.llama import quantize_layer_int4

    cfg = flagship_config(16)
    layer = {n: p.data for n, p in params.layers[0].named_parameters(recurse=False)}
    int4 = quantize_layer_int4({n: t.float() for n, t in layer.items()})
    gen = torch.Generator(device=params.device).manual_seed(20)
    values = torch.randn(1, cfg.num_kv_heads, 4096, cfg.head_dim, generator=gen,
                         device=params.device, dtype=torch.bfloat16)
    errs = {}
    for name, tensors in (("bf16", layer), ("int4", int4)):
        for size in (2, 4):
            errs[f"{name} model {size}"] = critical_norm_check(kt, torch, cfg, tensors, values,
                                                               size)
        must_reject(f"{name}: a rank takes the next rank's rows of wo", critical_norm_check,
                    kt, torch, cfg, tensors, values, 2, lambda r: 1 - r)
        must_reject(f"{name}: a rank reads the global num_heads and wo", critical_norm_check,
                    kt, torch, cfg, tensors, values, 2, None, True)
    report(f"  TP CriticalKV's ||Wo v|| per rank against the single device's heads (layer 0, "
           f"4,096 values): {', '.join(f'{k} {v:.2e}' for k, v in errs.items())} of the scale "
           "(limit 1e-05); a rank on the next rank's rows of wo and a rank reading the global "
           "num_heads and wo rejected, bf16 and int4")


def tp_local_presses_run(kt, torch, params, report):
    """Items 18.1-18.11 at the flagship shape: each press over a world of one
    over NCCL (int8 slots, TP_LOCAL_CONTEXTS, TP_LOCAL_NEW new), identical
    to the single-process engine, its launch counts held; and one prefill of
    the longer context timed on the rank's (sharded) runner and on the
    single-process runner (synchronized host clock, the better of two).
    Returns the mesh runs' launch counts."""
    from kvpress_tpu_torch.parallel import shard_params

    cfg = flagship_config(16)
    dev = params.device
    single = kt.Runner.create(cfg, attn_impl="flash", decode_kernel=True, device=dev)
    totals = {}
    times = {}
    with nccl_world_of_one() as mesh:
        sharded = single.sharded(mesh)
        local = shard_params(params, mesh)
        for i, label in enumerate(TP_LOCAL_PRESSES):
            press = tp_press(kt, label)
            reqs = serving_requests(torch.Generator().manual_seed(20 + i), cfg.vocab_size,
                                    TP_LOCAL_CONTEXTS, TP_LOCAL_NEW)
            counts = tp_world_of_one(kt, torch, params, report, press=press, reqs=reqs,
                                     label=f"TP {label}", mesh=mesh)
            for name, n in counts.items():
                totals[name] = totals.get(name, 0) + n
            ids = torch.tensor([reqs[1][0]], device=dev)
            best = {}
            for which, runner, p in (("one process", single, params),
                                     ("world of one", sharded, local)):
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    runner.prefill(p, ids, press=press)
                    torch.cuda.synchronize()
                    best[which] = min(best.get(which, 1e9), time.perf_counter() - t0)
            times[label] = best
        del local
    torch.cuda.empty_cache()
    report(f"  TP items 18.1-18.11, prefill of {TP_LOCAL_CONTEXTS[1]:,} tokens (ms, the "
           "better of two) on one process / on the world of one's rank: " + "; ".join(
               f"{k} {v['one process'] * 1e3:.1f} / {v['world of one'] * 1e3:.1f}"
               for k, v in times.items()))
    return totals


def tp_serving_run(kt, torch, tokenizer_cls, params, report,
                   worlds=("one", "local", "model2", "data2")):
    """Tensor-parallel serving at the flagship shape: the world of one over
    NCCL held identical to the single-process engine (Knorm, then
    (``"local"``) each press of items 18.1-18.11 and CriticalKV's norm per
    rank with its planted faults), then one 2-rank gloo world on the one
    card (a model 2 mesh with Knorm and the presses of TP_LOCAL_GLOO, a data
    2 mesh with Knorm) teacher-forced against the single-process runner.
    Returns the worlds of one's launch counts."""
    from kvpress_tpu_torch.ops import _build

    # Built here, before any rank is spawned: ranks never race nvcc into one
    # build directory (a no-op when phase 2 built them).
    _build.build()
    counts = {}
    if "one" in worlds:
        counts = tp_world_of_one(kt, torch, params, report)
    if "local" in worlds:
        tp_critical_norm_run(kt, torch, params, report)
        for name, n in tp_local_presses_run(kt, torch, params, report).items():
            counts[name] = counts.get(name, 0) + n
    gloo = [w for w in worlds if w in TP_GLOO_WORLDS]
    if gloo:
        # One world of spawned ranks for every run: a mesh a shape.
        tie = F32_RATIO * 2 * serving_noise(kt, torch, params, report)
        cfg = flagship_config(16)
        local = serving_requests(torch.Generator().manual_seed(19), cfg.vocab_size,
                                 TP_LOCAL_CONTEXTS, TP_GLOO_NEW)
        runs = []
        for name in gloo:
            runs += [(name, None, None)] + ([(name, spec, local) for spec in TP_LOCAL_GLOO]
                                            if name == "model2" else [])
        tp_gloo_world(kt, torch, params, report, tie, runs)
    return counts


def tp_serving_check(kt, torch, tokenizer_cls, params, report):
    """The TP mutant's check: the model 2 world (a world of one sums over one
    rank, so a dropped all-reduce shows only across two)."""
    return tp_serving_run(kt, torch, tokenizer_cls, params, report, worlds=("model2",))


# --------------------------------------------------------------------- #
# Context parallelism: parallel/ring, context_prefill, decode


CP_CONTEXT = CONTEXT_TOKENS   # the world of one: the flagship's 32K, whole
CP_NEW = 32
CP_BLOCK = 4096               # the gloo worlds' block of the sequence (Sl)
CP_GLOO_NEW = 16
# The 4-rank world shares the one card over gloo: seq 4 over 16,384 tokens
# (bf16 and int8 shards, host loop and fused), and model 2 x seq 2 over 8,192.
CP_GLOO_JOBS = {
    "seq4 bf16": dict(shape={"seq": 4}, context=4 * CP_BLOCK, quantized=False, fused=False),
    "seq4 int8": dict(shape={"seq": 4}, context=4 * CP_BLOCK, quantized=True, fused=False),
    "seq4 bf16 fused": dict(shape={"seq": 4}, context=4 * CP_BLOCK, quantized=False, fused=True),
    "model2 x seq2 bf16": dict(shape={"seq": 2, "model": 2}, context=2 * CP_BLOCK,
                               quantized=False, fused=False),
}


def cp_context(torch, n: int, vocab: int) -> list[int]:
    return torch.randint(0, vocab, (n,), generator=torch.Generator().manual_seed(n)).tolist()


def cp_rank(rank: int, world: int, d: str):
    """One rank of the 4-rank world on the one card (its own process, started
    by ``cp_gloo_world``): gloo through a FileStore under ``d``, the
    flagship's params drawn as ``main_path`` draws them, and for each job of
    ``d/job.json`` its mesh, ``context_parallel_generate`` with Knorm(0.5)
    (launch counts set to 0 before and read after, the (query, kv) heads
    each flash launch took) and ``context_parallel_prefill`` again for the
    per-layer lengths. Writes ``d/rank<r>.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    import kvpress_tpu_torch as kt
    from kvpress_tpu_torch.parallel import ring as ring_mod
    from kvpress_tpu_torch.parallel import (SeqShard, context_parallel_generate,
                                            context_parallel_prefill, make_seq_mesh,
                                            shard_params)

    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank}: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with open(f"{d}/job.json") as f:
        jobs = json.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(f"{d}/store", world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TP_RANK_TIMEOUT))
    try:
        cfg = flagship_config(16)
        params = kt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                dtype=torch.bfloat16, device=dev)
        heads = set()
        flash = ring_mod.flash_attention

        def recording(q, k, *a, **kw):
            heads.add((q.shape[1], k.shape[1]))
            return flash(q, k, *a, **kw)

        ring_mod.flash_attention = recording
        out = {}
        for label, job in jobs.items():
            shape = job["shape"]
            mesh = make_seq_mesh(shape["seq"], shape.get("model", 1), device_type="cuda")
            model = "model" in mesh.mesh_dim_names
            runner = kt.Runner.create(cfg, attn_impl="flash", device=dev,
                                      mesh=mesh if model else None)
            p = shard_params(params, mesh) if model else params
            ids = torch.tensor([job["ids"]], device=dev)
            kw = dict(runner=runner, mesh=mesh, press=kt.KnormPress(0.5),
                      quantized=job["quantized"], kv_bits=8)
            heads.clear()
            staged = SeqShard.staged_blocks
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            toks = context_parallel_generate(p, ids, max_new_tokens=CP_GLOO_NEW,
                                             fused=job["fused"], **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launched(read_counts())
            lengths = context_parallel_prefill(p, ids, **kw)[2].tolist()
            out[label] = dict(tokens=toks[0].tolist(), counts=counts, heads=sorted(heads),
                              lengths=lengths, wall=wall, seq_rank=mesh.get_local_rank("seq"),
                              staged=SeqShard.staged_blocks - staged)
            del p
            torch.cuda.empty_cache()
        with open(f"{d}/rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def cp_gloo_world(kt, torch, params, report, tie, labels=tuple(CP_GLOO_JOBS)):
    """The 4-rank world on the one card over gloo (``CP_GLOO_JOBS``): every
    rank's tokens alike, teacher-forced against the single-process runner
    with ``ChunkPress(KnormPress(0.5), CP_BLOCK)`` (the same math by
    construction); the fused loop's tokens the host loop's; each rank's
    lengths (Knorm's half of its block), flash launches (16 (r + 1) a
    prefill on seq rank r: a block in the future is skipped) and heads."""
    import tempfile

    cfg = flagship_config(16)
    L, vocab = cfg.num_layers, cfg.vocab_size
    jobs = {label: dict(CP_GLOO_JOBS[label], ids=cp_context(torch, CP_GLOO_JOBS[label]["context"],
                                                            vocab)) for label in labels}
    d = tempfile.mkdtemp(dir=ROOT / "build")
    with open(f"{d}/job.json", "w") as f:
        json.dump(jobs, f)
    start = time.perf_counter()
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'tests')!r}]; "
            f"import chip_smoke; chip_smoke.cp_rank(int(sys.argv[1]), 4, {d!r})")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=ROOT) for r in range(4)]
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                raise AssertionError(f"CP gloo world: a rank failed (exit codes "
                                     f"{[p.poll() for p in procs]})")
            if time.perf_counter() - start > TP_RANK_TIMEOUT:
                raise AssertionError(f"CP gloo world: it did not end in {TP_RANK_TIMEOUT} s")
            time.sleep(0.2)
        if any(p.returncode != 0 for p in procs):
            raise AssertionError(f"CP gloo world: a rank failed (exit codes "
                                 f"{[p.returncode for p in procs]})")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    world_s = time.perf_counter() - start
    ranks = [json.load(open(f"{d}/rank{r}.json")) for r in range(4)]
    runner = kt.Runner.create(cfg, attn_impl="flash", decode_kernel=True, device=params.device)
    knorm = kt.KnormPress(0.5)
    for label, job in jobs.items():
        toks = ranks[0][label]["tokens"]
        if any(r[label]["tokens"] != toks for r in ranks):
            raise AssertionError(f"CP {label}: the ranks' tokens differ")
        n_seq = job["shape"]["seq"]
        n_flip, worst, cache, _ = serving_reference(
            kt, torch, runner, params, kt.ChunkPress(knorm, chunk_length=CP_BLOCK),
            (job["ids"], [job["ids"][-1]]), toks, quantized=job["quantized"], kv_bits=8)
        del cache
        check_teacher_forced(f"CP {label}", n_flip, worst, len(toks), tie)
        tp = job["shape"].get("model", 1)
        want_heads = [[cfg.num_heads // tp, cfg.num_kv_heads // tp]]
        for r, out in enumerate(ranks):
            got = out[label]
            flash = got["counts"].get("flash_attention", 0)
            if flash != L * (got["seq_rank"] + 1) or set(got["counts"]) - {
                    "flash_attention", "flash_attention_bf16", "flash_attention_d64",
                    "flash_attention_bf16_d64"}:
                raise AssertionError(f"CP {label} rank {r}: launches {got['counts']}, not "
                                     f"flash_attention {L * (got['seq_rank'] + 1)} alone")
            if got["lengths"] != [knorm.n_kept(CP_BLOCK)] * L:
                raise AssertionError(f"CP {label} rank {r}: lengths {got['lengths']}")
            if got["heads"] != want_heads:
                raise AssertionError(f"CP {label} rank {r}: flash took heads {got['heads']}, "
                                     f"not {want_heads[0]}")
        report(f"  CP {label} ({job['context']} tokens, {n_seq} seq blocks of {CP_BLOCK}, "
               f"{CP_GLOO_NEW} new): teacher-forced against the single-process runner with "
               f"ChunkPress(Knorm(0.5), {CP_BLOCK}): {n_flip} near-tie flips, the widest gap "
               f"{worst:.4f} (limit {tie:.4f}); per rank: flash launches "
               f"{[r[label]['counts'].get('flash_attention', 0) for r in ranks]}, (query, kv) "
               f"heads {ranks[0][label]['heads']}, lengths {knorm.n_kept(CP_BLOCK)} a layer, "
               f"blocks through host memory {[r[label]['staged'] for r in ranks]}; the generate "
               f"call {max(r[label]['wall'] for r in ranks):.2f} s (gloo through the host: no "
               f"multi-card speed)")
    if "seq4 bf16 fused" in jobs and "seq4 bf16" in jobs:
        if ranks[0]["seq4 bf16 fused"]["tokens"] != ranks[0]["seq4 bf16"]["tokens"]:
            raise AssertionError("CP seq4: the fused loop's tokens differ from the host loop's")
        report("  CP seq4: the fused loop's tokens are the host loop's")
    report(f"  CP gloo world of 4 ranks: {world_s:.1f} s (spawn and weights included)")


def cp_world_of_one(kt, torch, params, report, tie):
    """The flagship at 32K through ``context_parallel_generate`` over a world
    of one over NCCL in this process, Knorm(0.5), 32 new tokens, bf16 and
    then int8 shards; against the single-process runner on the same weights:
    equal kept lengths per layer (and layer 0's kept keys bit-equal: they do
    not depend on attention), tokens teacher-forced within the bf16 tie
    limit, flash launched 16 times a prefill; the wall time and peak memory
    of each, and one decode step's device busy time and idle share beside
    the single-process step's. Returns the runs' launch counts and the CP
    flash launches."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from kvpress_tpu_torch.parallel import (context_parallel_decode_step,
                                            context_parallel_generate, context_parallel_prefill,
                                            grow_shards, make_seq_mesh)

    cfg = flagship_config(16)
    L, dev = cfg.num_layers, params.device
    runner = kt.Runner.create(cfg, attn_impl="flash", decode_kernel=True, device=dev)
    knorm = kt.KnormPress(0.5)
    ctx = cp_context(torch, CP_CONTEXT, cfg.vocab_size)
    ids = torch.tensor([ctx], device=dev)
    totals = {}
    store = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group("nccl", init_method=f"file://{store}/nccl", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=TP_RANK_TIMEOUT))
    try:
        mesh = make_seq_mesh(1, device_type="cuda")
        for quantized in (False, True):
            label = f"CP world of one over {dist.get_backend()}, {'int8' if quantized else 'bf16'} shards"
            kw = dict(runner=runner, mesh=mesh, press=knorm, quantized=quantized, kv_bits=8)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            toks = context_parallel_generate(params, ids, max_new_tokens=CP_NEW, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            counts = read_counts()
            for name, n in counts.items():
                totals[name] = totals.get(name, 0) + n
            if counts["flash_attention"] != L or counts["flash_attention_quant"] or \
                    counts["decode_attention"]:
                raise AssertionError(f"{label}: launches {launched(counts)}, not flash_attention "
                                     f"{L} alone")
            shards = context_parallel_prefill(params, ids, **kw)
            _, cache, _ = runner.prefill(params, ids, press=knorm, quantized=quantized, kv_bits=8)
            if shards[2].tolist() != cache.length.tolist():
                raise AssertionError(f"{label}: lengths {shards[2].tolist()}, the single-process "
                                     f"prefill's {cache.length.tolist()}")
            n0 = int(cache.length[0])
            if not torch.equal(shards[0][0][..., :n0, :], cache.keys[0][..., :n0, :]):
                raise AssertionError(f"{label}: layer 0's kept keys differ")
            del shards, cache
            got = toks[0].tolist()
            n_flip, worst, cache, _ = serving_reference(kt, torch, runner, params, knorm,
                                                        (ctx, [ctx[-1]]), got,
                                                        quantized=quantized, kv_bits=8)
            del cache
            check_teacher_forced(label, n_flip, worst, len(got), tie)
            report(f"  {label}: {CP_CONTEXT} tokens, {CP_NEW} new: {wall:.2f} s, peak memory "
                   f"{peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} GiB over the "
                   f"{held / 2**30:.3f} GiB held before); launches {launched(counts)}; lengths "
                   f"and layer 0's kept keys the single-process prefill's; teacher-forced: "
                   f"{n_flip} near-tie flips, the widest gap {worst:.4f} (limit {tie:.4f})")
        # One decode step, context parallel (the dense split-KV partials) and
        # single-process (the decode kernel), over the same Knorm cache.
        shards = grow_shards(context_parallel_prefill(params, ids, runner=runner, mesh=mesh,
                                                      press=knorm), 64)
        tok = ids[:, -1:]
        cp_wall, cp_k = device_kernels(lambda: context_parallel_decode_step(
            params, tok, shards, CP_CONTEXT, runner=runner, mesh=mesh), 4)
        _, cache, _ = runner.prefill(params, ids, press=knorm)
        cache = kt.resize(cache, int(cache.length.max()) + 64)
        sp_wall, sp_k = device_kernels(lambda: runner.forward(params, tok, cache,
                                                              logits_last_only=True), 4)
        readings = []
        for name, wall_ms, kernels in (("context parallel", cp_wall, cp_k),
                                       ("single-process", sp_wall, sp_k)):
            busy = sum(ms for ms, _ in kernels.values())
            top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:3]
            readings.append(f"{name} {wall_ms:.2f} ms a step, device busy {busy:.2f} ms, idle "
                            f"{1 - busy / wall_ms:.1%} (largest: "
                            + ", ".join(f"{k[:40]} {v[0]:.3f} ms" for k, v in top) + ")")
        report("  CP world of one, one decode step over the 32K Knorm cache: "
               + "; ".join(readings))
        del shards, cache
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    totals["flash_attention_cp"] = totals["flash_attention"]
    return totals


def cp_run(kt, torch, tokenizer_cls, params, report, worlds=("one", "gloo"),
           labels=tuple(CP_GLOO_JOBS)):
    """Context-parallel prefill and distributed decode at the flagship shape:
    the world of one over NCCL against the single-process path, then the
    4-rank gloo world on the one card (its jobs ``labels``). Returns the
    world of one's launch counts, with the ring's flash launches as
    ``flash_attention_cp``."""
    from kvpress_tpu_torch.ops import _build

    _build.build()          # before any rank is spawned (a no-op once built)
    tie = F32_RATIO * 2 * serving_noise(kt, torch, params, report)   # the TP phase's limit
    counts = cp_world_of_one(kt, torch, params, report, tie) if "one" in worlds else {}
    if "gloo" in worlds:
        cp_gloo_world(kt, torch, params, report, tie, labels)
    return counts


def cp_check(kt, torch, tokenizer_cls, params, report):
    """The ring mutant's check: the seq 4 world's bf16 host loop (a world of
    one has a single ring step, so a wrong combine shows only across ranks)."""
    cp_run(kt, torch, tokenizer_cls, params, report, worlds=("gloo",), labels=("seq4 bf16",))


# --------------------------------------------------------------------- #
# KVzap training and its surrogate served: training/, init_params_int8,
# utils/ (phase "KZ")


KZ_CONTEXT = 8192             # the pipeline runs' contexts, the 8B body's included
KZ_NEW = 16                   # new tokens an answer
KZ_DOCS = 16                  # the collector's synthetic documents
KZ_WORDS = 1024               # words a document: repeat prompts of about 2,070 tokens
KZ_TOKENS = 256               # collect_scores' n_tokens a document: N = 4,096
KZ_WORD_POOL = 4096           # distinct words the documents draw from
# The collector's log-targets against their float64 recomputation from the
# same captured probabilities, hidden states and values: float32 rounding
# moves them by about 1e-6; dropping the ||Wo . v|| factor moves them by
# its log, about 2 on random weights (PERF.md).
KZ_Y_LIMIT = 1e-3
KZ_TP_CONTEXT = 2048          # the DMS(KVzap) requests served under a mesh
KZ_TP_REQUESTS = 2
KZ_TP_NEW = 16


def chat_stub(tokenizer_cls, vocab_size: int):
    """``tokenizer_cls`` (the toy word tokenizer) with what
    ``repeat_prompt_tokenization`` calls: a chat template (``<|role|>
    content <|end|>`` a message) and character offsets of its whitespace
    tokens."""
    class ChatStub(tokenizer_cls):
        chat_template = "<|role|> content <|end|>"

        def apply_chat_template(self, messages, tokenize=False, add_generation_prompt=False):
            text = "".join(f"<|{m['role']}|> {m['content']} <|end|> " for m in messages)
            return self.encode(text) if tokenize else text

        def __call__(self, text, return_offsets_mapping=False, add_special_tokens=False):
            spans = [(m.start(), m.end()) for m in re.finditer(r"\S+", text)]
            out = {"input_ids": [self._tok2id(text[a:b]) for a, b in spans]}
            if return_offsets_mapping:
                out["offset_mapping"] = spans
            return out

    return ChatStub(vocab_size=vocab_size)


def kz_documents(n: int, words: int, seed: int = 18) -> list[str]:
    """``n`` synthetic documents of ``words`` words (of KZ_WORD_POOL), from a
    seed: the stand-in for the reference's Nemotron documents."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [" ".join(f"d{i}" for i in rng.integers(0, KZ_WORD_POOL, words)) for _ in range(n)]


def kz_pipeline(kt, torch, label, runner, params, tok, report, questions, press, needed,
                unwanted=(), context=None, **kw):
    """One ``KVPressPipeline`` call over ``context`` (KZ_CONTEXT distinct
    words unless given) with the launch counts set to 0 before it and read
    after it. Returns (answers, counts, the prefill's layer lengths, the
    prefill's masked fraction or None)."""
    prefills = []

    def summarize(cache):
        return None if cache.mask is None else float(kt.masked_fraction(cache))

    pipe = kt.KVPressPipeline(timed_runner(kt, torch, runner, prefills, summarize), params, tok)
    context = context or " ".join(f"w{i}" for i in range(KZ_CONTEXT))
    reset_counts()
    t0 = time.perf_counter()
    out = pipe(context, questions=questions, press=press, max_new_tokens=KZ_NEW, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    answers = out["answers"]
    if len(answers) != len(questions) or not all(isinstance(a, str) and a for a in answers):
        raise AssertionError(f"{label}: bad answers {answers!r}")
    check_run(label, counts, needed, unwanted)
    lengths, masked = prefills[-1][3:5]
    report(f"  {label}: {seconds:.2f} s in all, {prefill_reading(prefills)}, layer lengths "
           f"{sorted(set(lengths))}, masked fraction after the prefill {masked}, launches "
           f"{launched(counts)}, answer tokens {[len(a.split()) for a in answers]}")
    return answers, counts, lengths, masked


def masked_slots(torch, cache) -> int:
    """The valid slots whose keep bit is clear, over every layer and head."""
    pos = torch.arange(cache.max_size, device=cache.mask.device)
    valid = pos < cache.length.to(pos.device)[:, None]                   # (L, S)
    return int((valid[:, None, None] & ~cache.mask).sum())


def check_counts(label, counts, want):
    got = {name: counts.get(name, 0) for name in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, predicted {want}")


def kz_init_8b(kt, torch, tokenizer_cls, dev, report):
    """(a) ``init_params_int8`` at Llama-3.1-8B's published shape (32 layers,
    the 128,256-word vocabulary, untied): int4 layers and int8 embeddings
    drawn on the card ``dev``, then one pipeline call (8,192 tokens,
    Knorm(0.5), int4 KV, both questions, 16 new tokens). Returns its launch
    counts."""
    from kvpress_tpu_torch import utils

    cfg = dataclasses.replace(llama31_8b_config(32), vocab_size=128256,
                              tie_word_embeddings=False)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = kt.init_params_int8(cfg, torch.Generator(device=dev).manual_seed(8), bits=4,
                                 int8_embeddings=True, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stats = utils.memory_stats()
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    report(f"  KZ 8B init_params_int8 (int4 layers, int8 embedding and head, 128,256 words): "
           f"{seconds:.2f} s, {weights / 2**30:.3f} GiB of weights, peak "
           f"{(stats['peak_bytes_in_use'] - held) / 2**30:.3f} GiB over the "
           f"{held / 2**30:.3f} GiB held (of {stats['bytes_limit'] / 2**30:.1f})")
    # A bf16 copy of one layer's matrices would be 436 MB, of the embedding 1 GB.
    if stats["peak_bytes_in_use"] - held > weights + 64 * 2**20:
        raise AssertionError("KZ 8B: the init held more than its weights")
    if params.embed.dtype != torch.int8 or params.layers[0].wq.dtype != torch.uint8:
        raise AssertionError("KZ 8B: the draws are not int8 / int4 payloads")
    runner = kt.Runner.create(cfg, device=dev)
    tok = tokenizer_cls(vocab_size=cfg.vocab_size)
    _, counts, lengths, _ = kz_pipeline(
        kt, torch, "KZ 8B Knorm(0.5), int4 KV", runner, params, tok, report, QUESTIONS,
        kt.KnormPress(0.5), ("flash_attention", "decode_attention"), ("flash_attention_quant",),
        quantized=True, kv_bits=4)
    L = cfg.num_layers
    if lengths != [KZ_CONTEXT // 2] * L:
        raise AssertionError(f"KZ 8B: layer lengths {lengths}")
    # The prefill and the 152-token question on flash (the int4 buffer
    # dequantized), the 4-token question and 15 steps an answer on decode.
    check_counts("KZ 8B", counts, {"flash_attention_bf16_d128": 2 * L,
                                   "decode_attention_int4_d128": L * (1 + 2 * (KZ_NEW - 1)),
                                   "flash_attention": 2 * L,
                                   "decode_attention": L * (1 + 2 * (KZ_NEW - 1))})
    del params, runner
    torch.cuda.empty_cache()
    return counts


def recording_collector(kt, captured: dict, layers):
    """The collector press, keeping for ``layers`` what it read: the
    attention probabilities, hidden states and values, and its state."""
    base = kt.training.kvzap.KVzipScoreCollector

    @dataclasses.dataclass(frozen=True)
    class Recording(base):
        def layer_compress(self, ctx, keys, values, length, mask, state=None):
            out = super().layer_compress(ctx, keys, values, length, mask, state)
            if ctx.layer_idx in layers:
                captured[ctx.layer_idx] = dict(probs=ctx.attn_probs.clone(),
                                               hidden=ctx.hidden.clone(),
                                               values=values.clone(), wo=ctx.layer_params,
                                               state=out[4], spans=self)
            return out

    return Recording


def kz_target64(kt, torch, cfg, rec):
    """A layer's KVzip+ log-targets (n, H_kv) recomputed in float64 from what
    the collector read."""
    from kvpress_tpu_torch.models.llama import dequant_weight

    sp = rec["spans"]
    prompt = slice(sp.start_prompt, sp.end_prompt)
    rep = slice(sp.start_rep, sp.end_rep)
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = Hq // Hkv
    probs = rec["probs"][0][:, rep, prompt].double()                      # (Hq, r, n)
    h = rec["hidden"][0].double()
    scores = probs / torch.linalg.vector_norm(h[rep], dim=-1)[None, :, None]
    wo = dequant_weight(rec["wo"], "wo", torch.float64).reshape(Hq, D, -1)
    v = rec["values"][0].double()[:, prompt].repeat_interleave(G, dim=0)  # (Hq, n, D)
    wov = torch.linalg.vector_norm(torch.einsum("hnd,hde->hne", v, wo), dim=-1)
    y = (scores * wov[:, None, :]).amax(dim=1).reshape(Hkv, G, -1).amax(dim=1)
    return torch.log(y).T


def kz_collect(kt, torch, tokenizer_cls, params, report):
    """(b) ``collect_scores`` at the flagship's full width (bf16 weights):
    KZ_DOCS repeat prompts of synthetic documents, KZ_TOKENS tokens of each.
    Document 0's layers 0 and L - 1 are held against their float64
    recomputation (KZ_Y_LIMIT) and X against the captured hidden states.
    Returns (X (N, L, E), y (N, L, H_kv))."""
    import numpy as np

    from kvpress_tpu_torch.training import kvzap as kz

    cfg = flagship_config(16)
    dev = params.device
    L = cfg.num_layers
    runner = kt.Runner.create(cfg, device=dev)
    tok = chat_stub(tokenizer_cls, cfg.vocab_size)
    docs = kz_documents(KZ_DOCS, KZ_WORDS)
    Xs, ys, ms, peaks, lens = [], [], [], [], []
    captured = {}
    plain = kz.KVzipScoreCollector
    for i, doc in enumerate(docs):
        ids, *spans = kt.training.repeat_prompt_tokenization(tok, doc)
        rng = np.random.default_rng(i)
        sel = np.random.default_rng(i).permutation(spans[1] - spans[0])[:KZ_TOKENS]
        if i == 0:
            kz.KVzipScoreCollector = recording_collector(kt, captured, (0, L - 1))
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            X, y = kt.training.collect_scores(runner, params, ids, tuple(spans), rng=rng,
                                              n_tokens=KZ_TOKENS)
            torch.cuda.synchronize()
        finally:
            kz.KVzipScoreCollector = plain
        ms.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated() - held)
        lens.append(len(ids))
        if i == 0:
            worst = 0.0
            for l, rec in captured.items():
                want = kz_target64(kt, torch, cfg, rec)[sel]
                err = (y[l].double() - want).abs().max().item()
                worst = max(worst, err)
                if not err <= KZ_Y_LIMIT:
                    raise AssertionError(f"KZ collector: layer {l}'s targets are {err:.3e} off "
                                         f"their float64 recomputation (limit {KZ_Y_LIMIT})")
                hidden = rec["hidden"][0, spans[0]:spans[1]].float()[sel]
                if not torch.equal(X[l], hidden):
                    raise AssertionError(f"KZ collector: layer {l}'s X is not the layer's "
                                         "hidden states")
            report(f"  KZ collector, document 0 ({len(ids)} tokens, spans {spans}): layers "
                   f"{sorted(captured)} within {worst:.3e} of their float64 recomputation "
                   f"(limit {KZ_Y_LIMIT}); X the captured hidden states, bit for bit")
            del captured
        Xs.append(X.transpose(0, 1))
        ys.append(y.transpose(0, 1))
    X, y = torch.cat(Xs), torch.cat(ys)
    if not (torch.isfinite(X).all() and torch.isfinite(y).all()):
        raise AssertionError("KZ collector: non-finite targets")
    report(f"  KZ collector: {KZ_DOCS} documents of {KZ_WORDS} words (repeat prompts of "
           f"{min(lens)}-{max(lens)} tokens), {KZ_TOKENS} tokens each: X {tuple(X.shape)}, y "
           f"{tuple(y.shape)} (y from {y.min().item():.3f} to {y.max().item():.3f}, median "
           f"{y.median().item():.3f}); {statistics.median(ms):.1f} ms a document (median; "
           f"{min(ms):.1f}-{max(ms):.1f}, the first {ms[0]:.1f}), peak "
           f"{max(peaks) / 2**30:.3f} GiB over what was held")
    return X, y


def kz_train(kt, torch, X, y, report):
    """(c) ``train_linear`` and ``train_mlp`` (its defaults) on the collected
    tensors: the last epoch's validation loss below the first, the linear
    fit's R^2 on the training set above 0. Returns (linear, mlp)."""
    t0 = time.perf_counter()
    linear = kt.training.train_linear(X, y)
    torch.cuda.synchronize()
    lin_s = time.perf_counter() - t0
    pred = torch.einsum("nle,leh->nlh", X, linear["w"]) + linear["b"]
    r2 = 1 - (((pred - y) ** 2).sum() / ((y - y.mean(0)) ** 2).sum()).item()
    t0 = time.perf_counter()
    mlp, metrics = kt.training.train_mlp(X, y)
    torch.cuda.synchronize()
    mlp_s = time.perf_counter() - t0
    hist = metrics["history"]
    report(f"  KZ train_linear: {lin_s:.2f} s, R^2 on the training set {r2:.4f}; train_mlp "
           f"(hidden 512, {len(hist)} epochs, batch 512, lr 1e-3): {mlp_s:.2f} s, validation "
           f"loss {[round(h['val_loss'], 4) for h in hist]}, training loss first / last "
           f"{hist[0]['train_loss']:.4f} / {hist[-1]['train_loss']:.4f}")
    if not r2 > 0:
        raise AssertionError(f"KZ train_linear: R^2 {r2:.4f} on the training set")
    if not hist[-1]["val_loss"] < hist[0]["val_loss"]:
        raise AssertionError(f"KZ train_mlp: validation loss {hist[0]['val_loss']:.4f} -> "
                             f"{hist[-1]['val_loss']:.4f}")
    return linear, mlp


def kz_serve(kt, torch, tokenizer_cls, params, params8, mlp, threshold, report):
    """(d) The trained MLP surrogate through ``KVPressPipeline`` over a
    KZ_CONTEXT-word document of the training documents' kind: KVzap(0.5),
    DMS(KVzap) mask only, DMS(KVzap) decoding; the surrogate and the int8
    params through their savers and loaders; a decode step under
    ``utils.profile_trace``. Returns the launch counts."""
    import shutil
    import tempfile

    from kvpress_tpu_torch import utils

    cfg = flagship_config(16)
    L, dev = cfg.num_layers, params.device
    runner = kt.Runner.create(cfg, device=dev)
    tok = tokenizer_cls(vocab_size=cfg.vocab_size)
    totals = {name: 0 for name in read_counts()}
    # Two questions: the 152-token one and the prefill on flash, the 4-token
    # one and 15 steps an answer on decode; one question: 15 steps.
    two = {"flash_attention": 2 * L, "decode_attention": L * (1 + 2 * (KZ_NEW - 1))}
    one = {"flash_attention": 2 * L, "decode_attention": L * (KZ_NEW - 1)}
    half = KZ_CONTEXT // 2
    document = kz_documents(1, KZ_CONTEXT, seed=19)[0]
    runs = {}

    def run(label, p, press, questions, want, **kw):
        answers, counts, lengths, masked = kz_pipeline(
            kt, torch, label, runner, p, tok, report, questions, press,
            ("flash_attention", "decode_attention"), context=document, **kw)
        check_counts(label, counts, want)
        for name, n in counts.items():
            totals[name] += n
        runs[label] = (answers, lengths, masked)
        return answers, lengths, masked

    kvzap = kt.KVzapPress(0.5, surrogate=mlp)
    answers, lengths, _ = run("KZ KVzap(0.5), the trained MLP", params, kvzap, QUESTIONS, two)
    if lengths != [half] * L:
        raise AssertionError(f"KZ KVzap: layer lengths {lengths}")
    _, lengths, masked = run("KZ DMS(KVzap) mask only, threshold the median target", params,
                             kt.DMSPress(kvzap, threshold=threshold), QUESTIONS, two)
    if lengths != [KZ_CONTEXT] * L or not 0 < masked < 1:
        raise AssertionError(f"KZ DMS: layer lengths {sorted(set(lengths))}, masked fraction "
                             f"{masked}")
    decoding = kt.DMSPress(kvzap, threshold=threshold, decoding=True)
    recorded = []

    class Recording(type(runner)):
        def forward(self, *args, **kw):
            out = super().forward(*args, **kw)
            if kw.get("phase") == "decode":
                recorded.append(masked_slots(torch, out[1]))
            return out

        def prefill(self, *args, **kw):
            out = super().prefill(*args, **kw)
            recorded.append(masked_slots(torch, out[1]))
            return out

    saved = runner
    runner = Recording(**{f.name: getattr(saved, f.name) for f in dataclasses.fields(saved)})
    _, _, masked0 = run("KZ DMS(KVzap, decoding=True)", params, decoding, QUESTIONS[:1], one)
    runner = saved
    # Each decode call pushes its tokens' scores into the rings: the ones that
    # leave below the threshold clear their slots' bits.
    if not (0 < masked0 < 1 and len(recorded) == KZ_NEW + 1 and recorded[-1] > recorded[0]):
        raise AssertionError(f"KZ DMS decoding: masked fraction {masked0} after the prefill; "
                             f"masked slots {recorded}")
    report(f"  KZ DMS decoding: {recorded[0]} masked slots after the prefill (a fraction of "
           f"{masked0:.4f}), {recorded[1]} after the question, {recorded[-1]} after "
           f"{len(recorded) - 2} decode steps")

    # Round trips: the surrogate through its .npz, the int8 params through
    # save_params / load_params.
    d = ROOT / "build" / "kz"
    d.mkdir(parents=True, exist_ok=True)
    kt.save_kvzap_model(str(d / "mlp.npz"), mlp)
    again, _, _ = run("KZ KVzap(0.5), the surrogate read back", params,
                      kt.KVzapPress(0.5, surrogate=kt.load_kvzap_model(str(d / "mlp.npz"))),
                      QUESTIONS, two)
    if again != answers:
        raise AssertionError("KZ: the surrogate read back answers otherwise")
    knorm = kt.KnormPress(0.5)
    before, _, _ = run("KZ Knorm(0.5), int8 params", params8, knorm, QUESTIONS, two)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    utils.save_params(str(d / "params8.pt"), params8)
    save_s = time.perf_counter() - t0
    size = (d / "params8.pt").stat().st_size
    t0 = time.perf_counter()
    back = utils.load_params(str(d / "params8.pt"), device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    (d / "params8.pt").unlink()
    a = dict(params8.named_parameters())
    b = dict(back.named_parameters())
    if a.keys() != b.keys() or not all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
                                       for k in a):
        raise AssertionError("KZ: the int8 params read back are not bit-equal")
    after, _, _ = run("KZ Knorm(0.5), int8 params read back", back, knorm, QUESTIONS, two)
    if after != before:
        raise AssertionError("KZ: the int8 params read back answer otherwise")
    report(f"  KZ save_params / load_params of the int8 flagship ({size / 2**30:.3f} GiB on "
           f"disk): save {save_s:.2f} s, load {load_s:.2f} s; every tensor bit-equal, the "
           "greedy answers identical")
    del back

    # A decode step under the profiler.
    ids = torch.randint(3, cfg.vocab_size, (1, KZ_CONTEXT),
                        generator=torch.Generator(device=dev).manual_seed(9), device=dev)
    _, cache, _ = runner.prefill(params, ids, press=knorm)
    cache = kt.resize(cache, half + 2)
    reset_counts()
    with utils.profile_trace(tempfile.mkdtemp(dir=d)) as trace_dir:
        runner.forward(params, ids[:, -1:], cache, logits_last_only=True)
        torch.cuda.synchronize()
    counts = read_counts()
    for name, n in counts.items():
        totals[name] += n
    traces = list(Path(trace_dir).glob("*.pt.trace.json"))
    text = traces[0].read_text() if len(traces) == 1 else ""
    if "decode_kernel" not in text or counts["decode_attention"] != L:
        raise AssertionError(f"KZ profile_trace: {len(traces)} trace files; a decode_attention "
                             f"kernel named: {'decode_kernel' in text}")
    report(f"  KZ profile_trace around one decode step: {traces[0].name} "
           f"({len(text) / 2**20:.2f} MiB) names the decode_attention kernel "
           f"({text.count('decode_kernel')} mentions; {counts['decode_attention']} launches)")
    shutil.rmtree(trace_dir)
    return totals


def kz_mesh(kt, torch, params, path, threshold, report):
    """(e) DMS(KVzap) compact with the trained surrogate served under a mesh:
    KZ_TP_REQUESTS requests of KZ_TP_CONTEXT tokens through the world of one
    over NCCL (identical to the single-process engine) and the model 2 gloo
    world (each rank's heads, answers teacher-forced, the compacted
    lengths). Returns the world of one's launch counts."""
    from kvpress_tpu_torch.ops import _build

    _build.build()
    cfg = flagship_config(16)
    reqs = serving_requests(torch.Generator().manual_seed(18), cfg.vocab_size,
                            [KZ_TP_CONTEXT] * KZ_TP_REQUESTS, KZ_TP_NEW)
    spec = dict(path=str(path), threshold=threshold, compact=True)
    counts = tp_world_of_one(kt, torch, params, report, press=tp_press(kt, spec), reqs=reqs,
                             label="KZ DMS(KVzap) compact")
    tie = F32_RATIO * 2 * serving_noise(kt, torch, params, report)
    tp_gloo_world(kt, torch, params, report, tie, [("model2", spec, reqs)],
                  label="KZ DMS(KVzap) compact")
    return counts


def kvzap_run(kt, torch, tokenizer_cls, params, params8, report, parts=("a", "b", "c", "d",
                                                                         "e")):
    """Phase "KZ": (a) ``init_params_int8`` at the 8B shape, (b) the collector,
    (c) the trainers, (d) the trained surrogate through the pipeline with the
    savers and loaders and the profiler, (e) served under a mesh. Returns the
    launch counts of (a), (d) and (e)'s world of one."""
    totals = {name: 0 for name in read_counts()}

    def add(counts):
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n

    if "a" in parts:
        add(kz_init_8b(kt, torch, tokenizer_cls, params.device, report))
    if "b" not in parts:
        return totals
    X, y = kz_collect(kt, torch, tokenizer_cls, params, report)
    if "c" not in parts:
        return totals
    _, mlp = kz_train(kt, torch, X, y, report)
    threshold = float(y.median())
    del X, y
    torch.cuda.empty_cache()
    if "d" in parts:
        add(kz_serve(kt, torch, tokenizer_cls, params, params8, mlp, threshold, report))
    if "e" in parts:
        path = ROOT / "build" / "kz" / "mlp.npz"
        path.parent.mkdir(parents=True, exist_ok=True)
        kt.save_kvzap_model(str(path), mlp)
        add(kz_mesh(kt, torch, params, path, threshold, report))
    return totals


def kvzap_check(kt, torch, tokenizer_cls, params, report):
    """The collector mutant's check: (b) alone."""
    kvzap_run(kt, torch, tokenizer_cls, params, None, report, parts=("b",))


# The other bodies' pipeline runs use the first quarter of their layers
# (the 8B-class and Gemma-3-12B bodies) or the first half (Qwen3-8B,
# Phi-3-mini), for the whole script's time (inside 1,200 s on a slow run
# with the context-parallel phase); every layer does the same work at the
# same shapes, and each kind of layer is kept.
LONG_CONTEXT_RUN_LAYERS = 8
GEMMA3_12B_RUN_LAYERS = 12
QWEN3_RUN_LAYERS = 18
PHI3_RUN_LAYERS = 16


def long_context_run(kt, torch, tokenizer_cls, report):
    """The Llama-3.1-8B-class body at full width (seeded random weights,
    int4; ``LONG_CONTEXT_RUN_LAYERS`` of its 32 layers) through
    ``KVPressPipeline`` with int4 KV, Knorm(0.5) and a 131,072-token context
    in chunks of 8,192, two questions with 32 new tokens. At exactly 131,072 tokens the dense transient is 2^29 bytes, not
    over it, so the int4 chunks take the dense route (flash_attention).
    Prints the prefill's wall time and peak memory. Returns the launch counts."""
    cfg = llama31_8b_config(LONG_CONTEXT_RUN_LAYERS)
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
    # Where the prefill's time goes, on the body cut to 4 of its layers
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
    """The Qwen3-8B body at full width, its first ``QWEN3_RUN_LAYERS`` of 36
    layers (seeded random bf16 weights, q/k-norm spread), through
    ``KVPressPipeline`` with Knorm(0.5) and with ExpectedAttention(0.5), bf16
    KV, a 32,768-token context, the two questions and 32 new tokens; then its
    decode rate and idle share over the compressed cache, and the kernel
    path against the dense path at depth 1 and ``QWEN3_RUN_LAYERS``.
    Returns the launch counts."""
    cfg = qwen3_8b_config(QWEN3_RUN_LAYERS)
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

    # Where the prefill's time goes, on the body cut to 4 of its layers
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
              DECODE_PROFILE_ITERS, report, top=4)
    del cache, c
    torch.cuda.empty_cache()
    for depth in (1, cfg.num_layers):
        model_reference_check(kt, torch, f"Qwen3-8B, depth {depth}", qwen3_8b_config(depth),
                              first_layers(params, depth), report, layer0_equal=True)
    del params
    torch.cuda.empty_cache()
    return counts


# The Gemma-3-27B pipeline runs' depth: 18 of its 62 layers (15 sliding, 3
# global), for the whole script's time.
GEMMA3_27B_RUN_LAYERS = 18


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
    """The Gemma-3-12B body at full width (``GEMMA3_12B_RUN_LAYERS`` of its 48
    layers, seeded random bf16 weights, head_dim 256) with its SigLIP tower, through
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
    cfg, vcfg = gemma3_12b_config(GEMMA3_12B_RUN_LAYERS), gemma3_vision_config()
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
    """The Phi-3-mini-4k body at full width, its first ``PHI3_RUN_LAYERS`` of
    32 layers (seeded random bf16 weights, head_dim 96, one query head per kv
    head), through
    ``KVPressPipeline`` with a 3,840-token context, the two questions (152
    and 4 tokens) and 32 new tokens, within its 4,096 positions: (a) Knorm,
    bf16 KV; (b) Knorm, int8 KV (the 152-token question on
    flash_attention_quant); (c) Knorm, int4 KV and int4 weights; (d) Knorm,
    int8 KV, ``context_chunk=1024``; (e) AdaKV(Knorm, compact) on a runner
    with the head-wise decode. Every launch must be a head_dim-96 one, on the
    payload its options ask for, and the layer lengths right. Then the
    prefill's device breakdown, decode tok/s at B=1 with its idle share, and
    the kernel path against the dense path at depth 1 and ``PHI3_RUN_LAYERS``.
    Returns the launch counts of the runs."""
    cfg = phi3_mini_4k_config(PHI3_RUN_LAYERS)
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

    # Where the prefill's time goes (every layer of the run), then decode over the
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
              DECODE_PROFILE_ITERS, report, top=4)
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


# Timed decode loops of DECODE_STEPS steps, DECODE_REPS a pass and route in
# phase 4, and decode steps a profiler breakdown averages over (the other
# phases' 4): they keep the whole script inside its time with phases "KZ"
# and "TP".
DECODE_REPS = 2
DECODE_STEPS = 16
DECODE_PROFILE_ITERS = 4


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

    B, steps = DECODE_BATCH, DECODE_STEPS
    ids = torch.randint(3, cfg.vocab_size, (B, CONTEXT_TOKENS), generator=gen, device=dev)
    _, cache, _ = runner.prefill(params8, ids, press=press, quantized=True, kv_bits=4)
    cache = kt.resize(cache, CONTEXT_TOKENS // 2 + steps + 1)
    base_len, base_off = cache.length, cache.offset
    tok0 = ids[:, -1:]
    decode = {}
    for decode_kernel in (True, False, True, False):
        r = kt.Runner.create(cfg, decode_kernel=decode_kernel, device=dev)
        rates = []
        for _ in range(DECODE_REPS):
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
                          lambda: r.forward(params8, tok0, c, logits_last_only=True),
                          DECODE_PROFILE_ITERS, report)
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
                for _ in range(DECODE_REPS):
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
                      lambda: r.forward(params, tok0, c, logits_last_only=True),
                      DECODE_PROFILE_ITERS, report, top=4)
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
    # a context-parallel ring step's block behind the diagonal (seq 4, Sl 4,096)
    "flash_attention_ring": ("flash_attention", _CSRC + "flash.cu", "kvpress_tpu/ops/flash.py:154",
                             "bf16 B1 T4096 S4096 prior4096 ring block", "flash_attention_cp"),
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
    report("phase 3: the multi-pass presses at the flagship shape, 32K: KVzip (bf16, compact, "
           "int8 chunked, KVzip+ bf16 and int8), RestoreKV, FastKVzip (one-shot, chunked, "
           "compact), KVCompose (structured and unstructured chunked, int8, one-shot at "
           f"{MP_SMALL_CONTEXT})")
    t_phase = time.perf_counter()
    for name, n in multipass_presses_run(kt, torch, ToyTokenizer, params, report).items():
        launches[name] += n
    report(f"  the multi-pass phase took {time.perf_counter() - t_phase:.1f} s")
    report("phase 3: the continuous-batching ServingEngine at the flagship shape (16 layers, "
           f"{SV_SLOTS} slots): Knorm over bf16, int8 and int4 slots, PrefillDecodingPress, "
           "chunked interleaved admission with the context LRU, KVPressPipeline.batch(), 1 "
           "slot against 8, sampling")
    t_phase = time.perf_counter()
    for name, n in serving_run(kt, torch, ToyTokenizer, params, report).items():
        launches[name] += n
    report(f"  the serving phase took {time.perf_counter() - t_phase:.1f} s")
    report("phase 3: tensor-parallel serving at the flagship shape: a world of one over NCCL "
           "against the single-process engine (Knorm, then each press of items 18.1-18.11), then "
           "model 2 (Knorm, CriticalKV, KeyRerotation, Composed, Block) and data 2 worlds over "
           "gloo on the one card")
    t_phase = time.perf_counter()
    for name, n in tp_serving_run(kt, torch, ToyTokenizer, params, report).items():
        launches[name] += n
    report(f"  the tensor-parallel phase took {time.perf_counter() - t_phase:.1f} s")
    report("phase 3: context-parallel prefill and distributed decode at the flagship shape: a "
           f"world of one over NCCL at {CP_CONTEXT} tokens against the single-process path "
           "(bf16 and int8 shards), then a 4-rank world over gloo on the one card (seq 4 at "
           f"{4 * CP_BLOCK} tokens: bf16, int8, fused; model 2 x seq 2 at {2 * CP_BLOCK})")
    t_phase = time.perf_counter()
    for name, n in cp_run(kt, torch, ToyTokenizer, params, report).items():
        launches[name] = launches.get(name, 0) + n
    report(f"  the context-parallel phase took {time.perf_counter() - t_phase:.1f} s")
    report("phase 3: KVzap training and its surrogate served (KZ): init_params_int8 at the "
           "Llama-3.1-8B shape, the collector at the flagship's width, train_linear and "
           "train_mlp, the trained surrogate through the pipeline with its savers and loaders "
           "and the profiler, DMS(KVzap) compact under a mesh")
    t_phase = time.perf_counter()
    for name, n in kvzap_run(kt, torch, ToyTokenizer, params, params8, report).items():
        launches[name] = launches.get(name, 0) + n
    report(f"  the KVzap phase took {time.perf_counter() - t_phase:.1f} s")
    report("phase 3: chunked prefill's int4 routes at the flagship shape, 32K")
    for name, n in fused_int4_check(kt, torch, params, report).items():
        launches[name] += n
    report("phase 3: the 8B-class body at 131,072 tokens, chunked")
    for name, n in long_context_run(kt, torch, ToyTokenizer, report).items():
        launches[name] += n
    report(f"phase 3: the Qwen3-8B body at full width, {QWEN3_RUN_LAYERS} of 36 layers, 32K")
    for name, n in qwen3_run(kt, torch, ToyTokenizer, report).items():
        launches[name] += n
    report(f"phase 3: the Gemma-3-27B body (int4, {GEMMA3_27B_RUN_LAYERS} of 62 layers) with 4 "
           "images, 32K, one-shot and "
           "chunked")
    for name, n in gemma3_run(kt, torch, ToyTokenizer, report).items():
        launches[name] += n
    report(f"phase 3: the Gemma-3-12B body (bf16, {GEMMA3_12B_RUN_LAYERS} of 48 layers, head_dim "
           "256): 4 images one-shot and "
           "chunked, paths A and AdaKV(Observed), int8 KV, 32K")
    for name, n in gemma3_12b_run(kt, torch, ToyTokenizer, report).items():
        launches[name] += n
    report(f"phase 3: the Phi-3-mini-4k body (bf16, {PHI3_RUN_LAYERS} of 32 layers, head_dim 96, "
           "32/32 heads), "
           f"{PHI3_CONTEXT_TOKENS} tokens: Knorm with bf16, int8 and int4 KV, chunked by "
           f"{PHI3_CHUNK_TOKENS}, AdaKV(Knorm) compact")
    for name, n in phi3_run(kt, torch, ToyTokenizer, report).items():
        launches[name] += n
    reference_check(kt, torch, params, report)
    report(f"phase 3: chunked prefill (chunks of {REF_CHUNK}) against the dense path")
    reference_check(kt, torch, params, report, chunk=REF_CHUNK)
    report("phase 3: the decode-time presses against the dense path")
    decode_reference_check(kt, torch, params, report)
    report("phase 3: the multi-pass presses against the dense path")
    multipass_reference_check(kt, torch, ToyTokenizer, params, report)

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
