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
   cache at B=4); all are
   launched twice with equal bits. Each check must reject its planted
   faults (for the decode kernels: a skipped key run, one live step taken
   for dead, one key range or chunk dropped from the merge).
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
   Then ``Runner.prefill_chunked`` at 32K over int4 KV on its fused route
   (``flash_attention_quant`` at 4 bits) held against its dense route
   (``fused_int4_check``; also the peak memory of chunked and one-shot
   prefill), and a Llama-3.1-8B-class body (32 layers, random int4 weights)
   through the pipeline with int4 KV, Knorm and a 131,072-token context in
   chunks of 8,192 (``long_context_run``). Every prefill's wall time and
   peak memory are printed. The launch counts are set to 0 before each run
   and read after it, and every kernel of a path must have been launched in
   it. A 2,048-token run of each kernel path is also held against the dense
   path on the same weights, stage by stage, at depth 1 and 16
   (``reference_check``; chunked prefill in chunks of 512 too).
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
LONG_CONTEXT_TOKENS = 131072   # the 8B-class body's context
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
    ``symbol`` (from the profiler trace)."""
    _, kernels = device_kernels(fn, iters)
    found = [ms for name, (ms, _) in kernels.items() if symbol in name]
    if not found:
        raise AssertionError(f"no {symbol} kernel in the profiler trace: {sorted(kernels)}")
    return sum(found)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def visible_pairs(mask, prior: int, T: int, length: int | None = None) -> int:
    """Sum over (batch, kv head, query row) of the keys that row may attend:
    causal (slot <= prior + t), below ``length``, keep-bit set."""
    import torch

    S = mask.shape[-1]
    live = mask.clone()
    if length is not None:
        live[..., length:] = False
    cum = torch.cumsum(live.to(torch.int64), dim=-1)              # (B, Hkv, S)
    slots = (prior + torch.arange(T, device=mask.device)).clamp(max=S - 1)
    return int(cum[..., slots].sum())


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

    def keep_mask(B, S, p=0.2):
        m = torch.rand((B, Hkv, S), generator=gen, device=dev) > p
        m[:, :, :8] = True
        return m

    def sdpa_ms(q, k, v, allowed, iters):
        kr, vr = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
        return cuda_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=allowed,
                                                              scale=scale), iters)

    def allowed_mask(mask, B, prior, T, S, length=None):
        q_slot = prior + torch.arange(T, device=dev)[:, None]
        ok = torch.arange(S, device=dev)[None, :] <= q_slot
        if length is not None:
            ok &= torch.arange(S, device=dev)[None, :] < length
        if mask is None:
            mask = torch.ones((B, Hkv, S), dtype=torch.bool, device=dev)
        return ok[None, None] & mask.repeat_interleave(G, 1)[:, :, None, :]

    def fault_mask(mask, B, S, lo, n=256):
        """The keep-mask with the keys of slots lo .. lo + n - 1 (all visible
        to every query row) cleared: what a kernel that skipped them would
        compute."""
        m = torch.ones((B, Hkv, S), dtype=torch.bool, device=dev) if mask is None else mask.clone()
        m[:, :, lo:lo + n] = False
        return m

    def without_keys(q, k, lo, hi):
        """(q, k) with slots lo..hi-1 cut out of both: rows from hi on then
        see every earlier key but those."""
        return (torch.cat([q[:, :, :lo], q[:, :, hi:]], dim=2).contiguous(),
                torch.cat([k[:, :, :lo], k[:, :, hi:]], dim=2).contiguous())

    def above_diagonal(q, k, run, softcap, axis, lse=None):
        """What a kernel that drops the causal test inside each aligned run of
        ``run`` keys adds: for a row i, the keys j > i of its run. "rows": the
        log of their sum of exp(s_ij) per query row; "columns": their sum of
        exp(s_ij - lse_i) per key (rows whose LSE is -inf add nothing)."""
        B_, Hq_, S_, D_ = q.shape
        pad = -S_ % run
        qp, kp = (F.pad(t, (0, 0, 0, pad)).float() for t in (q, k))
        nb = (S_ + pad) // run
        qb = qp.reshape(B_, Hkv, Hq_ // Hkv, nb, run, D_)
        kb = kp.reshape(B_, Hkv, nb, run, D_)
        s_ = torch.einsum("bhgnid,bhnjd->bhgnij", qb, kb) * D_ ** -0.5
        if softcap is not None:
            s_ = torch.tanh(s_ / softcap) * softcap
        pos = torch.arange(S_ + pad, device=dev).reshape(nb, run)
        upper = (pos[:, None, :] > pos[:, :, None]) & (pos[:, None, :] < S_)   # (n, i, j): j > i
        if axis == "rows":
            s_ = s_.masked_fill(~upper, float("-inf"))
            return torch.logsumexp(s_, -1).reshape(B_, Hq_, S_ + pad)[..., :S_]
        l = F.pad(torch.where(torch.isinf(lse), float("inf"), lse), (0, pad), value=float("inf"))
        l = l.reshape(B_, Hkv, Hq_ // Hkv, nb, run, 1)
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

        # Fault: a 256-key step that every later row sees, skipped; read on the
        # rows right behind it, which it moves most.
        hole = prior // 2 if prior else min(512, T // 4)
        lo = max(0, hole + 256 - prior)
        hi = min(T, lo + 512)
        faults = {"one skipped key step": with_rows(lo, hi, plain_rows(
            plain, q, kv, prior, fault_mask(mask, B, S, hole), lo, hi, chunk, **kw)[0])}
        live = torch.ones((B, kv[0].shape[1], S), dtype=torch.bool, device=dev)
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
        ms = kernel_ms(call, "flash_sm90", iters)
        lib = None
        if lib_mask:
            kd, vd = kv[:2] if bits is None else (
                dequantize_kv(kv[0], kv[2], bits, torch.bfloat16),
                dequantize_kv(kv[1], kv[3], bits, torch.bfloat16))
            if lib_mask == "causal":    # all-live mask, no prior: the causal call is the same
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
                allowed = allowed_mask(mask, B, prior, T, S)
                lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, kr, vr, attn_mask=allowed, scale=kw["sm_scale"]), 5)
        flops = 4 * D_ * G_ * visible_pairs(live if mask is None else mask, prior, T)
        record(name, variant, got, ref, faults, ms, plain_ms, nbytes(q, *kv, mask, got), flops, lib)
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

    # flash_attention_quant: question forward over a compressed cache.
    T, prior = 256, 16384
    S = prior + T
    q = rnd(B, Hq, T, D)
    kd, vd = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    mask = keep_mask(B, S)
    for bits in (8, 4):
        flash_case("flash_attention_quant", f"int{bits} B1 T{T} prior{prior}", bits, q,
                   quantized(kd, vd, bits), prior, mask, chunk=T, iters=20)

    def decode_case(variant, q, kd, vd, length, mask, bits, iters=50):
        """One shape of decode_attention: launched twice (equal bits), against
        its plain version with its planted faults (a 256-key run skipped, one
        kernel step taken for dead, one key range dropped from the merge),
        timed beside its two bounds (the kept rows' bytes; the bytes of every
        slot of the live kernel steps) and the library call."""
        B_, _, T_, D_ = q.shape
        S_ = kd.shape[2]
        if bits is None:
            kk, vv, ks, vs = kd, vd, None, None
        else:
            (kk, ks), (vv, vs) = quantize_kv(kd, bits), quantize_kv(vd, bits)
        kw = dict(bits=bits, sm_scale=D_ ** -0.5)
        call = lambda: dec.decode_attention(q, kk, vv, length, ks, vs, mask, **kw)
        got = call()
        torch.cuda.synchronize()
        if not torch.equal(got, call()):
            failures.append(f"decode_attention[{variant}]: two launches differ")
        ref = dec.decode_attention_plain(q, kk, vv, length, ks, vs, mask, **kw)
        nk = dec.step_keys(D_, bits)
        splits = dec.decode_splits(B_, Hkv, G, T_, S_, D_, length, nk)
        lo, hi = dec.decode_key_ranges(length, T_, None, nk, splits)[1 if splits > 1 else 0]
        faults = {"one skipped key step": fault_mask(mask, B_, S_, 8192),
                  "one live step taken for dead": fault_mask(mask, B_, S_, 4096, nk),
                  "one key range dropped from the merge": fault_mask(mask, B_, S_, lo, hi - lo)}
        faults = {what: dec.decode_attention_plain(q, kk, vv, length, ks, vs, m, **kw)
                  for what, m in faults.items()}
        ms = kernel_ms(call, "decode_kernel", iters)
        wrapper = cuda_ms(call, iters, 5)
        plain = cuda_ms(lambda: dec.decode_attention_plain(q, kk, vv, length, ks, vs, mask, **kw),
                        10)
        kdq = kk if bits is None else dequantize_kv(kk, ks, bits, torch.bfloat16)
        vdq = vv if bits is None else dequantize_kv(vv, vs, bits, torch.bfloat16)
        lib = sdpa_ms(q, kdq, vdq, allowed_mask(mask, B_, length - T_, T_, S_, length), 20)
        full = torch.ones((B_, Hkv, S_), dtype=torch.bool, device=dev) if mask is None else mask
        pairs = visible_pairs(full, length - T_, T_, length)
        row = kk.shape[-1] * kk.element_size() + (0 if ks is None else 4)
        need = q.numel() * 2 * 2 + 2 * row * pairs // T_ + (0 if mask is None else mask.numel())
        live = full[..., :length].reshape(B_, Hkv, -1)
        pad = -length % nk
        steps = int(torch.nn.functional.pad(live, (0, pad)).reshape(B_, Hkv, -1, nk).any(-1).sum())
        walk = q.numel() * 2 * 2 + 2 * row * steps * nk + (0 if mask is None else mask.numel())
        walk_ms = bound_ms(walk, 4 * D_ * G * pairs)[0]
        record("decode_attention", variant, got, ref, faults, ms, plain, need, 4 * D_ * G * pairs,
               lib, wrapper_ms=wrapper, steps_bound_ms=walk_ms)
        report(f"    launched twice with equal bits; {splits} key ranges a kv head; bound over "
               f"the live {nk}-key steps ({steps} of {B_ * Hkv * -(-length // nk)}) "
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
    del q, kd, vd, mask
    torch.cuda.empty_cache()

    # observed_lse / observed_colsums_flash: a prefill's queries against its
    # own keys, B=1, whole and ragged tiles, with and without softcap, and the
    # 32K prefill itself. The column sums are taken with the kernel's own LSE
    # pass and with the flash prefill kernel's LSE.
    B = 1
    for S, softcaps, iters in ((8192, (None, 30.0), 5), (8000, (None, 30.0), 5),
                               (CONTEXT_TOKENS, (None,), 3)):
        q, k, v = rnd(B, Hq, S, D), rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
        pairs = B * Hq * S * (S + 1) // 2            # visible (query head, key) pairs
        kr, vr = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
        for softcap in softcaps:
            kw = dict(sm_scale=scale, softcap=softcap)
            variant = f"B{B} S{S}" + ("" if softcap is None else f" softcap {softcap:g}")
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
                          lse_ref, above_diagonal(q, k, fl.key_tile(D), softcap, "rows"))}
            ms = kernel_ms(lambda: oc.observed_lse(q, k, **kw), "observed_lse_kernel", iters)
            lib = None
            if softcap is None:
                # One PyTorch call gives the same row LSE: the library's causal
                # flash attention (its output besides), natural log.
                sdpa = lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                    q, kr, vr, 0.0, True, False, scale=scale)
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
                   2 * D * pairs, lib, LSE_LIMIT, compare_lse)
            del skipped, lse_fault, faults

            _, flash_lse = fl.flash_attention(q, k, v, 0, sm_scale=scale, softcap=softcap,
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
                record("observed_colsum", f"{source}, {variant}", got, ref, faults, ms, plain,
                       nbytes(q, k, rows, got), 2 * D * pairs, None, SUM_LIMIT, compare_sums)
                del got, ref, holed, faults
            del lse, lse_ref, flash_lse
        del q, k, v, kr, vr
        torch.cuda.empty_cache()

    def headwise_case(label, B, S, prefix, tail, Ts):
        """decode_attention_headwise over a cache compacted head by head
        (``prefix`` (B, Hkv) kept slots, the longest head running into a tail
        of ``tail`` appended tokens, stale bits past the end), at each T of
        ``Ts``: launched twice (equal bits), against its plain version with its
        planted faults (the tail skipped; at T=1, where the dense decode reads
        the same mask, one kernel step and one chunk of a head dropped),
        timed beside its two bounds and the library call."""
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
            q = rnd(B, Hq, T, D)
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
            lib = None
            if T == 1:      # the mask says what the ranges say: the dense decode reads it
                faults["one live step taken for dead"] = dec.decode_attention_plain(
                    q, k, v, length, mask=fault_mask(mask, B, S, 1024, nk), sm_scale=scale)
                faults["one chunk dropped from the merge"] = dec.decode_attention_plain(
                    q, k, v, length, mask=mask & (chunk != 1), sm_scale=scale)
                lib = sdpa_ms(q, k, v, allowed_mask(mask, B, length - T, T, S, length), 20)
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


def reset_counts():
    for fn in counters().values():
        fn.launches = 0
    counters()["flash_attention_quant"].launches_by_bits.update({8: 0, 4: 0})


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


QUESTIONS = ["summarise " + " ".join(f"w{i}" for i in range(0, 300, 2)) + " ?",   # 152 words
             "what follows w7 ?"]


def timed_runner(kt, torch, runner, log: list):
    """``runner`` with each prefill (one-shot or chunked) timed on a
    synchronized host clock and its peak device memory read: appends
    (seconds, peak bytes, bytes held before) to ``log``."""
    class Timed(kt.Runner):
        def _measure(self, call):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            log.append((time.perf_counter() - start, torch.cuda.max_memory_allocated(), held))
            return out

        def prefill(self, *args, **kw):
            return self._measure(lambda: super(Timed, self).prefill(*args, **kw))

        def prefill_chunked(self, *args, **kw):
            return self._measure(lambda: super(Timed, self).prefill_chunked(*args, **kw))

    return Timed(**{f.name: getattr(runner, f.name) for f in dataclasses.fields(runner)})


def prefill_reading(log) -> str:
    seconds, peak, held = log[-1]
    return (f"prefill {seconds * 1e3:.1f} ms, peak memory {peak / 2**30:.3f} GiB "
            f"({(peak - held) / 2**30:.3f} GiB over the {held / 2**30:.3f} GiB held before)")


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
    totals = {name: 0 for name in counters()}
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
               f"length {lengths.compressed[-1]}, launches {counts}, answer tokens "
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
    by_bits = dict(counters()["flash_attention_quant"].launches_by_bits)
    report(f"  chunked, Knorm, int4 KV, fused_kv=True: {seconds:.2f} s, lengths "
           f"{sorted(set(fused_cache.length.tolist()))}, launches {counts}, flash_attention_quant "
           f"by bits {by_bits}")
    check_run("fused int4 route", counts, ("flash_attention_quant",), ("flash_attention",))
    if by_bits != {8: 0, 4: counts["flash_attention_quant"]}:
        raise AssertionError(f"fused int4 route: flash_attention_quant launches by bits {by_bits}")
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
           f"{lengths.compressed[-1]}, launches {counts}, answer tokens "
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
    class Recording(base):
        def score(self, ctx, keys, values):
            s = super().score(ctx, keys, values).to(torch.float32)
            idx = torch.topk(s, self.n_kept(s.shape[-1]), dim=-1).indices
            log.append(torch.zeros_like(s, dtype=torch.bool).scatter_(-1, idx, True))
            return s

    return Recording(0.5)


def recording_adakv(kt, inner, log: list):
    """``AdaKVPress(inner, compact=True)`` that appends, per layer, the kept
    slots of every head (before they are compacted) as a (B, Hkv, S) mask."""
    from kvpress_tpu_torch.presses.wrappers import compact_headwise

    class Recording(kt.AdaKVPress):        # compact=False: compacted below
        def layer_compress(self, ctx, keys, values, length, mask, state=None):
            keys, values, length, keep, state = super().layer_compress(
                ctx, keys, values, length, mask, state)
            log.append(keep)
            return (*compact_headwise(keys, values, keep), state)

    return Recording(inner)


def reference_paths(kt, torch):
    """{path: (kernel runner options, press for the kernel path, press for the
    dense path, KV variants)}; a press is made by ``make(log)``."""
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
    return {
        "Knorm": ({}, lambda log: recording_scorer(torch, kt.KnormPress, log),
                  lambda log: recording_scorer(torch, kt.KnormPress, log), all_kv),
        # dense path: the probabilities the dense attention materializes
        "path A": ({}, lambda log: recording_scorer(torch, Chunked, log),
                   lambda log: recording_scorer(torch, kt.ObservedAttentionPress, log),
                   all_kv[:1]),
        "path B": (dict(decode_kernel=False, headwise_kernel=True),
                   lambda log: recording_adakv(kt, kt.ObservedAttentionPress(0.5), log),
                   lambda log: recording_adakv(kt, PlainSums(0.5), log), all_kv[:1]),
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
LAYER0_SLOTS = {"Knorm": 0, "path A": 2, "path B": 2, "Knorm, chunked": 0}


@contextlib.contextmanager
def planted_faults(torch):
    """Planted faults, all at once: every attention kernel wrapper the runner
    calls ignores slots 256-511 (their keep bits cleared), as a kernel that
    skipped that key step would compute; the column-sum kernel skips the
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
            mask[..., 256:512] = False
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


def reference_check(kt, torch, params, report, chunk=None):
    """Each kernel path (attn_impl "flash"; the decode kernel, or for path B
    the head-wise kernel) against the dense path (attn_impl "xla", the routes
    the runner takes on the CPU, scoring from materialized probabilities or
    the plain chunked sweep) on the same full-width weights, cut to their
    first layer and whole, with a 2,048-token context at ratio 0.5: Knorm for
    bf16, int8 and int4 KV, paths A and B for bf16 KV. With ``chunk``, the
    prefill is ``prefill_chunked`` in chunks of that many tokens instead:
    Knorm for bf16 and int8 KV and for int4 KV on both attention routes
    (``chunked_reference_paths``). Each stage starts both paths from one
    state, so no difference carries from one stage into the next:
      prefill:  the last position's logits, and every layer's kept slots
                (for path B per head, with the heads' kept counts);
      question: all logits of a 150-token forward over the kernel path's
                compressed cache (flash; flash_quant for int8 KV);
      decode:   4 teacher-forced steps over the kernel path's cache after
                the question (decode kernel; head-wise kernel for path B).
    Layer 0's kept slots must be equal (LAYER0_SLOTS). At full depth, dense
    bf16 against dense float32 sets the scale of what bf16 rounding alone
    moves. The planted faults must read above every limit they meet."""
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
            return r.prefill(p, ids, press=press, **kw)
        return r.prefill_chunked(p, ids, press=press, chunk_size=chunk, fused_kv=fused, **kw)

    def rel(a, b):
        if not torch.isfinite(a).all():
            raise AssertionError("non-finite logits on the kernel path")
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    def differing(a_log, b_log):
        return [int((a != b).sum()) // 2 for a, b in zip(a_log, b_log)]

    def head_counts(a_log, b_log):
        """Largest difference of a head's kept count, per layer."""
        return [int((a.sum(-1) - b.sum(-1)).abs().max()) for a, b in zip(a_log, b_log)]

    # bf16 rounding alone: dense bf16 against dense float32, full depth, with
    # bf16 KV. Chunked, for each KV variant: an int4 chunk attends a bf16
    # transient of its layer on one route and payload x scale on the other,
    # and the rounding of the model's K and V moves their int4 codes.
    p32 = copy.deepcopy(params).float()
    dense = kt.Runner.create(flagship_config(), attn_impl="xla", decode_kernel=False,
                             device=dev)
    noise = {}
    for path, (_, _, dense_press, variants) in paths.items():
        for variant in (variants if chunk else [None]):
            kw = {} if variant is None else dict(zip(("quantized", "bits", "fused"), variant))
            kept_32, kept_16 = [], []
            pre_32, _, _ = prefill(dense, p32, dense_press(kept_32), **kw)
            pre_16, _, _ = prefill(dense, params, dense_press(kept_16), **kw)
            # the press does not move the logits
            noise[path, variant] = (rel(pre_16, pre_32), differing(kept_16, kept_32))
            report(f"  {path}, depth 16, {variant or 'bf16 KV'} prefill, dense bf16 against "
                   f"dense float32: logits {noise[path, variant][0]:.3e}; kept slots differing "
                   f"per layer {noise[path, variant][1]}")
    del p32, dense
    torch.cuda.empty_cache()

    for depth in (1, 16):
        cfg = flagship_config(depth)
        p = first_layers(params, depth) if depth < len(params.layers) else params
        dense = kt.Runner.create(cfg, attn_impl="xla", decode_kernel=False, device=dev)
        limit = REF_LIMIT[depth]

        def steps(r, cache):
            out = []
            for i in range(REF_STEPS):
                logits, cache, _ = r.forward(p, question[:, i:i + 1], cache,
                                             logits_last_only=True)
                out.append(logits)
            return torch.cat(out, dim=1)

        for path, (options, kernel_press, dense_press, variants) in paths.items():
            kernel = kt.Runner.create(cfg, device=dev, **options)
            for quantized, bits, fused in variants:
                label = (f"{path}, depth {depth}, {f'int{bits}' if quantized else 'bf16'} KV"
                         + ("" if fused is None else f", fused_kv={fused}"))
                kw = dict(quantized=quantized, bits=bits, fused=fused)
                kept = {"kernel": [], "dense": [], "fault": []}
                pre_k, cache, _ = prefill(kernel, p, kernel_press(kept["kernel"]), **kw)
                pre_d, _, _ = prefill(dense, p, dense_press(kept["dense"]), **kw)
                shared = kt.resize(cache, int(cache.length.max()) + REF_QUESTION + REF_STEPS)
                ref_cache = (dequantized_cache(kt, shared, torch.bfloat16)
                             if quantized and bits == 4 else shared)
                q_k, after_q, _ = kernel.forward(p, question, clone_cache(shared))
                q_d, _, _ = dense.forward(p, question, clone_cache(ref_cache))
                d_k = steps(kernel, clone_cache(after_q))
                d_d = steps(dense, clone_cache(after_q))
                with planted_faults(torch):
                    pre_f, _, _ = prefill(kernel, p, kernel_press(kept["fault"]), **kw)
                    q_f, _, _ = kernel.forward(p, question, clone_cache(shared))
                    d_f = steps(kernel, clone_cache(after_q))
                read = {"prefill": rel(pre_k, pre_d), "question": rel(q_k, q_d),
                        "decode": rel(d_k, d_d)}
                fault = {"prefill": rel(pre_f, pre_d), "question": rel(q_f, q_d),
                         "decode": rel(d_f, d_d)}
                diff = differing(kept["kernel"], kept["dense"])
                diff_f = differing(kept["fault"], kept["dense"])
                report(f"  {label}: max |kernel - dense| / max |dense|: "
                       + ", ".join(f"{s} {x:.3e}" for s, x in read.items())
                       + f" (limit {limit}; planted faults: "
                       + ", ".join(f"{s} {x:.3e}" for s, x in fault.items())
                       + f"); kept slots differing per layer {diff} (planted faults: {diff_f})")
                if path == "path B":
                    report(f"    largest difference of a head's kept count per layer "
                           f"{head_counts(kept['kernel'], kept['dense'])} (planted faults: "
                           f"{head_counts(kept['fault'], kept['dense'])}); kept per head in "
                           f"layer 0: {kept['kernel'][0].sum(-1).flatten().tolist()}")
                failures += [f"{label}: {s} reads {x:.3e} > {limit}" for s, x in read.items()
                             if not x <= limit]
                failures += [f"{label}: the limit passes the planted faults at {s} ({x:.3e})"
                             for s, x in fault.items() if not x > limit]
                if diff[0] > LAYER0_SLOTS[path]:
                    failures.append(f"{label}: layer 0 keeps different slots ({diff[0]})")
                if not diff_f[0] > LAYER0_SLOTS[path] and not path.startswith("Knorm"):
                    failures.append(f"{label}: layer 0's limit passes the planted faults "
                                    f"({diff_f[0]})")
                if depth == 16:
                    noise_logits, noise_kept = noise[path, (quantized, bits, fused)
                                                     if chunk else None]
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
                                 for s, x in ratios_f.items() if not x > F32_RATIO]
            del kernel
        del dense
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


SOURCES = {
    "flash_attention": ("kvpress_tpu_torch/csrc/flash.cu", "kvpress_tpu/ops/flash.py:154",
                        "bf16 B1 T8192 S8192 masked"),
    "flash_attention_quant": ("kvpress_tpu_torch/csrc/flash_quant.cu",
                              "kvpress_tpu/ops/flash.py:435", "int8 B1 T256 prior16384"),
    "decode_attention": ("kvpress_tpu_torch/csrc/decode.cu", "kvpress_tpu/ops/decode.py:212",
                         "int4 B4 16K unmasked"),
    "observed_lse": ("kvpress_tpu_torch/csrc/observed_colsum.cu",
                     "kvpress_tpu/ops/observed_colsum.py:34", "B1 S8192"),
    "observed_colsum": ("kvpress_tpu_torch/csrc/observed_colsum.cu",
                        "kvpress_tpu/ops/observed_colsum.py:87", "flash lse, B1 S8192"),
    "decode_headwise": ("kvpress_tpu_torch/csrc/decode_headwise.cu",
                        "kvpress_tpu/ops/decode_headwise.py:236", "bf16 B4 T1 16K ragged"),
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
                report(f"  {name}: {line.strip()[:300]}")
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
    report("phase 3: chunked prefill's int4 routes at the flagship shape, 32K")
    for name, n in fused_int4_check(kt, torch, params, report).items():
        launches[name] += n
    report("phase 3: the 8B-class body at 131,072 tokens, chunked")
    for name, n in long_context_run(kt, torch, ToyTokenizer, report).items():
        launches[name] += n
    reference_check(kt, torch, params, report)
    report(f"phase 3: chunked prefill (chunks of {REF_CHUNK}) against the dense path")
    reference_check(kt, torch, params, report, chunk=REF_CHUNK)

    report(f"phase 4: timings on {card}")
    timings(kt, torch, params, params8, report)

    kernels = []
    for name, (src, replaces, variant) in SOURCES.items():
        row = checks[name][variant]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name],
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
