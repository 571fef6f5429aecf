#!/usr/bin/env python3
"""Drive the PyTorch port (kvpress_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card

1. Device line: ``nvidia-smi --query-gpu=name,power.limit``; every time
   printed after it was taken on that card.
2. Build the six Hopper kernels (csrc/*.cu, one nvcc per source, in
   parallel) and hold each against its plain PyTorch version on the card at
   the shapes the paths give it (GQA 32/8, head_dim 64), in bf16. Each check
   must reject a planted fault.
3. The paths at full width, through ``KVPressPipeline`` on the 1B-class
   flagship shape (16 layers, seeded random weights), a 32,768-token context
   and two questions (one longer than 128 tokens):
   - ``KnormPress(0.5)`` with a bf16 KV cache, then int8 KV, then int4 KV
     with int8 weights;
   - path A, ``ObservedAttentionPress(0.5)``: the flash prefill gives the row
     LSE and the column-sum kernel scores from it;
   - path B, ``AdaKVPress(ObservedAttentionPress(0.5), compact=True)`` on a
     runner with ``headwise_kernel=True, decode_kernel=False``: both
     column-sum passes in prefill, then decode over per-head prefixes.
   The launch counts are set to 0 before each run and read after it, and
   every kernel of a path must have been launched in it. A 2,048-token run
   of each kernel path is also held against the dense path on the same
   weights, stage by stage, at depth 1 and 16 (``reference_check``).
4. Timings: prefill at 32K under each press, and decode at batch 4 x 32K
   context, ratio 0.5 (Knorm: int4 KV + int8 weights, decode kernel on and
   off; path B: bf16 KV at batch 1 and 4, head-wise kernel against the dense
   route and the decode kernel over the same cache), on a synchronized host
   clock, medians, with profiler breakdowns (device busy time, idle share,
   largest kernels). Per kernel (phase 2): its device time from the
   profiler beside its bound, its plain version's time and, where one
   PyTorch call computes the same, ``scaled_dot_product_attention``'s
   (CUDA events).

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
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores
CONTEXT_TOKENS = 32768
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
# or more (PERF.md).
LSE_LIMIT = 1e-3
SUM_LIMIT = 2e-3


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

    def fault_mask(mask, B, S, lo):
        """The keep-mask with one decode-kernel step of keys (slots lo ..
        lo + 255, all visible to every query row) cleared: what a kernel
        that skipped that step would compute."""
        m = torch.ones((B, Hkv, S), dtype=torch.bool, device=dev) if mask is None else mask.clone()
        m[:, :, lo:lo + 256] = False
        return m

    def without_keys(q, k, lo, hi):
        """(q, k) with slots lo..hi-1 cut out of both: rows from hi on then
        see every earlier key but those."""
        return (torch.cat([q[:, :, :lo], q[:, :, hi:]], dim=2).contiguous(),
                torch.cat([k[:, :, :lo], k[:, :, hi:]], dim=2).contiguous())

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
               reading=compare):
        """Hold ``got`` against ``ref`` at the kernel's tolerance, and check
        that the tolerance rejects each of ``faults`` ({what was skipped: the
        plain version's result without it})."""
        err, row = reading(got, ref)
        fault_rows = {what: reading(f, ref)[1] for what, f in faults.items()}
        b, by = bound_ms(nb, flops)
        results.setdefault(name, {})[variant] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib)
        report(f"  {name}[{variant}]: max_abs_err {err:.3e}, worst row {row:.3e} (limit {limit}; "
               + "; ".join(f"{what}: {x:.3e}" for what, x in fault_rows.items())
               + f"), kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms ({by}), "
               + ("no library call" if lib is None else f"sdpa {lib:.4f} ms"))
        if not row <= limit:
            failures.append(f"{name}[{variant}] disagrees with its plain version: "
                            f"worst row {row:.3e} > {limit}")
        failures.extend(f"{name}[{variant}]: the limit passes {what} ({x:.3e} <= {limit})"
                        for what, x in fault_rows.items() if not x > limit)

    # flash_attention: prefill-shaped, B=1, T=S=8192, random keep-mask.
    B, T = 1, 8192
    q, k, v = rnd(B, Hq, T, D), rnd(B, Hkv, T, D), rnd(B, Hkv, T, D)
    mask = keep_mask(B, T)
    got = fl.flash_attention(q, k, v, 0, mask, sm_scale=scale)
    torch.cuda.synchronize()
    ref = fl.flash_attention_plain(q, k, v, 0, mask, sm_scale=scale)
    fault = fl.flash_attention_plain(q, k, v, 0, fault_mask(mask, B, T, 512), sm_scale=scale)
    torch.cuda.synchronize()
    ms = kernel_ms(lambda: fl.flash_attention(q, k, v, 0, mask, sm_scale=scale),
                   "flash_fwd_kernel", 10)
    plain = cuda_ms(lambda: fl.flash_attention_plain(q, k, v, 0, mask, sm_scale=scale), 3, 1)
    lib = sdpa_ms(q, k, v, allowed_mask(mask, B, 0, T, T), 5)
    flops = 4 * D * G * visible_pairs(mask, 0, T)
    record("flash_attention", "bf16 B1 T8192 S8192 masked", got, ref,
           {"one skipped key step": fault}, ms, plain, nbytes(q, k, v, mask, got), flops, lib)
    del q, k, v, got, ref, fault
    torch.cuda.empty_cache()

    # flash_attention_quant: question forward over a compressed cache.
    T, prior = 256, 16384
    S = prior + T
    q = rnd(B, Hq, T, D)
    kd, vd = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    mask = keep_mask(B, S)
    for bits in (8, 4):
        kq, ks = quantize_kv(kd, bits)
        vq, vs = quantize_kv(vd, bits)
        call = lambda: fl.flash_attention_quant(q, kq, vq, ks, vs, prior, mask, bits=bits,
                                                sm_scale=scale)
        got = call()
        torch.cuda.synchronize()
        ref = fl.flash_attention_quant_plain(q, kq, vq, ks, vs, prior, mask, bits=bits,
                                             sm_scale=scale)
        fault = fl.flash_attention_quant_plain(q, kq, vq, ks, vs, prior,
                                               fault_mask(mask, B, S, 8192), bits=bits,
                                               sm_scale=scale)
        ms = kernel_ms(call, "flash_fwd_kernel", 20)
        plain = cuda_ms(lambda: fl.flash_attention_quant_plain(
            q, kq, vq, ks, vs, prior, mask, bits=bits, sm_scale=scale), 3, 1)
        lib = sdpa_ms(q, dequantize_kv(kq, ks, bits, torch.bfloat16),
                      dequantize_kv(vq, vs, bits, torch.bfloat16),
                      allowed_mask(mask, B, prior, T, S), 5)
        flops = 4 * D * G * visible_pairs(mask, prior, T)
        record("flash_attention_quant", f"int{bits} B1 T{T} prior{prior}", got, ref,
               {"one skipped key step": fault}, ms, plain,
               nbytes(q, kq, vq, ks, vs, mask, got), flops, lib)

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
            if bits is None:
                kk, vv, ks, vs = kd, vd, None, None
            else:
                (kk, ks), (vv, vs) = quantize_kv(kd, bits), quantize_kv(vd, bits)
            call = lambda: dec.decode_attention(q, kk, vv, length, ks, vs, mask, bits=bits,
                                                sm_scale=scale)
            got = call()
            torch.cuda.synchronize()
            ref = dec.decode_attention_plain(q, kk, vv, length, ks, vs, mask, bits=bits,
                                             sm_scale=scale)
            fault = dec.decode_attention_plain(q, kk, vv, length, ks, vs,
                                               fault_mask(mask, B, S, 8192), bits=bits,
                                               sm_scale=scale)
            ms = kernel_ms(call, "decode_kernel", 50)
            wrapper = cuda_ms(call, 50, 5)
            plain = cuda_ms(lambda: dec.decode_attention_plain(
                q, kk, vv, length, ks, vs, mask, bits=bits, sm_scale=scale), 10)
            kdq = kk if bits is None else dequantize_kv(kk, ks, bits, torch.bfloat16)
            vdq = vv if bits is None else dequantize_kv(vv, vs, bits, torch.bfloat16)
            lib = sdpa_ms(q, kdq, vdq, allowed_mask(mask, B, length - T, T, S, length), 20)
            full = torch.ones((B, Hkv, S), dtype=torch.bool, device=dev) if mask is None else mask
            pairs = visible_pairs(full, length - T, T, length)
            row = kk.shape[-1] * kk.element_size() + (0 if ks is None else 4)
            need = q.numel() * 2 * 2 + 2 * row * pairs // T
            if mask is not None:
                need += mask.numel()
            name = "bf16" if bits is None else f"int{bits}"
            variant = f"{name} B{B} 16K {'masked' if masked else 'unmasked'}"
            record("decode_attention", variant, got, ref, {"one skipped key step": fault},
                   ms, plain, need, 4 * D * G * pairs, lib)
            report(f"    with the wrapper's live-tile table and mask padding: {wrapper:.4f} ms")
    del q, kd, vd, kk, vv, got, ref, fault
    torch.cuda.empty_cache()

    # observed_lse / observed_colsums_flash: a prefill's queries against its
    # own keys, B=1, whole and ragged tiles, with and without softcap. The
    # column sums are taken with the kernel's own LSE pass and with the
    # flash prefill kernel's LSE.
    B = 1
    for S in (8192, 8000):
        q, k, v = rnd(B, Hq, S, D), rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
        pairs = B * Hq * S * (S + 1) // 2            # visible (query head, key) pairs
        for softcap in (None, 30.0):
            kw = dict(sm_scale=scale, softcap=softcap)
            variant = f"B{B} S{S}" + ("" if softcap is None else f" softcap {softcap:g}")
            lse = oc.observed_lse(q, k, **kw)
            torch.cuda.synchronize()
            lse_ref = oc.observed_lse_plain(q, k, **kw)
            # Fault: keys 512..575 skipped (the rows below them, computed
            # without them).
            skipped = oc.observed_lse_plain(*without_keys(q, k, 512, 576), **kw)
            lse_fault = lse_ref.clone()
            lse_fault[:, :, 576:] = skipped[:, :, 512:]
            ms = kernel_ms(lambda: oc.observed_lse(q, k, **kw), "observed_lse_kernel", 5)
            plain = cuda_ms(lambda: oc.observed_lse_plain(q, k, **kw), 3, 1)
            record("observed_lse", variant, lse, lse_ref, {"one skipped key tile": lse_fault},
                   ms, plain, nbytes(q, k, lse), 2 * D * pairs, None, LSE_LIMIT, compare_lse)

            _, flash_lse = fl.flash_attention(q, k, v, 0, sm_scale=scale, softcap=softcap,
                                              return_lse=True)
            ms = kernel_ms(lambda: oc.observed_colsums_flash(q, k, flash_lse, **kw),
                           "observed_colsum_kernel", 5)
            plain = cuda_ms(lambda: oc.observed_colsums_plain(q, k, lse_ref, **kw), 3, 1)
            for source, given in (("own lse", None), ("flash lse", flash_lse)):
                got = oc.observed_colsums_flash(q, k, given, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, oc.observed_colsums_flash(q, k, given, **kw)):
                    failures.append(f"observed_colsum[{source}, {variant}]: two launches differ")
                rows = lse_ref if given is None else given
                ref = oc.observed_colsums_plain(q, k, rows, **kw)
                # Fault: one tile of 64 query rows near the end skipped (rows
                # whose LSE is -inf add nothing).
                holed = rows.clone()
                holed[:, :, S - 128:S - 64] = float("-inf")
                fault = oc.observed_colsums_plain(q, k, holed, **kw)
                record("observed_colsum", f"{source}, {variant}", got, ref,
                       {"one skipped query tile": fault}, ms, plain, nbytes(q, k, rows, got),
                       2 * D * pairs, None, SUM_LIMIT, compare_sums)
        del q, k, v
        torch.cuda.empty_cache()

    # decode_attention_headwise: B=4, 16K slots, ragged prefixes (one head
    # empty, the longest running into the tail as after a compaction), a tail
    # of 33 appended tokens; T=1 as the runner routes it, and T=4.
    B, S, tail = DECODE_BATCH, 16384 + 64, 33
    prefix = torch.randint(2048, 16384, (B, Hkv), generator=gen, device=dev)
    prefix[0, 0], prefix[1, 1] = 0, 16384
    tail_start = int(prefix.max())
    length = tail_start + tail
    col = torch.arange(S, device=dev)
    mask = col < prefix[..., None]
    mask[:, :, tail_start:length] = True
    mask[:, :, length:] = torch.rand((B, Hkv, S - length), generator=gen, device=dev) < 0.5
    k, v = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    live = int((mask & (col < length)).sum())               # K/V rows the heads read
    for T in (1, 4):
        q = rnd(B, Hq, T, D)
        call = lambda: hw.decode_attention_headwise(
            q, k, v, *hw.prefix_tail_from_mask(mask, length), sm_scale=scale)
        pfx, ts, tl = hw.prefix_tail_from_mask(mask, length)
        got = call()
        torch.cuda.synchronize()
        ref = hw.decode_attention_headwise_plain(q, k, v, pfx, ts, tl, sm_scale=scale)
        holed = mask.clone()
        holed[:, :, 1024:1280] = False
        faults = {"the tail skipped": hw.decode_attention_headwise_plain(
            q, k, v, pfx, ts, torch.zeros_like(tl), sm_scale=scale)}
        lib = None
        if T == 1:      # the mask says what the ranges say: the dense decode reads it
            faults["one skipped prefix step"] = dec.decode_attention_plain(
                q, k, v, length, mask=holed, sm_scale=scale)
            lib = sdpa_ms(q, k, v, allowed_mask(mask, B, length - T, T, S, length), 20)
        ms = kernel_ms(lambda: hw.decode_attention_headwise(q, k, v, pfx, ts, tl, sm_scale=scale),
                       "decode_headwise_kernel", 50)
        wrapper = cuda_ms(call, 50, 5)
        plain = cuda_ms(lambda: hw.decode_attention_headwise_plain(
            q, k, v, pfx, ts, tl, sm_scale=scale), 10)
        need = q.numel() * 2 * 2 + 2 * D * 2 * live + pfx.numel() * 4 + 8
        record("decode_headwise", f"bf16 B{B} T{T} 16K ragged", got, ref, faults, ms, plain,
               need, 4 * D * G * T * live, lib)
        report(f"    with prefix_tail_from_mask, from the mask: {wrapper:.4f} ms")
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


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def main_path(kt, torch, tokenizer_cls, report):
    """Every path once through the pipeline at 32K and full depth, the launch
    counts set to 0 before each run and read after it."""
    cfg = flagship_config(16)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = kt.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    params8 = kt.quantize_params_int8(params)
    tok = tokenizer_cls(vocab_size=cfg.vocab_size)
    context = " ".join(f"w{i}" for i in range(CONTEXT_TOKENS))
    long_q = "summarise " + " ".join(f"w{i}" for i in range(0, 300, 2))   # 151 words
    questions = [long_q + " ?", "what follows w7 ?"]
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
    }
    totals = {name: 0 for name in counters()}
    for label, (r, p, press, kw, needed, unwanted, (lo, hi)) in runs.items():
        pipe = kt.KVPressPipeline(r, p, tok)
        reset_counts()
        t0 = time.perf_counter()
        out = pipe(context, questions=questions, press=press, max_new_tokens=32, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        for name, n in counts.items():
            totals[name] += n
        answers = out["answers"]
        report(f"  {label}: {seconds:.2f} s, compressed length {lengths.compressed[-1]}, "
               f"launches {counts}, answer tokens {[len(a.split()) for a in answers]}")
        if not lo <= lengths.compressed[-1] <= hi:
            raise AssertionError(f"{label}: compressed length {lengths.compressed[-1]}")
        if len(answers) != 2 or not all(isinstance(a, str) and a for a in answers):
            raise AssertionError(f"{label}: bad answers {answers!r}")
        for name in needed:
            if counts[name] == 0:
                raise AssertionError(f"{label}: {name} was never launched")
        for name in unwanted:
            if counts[name] != 0:
                raise AssertionError(f"{label}: {name} was launched {counts[name]} times")
        if label.startswith("path") and counts["observed_colsum"] != cfg.num_layers:
            raise AssertionError(f"{label}: {counts['observed_colsum']} column-sum launches "
                                 f"for {cfg.num_layers} layers")
    return params, params8, totals


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

    all_kv = ((False, 8), (True, 8), (True, 4))
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


REF_CONTEXT, REF_QUESTION, REF_STEPS = 2048, 150, 4
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
LAYER0_SLOTS = {"Knorm": 0, "path A": 2, "path B": 2}


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
            mask = bound.arguments[mask_arg].clone()
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


def reference_check(kt, torch, params, report):
    """Each kernel path (attn_impl "flash"; the decode kernel, or for path B
    the head-wise kernel) against the dense path (attn_impl "xla", the routes
    the runner takes on the CPU, scoring from materialized probabilities or
    the plain chunked sweep) on the same full-width weights, cut to their
    first layer and whole, with a 2,048-token context at ratio 0.5: Knorm for
    bf16, int8 and int4 KV, paths A and B for bf16 KV. Each stage starts both
    paths from one state, so no difference carries from one stage into the
    next:
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
    paths = reference_paths(kt, torch)

    def rel(a, b):
        if not torch.isfinite(a).all():
            raise AssertionError("non-finite logits on the kernel path")
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    def differing(a_log, b_log):
        return [int((a != b).sum()) // 2 for a, b in zip(a_log, b_log)]

    def head_counts(a_log, b_log):
        """Largest difference of a head's kept count, per layer."""
        return [int((a.sum(-1) - b.sum(-1)).abs().max()) for a, b in zip(a_log, b_log)]

    # bf16 rounding alone: dense bf16 against dense float32, full depth.
    p32 = copy.deepcopy(params).float()
    dense = kt.Runner.create(flagship_config(), attn_impl="xla", decode_kernel=False,
                             device=dev)
    noise_kept = {}
    for path, (_, _, dense_press, _) in paths.items():
        kept_32, kept_16 = [], []
        pre_32, _, _ = dense.prefill(p32, ids, press=dense_press(kept_32),
                                     max_size=REF_CONTEXT, compute_logits=True)
        pre_16, _, _ = dense.prefill(params, ids, press=dense_press(kept_16),
                                     max_size=REF_CONTEXT, compute_logits=True)
        noise_logits = rel(pre_16, pre_32)         # the press does not move them
        noise_kept[path] = differing(kept_16, kept_32)
        report(f"  {path}, depth 16, bf16 KV prefill, dense bf16 against dense float32: "
               f"logits {noise_logits:.3e}; kept slots differing per layer {noise_kept[path]}")
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
            for quantized, bits in variants:
                label = f"{path}, depth {depth}, {f'int{bits}' if quantized else 'bf16'} KV"
                kw = dict(max_size=REF_CONTEXT, compute_logits=True, quantized=quantized,
                          kv_bits=bits)
                kept = {"kernel": [], "dense": [], "fault": []}
                pre_k, cache, _ = kernel.prefill(p, ids, press=kernel_press(kept["kernel"]), **kw)
                pre_d, _, _ = dense.prefill(p, ids, press=dense_press(kept["dense"]), **kw)
                shared = kt.resize(cache, int(cache.length.max()) + REF_QUESTION + REF_STEPS)
                ref_cache = (dequantized_cache(kt, shared, torch.bfloat16)
                             if quantized and bits == 4 else shared)
                q_k, after_q, _ = kernel.forward(p, question, clone_cache(shared))
                q_d, _, _ = dense.forward(p, question, clone_cache(ref_cache))
                d_k = steps(kernel, clone_cache(after_q))
                d_d = steps(dense, clone_cache(after_q))
                with planted_faults(torch):
                    pre_f, _, _ = kernel.prefill(p, ids, press=kernel_press(kept["fault"]), **kw)
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
                if not diff_f[0] > LAYER0_SLOTS[path] and path != "Knorm":
                    failures.append(f"{label}: layer 0's limit passes the planted faults "
                                    f"({diff_f[0]})")
                if depth == 16:
                    ratios = {"logits": read["prefill"] / noise_logits,
                              "kept slots": sum(diff) / max(sum(noise_kept[path]), 1)}
                    ratios_f = {"logits": fault["prefill"] / noise_logits,
                                "kept slots": sum(diff_f) / max(sum(noise_kept[path]), 1)}
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
        breakdown(f"decode step (decode_kernel={decode_kernel})",
                  lambda: r.forward(params8, tok0, c, logits_last_only=True), 8, report)

    # Paths A and B: the prefill under each press, then path B's decode over
    # per-head prefixes against the same cache decoded by the dense route
    # (attn_impl "xla") and by the decode kernel (live tiles of the keep-mask).
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
    share, and the kernels that take the most time."""
    wall, kernels = device_kernels(fn, iters)
    busy = sum(ms for ms, _ in kernels.values())
    launches = sum(n for _, n in kernels.values())
    report(f"  {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
           f"{1 - busy / wall:.3f}, {launches:.0f} kernel launches")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        report(f"    {ms:8.3f} ms  x{n:<5.0f} {name[:90]}")


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
    for log in sorted(_build.build_dir().glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                report(f"  {log.stem.split('-')[0]}: {line.strip()}")
    report(f"phase 2: kernels vs plain on {card}")
    checks = kernel_checks(kt, torch, report)

    report("phase 3: KVPressPipeline at the flagship shape, 32K: KnormPress(0.5), path A "
           "(ObservedAttentionPress), path B (AdaKVPress(ObservedAttentionPress), compact)")
    params, params8, launches = main_path(kt, torch, ToyTokenizer, report)
    reference_check(kt, torch, params, report)

    report(f"phase 4: timings on {card}")
    timings(kt, torch, params, params8, report)

    kernels = []
    for name, (src, replaces, variant) in SOURCES.items():
        row = checks[name][variant]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], **row})
    report(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
