#!/usr/bin/env python3
"""Drive the PyTorch port (kvpress_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card

1. Device line: ``nvidia-smi --query-gpu=name,power.limit``; every time
   printed after it was taken on that card.
2. Build the Hopper kernels (csrc/*.cu, one nvcc per source, in parallel)
   and hold each against its plain PyTorch version on the card at the
   main-path shapes (GQA 32/8, head_dim 64), in bf16.
3. The main path at full width: ``KVPressPipeline`` with ``KnormPress(0.5)``
   on the 1B-class flagship shape (16 layers, seeded random weights), a
   32,768-token context and two questions (one longer than 128 tokens), with
   a bf16 KV cache, then int8 KV, then int4 KV with int8 weights. Every
   kernel's launch count must move. A 2,048-token run of the kernel path is
   also held against the dense path on the same weights, stage by stage, at
   depth 1 and 16 (``reference_check``).
4. Timings: prefill at 32K, and decode at batch 4 x 32K context, ratio 0.5,
   int4 KV + int8 weights, with the decode kernel on and off (synchronized
   host clock, medians), each with a profiler breakdown (device busy time,
   idle share, largest kernels). Per kernel (phase 2): its device time from
   the profiler beside its bound, its plain version's time and the
   ``scaled_dot_product_attention`` yardstick's (CUDA events).

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
    from kvpress_tpu_torch.ops import flash as fl

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

    def compare(got, ref):
        """(max |got - ref|, the worst row's max |got - ref| / max |ref|)."""
        got, ref = got.float(), ref.float()
        if not torch.isfinite(got).all():
            raise AssertionError("non-finite kernel output")
        diff = (got - ref).abs()
        rows = diff.amax(-1) / ref.abs().amax(-1).clamp_min(1e-3)
        return diff.max().item(), rows.max().item()

    def record(name, variant, got, ref, fault, ms, plain, nb, flops, lib):
        """Hold ``got`` against ``ref`` at the kernel's tolerance, and check
        that the tolerance rejects ``fault`` (the plain version with one key
        step skipped)."""
        (err, row), (_, fault_row) = compare(got, ref), compare(fault, ref)
        limit = ROW_LIMIT
        b, by = bound_ms(nb, flops)
        results.setdefault(name, {})[variant] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib)
        report(f"  {name}[{variant}]: max_abs_err {err:.3e}, worst row {row:.3e} "
               f"(limit {limit}; one skipped key step: {fault_row:.3e}), "
               f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms ({by}), "
               f"sdpa {lib:.4f} ms")
        if not row <= limit:
            failures.append(f"{name}[{variant}] disagrees with its plain version: "
                            f"worst row {row:.3e} > {limit}")
        if not fault_row > limit:
            failures.append(f"{name}[{variant}]: the limit passes a skipped key step "
                            f"({fault_row:.3e} <= {limit})")

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
    record("flash_attention", "bf16 B1 T8192 S8192 masked", got, ref, fault, ms, plain,
           nbytes(q, k, v, mask, got), flops, lib)
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
        record("flash_attention_quant", f"int{bits} B1 T{T} prior{prior}", got, ref, fault,
               ms, plain, nbytes(q, kq, vq, ks, vs, mask, got), flops, lib)

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
            record("decode_attention", variant, got, ref, fault, ms, plain, need,
                   4 * D * G * pairs, lib)
            report(f"    with the wrapper's live-tile table and mask padding: {wrapper:.4f} ms")
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
    from kvpress_tpu_torch.ops.flash import flash_attention, flash_attention_quant

    return {"flash_attention": flash_attention, "flash_attention_quant": flash_attention_quant,
            "decode_attention": decode_attention}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def main_path(kt, torch, tokenizer_cls, report):
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
    runs = [("bf16 KV", params, {}),
            ("int8 KV", params, dict(quantized=True, kv_bits=8)),
            ("int4 KV + int8 weights", params8, dict(quantized=True, kv_bits=4))]
    totals = {name: 0 for name in counters()}
    per_run = {}
    for label, p, kw in runs:
        pipe = kt.KVPressPipeline(runner, p, tok)
        reset_counts()
        t0 = time.perf_counter()
        out = pipe(context, questions=questions, press=kt.KnormPress(0.5),
                   max_new_tokens=32, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        per_run[label] = counts
        for name, n in counts.items():
            totals[name] += n
        answers = out["answers"]
        report(f"  {label}: {seconds:.2f} s, compressed length {lengths.compressed[-1]}, "
               f"launches {counts}, answer tokens {[len(a.split()) for a in answers]}")
        if lengths.compressed[-1] != CONTEXT_TOKENS // 2:
            raise AssertionError(f"{label}: compressed length {lengths.compressed[-1]}")
        if len(answers) != 2 or not all(isinstance(a, str) and a for a in answers):
            raise AssertionError(f"{label}: bad answers {answers!r}")
    need = {"bf16 KV": ("flash_attention", "decode_attention"),
            "int8 KV": ("flash_attention", "flash_attention_quant", "decode_attention"),
            "int4 KV + int8 weights": ("flash_attention", "decode_attention")}
    for label, names in need.items():
        for name in names:
            if per_run[label][name] == 0:
                raise AssertionError(f"{label}: {name} was never launched")
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


def recording_knorm(kt, torch, log: list):
    """KnormPress(0.5) that appends, per layer, its kept slots as a
    (B, Hkv, S) bool mask (the same top-k as ``topk_keep``)."""
    class RecordingKnorm(kt.KnormPress):
        def score(self, ctx, keys, values):
            s = super().score(ctx, keys, values).to(torch.float32)
            idx = torch.topk(s, self.n_kept(s.shape[-1]), dim=-1).indices
            log.append(torch.zeros_like(s, dtype=torch.bool).scatter_(-1, idx, True))
            return s

    return RecordingKnorm(0.5)


REF_CONTEXT, REF_QUESTION, REF_STEPS = 2048, 150, 4
# Phase 3 limits on max |kernel - dense| / max |dense| per model depth. The
# logits come out of a bf16 product, so one ulp of the largest is 2^-8 to
# 2^-7 of it; depth 1 reads about one ulp (PERF.md).
REF_LIMIT = {1: 2.5e-2, 16: 1e-1}
# At full depth bf16 rounding alone moves the logits and the kept slots
# (dense bf16 against dense float32). The two bf16 paths may differ from each
# other by at most this many times as much.
F32_RATIO = 2.0


@contextlib.contextmanager
def skipped_key_step():
    """A planted fault: every attention kernel wrapper the runner calls
    ignores slots 256-511 (their keep bits cleared), as a kernel that
    skipped that key step would compute."""
    from kvpress_tpu_torch.models import llama

    mask_args = {"flash_attention": "head_mask", "flash_attention_quant": "head_mask",
                 "decode_attention": "mask"}
    originals = {name: getattr(llama, name) for name in mask_args}

    def skipping(fn, mask_arg):
        sig = inspect.signature(fn)

        def wrapper(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            mask = bound.arguments[mask_arg].clone()
            mask[..., 256:512] = False
            bound.arguments[mask_arg] = mask
            return fn(*bound.args, **bound.kwargs)
        return wrapper

    for name, arg in mask_args.items():
        setattr(llama, name, skipping(originals[name], arg))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(llama, name, fn)


def reference_check(kt, torch, params, report):
    """The kernel path (attn_impl "flash", decode kernel on) against the dense
    path (attn_impl "xla", the routes the runner takes on the CPU) on the
    same full-width weights, cut to their first layer and whole, with a
    2,048-token context and KnormPress(0.5), for bf16, int8 and int4 KV.
    Each stage starts both paths from one state, so no difference carries
    from one stage into the next:
      prefill:  the last position's logits, and every layer's kept slots;
      question: all logits of a 150-token forward over the kernel path's
                compressed cache (flash; flash_quant for int8 KV);
      decode:   4 teacher-forced steps over the kernel path's cache after
                the question (decode kernel).
    Layer 0's kept slots must be equal (its keys do not depend on attention).
    At full depth, dense bf16 against dense float32 sets the scale of what
    bf16 rounding alone moves. The planted fault (``skipped_key_step``) must
    read above every limit it meets."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    vocab = flagship_config().vocab_size
    ids = torch.randperm(vocab, generator=gen, device=dev)[:REF_CONTEXT][None]
    question = torch.randperm(vocab, generator=gen, device=dev)[:REF_QUESTION][None]
    failures = []

    def rel(a, b):
        if not torch.isfinite(a).all():
            raise AssertionError("non-finite logits on the kernel path")
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    def differing(a_log, b_log):
        return [int((a != b).sum()) // 2 for a, b in zip(a_log, b_log)]

    # bf16 rounding alone: dense bf16 against dense float32, full depth.
    p32 = copy.deepcopy(params).float()
    dense = kt.Runner.create(flagship_config(), attn_impl="xla", decode_kernel=False,
                             device=dev)
    kept_32, kept_16 = [], []
    pre_32, _, _ = dense.prefill(p32, ids, press=recording_knorm(kt, torch, kept_32),
                                 max_size=REF_CONTEXT, compute_logits=True)
    pre_16, _, _ = dense.prefill(params, ids, press=recording_knorm(kt, torch, kept_16),
                                 max_size=REF_CONTEXT, compute_logits=True)
    noise_logits = rel(pre_16, pre_32)
    noise_kept = differing(kept_16, kept_32)
    report(f"  depth 16, bf16 KV prefill, dense bf16 against dense float32: logits "
           f"{noise_logits:.3e}; kept slots differing per layer {noise_kept}")
    del p32, dense
    torch.cuda.empty_cache()

    for depth in (1, 16):
        cfg = flagship_config(depth)
        p = first_layers(params, depth) if depth < len(params.layers) else params
        kernel = kt.Runner.create(cfg, device=dev)
        dense = kt.Runner.create(cfg, attn_impl="xla", decode_kernel=False, device=dev)
        limit = REF_LIMIT[depth]

        def steps(r, cache):
            out = []
            for i in range(REF_STEPS):
                logits, cache, _ = r.forward(p, question[:, i:i + 1], cache,
                                             logits_last_only=True)
                out.append(logits)
            return torch.cat(out, dim=1)

        for quantized, bits in ((False, 8), (True, 8), (True, 4)):
            label = f"depth {depth}, {f'int{bits}' if quantized else 'bf16'} KV"
            kw = dict(max_size=REF_CONTEXT, compute_logits=True, quantized=quantized,
                      kv_bits=bits)
            kept = {"kernel": [], "dense": [], "fault": []}
            press = {name: recording_knorm(kt, torch, log) for name, log in kept.items()}
            pre_k, cache, _ = kernel.prefill(p, ids, press=press["kernel"], **kw)
            pre_d, _, _ = dense.prefill(p, ids, press=press["dense"], **kw)
            shared = kt.resize(cache, REF_CONTEXT // 2 + REF_QUESTION + REF_STEPS)
            ref_cache = (dequantized_cache(kt, shared, torch.bfloat16)
                         if quantized and bits == 4 else shared)
            q_k, after_q, _ = kernel.forward(p, question, clone_cache(shared))
            q_d, _, _ = dense.forward(p, question, clone_cache(ref_cache))
            d_k = steps(kernel, clone_cache(after_q))
            d_d = steps(dense, clone_cache(after_q))
            with skipped_key_step():
                pre_f, _, _ = kernel.prefill(p, ids, press=press["fault"], **kw)
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
                   + f" (limit {limit}; planted fault: "
                   + ", ".join(f"{s} {x:.3e}" for s, x in fault.items())
                   + f"); kept slots differing per layer {diff} (planted fault: {diff_f})")
            failures += [f"{label}: {s} reads {x:.3e} > {limit}" for s, x in read.items()
                         if not x <= limit]
            failures += [f"{label}: the limit passes the planted fault at {s} ({x:.3e})"
                         for s, x in fault.items() if not x > limit]
            if diff[0]:
                failures.append(f"{label}: layer 0 keeps different slots ({diff[0]})")
            if depth == 16:
                ratios = {"logits": read["prefill"] / noise_logits,
                          "kept slots": sum(diff) / sum(noise_kept)}
                ratios_f = {"logits": fault["prefill"] / noise_logits,
                            "kept slots": sum(diff_f) / sum(noise_kept)}
                report("    prefill, kernel against dense over dense bf16 against float32: "
                       + ", ".join(f"{s} {x:.3f}" for s, x in ratios.items())
                       + f" (limit {F32_RATIO}; planted fault: "
                       + ", ".join(f"{s} {x:.3f}" for s, x in ratios_f.items()) + ")")
                failures += [f"{label}: {s} ratio {x:.3f} > {F32_RATIO}"
                             for s, x in ratios.items() if not x <= F32_RATIO]
                failures += [f"{label}: the ratio passes the planted fault at {s} ({x:.3f})"
                             for s, x in ratios_f.items() if not x > F32_RATIO]
        del kernel, dense
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
    return prefill_ms, {k: statistics.median(v) for k, v in decode.items()}


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

    report("phase 3: main path, KVPressPipeline + KnormPress(0.5), flagship shape, 32K")
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
