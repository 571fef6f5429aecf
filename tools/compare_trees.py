#!/usr/bin/env python3
"""Time two trees of this repository on one CUDA card, in turns.

    python3 tools/compare_trees.py PARENT_ROOT CHANGE_ROOT

A comparison of two versions of a kernel means something only inside one run
on one card: two runs may land on cards with other power limits. Each root is
a checkout (for the parent: ``git archive <commit> | tar -x -C <dir>``) that
holds ``chip_smoke.py`` and ``kvpress_tpu_torch``. The roots are measured in
the order parent, change, change, parent, each in a process of its own that
builds that tree's kernels, runs that tree's ``chip_smoke.kernel_checks`` (the
time of every kernel at the shapes of its ``kernels`` line, from the profiler,
beside its bound and the library call timed in the same process) and then
times the 32K prefill of the flagship shape under ``KnormPress(0.5)``,
``ObservedAttentionPress(0.5)`` (path A) and
``AdaKVPress(ObservedAttentionPress(0.5), compact=True)`` (path B): median of
three on a synchronized host clock, and the device time of the flash kernels
and of the column-sum kernels (``observed_lse_kernel``,
``observed_colsum_kernel``) in one such prefill from the profiler. Its
decode section, built on the public entry points alone (``Runner.create``,
``prefill``, ``forward``) so that any tree can run it, prefills 32K under
``KnormPress(0.5)`` at B=4 (int4 KV, int8 weights) and at B=1 (bf16 KV), and
under path B's press at B=4, and times 32 decode steps over each cache: wall
ms per step and tok/s (median of three passes, synchronized host clock),
and from the profiler the device busy ms per step, the decode kernels'
device ms per step (every kernel whose name holds ``decode_kernel`` or
``decode_headwise_kernel``: a split launch's merge included) and the idle
share. Each process prints one JSON line:
``{"tree": ..., "card": ..., "kernels": {...}, "wrapper_notes": {...},
"prefill": {...}, "decode": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "tests"))
    import torch

    import chip_smoke
    import kvpress_tpu_torch as kt
    from kvpress_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("compare_trees: no CUDA device")
    card = chip_smoke.device_line()
    _build.build()
    notes = []
    checks = chip_smoke.kernel_checks(kt, torch, notes.append)
    kernels = {}
    for name, variants in checks.items():
        for variant, row in variants.items():
            kernels[f"{name}[{variant}]"] = {
                k: row.get(k) for k in ("ms", "bound_ms", "steps_bound_ms", "wrapper_ms",
                                        "ranges_ms", "plain_ms", "library_ms")}

    cfg = chip_smoke.flagship_config(16)
    dev = torch.device("cuda")
    params = kt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    ids = torch.randint(3, cfg.vocab_size, (1, chip_smoke.CONTEXT_TOKENS), generator=gen,
                        device=dev)
    runner = kt.Runner.create(cfg, device=dev)
    headwise = kt.Runner.create(cfg, decode_kernel=False, headwise_kernel=True, device=dev)
    observed = kt.ObservedAttentionPress(0.5)
    prefill = {}
    for label, r, press in (("Knorm", runner, kt.KnormPress(0.5)),
                            ("path A", runner, observed),
                            ("path B", headwise, kt.AdaKVPress(observed, compact=True))):
        call = lambda: r.prefill(params, ids, press=press, compute_logits=True)
        call()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        _, by_name = chip_smoke.device_kernels(call, 1)
        flash = sum(ms for name, (ms, _) in by_name.items() if "flash_" in name)
        observed_ms = {re.search(r"observed_\w+", name).group(0): ms
                       for name, (ms, _) in by_name.items() if "observed_" in name}
        prefill[label] = {"wall_ms": statistics.median(times), "flash_kernel_ms": flash,
                          "observed_kernel_ms": observed_ms,
                          "device_busy_ms": sum(ms for ms, _ in by_name.values())}
    # The report lines that give a wrapper's time (CUDA events around the
    # wrapper), under the kernel line they follow: a tree whose checks keep
    # no wrapper time in their rows still prints it.
    wrappers, last = {}, None
    for line in notes:
        if line.lstrip().startswith(("decode_attention[", "decode_headwise[")):
            last = line.split(":")[0].strip()
        elif ("wrapper" in line or "prefix_tail_from_mask" in line) and last is not None:
            wrappers[last] = line.strip()
    return {"tree": str(root), "card": card, "kernels": kernels, "wrapper_notes": wrappers,
            "prefill": prefill, "decode": decode_steps(torch, kt, chip_smoke, cfg, params, gen)}


DECODE_STEPS = 32


def decode_steps(torch, kt, chip_smoke, cfg, params, gen) -> dict:
    """Per decode step over a 32K prefill's compressed cache, for each route:
    wall ms and tok/s (median of three passes of DECODE_STEPS steps), device
    busy ms, the decode kernels' device ms and the idle share (profiler, one
    pass)."""
    dev = torch.device("cuda")
    params8 = kt.quantize_params_int8(params)
    knorm = kt.KnormPress(0.5)
    adakv = kt.AdaKVPress(kt.ObservedAttentionPress(0.5), compact=True)
    runner = kt.Runner.create(cfg, device=dev)
    headwise = kt.Runner.create(cfg, decode_kernel=False, headwise_kernel=True, device=dev)
    routes = {"Knorm B4 int4 KV + int8 weights": (runner, params8, knorm, 4,
                                                  dict(quantized=True, kv_bits=4)),
              "Knorm B1 bf16 KV": (runner, params, knorm, 1, {}),
              "path B B4 bf16 KV": (headwise, params, adakv, 4, {})}
    out = {}
    for label, (r, p, press, B, kw) in routes.items():
        ids = torch.randint(3, cfg.vocab_size, (B, chip_smoke.CONTEXT_TOKENS), generator=gen,
                            device=dev)
        _, cache, _ = r.prefill(p, ids, press=press, **kw)
        cache = kt.resize(cache, int(cache.length.max()) + DECODE_STEPS + 1)
        base_len, base_off = cache.length, cache.offset
        tok0 = ids[:, -1:]

        def steps():
            c = dataclasses.replace(cache, length=base_len, offset=base_off)
            tok = tok0
            for _ in range(DECODE_STEPS):
                logits, c, _ = r.forward(p, tok, c, logits_last_only=True)
                tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)

        steps()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / DECODE_STEPS)
        wall, by_name = chip_smoke.device_kernels(steps, 1)
        busy = sum(ms for ms, _ in by_name.values()) / DECODE_STEPS
        kernel = sum(ms for name, (ms, _) in by_name.items()
                     if "decode_kernel" in name or "decode_headwise_kernel" in name)
        out[label] = {"slots": cache.keys.shape[-2], "wall_ms": statistics.median(times),
                      "tok_s": B * 1e3 / statistics.median(times), "device_busy_ms": busy,
                      "decode_kernel_ms": kernel / DECODE_STEPS,
                      "idle_share": 1 - busy * DECODE_STEPS / wall}
        del cache
        torch.cuda.empty_cache()
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[1] == "--measure":
        print(json.dumps(measure(Path(argv[2]).resolve())), flush=True)
        return 0
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = Path(argv[1]).resolve(), Path(argv[2]).resolve()
    for root in (parent, change, change, parent):
        done = subprocess.run([sys.executable, __file__, "--measure", str(root)], cwd=root,
                              capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout[-2000:], done.stderr[-4000:], file=sys.stderr)
            return 1
        print(done.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
