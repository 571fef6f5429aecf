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
``observed_colsum_kernel``) in one such prefill from the profiler. Each
process prints one JSON line:
``{"tree": ..., "card": ..., "kernels": {...}, "prefill": {...}}``.
"""

from __future__ import annotations

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
    checks = chip_smoke.kernel_checks(kt, torch, lambda msg: None)
    kernels = {}
    for name, variants in checks.items():
        for variant, row in variants.items():
            kernels[f"{name}[{variant}]"] = {k: row[k] for k in ("ms", "bound_ms", "library_ms")}

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
    return {"tree": str(root), "card": card, "kernels": kernels, "prefill": prefill}


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
