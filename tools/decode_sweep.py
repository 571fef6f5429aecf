#!/usr/bin/env python3
"""Time the two decode kernels at each key-range count on one CUDA card.

    python3 tools/decode_sweep.py [--splits 1,4,8,16,32]

Each launch is made with ``ops.decode.decode_splits`` replaced by the count
under test, so the sweep shows what that function trades: more ranges put more blocks on the card
and give the merge more to add. At GQA 32/8, head_dim 64, T=1, for bf16, int8
and int4 KV: B=4 over 16K live slots, unmasked and with 40% of the
keep-bits clear, and B=1 over a half-live 33K buffer; then the head-wise
kernel at B=4 over 16K ragged prefixes. One line per shape: the default
split count, then for each count the block kernel's and the merge's device
microseconds (profiler, 30 launches).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--splits", default="1,4,8,16,32")
    args = parser.parse_args(argv)
    splits = [int(x) for x in args.splits.split(",")]

    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from kvpress_tpu_torch.cache import quantize_kv
    from kvpress_tpu_torch.ops import decode as dec
    from kvpress_tpu_torch.ops import decode_headwise as hw

    if not torch.cuda.is_available():
        raise SystemExit("decode_sweep: no CUDA device")
    print(chip_smoke.device_line(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    Hq, Hkv, D = 32, 8, 64

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    choose = dec.decode_splits

    def times(n, call):
        dec.decode_splits = lambda *shape: n
        try:
            _, kernels = chip_smoke.device_kernels(call, 30)
        finally:
            dec.decode_splits = choose
        main_us = sum(ms for name, (ms, _) in kernels.items() if "_kernel<" in name) * 1e3
        merge_us = sum(ms for name, (ms, _) in kernels.items() if "_merge" in name) * 1e3
        return f"{main_us:.1f}+{merge_us:.1f}"

    for B, length, dead in ((4, 16385, 0.0), (4, 16385, 0.4), (1, 32769, 0.5)):
        S = length + 63
        q, kd, vd = rnd(B, Hq, 1, D), rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
        mask = None
        if dead:
            mask = torch.rand((B, Hkv, S), generator=gen, device=dev) > dead
            mask[:, :, length - 1] = True
        for bits in (None, 8, 4):
            if bits is None:
                kk, vv, ks, vs = kd, vd, None, None
            else:
                (kk, ks), (vv, vs) = quantize_kv(kd, bits), quantize_kv(vd, bits)
            default = choose(B, Hkv, Hq // Hkv, 1, S, D, length, dec.step_keys(D, bits))
            row = [f"{n}:" + times(n, lambda: dec.decode_attention(
                q, kk, vv, length, ks, vs, mask, bits=bits, sm_scale=D ** -0.5))
                for n in splits]
            print(f"decode B{B} length {length} dead {dead} "
                  f"{'bf16' if bits is None else f'int{bits}'} (default {default}): "
                  + " ".join(row), flush=True)

    B, S, tail = 4, 16384 + 64, 33
    prefix = torch.randint(2048, 16384, (B, Hkv), generator=gen, device=dev)
    prefix[0, 0], prefix[1, 1] = 0, 16384
    tail_start = int(prefix.max())
    length = tail_start + tail
    col = torch.arange(S, device=dev)
    mask = col < prefix[..., None]
    mask[:, :, tail_start:length] = True
    q, k, v = rnd(B, Hq, 1, D), rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    ranges = hw.prefix_tail_from_mask(mask, length)
    default = choose(B, Hkv, Hq // Hkv, 1, S, D, S, dec.step_keys(D, None))
    row = [f"{n}:" + times(n, lambda: hw.decode_attention_headwise(
        q, k, v, *ranges, sm_scale=D ** -0.5)) for n in splits]
    print(f"headwise B{B} 16K ragged (default {default}): " + " ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
