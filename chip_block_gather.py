"""BlockPress over a hidden-reading scorer under a tensor-parallel mesh on
one H100: a 2-rank ``model=2`` gloo world at the flagship shape (the
ranks share the card), against one process.

Under a mesh ``BlockPress`` all-gathers each round's candidate sets over
"model", so a wrapped press that reads the hidden states (KVzap) sees each
kv head's part of them from that head's candidates on every rank. The
check: one 4,096-token prefill (random bf16 weights from seed 0, a seeded
linear KVzap surrogate), each rank's kept keys at layer 0 (whose input is
the same on every rank) against one process that scores each rank's
columns of the surrogate apart, as the ranks do: no kept row may be
missing. Also printed, per layer: the kept rows of each rank (and of one
process on its ``xla`` attention route) with no match among one process's
for Block(KVzap), Block(Knorm), Knorm and KVzap. Block's candidate sets
mix every head's chosen tokens into one hidden row, so a rounding
difference in a score moves many of its later choices; the readings show
how many.

Run from the repo root: ``python3 chip_block_gather.py`` (one card; exits
with 1 if a check fails)."""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.presses.kvzap import kvzap_apply

ROOT = os.path.dirname(os.path.abspath(__file__))
BLOCK = 512
DEVICE = "cuda"


class SplitKVzapPress(kt.KVzapPress):
    """KVzap scoring each rank's columns of the surrogate apart (model 2),
    as the ranks do, on one process."""

    def score(self, ctx, keys, values):
        n = keys.shape[1] // 2
        return torch.cat([kvzap_apply(self.surrogate, ctx.layer_idx, ctx.hidden,
                                      slice(r * n, (r + 1) * n)) for r in range(2)], dim=1)


def surrogate(cfg) -> dict:
    """A linear KVzap surrogate at ``cfg``'s width from seed 21 (the same on
    every rank)."""
    rng = np.random.default_rng(21)
    E, L, H = cfg.hidden_size, cfg.num_layers, cfg.num_kv_heads
    return {"w": (rng.standard_normal((L, E, H)) / np.sqrt(E)).astype(np.float32),
            "b": np.zeros((L, H), np.float32)}


def presses(cfg, split=False):
    zap = (SplitKVzapPress if split else kt.KVzapPress)(0.5, surrogate=surrogate(cfg))
    return {"Block(KVzap)": kt.BlockPress(zap, block_size=BLOCK),
            "Block(Knorm)": kt.BlockPress(kt.KnormPress(0.5), block_size=BLOCK),
            "Knorm": kt.KnormPress(0.5), "KVzap": zap}


def kept_keys(cache):
    """Layer by layer the kept keys of batch row 0, (L, H, n, D) on the host."""
    return cache.keys[:, 0, :, :int(cache.length.max())].cpu()


def setup():
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = cs.flagship_config(16)
    params = kt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.bfloat16, device=dev)
    reqs = cs.serving_requests(torch.Generator().manual_seed(19), cfg.vocab_size,
                               cs.TP_LOCAL_CONTEXTS, cs.TP_GLOO_NEW)
    return dev, cfg, params, torch.tensor([reqs[1][0]], device=dev)


def rank(r: int, d: str):
    """Rank ``r``: the all-gather of int64 and float32 CUDA tensors held
    exact, then each press's sharded prefill; its kept keys to ``d``."""
    import torch.distributed as dist

    from kvpress_tpu_torch.parallel import make_mesh, shard_params
    from kvpress_tpu_torch.parallel.mesh import model_shard

    dev, cfg, params, ids = setup()
    dist.init_process_group("gloo", store=dist.FileStore(f"{d}/store", 2), rank=r,
                            world_size=2, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(1, 2, device_type="cuda")
        gathered = {}
        for dt in (torch.int64, torch.float32):
            part = lambda k: (torch.arange(4 * 2560, device=dev).reshape(1, 4, 2560)
                              + 100000 * k).to(dt)
            got = model_shard(mesh, dev).all_gather(part(r), dim=1)
            gathered[str(dt)] = torch.equal(got, torch.cat([part(0), part(1)], dim=1))
        runner = kt.Runner.create(cfg, attn_impl="flash", decode_kernel=True,
                                  device=dev).sharded(mesh)
        local = shard_params(params, mesh)
        for name, press in presses(cfg).items():
            torch.save(kept_keys(runner.prefill(local, ids, press=press)[1]),
                       f"{d}/r{r}_{name}.pt")
        with open(f"{d}/r{r}.json", "w") as f:
            json.dump(gathered, f)
    finally:
        dist.destroy_process_group()


def unmatched(got, want) -> int:
    """Rows of ``got`` (H, n, D) within 5% of the largest row norm of no
    row of ``want``'s same head."""
    n = 0
    for h in range(got.shape[0]):
        a, b = got[h].float().to(DEVICE), want[h].float().to(DEVICE)
        near = torch.cdist(a, b).min(dim=1).values
        n += int((near > 0.05 * b.norm(dim=-1).max()).sum())
    return n


def main() -> int:
    from kvpress_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_block_gather: no CUDA device", file=sys.stderr)
        return 2
    _build.build()
    d = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "rank", str(r), d],
                              cwd=ROOT) for r in range(2)]
    try:
        dev, cfg, params, ids = setup()
        flash = kt.Runner.create(cfg, attn_impl="flash", decode_kernel=True, device=dev)
        xla = kt.Runner.create(cfg, attn_impl="xla", decode_kernel=False, device=dev)
        one = {k: kept_keys(flash.prefill(params, ids, press=p)[1])
               for k, p in presses(cfg).items()}
        split = {k: kept_keys(flash.prefill(params, ids, press=p)[1])
                 for k, p in presses(cfg, split=True).items() if "KVzap" in k}
        routes = {k: kept_keys(xla.prefill(params, ids, press=p)[1])
                  for k, p in presses(cfg).items()}
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if codes != [0, 0]:
        print(f"a rank failed (exit codes {codes})")
        return 1
    failures = []
    gathered = [json.load(open(f"{d}/r{r}.json")) for r in range(2)]
    print(f"all_gather of CUDA tensors over gloo exact, per rank: {gathered}")
    if not all(all(g.values()) for g in gathered):
        failures.append("an all_gather differs")
    H, n = cfg.num_kv_heads // 2, cfg.num_kv_heads
    for name in presses(cfg):
        ranks = [torch.load(f"{d}/r{r}_{name}.pt") for r in range(2)]
        kept = ranks[0].shape[-2]

        def against(want):
            return [sum(unmatched(ranks[r][l], want[l, r * H:(r + 1) * H]) for r in range(2))
                    for l in range(cfg.num_layers)]

        mesh = against(one[name])
        route = [unmatched(routes[name][l], one[name][l]) for l in range(cfg.num_layers)]
        print(f"{name}: kept rows of {kept} x {n} heads a layer with no match among one "
              f"process's: the ranks {mesh}; one process's xla route {route}")
        if name in split:
            apart = against(split[name])
            print(f"{name}: the ranks against one process scoring each rank's columns apart "
                  f"{apart}")
            if apart[0]:
                failures.append(f"{name}: {apart[0]} kept rows of layer 0 off one process "
                                "scoring each rank's columns apart")
    print(cs.device_line())
    for f in failures:
        print(f"FAILED: {f}")
    return 1 if failures else 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "rank":
        rank(int(sys.argv[2]), sys.argv[3])
    else:
        sys.exit(main())
