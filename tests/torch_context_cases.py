"""Rank workers of the context-parallel tests (tests/test_torch_context_*.py).
Like tests/torch_parallel_cases.py, whose ``start_world`` / ``finish_world``
start them, this module imports neither JAX nor ``kvpress_tpu``: the tests
compute the JAX references in their own process and hand the ranks numpy
arrays and the port's objects.

A job's ``mesh`` is ``{"seq": n}`` or ``{"model": m, "seq": n, "order":
(...)}``; each kind gathers its results over the mesh (``gathered``) into
the global arrays of JAX's ``P(None, None, "model", "seq", None)`` layout,
and the per-rank lengths into JAX's ``P(("model", "seq"))`` order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from torch_parallel_cases import as_numpy, port_params

CASES = __name__


def mesh_of(shape: dict):
    from kvpress_tpu_torch.parallel import make_seq_mesh

    return make_seq_mesh(shape["seq"], shape.get("model", 1),
                         order=tuple(shape.get("order", ("model", "seq"))))


def rank_setup(job: dict, mesh):
    """The rank's (runner, params): sharded over "model" when the mesh has
    it."""
    import kvpress_tpu_torch as kt
    from kvpress_tpu_torch.parallel import shard_params

    params = port_params(job)
    model = "model" in mesh.mesh_dim_names
    runner = kt.Runner.create(job["cfg"], attn_impl=job.get("attn_impl", "xla"),
                              decode_kernel=False, device="cpu", mesh=mesh if model else None)
    return runner, shard_params(params, mesh) if model else params


def gathered(t, mesh):
    """A rank's cache block gathered over "seq" (the slot axis) and
    "model" (the kv-head axis)."""
    from kvpress_tpu_torch.parallel import gather_heads, gather_seq

    t = gather_seq(t, mesh)
    return as_numpy(gather_heads(t, mesh) if "model" in mesh.mesh_dim_names else t)


def lengths_of(lengths, mesh) -> np.ndarray:
    """Every rank's lengths, ordered as JAX's ``P(("model", "seq"))``:
    (model * seq, L)."""
    coord = (mesh.get_local_rank("model") if "model" in mesh.mesh_dim_names else 0,
             mesh.get_local_rank("seq"))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (coord, lengths.tolist()))
    return np.asarray([l for _, l in sorted(every)])


def shards_of(shards, mesh) -> dict:
    names = ("keys", "values", "lengths", "masks", "key_scales", "value_scales")
    out = {n: gathered(t, mesh) for n, t in zip(names, shards) if n != "lengths"}
    out["lengths"] = lengths_of(shards[2], mesh)
    return out


# --------------------------------------------------------------------- #
# Ring attention


def ring(job: dict, mesh) -> dict:
    """``context_parallel_attention`` of the job's whole (B, H, S, D) q, k,
    v (``impl``), and with ``lse`` the rank blocks of
    ``ring_self_attention_lse`` and ``ring_colagg`` gathered."""
    from kvpress_tpu_torch.parallel import (context_parallel_attention, gather_seq, ring_colagg,
                                            ring_flash_self_attention, ring_self_attention_lse,
                                            seq_block, seq_shard)

    q, k, v = (torch.from_numpy(job[n]) for n in "qkv")
    scale = q.shape[-1] ** -0.5
    out = {}
    if "impl" in job:
        out["out"] = as_numpy(context_parallel_attention(q, k, v, mesh, impl=job["impl"]))
    seq = seq_shard(mesh, "cpu")
    ql, kl, vl = (seq_block(t, mesh, dim=2) for t in (q, k, v))
    if job.get("window"):
        out["windowed"] = as_numpy(gather_seq(ring_flash_self_attention(
            ql, kl, vl, seq=seq, sm_scale=scale, window=job["window"]), mesh, dim=2))
    if job.get("lse"):
        o, lse = ring_self_attention_lse(ql, kl, vl, seq=seq, sm_scale=scale)
        out["lse_out"] = as_numpy(gather_seq(o, mesh, dim=2))
        out["lse"] = as_numpy(gather_seq(lse, mesh, dim=2))
        for agg in ("max", "sum"):
            out[f"colagg_{agg}"] = as_numpy(gather_seq(ring_colagg(
                ql, kl, lse, seq=seq, sm_scale=scale, ctx_len=job["ctx_len"], agg=agg), mesh,
                dim=2))
    return out


# --------------------------------------------------------------------- #
# Prefill and decode


def prefill(job: dict, mesh) -> dict:
    """``context_parallel_prefill`` of the job, gathered; with ``plain`` also
    the pressless prefill's keys."""
    from kvpress_tpu_torch.parallel import context_parallel_prefill

    runner, params = rank_setup(job, mesh)
    ids = torch.from_numpy(np.asarray(job["ids"], np.int64))
    kw = dict(quantized=job.get("quantized", False), kv_bits=job.get("kv_bits", 8))
    out = shards_of(context_parallel_prefill(params, ids, runner=runner, mesh=mesh,
                                             press=job.get("press"), **kw), mesh)
    if job.get("plain"):
        out["plain_keys"] = gathered(context_parallel_prefill(
            params, ids, runner=runner, mesh=mesh, **kw)[0], mesh)
    return out


def decode(job: dict, mesh) -> dict:
    """Prefill (or KVCompose's pass), ``grow`` slots, then one
    ``context_parallel_decode_step`` per entry of ``tokens`` ((B, 1) ids to
    feed, or None for the greedy token of the step before): each step's
    logits (None on overflow) and overflow flag, the lengths after every
    step, the shards at the end, and with ``decode_press`` its state."""
    from kvpress_tpu_torch.parallel import (context_parallel_decode_step,
                                            context_parallel_kvcompose, context_parallel_prefill,
                                            grow_shards)

    runner, params = rank_setup(job, mesh)
    ids = torch.from_numpy(np.asarray(job["ids"], np.int64))
    if job.get("kvcompose") is not None:
        shards = context_parallel_kvcompose(params, ids, runner=runner, press=job["kvcompose"],
                                            mesh=mesh)
    else:
        shards = context_parallel_prefill(params, ids, runner=runner, mesh=mesh,
                                          press=job.get("press"),
                                          quantized=job.get("quantized", False),
                                          kv_bits=job.get("kv_bits", 8))
    before = {}
    if job.get("grow"):
        before = shards_of(shards, mesh)
        shards = grow_shards(shards, job["grow"])
    S = ids.shape[1]
    n_seq = mesh.shape[mesh.mesh_dim_names.index("seq")]
    press = job.get("decode_press")
    state = None if press is None else press.init_state(runner.cfg, ids.shape[0], 1)
    psl = job.get("psl", S // n_seq if runner.cfg.sliding_window is not None else None)
    offset, tok = S, ids[:, -1:]
    steps = []
    for feed in job["tokens"]:
        if feed is not None:
            tok = torch.from_numpy(np.asarray(feed, np.int64))
        logits, out, offset2, ovf, state2 = context_parallel_decode_step(
            params, tok, shards, offset, runner=runner, mesh=mesh, press=press,
            press_state=state, prefill_shard_len=psl)
        steps.append(dict(logits=None if logits is None else as_numpy(logits), overflow=ovf,
                          lengths=lengths_of(out[2], mesh)))
        if ovf and job.get("regrow"):
            # The generate loop's retry: the shards as they were, grown.
            steps[-1]["kept"] = shards_of(out, mesh)
            out = grow_shards(shards, job["regrow"])
            logits, out, offset2, ovf, state2 = context_parallel_decode_step(
                params, tok, out, offset, runner=runner, mesh=mesh, press=press,
                press_state=state, prefill_shard_len=psl)
            steps.append(dict(logits=as_numpy(logits), overflow=ovf,
                              lengths=lengths_of(out[2], mesh)))
        shards, offset, state = out, offset2, state2
        if logits is not None:
            tok = torch.argmax(logits[:, -1:], dim=-1)
    return dict(steps=steps, shards=shards_of(shards, mesh), before=before,
                state=None if state is None else [
                    {k: (as_numpy(v) if torch.is_tensor(v) else v) for k, v in s.items()}
                    for s in state])


def generate(job: dict, mesh) -> dict:
    """``context_parallel_generate`` of the job, host loop and fused."""
    from kvpress_tpu_torch.parallel import context_parallel_generate

    runner, params = rank_setup(job, mesh)
    ids = torch.from_numpy(np.asarray(job["ids"], np.int64))
    kw = dict(press=job.get("press"), decode_press=job.get("decode_press"),
              max_new_tokens=job["new"], eos_id=job.get("eos_id"),
              quantized=job.get("quantized", False), kv_bits=job.get("kv_bits", 8))
    return {fused: context_parallel_generate(params, ids, runner=runner, mesh=mesh, fused=fused,
                                             **kw).numpy()
            for fused in job.get("fused", (False, True))}


def refusal(job: dict, mesh) -> str:
    """The error that ``context_parallel_generate`` with ``kw`` raises (with
    ``step``: a decode step after the pressless prefill, with ``kw``), as
    ``"<type>: <message>"``."""
    from kvpress_tpu_torch.parallel import (context_parallel_decode_step,
                                            context_parallel_generate, context_parallel_prefill)

    runner, params = rank_setup(job, mesh)
    ids = torch.from_numpy(np.asarray(job["ids"], np.int64))
    try:
        if job.get("step"):
            shards = context_parallel_prefill(params, ids, runner=runner, mesh=mesh)
            context_parallel_decode_step(params, ids[:, -1:], shards, ids.shape[1],
                                         runner=runner, mesh=mesh, **job["kw"])
        else:
            context_parallel_generate(params, ids, runner=runner, mesh=mesh, max_new_tokens=2,
                                      **job["kw"])
    except Exception as e:                       # noqa: BLE001 - reported to the test
        return f"{type(e).__name__}: {e}"
    return "no error"


KINDS = {"ring": ring, "prefill": prefill, "decode": decode, "generate": generate,
         "refusal": refusal}
