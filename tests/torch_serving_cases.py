"""Shared cases of the serving tests (tests/test_torch_serving*.py,
tests/test_torch_pipeline_batch.py): the tiny models in both packages,
requests drawn from a numpy seed as tests/test_serving.py draws them, one
engine run on each side, the comparisons of the port's engine with the JAX
engine (answers, stats, the pool's host lengths and offsets, live K/V within
KV_RTOL of their scale, keep-masks below the lengths), and the teacher-forced
check of a served answer against the port's single-request path through
``Runner``.

Every run of the port's engine here also holds the engine to its tokens
contract: a tensor of tokens that a decode step returned is never written
after (a pending step's tokens are read ``fetch_lag`` steps later)."""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import kvpress_tpu as kj
from kvpress_tpu import serving as jserving
import kvpress_tpu_torch as kt
from kvpress_tpu_torch import serving as tserving
from torch_scorer_cases import tiny_models

# The engine stats that must be equal on both sides.
STATS = ("decode_steps", "slot_step_utilization", "ctx_hits", "dropped", "retried_admissions")
# Live K/V: float32 on both sides, the same arithmetic in another order.
KV_RTOL = 1e-5
# The teacher-forced check (JAX's tests/test_serving.py): an engine token is
# the reference argmax or within TIE_EPS of it in the reference logits.
TIE_EPS = 2e-3


def make_requests(vocab: int, lengths, n_new: int = 6, seed: int = 0):
    """[(context ids, question ids, max_new_tokens)] of distinct random ids,
    one per (context length, question length)."""
    rng = np.random.default_rng(seed)
    return [(rng.permutation(vocab)[:c].tolist(), rng.permutation(vocab)[:q].tolist(), n_new)
            for c, q in lengths]


def requests(module, reqs):
    """The package's Request objects for ``reqs``: (context ids, question
    ids, max_new_tokens[, dict of other Request fields])."""
    return [module.Request(list(r[0]), list(r[1]), r[2], **(r[3] if len(r) > 3 else {}))
            for r in reqs]


@dataclasses.dataclass
class Models:
    cfg_j: object
    cfg_t: object
    params_j: dict
    params_t: object

    @staticmethod
    def tiny():
        return Models(*tiny_models())

    @staticmethod
    def sliding():
        """A Gemma3-like tiny config: interleaved sliding (window 8) and
        global layers, a local RoPE base."""
        over = dict(num_layers=4, sliding_window=8, rope_local_base_freq=500.0,
                    layer_is_sliding=tuple(i % 2 == 0 for i in range(4)))
        cfg_j, cfg_t = kj.tiny_config(**over), kt.tiny_config(**over)
        params_j = kj.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
        params_t = kt.params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), cfg_t,
                                      device="cpu", dtype=torch.float32)
        return Models(cfg_j, cfg_t, params_j, params_t)

    def runners(self, attn_impl="xla", decode_kernel=False):
        return (kj.Runner.create(self.cfg_j),
                kt.Runner.create(self.cfg_t, attn_impl=attn_impl, decode_kernel=decode_kernel,
                                 device="cpu"))


@contextlib.contextmanager
def tokens_contract():
    """Records each decode step's returned tokens with a copy; on exit every
    recorded tensor must still equal its copy."""
    seen = []
    original = tserving._decode_step

    def recording(*args, **kwargs):
        out = original(*args, **kwargs)
        seen.append((out[0], out[0].clone()))
        return out

    tserving._decode_step = recording
    try:
        yield seen
    finally:
        tserving._decode_step = original
    for i, (t, copy) in enumerate(seen):
        assert torch.equal(t, copy), f"the tokens of decode step {i} were written after it"


def serve_torch(runner, params, reqs, run_kw=None, **engine_kw):
    eng = kt.ServingEngine(runner, params, **engine_kw)
    with tokens_contract():
        answers = eng.run(requests(tserving, reqs), **(run_kw or {}))
    return answers, eng


def serve_jax(runner, params, reqs, run_kw=None, **engine_kw):
    eng = jserving.ServingEngine(runner, params, **engine_kw)
    return eng.run(requests(jserving, reqs), **(run_kw or {})), eng


def serve_both(models, reqs, jpress=None, tpress=None, runners=None, run_kw=None, **engine_kw):
    """One engine run on each side. Returns ((answers, engine) of JAX, of the
    port)."""
    rj, rt = runners or models.runners()
    return (serve_jax(rj, models.params_j, reqs, run_kw, press=jpress, **engine_kw),
            serve_torch(rt, models.params_t, reqs, run_kw, press=tpress, **engine_kw))


def pool(sc):
    """A pool's state as numpy: lengths, offsets, keys and values (float32;
    the payload codes of a quantized pool, int4 unpacked), their scales,
    keep-mask."""
    def arr(x):
        return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)

    out = dict(lengths=np.asarray(sc.lengths).copy(), offsets=np.asarray(sc.offsets).copy(),
               keys=arr(sc.keys), values=arr(sc.values), mask=np.asarray(sc.mask).copy())
    if sc.key_scales is not None:
        out.update(key_scales=arr(sc.key_scales), value_scales=arr(sc.value_scales))
        if sc.bits == 4:
            for name in ("keys", "values"):
                p = out[name].astype(np.int32)
                out[name] = np.concatenate([p & 0xF, p >> 4], axis=-1).astype(np.float32)
    return out


def assert_same_pool(sc_j, sc_t):
    """Equal host lengths and offsets; below each slot's per-layer length,
    equal keep bits and K/V within KV_RTOL of their scale. A quantized pool:
    scales within KV_RTOL, and payload codes equal but at half steps, where
    JAX's compiled quantizer (x * (1/scale)) and eager rounding (x / scale)
    may part by one code (ROADMAP, standing records)."""
    pj, pt = pool(sc_j), pool(sc_t)
    np.testing.assert_array_equal(pt["lengths"], pj["lengths"])
    np.testing.assert_array_equal(pt["offsets"], pj["offsets"])
    quantized = "key_scales" in pt
    L, N = pt["lengths"].shape
    codes = off = 0
    for l in range(L):
        for s in range(N):
            n = int(pt["lengths"][l, s])
            for name in ("keys", "values"):
                a, b = pt[name][l, s, :, :n], pj[name][l, s, :, :n]
                if quantized:
                    assert np.abs(a - b).max(initial=0.0) <= 1, (name, l, s)
                    codes, off = codes + a.size, off + int((a != b).sum())
                    a, b = pt[name[:-1] + "_scales"][l, s, :, :n], \
                        pj[name[:-1] + "_scales"][l, s, :, :n]
                scale = max(np.abs(b).max(initial=0.0), 1e-6)
                assert np.abs(a - b).max(initial=0.0) <= KV_RTOL * scale, (name, l, s)
            np.testing.assert_array_equal(pt["mask"][l, s, :, :n], pj["mask"][l, s, :, :n])
    assert off <= max(2, codes // 1000), f"{off} of {codes} codes one apart"


def assert_same(served_j, served_t, answers=True):
    """The port's engine run against the JAX engine's: answers, stats, pool."""
    (aj, ej), (at, et) = served_j, served_t
    if answers:
        assert at == aj
    for key in STATS:
        assert et.last_stats[key] == ej.last_stats[key], key
    assert_same_pool(ej.sc, et.sc)


def single_request(runner, params, press, req, n_tokens, quantized=False, kv_bits=8,
                   prepare=None):
    """The port's single-request path through ``Runner``: the prefill with the
    press (then ``prepare(cache)``: a multi-pass press's scoring passes), the
    question forward, room for ``n_tokens`` more. Returns (logits, cache)."""
    ctx, q = req[0], req[1]
    ids = torch.tensor([ctx], dtype=torch.long)
    logits, cache, _ = runner.prefill(params, ids, press=press, compute_logits=True,
                                      dtype=params.dtype, quantized=quantized, kv_bits=kv_bits)
    if prepare is not None:
        cache = prepare(cache)
    if q:
        need = int(cache.length.max()) + len(q)
        if cache.max_size < need:
            cache = kt.resize(cache, need)
        logits, cache, _ = runner.forward(params, torch.tensor([q], dtype=torch.long), cache,
                                          logits_last_only=True, valid_len=len(q))
    need = int(cache.length.max()) + n_tokens + 1
    if cache.max_size < need:
        cache = kt.resize(cache, need)
    return logits, cache


def assert_teacher_forced(runner, params, press, req, got, tie_eps=TIE_EPS, **kw):
    """Replay ``got`` through the single-request path: at every step the
    engine's token is the reference argmax or within ``tie_eps`` of it, and
    near-tie flips are rare."""
    logits, cache = single_request(runner, params, press, req, len(got), **kw)
    mismatches = 0
    for i, tok in enumerate(got):
        row = logits[0, -1]
        ref = int(torch.argmax(row))
        if tok != ref:
            mismatches += 1
            gap = float(row[ref] - row[tok])
            assert gap < tie_eps, f"step {i}: token {tok} lags the argmax {ref} by {gap}"
        logits, cache, _ = runner.forward(params, torch.tensor([[tok]]), cache,
                                          logits_last_only=True)
    assert mismatches <= max(1, len(got) // 3), (mismatches, got)
