"""The ServingEngine's admission paths in kvpress_tpu_torch against the JAX
engine (CPU, float32, tiny config; tests/torch_serving_cases.py compares
answers, stats, the pool's host lengths and offsets, live K/V and keep-masks):
KVzip's multi-pass admission, chunked, interleaved and bucketed admission
(with a chunked wrapper press), the context LRU over float32 and int8 KV with
the in-flight dedup and with bucketing (the stored entry bit-equal below its
length after its hits), compacting presses' measured shrink and their
optimistic admission with its clamped retry and drop, DMS compact at a small
capacity, a KeyRerotation admission's offset, and every refusal (JAX asserts
where the port raises ValueError; ``mesh=`` takes only a DeviceMesh)."""

import contextlib

import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu import presses as jp
from kvpress_tpu import serving as jserving
import kvpress_tpu_torch as kt
from toy_tokenizer import ToyTokenizer
from torch_serving_cases import (Models, assert_same, assert_teacher_forced, make_requests,
                                 serve_both, serve_jax, serve_torch)

torch.set_num_threads(2)

ENGINE = dict(n_slots=2, capacity=64, question_bucket=4, fetch_lag=2)


@pytest.fixture(scope="module")
def m():
    return Models.tiny()


@pytest.fixture(scope="module")
def tok(m):
    return ToyTokenizer(m.cfg_t.vocab_size)


@contextlib.contextmanager
def lru_snapshots(engine_cls=kt.ServingEngine):
    """Clones of every entry the port's engine stores in its LRU, by key."""
    stored = {}
    original = engine_cls._lru_store

    def store(self, key, cache, pre_row):
        stored[key] = {n: getattr(cache, n).clone() for n in ("keys", "values", "mask",
                                                              "key_scales", "value_scales")
                       if getattr(cache, n) is not None}
        return original(self, key, cache, pre_row)

    engine_cls._lru_store = store
    try:
        yield stored
    finally:
        engine_cls._lru_store = original


def assert_entries_unchanged(eng, stored):
    """Each entry left in the LRU bit-equal, below its per-layer lengths, to
    what was stored."""
    assert eng._ctx_lru
    for key, (cache, _) in eng._ctx_lru.items():
        for name, t in stored[key].items():
            for l, n in enumerate(cache.length.tolist()):
                assert torch.equal(getattr(cache, name)[l, :, :, :n], t[l, :, :, :n]), name


# --------------------------------------------------------------------- #
# Multi-pass, chunked, interleaved, bucketed


def test_kvzip_multi_pass_admission_matches_jax(m, tok):
    """The repeat passes run at admission; generation reads the masked
    cache. Each answer teacher-forced against the single-request path with
    the same passes."""
    reqs = make_requests(m.cfg_t.vocab_size, [(32, 4), (24, 4)])
    press = {mod: mod.KVzipPress(compression_ratio=0.5, chunk_size=16) for mod in (jp, kt)}
    served = serve_both(m, reqs, press[jp], press[kt], tokenizer=tok,
                        **dict(ENGINE, capacity=96))
    assert_same(*served)
    eng = served[1][1]
    assert not bool(eng.sc.mask.all())
    runner = m.runners()[1]
    pipe = kt.KVPressPipeline(runner, m.params_t, tok)
    for req, got in zip(reqs, served[1][0]):
        assert_teacher_forced(runner, m.params_t, press[kt], req, got,
                              prepare=lambda c, r=req: pipe._run_kvzip(c, list(r[0]),
                                                                        press[kt]))


@pytest.fixture(scope="module")
def chunk_reqs(m):
    return make_requests(m.cfg_t.vocab_size, [(50, 4), (64, 8), (33, 4), (48, 4)])


def test_chunked_admission_matches_one_shot_and_jax(m, chunk_reqs):
    served = serve_both(m, chunk_reqs, kj.KnormPress(0.5), kt.KnormPress(0.5), context_chunk=16,
                        **ENGINE)
    assert_same(*served)
    one_shot = serve_torch(m.runners()[1], m.params_t, chunk_reqs, press=kt.KnormPress(0.5),
                           **ENGINE)[0]
    assert served[1][0] == one_shot


def test_interleaved_admission_matches_jax(m):
    """Decode steps issued between the chunks of admissions: the answers of
    non-interleaved chunked admission, staggered budgets, gap stats."""
    reqs = [(c, q, 3 + 2 * i) for i, (c, q, _) in enumerate(make_requests(
        m.cfg_t.vocab_size, [(50, 9), (64, 3), (33, 7), (48, 4), (61, 5)]))]
    base = serve_torch(m.runners()[1], m.params_t, reqs, press=kt.KnormPress(0.5),
                       context_chunk=16, **ENGINE)[0]
    served = serve_both(m, reqs, kj.KnormPress(0.5), kt.KnormPress(0.5), context_chunk=16,
                        interleave=True, **ENGINE)
    assert_same(*served)
    assert served[1][0] == base
    stats = served[1][1].last_stats
    assert stats["max_intertoken_gap_s"] >= stats["p50_intertoken_gap_s"] > 0


def test_bucketed_admission_matches_jax(m, chunk_reqs):
    served = serve_both(m, chunk_reqs, kj.KnormPress(0.5), kt.KnormPress(0.5),
                        context_bucket=16, **ENGINE)
    assert_same(*served)
    for req, got in zip(chunk_reqs, served[1][0]):
        assert_teacher_forced(m.runners()[1], m.params_t, kt.KnormPress(0.5), req, got)


def test_chunked_wrapper_admission_matches_jax(m):
    """AdaKV(Knorm) compact through chunked admission: the one-shot answers."""
    reqs = make_requests(m.cfg_t.vocab_size, [(50, 4), (64, 8), (33, 4)], n_new=5, seed=9)
    press = {mod: mod.AdaKVPress(press=mod.KnormPress(0.5), compact=True) for mod in (jp, kt)}
    kw = dict(ENGINE, capacity=96)
    served = serve_both(m, reqs, press[jp], press[kt], context_chunk=16, **kw)
    assert_same(*served)
    assert served[1][0] == serve_torch(m.runners()[1], m.params_t, reqs, press=press[kt],
                                       **kw)[0]


# --------------------------------------------------------------------- #
# The context LRU


@pytest.mark.parametrize("quantized", [False, True])
def test_context_cache_reuse_matches_jax(m, quantized):
    """Three questions on one context: one miss, two hits; a fourth context
    evicts it. The entry stays bit-equal below its length through the hits'
    question forwards."""
    rng = np.random.default_rng(3)
    ctx = rng.permutation(m.cfg_t.vocab_size)[:40].tolist()
    reqs = [(ctx, rng.permutation(m.cfg_t.vocab_size)[:4].tolist(), 5) for _ in range(3)]
    other = (rng.permutation(m.cfg_t.vocab_size)[:24].tolist(),
             rng.permutation(m.cfg_t.vocab_size)[:4].tolist(), 5)
    kw = dict(context_cache=1, quantized=quantized, **ENGINE)
    with lru_snapshots() as stored:
        served_t = serve_torch(m.runners()[1], m.params_t, reqs, press=kt.KnormPress(0.5), **kw)
    assert served_t[1].ctx_hits == 2
    assert_entries_unchanged(served_t[1], stored)
    served = serve_both(m, reqs + [other], kj.KnormPress(0.5), kt.KnormPress(0.5), **kw)
    assert_same(*served)
    eng = served[1][1]
    assert eng.ctx_hits == 2
    assert list(eng._ctx_lru) == [(tuple(other[0]), None)]
    for req, got in zip(reqs + [other], served[1][0]):
        assert_teacher_forced(m.runners()[1], m.params_t, kt.KnormPress(0.5), req, got,
                              quantized=quantized)


def test_context_cache_inflight_dedup_matches_jax(m):
    """Two admissions of one context issued together (interleaved): the
    second waits for the first's entry and hits; processed tokens leave out
    the skipped context."""
    rng = np.random.default_rng(11)
    ctx = rng.permutation(m.cfg_t.vocab_size)[:48].tolist()
    reqs = [(ctx, rng.permutation(m.cfg_t.vocab_size)[:4].tolist(), 5) for _ in range(2)]
    served = serve_both(m, reqs, kj.KnormPress(0.5), kt.KnormPress(0.5), context_chunk=16,
                        interleave=True, context_cache=1, **ENGINE)
    assert_same(*served)
    answers, eng = served[1]
    assert eng.ctx_hits == 1
    assert eng.last_stats["skipped_context_tokens"] == len(ctx)
    assert eng.last_stats["processed_tokens"] == (
        sum(len(a) for a in answers) + sum(len(r[0]) + len(r[1]) for r in reqs) - len(ctx))
    for req, got in zip(reqs, answers):
        assert_teacher_forced(m.runners()[1], m.params_t, kt.KnormPress(0.5), req, got)


def test_context_cache_with_bucketing_matches_jax(m):
    """Bucketed admission (40 tokens in a bucket of 48) with the LRU: the
    entry shrunk to the unpadded kept bound; two hits; the unbucketed
    engine's answers; the entry bit-equal after the hits."""
    rng = np.random.default_rng(5)
    ctx = rng.permutation(m.cfg_t.vocab_size)[:40].tolist()
    reqs = [(ctx, rng.permutation(m.cfg_t.vocab_size)[:4].tolist(), 5) for _ in range(3)]
    plain = serve_torch(m.runners()[1], m.params_t, reqs, press=kt.KnormPress(0.5), **ENGINE)[0]
    with lru_snapshots() as stored:
        served = serve_both(m, reqs, kj.KnormPress(0.5), kt.KnormPress(0.5), context_bucket=16,
                            context_cache=1, **ENGINE)
    assert_same(*served)
    assert served[1][1].ctx_hits == 2
    assert served[1][0] == plain
    assert_entries_unchanged(served[1][1], stored)


# --------------------------------------------------------------------- #
# Compacting presses, rerotation


def _kvzip_compact(mod, ratio):
    return mod.KVzipPress(compression_ratio=ratio, compact=True, chunk_size=24)


def test_compact_press_lru_measured_shrink_matches_jax(m, tok):
    """The entry stored at the static bound (the whole context) shrinks to
    the measured kept length, bucketed; the hits answer as the engine
    without an LRU."""
    rng = np.random.default_rng(13)
    ctx = rng.permutation(m.cfg_t.vocab_size)[:64].tolist()
    reqs = [(ctx, rng.permutation(m.cfg_t.vocab_size)[:4].tolist(), 4) for _ in range(3)]
    kw = dict(n_slots=1, capacity=96, tokenizer=tok, fetch_lag=2)
    ref = serve_torch(m.runners()[1], m.params_t, reqs, press=_kvzip_compact(kt, 0.6), **kw)[0]
    served = serve_both(m, reqs, _kvzip_compact(jp, 0.6), _kvzip_compact(kt, 0.6),
                        context_cache=1, question_bucket=16, **kw)
    assert_same(*served)
    assert served[1][0] == ref
    eng = served[1][1]
    assert eng.ctx_hits == 2
    ((entry, _),) = eng._ctx_lru.values()
    ((entry_j, _),) = served[0][1]._ctx_lru.values()
    assert entry.max_size == entry_j.max_size < 64
    assert entry.max_size % 16 == 0 and entry.max_size >= int(entry.length.max())


def test_compact_press_small_capacity_retry_and_drop_match_jax(m, tok):
    """Optimistic admission: a slot below the static bound serves when the
    compacted cache fits; a barely compressing press retries once at a
    clamped ratio and answers; an impossible slot drops the request after
    the retry, reported, and the other request serves."""
    rng = np.random.default_rng(11)
    ctx = rng.permutation(m.cfg_t.vocab_size)[:64].tolist()
    q = rng.permutation(m.cfg_t.vocab_size)[:4].tolist()
    short = rng.permutation(m.cfg_t.vocab_size)[:20].tolist()
    kw = dict(n_slots=1, tokenizer=tok, fetch_lag=2)
    big = serve_torch(m.runners()[1], m.params_t, [(ctx, q, 4)], press=_kvzip_compact(kt, 0.6),
                      capacity=96, **kw)[0]
    small = serve_both(m, [(ctx, q, 4)], _kvzip_compact(jp, 0.6), _kvzip_compact(kt, 0.6),
                       capacity=48, **kw)
    assert_same(*small)
    assert small[1][0] == big
    assert small[1][1].last_stats["retried_admissions"] == 0

    retry = serve_both(m, [(ctx, q, 4), (short, q, 4)], _kvzip_compact(jp, 0.05),
                       _kvzip_compact(kt, 0.05), capacity=40, **kw)
    assert_same(*retry)
    assert [len(a) for a in retry[1][0]] == [4, 4]
    assert retry[1][1].last_stats["retried_admissions"] == 1
    assert retry[1][1].last_stats["dropped"] == []

    tight = serve_both(m, [(ctx, q, 4), (short[:6], q, 4)], _kvzip_compact(jp, 0.05),
                       _kvzip_compact(kt, 0.05), capacity=16, **kw)
    assert_same(*tight)
    stats = tight[1][1].last_stats
    assert tight[1][0][0] == [] and len(tight[1][0][1]) == 4
    assert (stats["retried_admissions"], stats["dropped"], stats["dropped_requests"]) == \
        (1, [0], 1)


def test_dms_compact_small_capacity_matches_jax(m):
    """DMS(Knorm) compact: a slot below the context serves when the
    compacted threshold mask fits; an impossible slot drops at once (no
    ratio to clamp)."""
    rng = np.random.default_rng(23)
    ctx = rng.permutation(m.cfg_t.vocab_size)[:64].tolist()
    q = rng.permutation(m.cfg_t.vocab_size)[:4].tolist()
    _, c0, _ = m.runners()[1].prefill(m.params_t, torch.tensor([ctx]))
    thr = float(np.percentile(-np.linalg.norm(c0.keys[..., :64, :].numpy(), axis=-1), 55))
    press = {mod: mod.DMSPress(press=mod.KnormPress(), threshold=thr, sliding_window_size=16,
                               compact=True) for mod in (jp, kt)}
    kw = dict(n_slots=1, fetch_lag=2)
    big = serve_torch(m.runners()[1], m.params_t, [(ctx, q, 4)], press=press[kt], capacity=96,
                      **kw)[0]
    small = serve_both(m, [(ctx, q, 4)], press[jp], press[kt], capacity=56, **kw)
    assert_same(*small)
    assert small[1][0] == big
    tight = serve_both(m, [(ctx, q, 4)], press[jp], press[kt], capacity=12, **kw)
    assert_same(*tight)
    assert tight[1][0] == [[]]
    assert (tight[1][1].last_stats["dropped"], tight[1][1].last_stats["retried_admissions"]) \
        == ([0], 0)


def test_key_rerotation_admission_continues_from_the_kept_length(m):
    """A rerotating press: the admitted cache's offset is its compressed
    length, so the question and the answer continue from there (as the
    pipeline does)."""
    reqs = make_requests(m.cfg_t.vocab_size, [(32, 4), (40, 4)])
    press = {mod: mod.KeyRerotationPress(press=mod.KnormPress(0.5)) for mod in (jp, kt)}
    served = serve_both(m, reqs, press[jp], press[kt], **ENGINE)
    assert_same(*served)
    eng = served[1][1]
    # the last request of each slot: kept 16 / 20, question 4, 5 steps
    assert sorted(eng.sc.offsets.tolist()) == [16 + 4 + 5, 20 + 4 + 5]

    def rerotated(cache):
        import dataclasses

        return dataclasses.replace(cache, offset=torch.tensor(int(cache.length.max()),
                                                              dtype=torch.int32))

    for req, got in zip(reqs, served[1][0]):
        assert_teacher_forced(m.runners()[1], m.params_t, press[kt], req, got,
                              prepare=rerotated)


# --------------------------------------------------------------------- #
# Refusals


def test_capacity_refused_before_any_device_work(m):
    """A request over the static bound is refused at run(), and the engine
    serves normally afterwards."""
    big = make_requests(m.cfg_t.vocab_size, [(60, 4)], n_new=32)
    ok = make_requests(m.cfg_t.vocab_size, [(32, 4)], n_new=4)
    eng = kt.ServingEngine(m.runners()[1], m.params_t, n_slots=1, capacity=64,
                           question_bucket=4)
    from torch_serving_cases import requests

    with pytest.raises(ValueError, match="capacity"):
        eng.run(requests(kt.serving, big))
    assert_teacher_forced(m.runners()[1], m.params_t, None, ok[0],
                          eng.run(requests(kt.serving, ok))[0])


def _refusals(mod, tok):
    knorm = mod.KnormPress(0.5)
    return {
        "a CAM-style merge press": (dict(press=mod.CAMPress(
            base_press=mod.KnormPress(), compression_interval=4, target_size=24,
            hidden_states_buffer_size=4)), "CAM-style"),
        "another decode-time press": (dict(press=mod.DMSPress(
            press=mod.KnormPress(), threshold=-1.0, decoding=True)), "decode-phase"),
        "context_bucket with a multi-pass press": (dict(
            press=mod.KVzipPress(0.5), tokenizer=tok, context_bucket=16), "context_bucket"),
        "context_bucket with a post-mask press": (dict(
            press=mod.FastKVzipPress(compression_ratio=0.5), context_bucket=16),
            "context_bucket"),
        "KVzip without a tokenizer": (dict(press=mod.KVzipPress(0.5)), "tokenizer"),
        "context_chunk with a press that cannot chunk": (dict(
            press=mod.BlockPress(press=knorm), context_chunk=16), "ScorerPress"),
        "context_chunk with context_bucket": (dict(
            press=knorm, context_chunk=16, context_bucket=16), "mutually exclusive"),
        "interleave without context_chunk": (dict(press=knorm, interleave=True),
                                             "context_chunk"),
        "an unknown schedule": (dict(schedule="lifo"), "lifo"),
    }


@pytest.mark.parametrize("case", list(_refusals(kt, None)))
def test_refusals_as_jax(m, tok, case):
    kw, match = _refusals(kt, tok)[case]
    with pytest.raises(ValueError, match=match):
        kt.ServingEngine(m.runners()[1], m.params_t, n_slots=2, capacity=64, **kw)
    kw_j, _ = _refusals(jp, tok)[case]
    with pytest.raises(AssertionError):
        jserving.ServingEngine(m.runners()[0], m.params_j, n_slots=2, capacity=64, **kw_j)


def test_mesh_is_refused_until_the_parallel_layer(m):
    # Tensor-parallel serving takes a torch.distributed DeviceMesh
    # (tests/test_torch_serving_parallel.py); anything else is refused.
    with pytest.raises(TypeError, match="DeviceMesh"):
        kt.ServingEngine(m.runners()[1], m.params_t, mesh=object())
