"""The continuous-batching ServingEngine of kvpress_tpu_torch against the JAX
engine (kvpress_tpu/serving.py) on the same weights and requests (CPU,
float32, tiny configs), one case per serving contract of
tests/test_serving.py but tensor parallel: equal greedy answers, equal
stats, equal host lengths and offsets, live K/V within 1e-5 of their scale
and equal keep-masks (tests/torch_serving_cases.py); each served answer also
teacher-forced against the port's single-request path (JAX's tie_eps, 2e-3).

The port's engine runs on the dense route (the JAX engine's arithmetic) for
the comparisons with JAX; its decode-kernel route (``decode_attention``,
whose plain version runs here) is held against the dense route, step and
engine, and against the single-request path on the same runner."""

import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu import presses as jp
import kvpress_tpu_torch as kt
from kvpress_tpu_torch import serving as tserving
from torch_serving_cases import (Models, assert_same, assert_teacher_forced, make_requests,
                                 serve_both, serve_torch, single_request)

torch.set_num_threads(2)

ENGINE = dict(n_slots=2, capacity=64, question_bucket=4)


@pytest.fixture(scope="module")
def m():
    return Models.tiny()


@pytest.fixture(scope="module")
def knorm_run(m):
    """Five requests through two slots under Knorm(0.5) on both sides."""
    reqs = make_requests(m.cfg_t.vocab_size, [(32, 4), (48, 8), (24, 4), (40, 4), (32, 8)])
    return reqs, serve_both(m, reqs, kj.KnormPress(0.5), kt.KnormPress(0.5), fetch_lag=2,
                            **ENGINE)


def _free_run(m, press, req, n):
    """The single-request path's greedy tokens (no EOS)."""
    runner = m.runners()[1]
    logits, cache = single_request(runner, m.params_t, press, req, n)
    out = []
    for _ in range(n):
        out.append(int(torch.argmax(logits[0, -1])))
        logits, cache, _ = runner.forward(m.params_t, torch.tensor([[out[-1]]]), cache,
                                          logits_last_only=True)
    return out


def test_more_requests_than_slots_match_jax_and_single_request(m, knorm_run):
    reqs, (served_j, served_t) = knorm_run
    assert_same(served_j, served_t)
    for req, got in zip(reqs, served_t[0]):
        assert len(got) == req[2]
        assert_teacher_forced(m.runners()[1], m.params_t, kt.KnormPress(0.5), req, got)


def test_slot_reuse_without_press_matches_jax(m):
    """8 requests through 2 slots: retirement and re-admission."""
    reqs = make_requests(m.cfg_t.vocab_size, [(16 + 4 * i, 4) for i in range(8)], n_new=4)
    served = serve_both(m, reqs, fetch_lag=3, **ENGINE)
    assert_same(*served)
    for req, got in zip(reqs, served[1][0]):
        assert_teacher_forced(m.runners()[1], m.params_t, None, req, got)


def test_staggered_budgets_match_jax(m):
    """Budgets out of lockstep: a re-admission's window overlaps live decode
    steps, whose dead lane must keep the staged first token."""
    rng = np.random.default_rng(3)
    reqs = [(rng.permutation(m.cfg_t.vocab_size)[:24 + 4 * i].tolist(), [], b)
            for i, b in enumerate([4, 9, 5, 8, 3, 7])]
    served = serve_both(m, reqs, fetch_lag=3, **ENGINE)
    assert_same(*served)
    for req, got in zip(reqs, served[1][0]):
        assert len(got) == req[2]
        assert_teacher_forced(m.runners()[1], m.params_t, None, req, got)


def test_eos_trims_the_tokens_issued_past_it(m):
    req = make_requests(m.cfg_t.vocab_size, [(32, 4)], n_new=12)[0]
    free = _free_run(m, None, req, 12)
    eos = free[3]
    served = serve_both(m, [req], fetch_lag=4, eos_ids=(eos,), **ENGINE)
    assert_same(*served)
    assert served[1][0][0] == free[:free.index(eos) + 1]
    assert len(served[1][0][0]) < 12


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_slots_match_jax(m, bits):
    reqs = make_requests(m.cfg_t.vocab_size, [(32, 4), (24, 4)], n_new=5)
    served = serve_both(m, reqs, quantized=True, kv_bits=bits, **ENGINE)
    assert_same(*served)
    assert served[1][1].sc.keys.dtype == (torch.int8 if bits == 8 else torch.uint8)
    for req, got in zip(reqs, served[1][0]):
        assert_teacher_forced(m.runners()[1], m.params_t, None, req, got, quantized=True,
                              kv_bits=bits)


def test_int8_weights_match_jax(m):
    """The slot step's matmuls read the per-channel scales: the same int8
    weights on both sides (JAX's, carried over)."""
    import jax

    from kvpress_tpu.models.llama import quantize_params_int8

    qj = quantize_params_int8(m.params_j)
    qt = kt.params_from_jax(jax.tree_util.tree_map(np.asarray, qj), m.cfg_t, device="cpu",
                            dtype=torch.float32)
    q = Models(m.cfg_j, m.cfg_t, qj, qt)
    reqs = make_requests(m.cfg_t.vocab_size, [(32, 4), (40, 8)], n_new=5)
    served = serve_both(q, reqs, kj.KnormPress(0.5), kt.KnormPress(0.5), fetch_lag=2, **ENGINE)
    assert_same(*served)
    for req, got in zip(reqs, served[1][0]):
        assert_teacher_forced(q.runners()[1], qt, kt.KnormPress(0.5), req, got)


def test_sliding_window_model_matches_jax():
    """Interleaved sliding and global layers: the per-slot window on the
    sliding layers, their own RoPE base, the press skipping them."""
    s = Models.sliding()
    reqs = make_requests(s.cfg_t.vocab_size, [(32, 4), (24, 4), (40, 4)])
    served = serve_both(s, reqs, kj.KnormPress(0.5), kt.KnormPress(0.5), fetch_lag=2, **ENGINE)
    assert_same(*served)
    for req, got in zip(reqs, served[1][0]):
        assert_teacher_forced(s.runners()[1], s.params_t, kt.KnormPress(0.5), req, got)
    # the decode-kernel route's window is folded into the mask, per slot
    flash = kt.Runner.create(s.cfg_t, attn_impl="flash", decode_kernel=True, device="cpu")
    got, eng = serve_torch(flash, s.params_t, reqs, press=kt.KnormPress(0.5), fetch_lag=2,
                           **ENGINE)
    for req, answer in zip(reqs, got):
        assert_teacher_forced(flash, s.params_t, kt.KnormPress(0.5), req, answer)


# --------------------------------------------------------------------- #
# Decode-time compression per slot


def _decoding(mod, **kw):
    return mod.DecodingPress(base_press=mod.KnormPress(), hidden_states_buffer_size=4, **kw)


@pytest.mark.parametrize("quantized", [False, True])
def test_decoding_press_that_never_binds_is_exact(m, quantized):
    """A target the pool never reaches: answers and pool equal the pressless
    engine's."""
    reqs = make_requests(m.cfg_t.vocab_size, [(32, 4), (24, 4), (40, 4)])
    rt = m.runners()[1]
    plain = serve_torch(rt, m.params_t, reqs, quantized=quantized, **ENGINE)
    served = serve_both(m, reqs, _decoding(jp, compression_interval=3, target_size=4096),
                        _decoding(kt, compression_interval=3, target_size=4096),
                        quantized=quantized, **ENGINE)
    assert_same(*served)
    assert served[1][0] == plain[0]
    np.testing.assert_array_equal(served[1][1].sc.lengths.numpy(), plain[1].sc.lengths.numpy())


def test_prefill_decoding_press_compresses_each_slot_as_jax(m):
    """Knorm(0.25) at admission, DecodingPress(target 24, interval 4) in the
    step: staggered slots compress at their own steps; every length within
    target + interval + fetch_lag."""
    reqs = make_requests(m.cfg_t.vocab_size, [(40, 4), (32, 4), (48, 4)], n_new=10)
    press = {mod: mod.PrefillDecodingPress(
        prefilling_press=mod.KnormPress(compression_ratio=0.25),
        decoding_press=_decoding(mod, compression_interval=4, target_size=24)) for mod in (jp, kt)}
    served = serve_both(m, reqs, press[jp], press[kt], fetch_lag=2, **ENGINE)
    assert_same(*served)
    lengths = served[1][1].sc.lengths
    assert (lengths <= 24 + 4 + 2).all(), lengths
    assert all(len(a) == 10 for a in served[1][0])


@pytest.mark.parametrize("bits", [8, 4])
def test_decoding_press_over_quantized_slots_matches_jax(m, bits):
    """Payload and scales gathered per slot (scored on the dequantized
    values)."""
    reqs = make_requests(m.cfg_t.vocab_size, [(40, 4), (32, 4)], n_new=8)
    served = serve_both(m, reqs, _decoding(jp, compression_interval=3, target_size=32),
                        _decoding(kt, compression_interval=3, target_size=32), quantized=True,
                        kv_bits=bits, **ENGINE)
    assert_same(*served)
    assert (served[1][1].sc.lengths <= 32 + 3 + 4).all()


def test_compression_ratio_decoding_press_matches_jax(m):
    """Per-slot targets from each slot's own position (target_value_vec)."""
    reqs = make_requests(m.cfg_t.vocab_size, [(40, 4), (24, 4), (32, 4)], n_new=12)
    press = {mod: mod.CompressionRatioDecodingPress(
        base_press=mod.KnormPress(), compression_interval=3, hidden_states_buffer_size=4,
        target_compression_ratio=0.4) for mod in (jp, kt)}
    served = serve_both(m, reqs, press[jp], press[kt], fetch_lag=2, **ENGINE)
    assert_same(*served)
    assert served[1][1].sc.lengths.max() < 40


@pytest.mark.parametrize("name", ["decoding", "ratio"])
def test_target_value_vec_matches_jax(name):
    import jax.numpy as jnp

    kw = dict(compression_interval=4, hidden_states_buffer_size=4)
    make = {"decoding": lambda mod: mod.DecodingPress(base_press=mod.KnormPress(),
                                                      target_size=24, **kw),
            "ratio": lambda mod: mod.CompressionRatioDecodingPress(
                base_press=mod.KnormPress(), target_compression_ratio=0.37, **kw)}[name]
    pos = np.array([0, 1, 2, 7, 99, 1000, 32767, 65599], np.int32)
    length = np.array([1, 2, 3, 8, 50, 400, 16000, 9], np.int32)
    want = np.asarray(make(jp).target_value_vec(jnp.asarray(pos), jnp.asarray(length)))
    got = make(kt).target_value_vec(torch.from_numpy(pos), torch.from_numpy(length))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(NotImplementedError):
        from kvpress_tpu_torch.presses.decoding import BudgetDecodingPress

        BudgetDecodingPress(base_press=kt.KnormPress(0.5)).target_value_vec(
            torch.from_numpy(pos), torch.from_numpy(length))


# --------------------------------------------------------------------- #
# Scheduling, streaming, sampling


def test_sjf_and_priority_orders_match_jax(m):
    """sjf admits the smallest budgets first, priority the highest priority
    (ties by submission); answers are those of fifo."""
    rng = np.random.default_rng(5)
    reqs = [(rng.permutation(m.cfg_t.vocab_size)[:24 + 4 * i].tolist(), [], b, dict(priority=p))
            for i, (b, p) in enumerate(zip([9, 3, 7, 4, 8, 5], [0, 0, 2, 0, 5, 0]))]
    fifo = serve_torch(m.runners()[1], m.params_t, reqs, fetch_lag=2, **ENGINE)[0]
    for schedule in ("sjf", "priority"):
        first = {}
        served = serve_both(m, reqs, fetch_lag=2, schedule=schedule,
                            run_kw=dict(on_token=lambda i, t, n: n == 1 and first.setdefault(
                                len(first), i)), **ENGINE)
        assert_same(*served)
        assert served[1][0] == fifo
        order = [first[k] for k in sorted(first)]
        # JAX's admissions first, then the port's: the same order twice
        assert order[:6] == order[6:]
        if schedule == "sjf":
            assert order[:2] == [1, 3]
        else:
            assert order[:2] == [4, 2]


def test_streaming_equals_the_answers(m):
    """on_token delivers the first token at admission and every read token
    up to an EOS, never one issued past it."""
    reqs = make_requests(m.cfg_t.vocab_size, [(32, 4), (40, 8), (24, 4)], n_new=8)
    eos = _free_run(m, kt.KnormPress(0.5), reqs[0], 8)[3]
    streamed = {}

    def on_token(idx, tok, n):
        streamed.setdefault(idx, []).append(tok)
        assert n == len(streamed[idx])

    answers, _ = serve_torch(m.runners()[1], m.params_t, reqs, run_kw=dict(on_token=on_token),
                             press=kt.KnormPress(0.5), fetch_lag=3, eos_ids=(eos,), **ENGINE)
    assert streamed == {i: a for i, a in enumerate(answers)}
    assert any(eos in a for a in answers)


def test_sampling(m):
    """Temperature 1e-4 gives the greedy answers; a seed reproduces its
    draws; two seeds differ (18 draws at temperature 2)."""
    reqs = make_requests(m.cfg_t.vocab_size, [(32, 4), (40, 4), (24, 0)])
    rt = m.runners()[1]
    common = dict(press=kt.KnormPress(0.5), fetch_lag=2, **ENGINE)
    greedy = serve_torch(rt, m.params_t, reqs, **common)[0]
    cold = serve_torch(rt, m.params_t, reqs, do_sample=True, temperature=1e-4, seed=7,
                       **common)[0]
    assert cold == greedy

    def hot(seed):
        return serve_torch(rt, m.params_t, reqs, do_sample=True, temperature=2.0, top_p=0.95,
                           seed=seed, **common)[0]

    a, b, c = hot(1), hot(1), hot(2)
    assert a == b
    assert a != c
    assert [len(x) for x in a] == [6, 6, 6]


# --------------------------------------------------------------------- #
# The decode-kernel route


def test_slot_attention_kernel_route_matches_dense_route():
    """One layer's slot attention over a ragged pool (per-slot lengths from
    1 to C, keep bits, a window folded into the mask): decode_attention (its
    plain version here) against gqa_attention / quant_gqa_attention with the
    per-slot bias, bf16-free float32, int8 and int4."""
    cfg = kt.tiny_config()
    rng = np.random.default_rng(0)
    N, H, C, D = 5, cfg.num_kv_heads, 40, cfg.head_dim
    q = torch.from_numpy(rng.standard_normal((N, cfg.num_heads, 1, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((N, H, C, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((N, H, C, D)).astype(np.float32))
    clen = torch.tensor([0, 5, 17, 38, 39])
    k_slot = torch.arange(C)
    keep = torch.from_numpy(rng.random((N, H, C)) < 0.7)
    keep[torch.arange(N), :, clen] = True
    kernel = kt.Runner.create(cfg, attn_impl="flash", decode_kernel=True, device="cpu")
    dense = kt.Runner.create(cfg, device="cpu")
    for window in (None, 8):
        allowed = k_slot[None] <= clen[:, None]
        if window:
            allowed &= k_slot[None] > clen[:, None] - window
        allowed = keep & allowed[:, None]
        length = int(clen.max()) + 1
        for bits in (None, 8, 4):
            kk, vv, ks, vs = k, v, None, None
            if bits:
                (kk, ks), (vv, vs) = kt.quantize_kv(k, bits), kt.quantize_kv(v, bits)
            got = tserving._slot_attention(kernel, q, kk, vv, ks, vs, allowed, length, bits)
            want = tserving._slot_attention(dense, q, kk, vv, ks, vs, allowed, length, bits)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_kernel_route_engine_matches_dense_route(m, knorm_run):
    """The engine on a runner with the decode kernel: the dense route's
    answers and pool, and each answer teacher-forced on that runner."""
    reqs, (_, (answers, dense_eng)) = knorm_run
    flash = kt.Runner.create(m.cfg_t, attn_impl="flash", decode_kernel=True, device="cpu")
    got, eng = serve_torch(flash, m.params_t, reqs, press=kt.KnormPress(0.5), fetch_lag=2,
                           **ENGINE)
    for req, answer in zip(reqs, got):
        assert_teacher_forced(flash, m.params_t, kt.KnormPress(0.5), req, answer)
    assert got == answers
    np.testing.assert_array_equal(eng.sc.lengths.numpy(), dense_eng.sc.lengths.numpy())


def test_dead_lane_at_capacity_writes_nothing(m):
    """A dead slot whose length is the capacity (a dropped admission): the
    step's write there is dropped (as JAX's scatter drops it) and every live
    slot's keys stay."""
    rt = m.runners()[1]
    eng = kt.ServingEngine(rt, m.params_t, **ENGINE)
    eng.sc.lengths[:, 0] = eng.capacity
    eng.sc.lengths[:, 1] = 10
    eng.sc.keys.normal_()
    before = eng.sc.keys.clone()
    eng.live[1] = True
    eng._step()
    assert eng.sc.lengths[:, 0].tolist() == [eng.capacity] * m.cfg_t.num_layers
    assert eng.sc.lengths[:, 1].tolist() == [11] * m.cfg_t.num_layers
    assert torch.equal(eng.sc.keys[:, 0], before[:, 0])
    assert torch.equal(eng.sc.keys[:, 1, :, :10], before[:, 1, :, :10])
    assert not torch.equal(eng.sc.keys[:, 1, :, 10], before[:, 1, :, 10])
