"""The decode-time presses of kvpress_tpu_torch (DecodingPress,
CompressionRatioDecodingPress, PrefillDecodingPress) against the JAX package
on the same seeded inputs (CPU, float32, tiny config): ``decode_compress``
and ``decode_compress_quantized`` (int8, int4) on an interval hit and a skip,
at T = 1 and T = 12 (the registry's base presses Knorm, StreamingLLM, TOVA
and KeyDiff); ``Runner.forward`` decoding past compressions (logits and
lengths); ``KVPressPipeline`` with each press, over int8 and int4 KV, chunked,
bucketed, with an empty question and on a model with sliding layers; the
device and dtype of a prefill's press state.

Tolerances: kept rows, payloads, scales, states and lengths equal (a
compression gathers, so nothing is rounded; the kept order follows JAX's
``top_k``); logits within 1e-4; greedy answers and final per-layer lengths
equal.
"""

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.cache import quantize_kv as j_quantize_kv
import kvpress_tpu_torch as kt
from torch_decoding_cases import DECODING, Pipelines, both, decode_ctx

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)
B, S, LENGTH, BUF = 2, 64, 50, 16


@pytest.fixture(scope="module")
def pipes():
    return Pipelines.tiny()


@pytest.fixture(scope="module")
def runner(pipes):
    return kt.Runner.create(pipes.cfg_t, attn_impl="flash", decode_kernel=True, device="cpu")


UNIT = DECODING + ["compression_ratio_decoding"]


def _unit_press(name):
    """The press of ``name`` with a 16-row buffer, an interval of 3 and a
    target of 20 (of 121 tokens seen, at ratio 0.8: 24)."""
    def fix(p):
        kw = dict(hidden_states_buffer_size=BUF, compression_interval=3)
        if hasattr(p, "target_compression_ratio"):
            kw["target_compression_ratio"] = 0.8
        else:
            kw["target_size"] = 20
        return dataclasses.replace(p, **kw)
    return tuple(fix(p) for p in both(name))


def _state(hit: bool, seed: int, E: int):
    """A layer's ring in both packages: 5 of 16 rows filled; the interval
    (3) is hit on the next call, or not."""
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((B, BUF, E)).astype(np.float32)
    steps = 2 if hit else 0
    return ({"buffer": torch.from_numpy(buf), "buf_len": 5, "steps": steps},
            {"buffer": jnp.asarray(buf), "buf_len": jnp.int32(5), "steps": jnp.int32(steps)})


def _kv(seed, D, H):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, H, S, D)).astype(np.float32))


def _check_state(got, want):
    assert got["buf_len"] == int(want["buf_len"]) and got["steps"] == int(want["steps"])
    np.testing.assert_array_equal(got["buffer"].numpy(), np.asarray(want["buffer"]))


@pytest.mark.parametrize("T", [1, 12])
@pytest.mark.parametrize("hit", [True, False])
@pytest.mark.parametrize("name", UNIT)
def test_decode_compress_matches_jax(pipes, runner, name, hit, T):
    cfg = pipes.cfg_t
    jpress, tpress = _unit_press(name)
    ctx, jctx = decode_ctx(runner, pipes.params_t, pipes.params_j, pipes.cfg_j, T, 120, seed=T)
    k, v = _kv(3, cfg.head_dim, cfg.num_kv_heads)
    state, jstate = _state(hit, 4, cfg.hidden_size)
    mask = np.ones((B, cfg.num_kv_heads, S), bool)
    got = tpress.decode_compress(ctx, torch.from_numpy(k), torch.from_numpy(v), LENGTH,
                                 torch.from_numpy(mask), state)
    want = jpress.decode_compress(jctx, jnp.asarray(k), jnp.asarray(v), jnp.int32(LENGTH),
                                  jnp.asarray(mask), jstate)
    n = int(want[2])
    assert got[2] == n and (n < LENGTH) == hit
    np.testing.assert_array_equal(got[0].numpy()[:, :, :n], np.asarray(want[0])[:, :, :n])
    np.testing.assert_array_equal(got[1].numpy()[:, :, :n], np.asarray(want[1])[:, :, :n])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    _check_state(got[4], want[4])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("hit", [True, False])
@pytest.mark.parametrize("name", UNIT)
def test_decode_compress_quantized_matches_jax(pipes, runner, name, hit, bits):
    """The kept payload and scale rows are JAX's, bit for bit: a gather."""
    cfg = pipes.cfg_t
    jpress, tpress = _unit_press(name)
    ctx, jctx = decode_ctx(runner, pipes.params_t, pipes.params_j, pipes.cfg_j, 1, 120, seed=9)
    k, v = _kv(5, cfg.head_dim, cfg.num_kv_heads)
    (qk, ks), (qv, vs) = (j_quantize_kv(jnp.asarray(x), bits) for x in (k, v))
    state, jstate = _state(hit, 6, cfg.hidden_size)
    mask = np.ones((B, cfg.num_kv_heads, S), bool)
    t = lambda x: torch.from_numpy(np.array(x))
    got = tpress.decode_compress_quantized(ctx, t(qk), t(qv), t(ks), t(vs), bits, LENGTH,
                                           torch.from_numpy(mask), state)
    want = jpress.decode_compress_quantized(jctx, qk, qv, ks, vs, bits, jnp.int32(LENGTH),
                                            jnp.asarray(mask), jstate)
    n = int(want[4])
    assert got[4] == n and (n < LENGTH) == hit
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy()[:, :, :n], np.asarray(b)[:, :, :n])
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    _check_state(got[6], want[6])


def test_compression_ratio_target_reads_the_host_position(pipes, runner):
    """The target comes from ``ctx.last_position`` (no device read), with
    JAX's float32 rounding of the kept share."""
    press = kt.CompressionRatioDecodingPress(base_press=kt.KnormPress(),
                                             target_compression_ratio=0.3)
    ctx, _ = decode_ctx(runner, pipes.params_t, pipes.params_j, pipes.cfg_j, 1, 9, seed=0)
    ctx = dataclasses.replace(ctx, positions=None)
    want = int(np.maximum(1, (np.float32(10) * np.float32(1 - 0.3)).astype(np.int32)))
    assert press.target_value(ctx, 10) == want == 7


# ------------------------------------------------------------------ #
# The runner: decode steps past compressions


@pytest.mark.parametrize("kv", ["float32", "int8", "int4"])
def test_decode_logits_past_compressions_match_jax(pipes, runner, kv):
    """A prefill, a 6-token question and 10 one-token steps with
    DecodingPress(Knorm) compressing every 3 calls to 40: after a
    compression the length drops while the offset runs on, so each new
    token's RoPE position is the logical count, not its slot."""
    cfg_j, cfg_t = pipes.cfg_j, pipes.cfg_t
    jpress, tpress = (dataclasses.replace(p, compression_interval=3) for p in
                      both("decoding_knorm"))
    quant = dict(quantized=kv != "float32", kv_bits=4 if kv == "int4" else 8)
    ids = np.random.default_rng(11).permutation(np.arange(3, cfg_t.vocab_size))[:70][None]
    ids = ids.astype(np.int32)
    jr = kj.Runner.create(cfg_j, attn_impl="xla")
    _, jc, jstate = jr.prefill(pipes.params_j, jnp.asarray(ids[:, :54]), press=jpress,
                               max_size=80, dtype=jnp.float32, **quant)
    _, tc, tstate = runner.prefill(pipes.params_t, torch.from_numpy(ids[:, :54]).long(),
                                   press=tpress, max_size=80, **quant)
    jstep = jax.jit(lambda p, chunk, c, state: jr.forward(
        p, chunk, c, press=jpress, press_state=state, phase="decode", logits_last_only=True))
    steps = [ids[:, 54:60]] + [ids[:, t:t + 1] for t in range(60, 70)]
    lengths = []
    for chunk in steps:
        jl, jc, jstate = jstep(pipes.params_j, jnp.asarray(chunk), jc, jstate)
        tl, tc, tstate = runner.forward(pipes.params_t, torch.from_numpy(chunk).long(), tc,
                                        press=tpress, press_state=tstate, phase="decode",
                                        logits_last_only=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert tc.length.tolist() == np.asarray(jc.length).tolist()
        assert int(tc.offset) == int(jc.offset)
        lengths.append(tc.length.tolist())
    assert min(l[0] for l in lengths) == 40 and int(tc.offset) == 70


def test_prefill_state_on_the_runner_device_and_dtype(pipes, runner):
    """``Runner.prefill`` hands ``init_state`` the cache's dtype and the
    runner's device."""
    seen = {}

    class Recording(kt.DecodingPress):
        def init_state(self, cfg, batch, seq_len, dtype=None, device=None):
            seen.update(dtype=dtype, device=device)
            return super().init_state(cfg, batch, seq_len, dtype, device)

    ids = torch.arange(3, 43)[None]
    _, _, state = runner.prefill(pipes.params_t, ids, press=Recording(base_press=kt.KnormPress()))
    assert seen == dict(dtype=pipes.params_t.dtype, device=runner.device)
    assert len(state) == pipes.cfg_t.num_layers
    assert state[0]["buffer"].dtype == torch.float32 and state[0]["buffer"].device == runner.device
    dms = kt.DMSPress(kt.KnormPress(), decoding=True).init_state(pipes.cfg_t, 1, 8,
                                                                 device=runner.device)
    assert dms[0]["scores"].device == runner.device


# ------------------------------------------------------------------ #
# Pipelines


def _same(out, n_tokens=24):
    assert out["torch"] == out["jax"], out
    answer, lengths = out["torch"]
    assert len(answer.split()) == n_tokens, answer
    return lengths


@pytest.mark.parametrize("name", UNIT + ["prefill_decoding_snapkv", "prefill_decoding_none"])
def test_pipeline_same_answers_and_lengths_as_jax(pipes, name):
    lengths = _same(pipes.run(*both(name)))
    if name.startswith("decoding") or name == "prefill_decoding_none":
        assert all(40 <= n < 44 for n in lengths), lengths      # [target, target + interval)
    if name == "prefill_decoding_snapkv":
        assert all(24 <= n < 28 for n in lengths), lengths


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", DECODING)
def test_pipeline_quantized_same_answers_as_jax(pipes, name, bits):
    lengths = _same(pipes.run(*both(name), quantized=True, kv_bits=bits))
    assert all(40 <= n < 44 for n in lengths), lengths


@pytest.mark.parametrize("option", ["context_chunk", "context_bucket", "empty question"])
def test_pipeline_chunked_bucketed_and_empty_question(pipes, option):
    """Chunked prefill leaves a decode-time press's prefill whole and makes
    its state after the last chunk; the bucketed prefill takes it as JAX's;
    an empty question starts from the prefill's logits and state."""
    kw = {"context_chunk": dict(context_chunk=16), "context_bucket": dict(context_bucket=32),
          "empty question": dict(question="")}[option]
    _same(pipes.run(*both("decoding_knorm"), **kw))


def test_pipeline_on_sliding_layers():
    """The sliding layers keep their whole length; the global one
    compresses, as in JAX."""
    pipes = Pipelines.tiny(dict(num_layers=3, sliding_window=8,
                                layer_is_sliding=(True, False, True)))
    lengths = _same(pipes.run(*both("decoding_knorm")))
    assert lengths[0] == lengths[2] == 60 + 4 + 23 and 40 <= lengths[1] < 44


def test_prefill_decoding_press_is_refused_through_chunked_prefill(pipes, runner):
    """JAX's assertion refuses it: its prefilling press would compress in a
    layer body that the chunked prefill does not run."""
    _, tpress = both("prefill_decoding_snapkv")
    with pytest.raises(TypeError, match="PrefillDecodingPress"):
        runner.prefill_chunked(pipes.params_t, torch.arange(3, 43)[None], press=tpress,
                               chunk_size=16)
    jpress, _ = both("prefill_decoding_snapkv")
    with pytest.raises(AssertionError):
        kj.Runner.create(pipes.cfg_j).prefill_chunked(
            pipes.params_j, jnp.arange(3, 43)[None], press=jpress, chunk_size=16)
