"""CAMPress and the decode half of DMSPress in kvpress_tpu_torch against the
JAX package on the same seeded inputs (CPU, float32, tiny config): CAM's
``decode_compress`` on an interval hit (its attention sum, the Bernoulli
merge with JAX's draws handed to the port, the kept slots) at T = 1 and
T = 12 over the registry's three base presses, and after a resize (the sum
restarts); DMS's ``decode_compress`` for T = 1, T < W and T > W with the
ring full and not, against JAX and against a token-by-token copy of JAX's
loop; ``KVPressPipeline`` with the registry's ``cam_*`` presses (CAM over
int8 KV too: the dense route requantizes the layer every step) and DMS over
Knorm and KVzap, one-shot, over int8 KV and chunked; the refusals.

Tolerances: kept keys, masks, rings, counts and lengths equal; merged
values and the attention sum within 1e-5 (float32 scatter-adds and sums in
another order than XLA's); greedy answers and final per-layer lengths
equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
import kvpress_tpu_torch as kt
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
from torch_decoding_cases import (CAM, DMS, MERGE_TOL, Pipelines, both, decode_ctx,
                                  use_jax_uniforms)

torch.set_num_threads(2)

B, S, LENGTH = 2, 64, 50


@pytest.fixture(scope="module")
def pipes():
    return Pipelines.tiny()


@pytest.fixture(scope="module")
def runner(pipes):
    return kt.Runner.create(pipes.cfg_t, attn_impl="flash", decode_kernel=True, device="cpu")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ #
# CAM


@pytest.mark.parametrize("restart", [False, True])
@pytest.mark.parametrize("T", [1, 12])
@pytest.mark.parametrize("name", CAM)
def test_cam_decode_compress_matches_jax(pipes, runner, monkeypatch, name, T, restart):
    """An interval hit at a length of 50 and a target of 20: the kept slots
    and keys equal JAX's, the merged values within 1e-5, with JAX's draws.
    ``restart``: the sum was made for another buffer size, so both restart
    it from this call's attention."""
    use_jax_uniforms(monkeypatch)
    cfg = pipes.cfg_t
    H, E = cfg.num_kv_heads, cfg.hidden_size
    jpress, tpress = (dataclasses.replace(p, target_size=20, compression_interval=6,
                                          hidden_states_buffer_size=16) for p in both(name))
    ctx, jctx = decode_ctx(runner, pipes.params_t, pipes.params_j, pipes.cfg_j, T, 120, seed=T)
    k, v = _rand(1, B, H, S, cfg.head_dim), _rand(2, B, H, S, cfg.head_dim)
    attn = np.abs(_rand(3, B, H, S - 8 if restart else S)) * 0.05
    buf = _rand(4, B, 16, E)
    mask = np.ones((B, H, S), bool)
    state = {"buffer": torch.from_numpy(buf), "buf_len": 7, "steps": 5,
             "attn_sum": torch.from_numpy(attn), "rng_step": 2}
    jstate = {"buffer": jnp.asarray(buf), "buf_len": jnp.int32(7), "steps": jnp.int32(5),
              "attn_sum": jnp.asarray(attn), "rng_step": jnp.int32(2)}
    got = tpress.decode_compress(ctx, torch.from_numpy(k), torch.from_numpy(v), LENGTH,
                                 torch.from_numpy(mask), state)
    want = jpress.decode_compress(jctx, jnp.asarray(k), jnp.asarray(v), jnp.int32(LENGTH),
                                  jnp.asarray(mask), jstate)
    n = int(want[2])
    assert got[2] == n == 20
    np.testing.assert_array_equal(got[0].numpy()[:, :, :n], np.asarray(want[0])[:, :, :n])
    np.testing.assert_allclose(got[1].numpy()[:, :, :n], np.asarray(want[1])[:, :, :n],
                               **MERGE_TOL)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    st, jst = got[4], want[4]
    np.testing.assert_allclose(st["attn_sum"].numpy(), np.asarray(jst["attn_sum"]), **MERGE_TOL)
    np.testing.assert_array_equal(st["buffer"].numpy(), np.asarray(jst["buffer"]))
    assert (st["buf_len"], st["steps"], st["rng_step"]) == (0, 0, 3) == tuple(
        int(jst[f]) for f in ("buf_len", "steps", "rng_step"))
    # some kept value took a merge: the kept keys' own values do not all match
    kept_v = np.take_along_axis(v, _kept_slots(k, got[0].numpy(), n)[..., None], axis=2)
    assert not np.allclose(got[1].numpy()[:, :, :n], kept_v)


def _kept_slots(k, kept_keys, n):
    """The slot of each kept key row (keys are distinct random rows)."""
    return np.stack([[[int(np.flatnonzero((k[b, h] == kept_keys[b, h, i]).all(-1))[0])
                       for i in range(n)] for h in range(k.shape[1])] for b in range(k.shape[0])])


def test_cam_skip_accumulates_only(pipes, runner):
    """Between hits CAM sums the last query's attention over the valid
    slots (the group mean) and changes nothing else."""
    _, tpress = both("cam_knorm")
    cfg = pipes.cfg_t
    ctx, _ = decode_ctx(runner, pipes.params_t, pipes.params_j, pipes.cfg_j, 1, 49, seed=7)
    k, v = torch.from_numpy(_rand(1, B, 2, S, cfg.head_dim)), torch.from_numpy(
        _rand(2, B, 2, S, cfg.head_dim))
    state = tpress.init_state(cfg, B, S)[1]
    mask = torch.ones((B, 2, S), dtype=torch.bool)
    nk, nv, n, nm, st = tpress.decode_compress(ctx, k, v, LENGTH, mask, state)
    assert nk is k and nv is v and nm is mask and n == LENGTH
    assert (st["steps"], st["rng_step"], st["buf_len"]) == (1, 1, 1)
    np.testing.assert_allclose(st["attn_sum"].sum(-1).numpy(), np.ones((B, 2)), atol=1e-6)
    assert not st["attn_sum"][..., LENGTH:].any()


def test_cam_draws_are_seeded_by_layer_and_step():
    press = kt.CAMPress(base_press=kt.KnormPress())
    draw = lambda l, s: press.draw_uniforms(l, s, (2, 3), torch.device("cpu"))
    assert torch.equal(draw(1, 4), draw(1, 4))
    assert not torch.equal(draw(1, 4), draw(1, 5)) and not torch.equal(draw(1, 4), draw(0, 4))
    assert ((draw(0, 1) >= 0) & (draw(0, 1) < 1)).all()


# ------------------------------------------------------------------ #
# DMS


def _token_loop(press, ctx, keys, values, length, mask, state):
    """JAX's decode loop, token by token, in torch."""
    W, T, S_ = press.sliding_window_size, ctx.hidden.shape[1], keys.shape[2]
    scores = press.press.score(dataclasses.replace(ctx, attn_probs=None),
                               keys[:, :, length - T:length],
                               values[:, :, length - T:length]).float()
    buf, count, first = state["scores"].clone(), state["count"], state["first_slot"]
    mask = mask.clone()
    for t in range(T):
        full = count >= W
        if full:
            if first < S_:
                mask[..., first] &= ~(buf[..., 0] < press.threshold)
            buf = torch.roll(buf, -1, dims=-1)
        buf[..., W - 1 if full else count] = scores[..., t]
        first += int(full)
        count = min(count + 1, W)
    return mask, {"scores": buf, "count": count, "first_slot": first}


# (T, count): one token into a full ring; a few into a ring with room
# left; more than W into a full ring and into one that is not.
DMS_CASES = [(1, 16), (1, 3), (5, 14), (20, 16), (20, 3)]


@pytest.mark.parametrize("T,count", DMS_CASES)
@pytest.mark.parametrize("name", DMS)
def test_dms_decode_compress_matches_jax_and_the_token_loop(pipes, runner, name, T, count):
    cfg = pipes.cfg_t
    H = cfg.num_kv_heads
    jpress, tpress = both(name)
    ctx, jctx = decode_ctx(runner, pipes.params_t, pipes.params_j, pipes.cfg_j, T, 120, seed=T)
    # Knorm's scores near its threshold: keys of norm about 3.86
    k, v = _rand(5, B, H, S, cfg.head_dim), _rand(6, B, H, S, cfg.head_dim)
    ring = _rand(7, B, H, 16) * (0.5 if name == "dms_kvzap_decoding" else 3.86 / 4) - (
        0.0 if name == "dms_kvzap_decoding" else 3.86)
    first = LENGTH - T - count
    mask = np.random.default_rng(8).random((B, H, S)) > 0.2
    state = {"scores": torch.from_numpy(ring), "count": count, "first_slot": first}
    jstate = {"scores": jnp.asarray(ring), "count": jnp.int32(count),
              "first_slot": jnp.int32(first)}
    got = tpress.decode_compress(ctx, torch.from_numpy(k), torch.from_numpy(v), LENGTH,
                                 torch.from_numpy(mask), state)
    want = jpress.decode_compress(jctx, jnp.asarray(k), jnp.asarray(v), jnp.int32(LENGTH),
                                  jnp.asarray(mask), jstate)
    loop_mask, loop_state = _token_loop(tpress, ctx, torch.from_numpy(k), torch.from_numpy(v),
                                        LENGTH, torch.from_numpy(mask), state)
    assert got[2] == LENGTH
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert torch.equal(got[3], loop_mask)
    assert torch.equal(got[4]["scores"], loop_state["scores"])
    assert (got[4]["count"], got[4]["first_slot"]) == (loop_state["count"],
                                                      loop_state["first_slot"]) == (
        int(want[4]["count"]), int(want[4]["first_slot"]))
    np.testing.assert_allclose(got[4]["scores"].numpy(), np.asarray(want[4]["scores"]),
                               atol=1e-6, rtol=1e-6)
    evicted = int((got[3] != torch.from_numpy(mask)).sum())
    assert evicted == 0 if T + count <= 16 else evicted > 0


# ------------------------------------------------------------------ #
# Pipelines


def _same(out, n_tokens=24):
    assert out["torch"] == out["jax"], out
    answer, lengths = out["torch"]
    assert len(answer.split()) == n_tokens, answer
    return lengths


def _recording_cam(press, ties: list):
    """``press`` that appends to ``ties`` the decode call (0: the question
    forward) of each compression of layer 0 that ranks two merge candidates
    whose scores lie within float32 rounding of each other (1e-6 relative):
    their ranks, and so the draws they take, follow each side's rounding.
    JAX's float32 jitter (slot * 1e-12) does not part them. A repeated
    token's keys in layer 0 score so under Knorm: the same pre-RoPE key,
    rotated to two positions."""
    calls = [0]

    class Recording(type(press)):
        def decode_compress(self, ctx, *args):
            out = super().decode_compress(ctx, *args)
            if ctx.layer_idx == 0:
                calls[0] += 1
            return out

        def merge(self, keys, values, length, steps, scores, kept, attn_sum, uniforms):
            S = scores.shape[1]
            evicted = torch.arange(S) < length
            evicted[kept.flatten()] = False       # batch 1 in the pipeline
            top = torch.sort(torch.where(evicted, scores, float("-inf")), dim=-1,
                             descending=True).values[:, :uniforms.shape[-1] + 1]
            near = (top[:, :-1] - top[:, 1:]).abs() <= 1e-6 * top[:, :-1].abs()
            if bool((near & torch.isfinite(top[:, 1:])).any()):
                ties.append(calls[0])
            return super().merge(keys, values, length, steps, scores, kept, attn_sum, uniforms)

    return Recording(**{f.name: getattr(press, f.name) for f in dataclasses.fields(press)})


@pytest.mark.parametrize("name,kv", [("cam_knorm", "float32"), ("cam_streaming_llm", "float32"),
                                     ("cam_tova", "float32"), ("cam_knorm", "int8")])
def test_cam_pipeline_same_answers_as_jax(pipes, monkeypatch, name, kv):
    """With JAX's draws: the same answer up to the first compression that
    ranks two merge candidates tied within rounding (``_recording_cam``),
    and the whole answer when none does; the same final lengths. Over int8
    KV CAM takes the dense route: the layer is dequantized, merged and
    requantized every step."""
    use_jax_uniforms(monkeypatch)
    quant = {} if kv == "float32" else dict(quantized=True, kv_bits=8)
    jpress, tpress = both(name)
    ties = []
    out = pipes.run(jpress, _recording_cam(tpress, ties), **quant)
    (got, lengths), (want, want_lengths) = out["torch"], out["jax"]
    n = len(want.split()) if not ties else ties[0] + 1
    assert got.split()[:n] == want.split()[:n] and n > 4, (out, ties)
    assert lengths == want_lengths and all(40 <= l < 44 for l in lengths), out
    assert len(got.split()) == 24


@pytest.mark.parametrize("option", ["one-shot", "int8 KV", "context_chunk"])
@pytest.mark.parametrize("name", DMS)
def test_dms_decoding_pipeline_same_answers_as_jax(pipes, name, option):
    kw = {"one-shot": {}, "int8 KV": dict(quantized=True, kv_bits=8),
          "context_chunk": dict(context_chunk=16)}[option]
    lengths = _same(pipes.run(*both(name), **kw))
    assert lengths == [60 + 4 + 23] * pipes.cfg_t.num_layers        # a mask press


def test_dms_decoding_pipeline_clears_bits(pipes):
    """The decode steps clear mask bits as slots leave the window."""
    seen = []

    @dataclasses.dataclass(frozen=True)
    class Recording(kt.Runner):
        def forward(self, params, ids, cache, *args, **kw):
            out = super().forward(params, ids, cache, *args, **kw)
            if kw.get("phase") == "decode":
                seen.append(float(kt.masked_fraction(out[1])))
            return out

    base = kt.Runner.create(pipes.cfg_t, attn_impl="flash", decode_kernel=True, device="cpu")
    pipe = kt.KVPressPipeline(Recording(**{f.name: getattr(base, f.name)
                                           for f in dataclasses.fields(base)}),
                              pipes.params_t, pipes.tok)
    context, question = pipes.context()
    pipe(context, question=question, press=both("dms_knorm_decoding")[1], max_new_tokens=24)
    assert seen[-1] > seen[0] > 0


PRESSES_OF_ONE_QUESTION = ["decoding_knorm", "cam_knorm", "dms_knorm_decoding",
                           "prefill_decoding_snapkv"]


@pytest.mark.parametrize("name", PRESSES_OF_ONE_QUESTION)
def test_several_questions_are_refused(pipes, name):
    """A decode-time press rewrites slots below the rolled-back length: one
    question only, in both packages."""
    context, _ = pipes.context()
    jpress, tpress = both(name)
    tpipe = kt.KVPressPipeline(kt.Runner.create(pipes.cfg_t, device="cpu"), pipes.params_t,
                               pipes.tok)
    with pytest.raises(ValueError, match="single question"):
        tpipe(context, questions=["a ?", "b ?"], press=tpress, max_new_tokens=2)
    jpipe = JaxPipeline(kj.Runner.create(pipes.cfg_j), pipes.params_j, pipes.tok)
    with pytest.raises(ValueError, match="single question"):
        jpipe(context, questions=["a ?", "b ?"], press=jpress, max_new_tokens=2)


def test_dms_compact_decoding_is_refused():
    with pytest.raises(ValueError, match="prefill-only"):
        kt.DMSPress(kt.KnormPress(), decoding=True, compact=True)
    with pytest.raises(AssertionError):
        kj.DMSPress(kj.KnormPress(), decoding=True, compact=True)
