"""Distributed decode of the port over a 2-rank ("seq",) mesh against the JAX
package, and ``DecodingPress(..., sync_state=)``: the mirrors of
tests/test_context_prefill.py's seq-tp, overflow, decode-press and 2-shard
sliding tests (tiny_config, S = 128, float32 params from the seed), plus
CompressionRatioDecodingPress and the refusals.

Over 2 ranks the tiny model's 4 query, 2 kv heads and 128 MLP columns
divide the axis, so the decode runs tensor-parallel over "seq" (column
blocks of the replicated weights). Greedy steps on both sides: the same
tokens, logits within JAX's tolerance, lengths and press counters exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import kvpress_tpu as kj
from kvpress_tpu.cache import quantize_kv as j_quantize_kv
from kvpress_tpu.parallel.context_prefill import context_parallel_prefill as jprefill
from kvpress_tpu.parallel.decode import context_parallel_decode_step as jstep
from kvpress_tpu.parallel.decode import grow_shards as jgrow
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.parallel import context_parallel_decode_step, context_parallel_generate
from test_torch_context_decode import assert_same_steps, jax_steps
from test_torch_context_prefill import QTOL, S, SLIDING, TOL, context_ids, numpy_tree
from torch_context_cases import CASES
from torch_decoding_cases import Pipelines, decode_ctx
from torch_parallel_cases import finish_world, start_world

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

SEQ2 = {"seq": 2}
STEPS = 10
GROW = 16
# tests/test_context_prefill.py's decode presses: never binding, and binding.
NOOP = dict(compression_interval=3, target_size=512, hidden_states_buffer_size=4)
REAL = dict(compression_interval=4, target_size=24, hidden_states_buffer_size=4)
RATIO = dict(compression_interval=3, target_compression_ratio=0.7, hidden_states_buffer_size=4)


def presses(pkg, kind):
    if kind == "ratio":
        return pkg.CompressionRatioDecodingPress(base_press=pkg.KnormPress(), **RATIO)
    return pkg.DecodingPress(base_press=pkg.KnormPress(), **(NOOP if kind == "noop" else REAL))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg_j, cfg_t = kj.tiny_config(), kt.tiny_config()
    params = kj.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    ids = context_ids(cfg_j)
    scfg_j, scfg_t = dataclasses.replace(cfg_j, **SLIDING), dataclasses.replace(cfg_t, **SLIDING)
    base = dict(cfg=cfg_t, params=numpy_tree(params), ids=ids, mesh=SEQ2)
    knorm = (kj.KnormPress(0.5), kt.KnormPress(0.5))
    greedy = lambda n: [None] * n
    jobs = {
        "seq_tp": ("decode", dict(base, press=knorm[1], tokens=greedy(2))),
        "overflow": ("decode", dict(base, tokens=greedy(1), regrow=8)),
        "sliding": ("decode", dict(base, cfg=scfg_t, grow=8, tokens=greedy(5))),
        "cam": ("refusal", dict(base, kw=dict(quantized=True, decode_press=kt.CAMPress(
            base_press=kt.KnormPress(), compression_interval=4, target_size=24,
            hidden_states_buffer_size=4)))),
    }
    for bits in (None, 8, 4):
        q = {} if bits is None else dict(quantized=True, kv_bits=bits)
        for kind in ("none", "noop", "real") + (("ratio",) if bits is None else ()):
            dp = None if kind == "none" else presses(kt, kind)
            jobs[f"press-{bits}-{kind}"] = ("decode", dict(base, grow=GROW, decode_press=dp,
                                                          tokens=greedy(STEPS), **q))
    handle = start_world(2, jobs, tmp_path_factory.mktemp("cpd2"), cases=CASES)

    runner, srunner = kj.Runner.create(cfg_j), kj.Runner.create(scfg_j)
    jids = jnp.asarray(ids)
    mesh = Mesh(np.array(jax.devices()[:2]), ("seq",))
    psl = jnp.asarray(S // 2, jnp.int32)
    want = {"seq_tp": jax_steps(params, runner, mesh, jprefill(
        params, jids, runner=runner, press=knorm[0], mesh=mesh), 2, ids)}
    plain = jprefill(params, jids, runner=runner, mesh=mesh)
    want["plain"] = np.asarray(plain[0])
    _, _, _, ovf, _ = jstep(params, jids[:, -1:], plain, jnp.asarray(S, jnp.int32),
                            runner=runner, mesh=mesh, prefill_shard_len=psl)
    want["overflow"] = int(ovf)
    want["grown"] = jax_steps(params, runner, mesh, jgrow(plain, 2, 8), 1, ids)
    want["sliding"] = jax_steps(params, srunner, mesh, jgrow(
        jprefill(params, jids, runner=srunner, mesh=mesh), 2, 8), 5, ids)
    for bits, kind in ((None, "real"), (None, "ratio"), (8, "real"), (4, "real")):
        q = {} if bits is None else dict(quantized=True, kv_bits=bits)
        shards = jgrow(jprefill(params, jids, runner=runner, mesh=mesh, **q), 2, GROW)
        dp = presses(kj, kind)
        state = dp.init_state(cfg_j, 1, 1)
        tok, off, toks, logits, lengths = jids[:, -1:], jnp.asarray(S, jnp.int32), [], [], []
        for _ in range(STEPS):
            lg, shards, off, _, state = jstep(params, tok, shards, off, runner=runner,
                                              mesh=mesh, press=dp, press_state=state,
                                              prefill_shard_len=psl)
            tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
            logits.append(np.asarray(lg))
            toks.append(int(tok[0, 0]))
            lengths.append(np.asarray(shards[2]).reshape(2, -1))
        want[f"press-{bits}-{kind}"] = (logits, toks, lengths,
                                        [(int(s), int(b)) for s, b in
                                         zip(state["steps"], state["buf_len"])])
    return dict(got=finish_world(handle), want=want)


def test_distributed_decode_seq_tp_matches_jax(world):
    """Two greedy steps over 2 ranks, the dense compute tensor-parallel over
    "seq" (an all-gather of q/k/v, two all-reduces a layer): JAX's logits."""
    assert_same_steps(world["got"]["seq_tp"], world["want"]["seq_tp"])


def test_distributed_decode_overflow_raises_flag_and_grows(world):
    """The pressless prefill leaves no slack: the first step raises
    overflow (as JAX's does), returns no logits and leaves every shard as it
    was; grown by 8 slots, the step gives JAX's logits."""
    got = world["got"]["overflow"]
    first, retry = got["steps"]
    assert first["overflow"] == 1 == world["want"]["overflow"] and first["logits"] is None
    np.testing.assert_allclose(first["kept"]["keys"], world["want"]["plain"], **TOL)
    assert (first["kept"]["lengths"] == S // 2).all()
    assert_same_steps(dict(steps=[retry]), world["want"]["grown"])
    assert got["shards"]["keys"].shape[3] == S + 2 * 8


def test_sliding_window_decode_over_two_shards(world):
    """The sliding model over 2 ranks (seq-tp and the window's slot
    positions), 5 greedy steps: JAX's logits."""
    assert_same_steps(world["got"]["sliding"], world["want"]["sliding"], QTOL)


def _press_run(world, bits, kind):
    return world["got"][f"press-{bits}-{kind}"]


def _tokens(run):
    return [int(np.argmax(s["logits"][0, -1])) for s in run["steps"]]


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "int8", "int4"])
def test_distributed_decode_press(world, bits):
    """A shard-local DecodingPress(Knorm) over float, int8 and int4 shards:
    a target no shard reaches leaves generation as without a press; a
    binding one (interval 4, target 24) bounds every shard (24 + the 4
    appends since the last interval) and gives JAX's logits, tokens, lengths
    and counters (every shard's the same, sync_state)."""
    assert _tokens(_press_run(world, bits, "noop")) == _tokens(_press_run(world, bits, "none"))
    got = _press_run(world, bits, "real")
    assert (got["steps"][-1]["lengths"] <= 24 + 4).all()
    logits, toks, lengths, counters = world["want"][f"press-{bits}-real"]
    assert_same_steps(got, (logits, toks, lengths), TOL if bits is None else QTOL)
    assert [(s["steps"], s["buf_len"]) for s in got["state"]] == counters


def test_compression_ratio_decoding_press(world):
    """CompressionRatioDecodingPress(Knorm, 0.7): each shard cut to 30% of
    the tokens seen (its target from the host position) at every third
    step: JAX's logits, tokens and lengths."""
    logits, toks, lengths, counters = world["want"]["press-None-ratio"]
    got = _press_run(world, None, "ratio")
    assert_same_steps(got, (logits, toks, lengths))
    assert [(s["steps"], s["buf_len"]) for s in got["state"]] == counters


def test_distributed_decode_press_quantized_rejects_cam(world):
    """CAM reads dense buffers every step: refused over quantized shards."""
    got = world["got"]["cam"]
    assert got.startswith("ValueError") and "dense buffers" in got


@pytest.mark.parametrize("press", [
    kt.CAMPress(base_press=kt.KnormPress()),
    kt.DecodingPress(base_press=kt.TOVAPress()),
    kt.PrefillDecodingPress(kt.KnormPress(0.5), kt.DecodingPress(base_press=kt.KnormPress()))],
    ids=["cam", "decoding_tova", "prefill_decoding"])
def test_unheld_decode_presses_refused(press):
    """A decode press outside SEQ_DECODE_PRESSES, or over a scorer outside
    SEQ_PRESSES, raises NotImplementedError naming ROADMAP item 19."""
    with pytest.raises(NotImplementedError, match="item 19 "):
        context_parallel_decode_step(None, None, (None,) * 4, S, runner=None, mesh=None,
                                     press=press)
    with pytest.raises(NotImplementedError, match="item 19 "):
        context_parallel_generate(None, None, runner=None, mesh=None, decode_press=press)


# --------------------------------------------------------------------- #
# sync_state on one layer, against JAX's decode_compress


B, SLOTS, LENGTH, BUF = 2, 64, 50, 16


@pytest.fixture(scope="module")
def pipes():
    return Pipelines.tiny()


@pytest.mark.parametrize("bits", [None, 8], ids=["float", "int8"])
@pytest.mark.parametrize("sync", [False, True])
def test_sync_state_resets_counters_on_every_interval_hit(pipes, sync, bits):
    """An interval hit on a shard already under its target (50 <= 60): no
    compression; with ``sync_state`` the counters and the buffer length
    reset all the same (every shard's state stays alike), without it they
    run on. Kept rows, lengths and state equal JAX's."""
    cfg = pipes.cfg_t
    runner = kt.Runner.create(cfg, device="cpu")
    kw = dict(hidden_states_buffer_size=BUF, compression_interval=3, target_size=60)
    jp, tp = (pkg.DecodingPress(base_press=pkg.KnormPress(), **kw) for pkg in (kj, kt))
    ctx, jctx = decode_ctx(runner, pipes.params_t, pipes.params_j, pipes.cfg_j, 1, 120, seed=2)
    rng = np.random.default_rng(7)
    buf = rng.standard_normal((B, BUF, cfg.hidden_size)).astype(np.float32)
    state = {"buffer": torch.from_numpy(buf), "buf_len": 5, "steps": 2}
    jstate = {"buffer": jnp.asarray(buf), "buf_len": jnp.int32(5), "steps": jnp.int32(2)}
    k, v = (rng.standard_normal((B, cfg.num_kv_heads, SLOTS, cfg.head_dim)).astype(np.float32)
            for _ in range(2))
    mask = np.ones((B, cfg.num_kv_heads, SLOTS), bool)
    if bits is None:
        got = tp.decode_compress(ctx, torch.from_numpy(k), torch.from_numpy(v), LENGTH,
                                 torch.from_numpy(mask), state, sync_state=sync)
        want = jp.decode_compress(jctx, jnp.asarray(k), jnp.asarray(v), jnp.int32(LENGTH),
                                  jnp.asarray(mask), jstate, sync_state=sync)
    else:
        (qk, ks), (qv, vs) = (j_quantize_kv(jnp.asarray(x), bits) for x in (k, v))
        t = lambda x: torch.from_numpy(np.array(x))
        got = tp.decode_compress_quantized(ctx, t(qk), t(qv), t(ks), t(vs), bits, LENGTH,
                                           torch.from_numpy(mask), state, sync_state=sync)
        want = jp.decode_compress_quantized(jctx, qk, qv, ks, vs, bits, jnp.int32(LENGTH),
                                            jnp.asarray(mask), jstate, sync_state=sync)
    for a, b in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(got[-3]) == LENGTH
    new, jnew = got[-1], want[-1]
    assert (new["steps"], new["buf_len"]) == (int(jnew["steps"]), int(jnew["buf_len"]))
    assert (new["steps"], new["buf_len"]) == ((0, 0) if sync else (3, 6))
    np.testing.assert_array_equal(new["buffer"].numpy(), np.asarray(jnew["buffer"]))
