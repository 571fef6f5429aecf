"""Distributed decode of the port (kvpress_tpu_torch/parallel/decode.py) over
context-parallel shards against the JAX package: the mirrors of
tests/test_context_prefill.py's decode and generate tests on an 8-rank gloo
world (("seq",) 8, ("model", "seq") 2 x 4 and ("seq", "model") 4 x 2) at
their shapes (tiny_config, S = 128, float32 params from the seed).

Each case runs greedily on both sides from the same prefill: the port's
tokens must be JAX's, and every step's logits within JAX's tolerance (atol
2e-4, rtol 1e-3; 3e-4 / 2e-3 over quantized shards, as its quantized
tests); lengths exactly. The ranks run tests/torch_context_cases.py (no JAX
there) while the parent computes the JAX references.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import kvpress_tpu as kj
from kvpress_tpu.models.llama import quantize_params_int8 as jquant8
from kvpress_tpu.parallel.context_prefill import context_parallel_prefill as jprefill
from kvpress_tpu.parallel.decode import context_parallel_decode_step as jstep
from kvpress_tpu.parallel.decode import context_parallel_generate as jgenerate
from kvpress_tpu.parallel.decode import grow_shards as jgrow
import kvpress_tpu_torch as kt
from test_torch_context_prefill import (MS24, QTOL, S, SEQ8, SLIDING, SM42, TOL, context_ids,
                                        jax_mesh, numpy_tree)
from torch_context_cases import CASES
from torch_parallel_cases import finish_world, start_world

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

N = 8
GEN_NEW = 12          # > the 8 free slots Knorm(0.5) leaves on the last shard: one grow
DPRESS = dict(compression_interval=3, target_size=12, hidden_states_buffer_size=4)
SLIDING_STEPS = 5


def jax_steps(params, runner, mesh, shards, n, ids, axes=None):
    """``n`` greedy JAX decode steps from the context's last token: (the
    steps' logits, tokens, lengths (ranks, L) after each, the shards)."""
    axes = axes or {}
    tok, off = jnp.asarray(ids[:, -1:]), jnp.asarray(S, jnp.int32)
    psl = jnp.asarray(S // mesh.shape["seq"], jnp.int32)
    logits, toks, lengths = [], [], []
    for _ in range(n):
        lg, shards, off, ovf, _ = jstep(params, tok, shards, off, runner=runner, mesh=mesh,
                                        prefill_shard_len=psl, **axes)
        assert int(ovf) == 0
        tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        logits.append(np.asarray(lg))
        toks.append(int(tok[0, 0]))
        lengths.append(np.asarray(shards[2]).reshape(-1, shards[0].shape[0]))
    return logits, toks, lengths, shards


def assert_same_steps(got, want, tol=TOL):
    """The port's greedy steps are JAX's: logits within ``tol``, the same
    tokens and the lengths after each step."""
    logits, toks, lengths = want[:3]
    assert len(got["steps"]) == len(logits)
    for i, (step, lg, n) in enumerate(zip(got["steps"], logits, lengths)):
        assert step["overflow"] == 0
        np.testing.assert_allclose(step["logits"], lg, **tol, err_msg=f"step {i}")
        np.testing.assert_array_equal(step["lengths"], n, err_msg=f"step {i}")
    assert [int(np.argmax(s["logits"][0, -1])) for s in got["steps"]] == toks


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg_j, cfg_t = kj.tiny_config(), kt.tiny_config()
    params = kj.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    ids = context_ids(cfg_j)
    q8 = jquant8(params, include_embeddings=True)
    scfg_j, scfg_t = dataclasses.replace(cfg_j, **SLIDING), dataclasses.replace(cfg_t, **SLIDING)
    knorm = (kj.KnormPress(0.5), kt.KnormPress(0.5))
    stream = (kj.StreamingLLMPress(0.5, n_sink=2), kt.StreamingLLMPress(0.5, n_sink=2))
    dpress = (kj.DecodingPress(base_press=kj.KnormPress(), **DPRESS),
              kt.DecodingPress(base_press=kt.KnormPress(), **DPRESS))
    base = dict(cfg=cfg_t, params=numpy_tree(params), ids=ids)
    greedy = lambda n: [None] * n
    jobs = {
        "decode_1d": ("decode", dict(base, press=knorm[1], tokens=greedy(2), mesh=SEQ8)),
        "decode_2d": ("decode", dict(base, press=knorm[1], tokens=greedy(2), mesh=MS24)),
        "generate": ("generate", dict(base, press=knorm[1], new=GEN_NEW, mesh=SEQ8)),
        "generate_dpress": ("generate", dict(base, press=knorm[1], decode_press=dpress[1],
                                             new=8, mesh=SEQ8)),
        "int8": ("decode", dict(base, params=numpy_tree(q8), grow=4, tokens=greedy(1),
                                mesh=SEQ8)),
        "sliding": ("decode", dict(base, cfg=scfg_t, grow=8, tokens=greedy(SLIDING_STEPS),
                                   mesh=SEQ8)),
        "sliding_no_psl": ("refusal", dict(base, cfg=scfg_t, step=True,
                                           kw=dict(prefill_shard_len=None), mesh=SEQ8)),
        "q8_2d": ("decode", dict(base, press=stream[1], quantized=True, kv_bits=8,
                                 tokens=greedy(1), mesh=SM42)),
    }
    for bits in (8, 4):
        q = dict(base, press=stream[1], quantized=True, kv_bits=bits, mesh=SEQ8)
        jobs[f"q{bits}"] = ("decode", dict(q, tokens=greedy(2)))
        jobs[f"q{bits}_generate"] = ("generate", dict(q, new=6))
    handle = start_world(8, jobs, tmp_path_factory.mktemp("cpd8"), cases=CASES)

    runner, srunner = kj.Runner.create(cfg_j), kj.Runner.create(scfg_j)
    jids = jnp.asarray(ids)
    mesh = jax_mesh(SEQ8)[0]

    def steps(shape, n, p=params, r=runner, grow=0, **kw):
        m, axes = jax_mesh(shape)
        shards = jprefill(p, jids, runner=r, mesh=m, **axes, **kw)
        if grow:
            shards = jgrow(shards, m.shape["seq"], grow)
        return jax_steps(p, r, m, shards, n, ids, axes)

    want = {
        "decode_1d": steps(SEQ8, 2, press=knorm[0]),
        "decode_2d": steps(MS24, 2, press=knorm[0]),
        "int8": steps(SEQ8, 1, p=q8, grow=4),
        "sliding": steps(SEQ8, SLIDING_STEPS, r=srunner, grow=8),
        "q8_2d": steps(SM42, 1, press=stream[0], quantized=True, kv_bits=8),
        "generate": np.asarray(jgenerate(params, jids, runner=runner, mesh=mesh, press=knorm[0],
                                         max_new_tokens=GEN_NEW)),
        "generate_dpress": np.asarray(jgenerate(params, jids, runner=runner, mesh=mesh,
                                                press=knorm[0], decode_press=dpress[0],
                                                max_new_tokens=8)),
    }
    for bits in (8, 4):
        want[f"q{bits}"] = steps(SEQ8, 2, press=stream[0], quantized=True, kv_bits=bits)
        want[f"q{bits}_generate"] = np.asarray(jgenerate(
            params, jids, runner=runner, mesh=mesh, press=stream[0], max_new_tokens=6,
            quantized=True, kv_bits=bits))
    return dict(got=finish_world(handle), want=want)


def test_distributed_decode_matches_single_device(world):
    """Two greedy steps over the Knorm shards of 8 ranks: JAX's logits and
    tokens; the appends on the last shard alone (8, then 10 on rank 7)."""
    got = world["got"]["decode_1d"]
    assert_same_steps(got, world["want"]["decode_1d"])
    lengths = got["steps"][-1]["lengths"]
    assert (lengths[:-1] == 8).all() and (lengths[-1] == 10).all()


def test_distributed_decode_2d(world):
    """("model", "seq") 2 x 4: local heads, the model all-reduces and the
    split-KV combine over each seq group give JAX's logits and tokens."""
    assert_same_steps(world["got"]["decode_2d"], world["want"]["decode_2d"])


@pytest.mark.parametrize("fused", [False, True])
def test_distributed_generate_matches_jax(world, fused):
    """context_parallel_generate, 12 tokens over Knorm shards (the last shard
    fills after 8: the host loop grows it and redoes the step, the fused
    loop grows every shard first): JAX's host-loop tokens."""
    np.testing.assert_array_equal(world["got"]["generate"][fused], world["want"]["generate"])


@pytest.mark.parametrize("fused", [False, True])
def test_generate_with_decode_press_matches_jax(world, fused):
    """A shard-local DecodingPress(Knorm, interval 3, target 12) rides along,
    in the host loop and fused: JAX's tokens."""
    np.testing.assert_array_equal(world["got"]["generate_dpress"][fused],
                                  world["want"]["generate_dpress"])


def test_distributed_paths_int8_weights(world):
    """int8 weights (embedding and head too) through the prefill and a
    decode step: JAX's logits."""
    assert_same_steps(world["got"]["int8"], world["want"]["int8"])


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_shards_decode(world, bits):
    """int8 and packed-int4 shards (StreamingLLM): two steps reading the
    payload with its scales, the second over the quantized append: JAX's
    logits and tokens."""
    assert_same_steps(world["got"][f"q{bits}"], world["want"][f"q{bits}"], QTOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_generate_fused_matches_host_loop(world, bits):
    """Generation over quantized shards: the fused loop gives the host
    loop's tokens, and both JAX's."""
    got = world["got"][f"q{bits}_generate"]
    np.testing.assert_array_equal(got[True], got[False])
    np.testing.assert_array_equal(got[False], world["want"][f"q{bits}_generate"])


def test_quantized_shards_2d_sp_tp(world):
    """int8 shards over ("seq", "model") 4 x 2: JAX's logits."""
    assert_same_steps(world["got"]["q8_2d"], world["want"]["q8_2d"], QTOL)


def test_sliding_window_distributed_decode(world):
    """A sliding model over 8 ranks, 5 greedy steps past the prefill: the
    window test on slot positions (rank * 16 + slot) gives JAX's logits."""
    assert_same_steps(world["got"]["sliding"], world["want"]["sliding"], QTOL)


def test_sliding_window_decode_requires_prefill_shard_len(world):
    assert world["got"]["sliding_no_psl"].startswith("ValueError")
    assert "prefill_shard_len" in world["got"]["sliding_no_psl"]
