"""Context-parallel prefill of the port (kvpress_tpu_torch/parallel/ring.py and
context_prefill.py) against the JAX package: the mirrors of
tests/test_parallel.py's ring tests and of tests/test_context_prefill.py's
prefill tests, at their shapes (tiny_config, S = 128, float32 params from
the seed), on one gloo world of 8 ranks meshed as ("seq",) 8, ("model",
"seq") 2 x 4 and ("seq", "model") 4 x 2.

The ranks run tests/torch_context_cases.py (no JAX there); they start
before the parent computes the JAX references on the conftest's 8 virtual
devices and are joined after. Keys, values and logits are held within JAX's
tolerance (atol 2e-4, rtol 1e-3), kept sets and lengths exactly (a shard's
kept rows as a set: the order of its kept entries is the scores').
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import kvpress_tpu as kj
from kvpress_tpu.ops.attention import attention_bias, gqa_attention
from kvpress_tpu.parallel import ring as jring
from kvpress_tpu.parallel.context_prefill import context_parallel_kvcompose as jkvcompose
from kvpress_tpu.parallel.context_prefill import context_parallel_prefill as jprefill
from kvpress_tpu.parallel.decode import context_parallel_decode_step as jstep
from kvpress_tpu.parallel.decode import grow_shards as jgrow
from kvpress_tpu.models.llama import quantize_params_int8 as jquant8
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.parallel import (SEQ_PRESSES, context_parallel_prefill,
                                        ring_flash_self_attention, ring_self_attention)
from kvpress_tpu_torch.parallel.mesh import SeqShard
from torch_context_cases import CASES
from torch_parallel_cases import finish_world, start_world

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

S, N = 128, 8
TOL = dict(atol=2e-4, rtol=1e-3)        # tests/test_context_prefill.py's
QTOL = dict(atol=3e-4, rtol=2e-3)       # its quantized tests'
SEQ8, MS24, SM42 = {"seq": 8}, {"model": 2, "seq": 4}, {"seq": 4, "model": 2,
                                                       "order": ("seq", "model")}
# (JAX press, port press) held over the seq mesh beside Knorm.
PRESSES = {
    "streaming": (kj.StreamingLLMPress(0.5, n_sink=2), kt.StreamingLLMPress(0.5, n_sink=2)),
    "snapkv": (kj.SnapKVPress(0.5, window_size=4), kt.SnapKVPress(0.5, window_size=4)),
    "keydiff": (kj.KeyDiffPress(0.5), kt.KeyDiffPress(0.5)),
}
SLIDING = dict(sliding_window=8, rope_local_base_freq=500.0, layer_is_sliding=(True, False))
RING = dict(B=2, Hq=8, Hkv=4, S=256, D=32)      # tests/test_parallel.py's ring shapes
WINDOW = 24                                      # < Sl = 32: rows with no visible key


def context_ids(cfg) -> np.ndarray:
    """(1, S) distinct token ids from the seed. A repeated token's keys have
    one pre-RoPE norm: Knorm's tie between them is broken by each package's
    rounding after RoPE, differently, and at the cut of a shard it changes
    the kept set."""
    return np.asarray(jax.random.permutation(jax.random.PRNGKey(1), cfg.vocab_size)[None, :S])


def numpy_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def jax_mesh(shape):
    if shape == SEQ8:
        return Mesh(np.array(jax.devices()[:8]), ("seq",)), {}
    if shape == MS24:
        return (Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("model", "seq")),
                dict(axis="seq", model_axis="model"))
    return (Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("seq", "model")),
            dict(axis="seq", model_axis="model"))


def jax_shards(out, mesh):
    """JAX's prefill tuple as the ranks' gathered dict: lengths (model x
    seq ranks, L) in ``P(("model", "seq"))`` order, and the seq count."""
    names = ("keys", "values", "lengths", "masks", "key_scales", "value_scales")
    d = {n: np.asarray(t) for n, t in zip(names, out)}
    d["lengths"] = d["lengths"].reshape(-1, d["keys"].shape[0])
    d["n_seq"] = mesh.shape["seq"]
    return d


def assert_same_shards(got, want, tol=TOL):
    """Equal lengths and keep-masks, scales within ``tol``; each layer's
    kept rows of each seq shard: (key, value) rows within ``tol`` as sets
    (the order of tied scores is rounding's), int payload rows equal."""
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    np.testing.assert_array_equal(got["masks"], want["masks"])
    for name in ("key_scales", "value_scales"):
        if name in want:
            np.testing.assert_allclose(got[name], want[name], **tol)
    n_seq, (L, _, _, Sg) = want["n_seq"], want["masks"].shape
    lengths = want["lengths"].reshape(-1, n_seq, L)[0]            # every model rank alike
    sl = Sg // n_seq
    for l in range(L):
        for s in range(n_seq):
            n = lengths[s, l]
            a, b = (np.concatenate([c[k][l, :, :, s * sl:s * sl + n].astype(np.float32)
                                    for k in ("keys", "values")], -1) for c in (got, want))
            if want["keys"].dtype != np.float32:
                np.testing.assert_array_equal(a, b, err_msg=f"layer {l} shard {s}")
                continue
            d = np.abs(a[:, :, :, None] - b[:, :, None]).max(-1)
            lim = tol["atol"] + tol["rtol"] * np.abs(b).max()
            assert d.min(-1).max() <= lim and d.min(-2).max() <= lim, (l, s)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 8-rank world's results, and the JAX references."""
    cfg_j, cfg_t = kj.tiny_config(), kt.tiny_config()
    params = kj.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    ids = context_ids(cfg_j)
    q8 = jquant8(params, include_embeddings=True)
    scfg_j, scfg_t = dataclasses.replace(cfg_j, **SLIDING), dataclasses.replace(cfg_t, **SLIDING)
    knorm = (kj.KnormPress(0.5), kt.KnormPress(0.5))
    stream = PRESSES["streaming"]
    base = dict(cfg=cfg_t, params=numpy_tree(params), ids=ids)

    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    B, Hq, Hkv, Sr, D = RING.values()
    qkv = [np.asarray(jax.random.normal(kk, (B, h, Sr, D), jnp.float32))
           for kk, h in zip(ks, (Hq, Hkv, Hkv))]
    ring_job = dict(q=qkv[0], k=qkv[1], v=qkv[2], mesh=SEQ8)

    jobs = {
        "ring_xla": ("ring", dict(ring_job, impl="xla", window=WINDOW, lse=True,
                                  ctx_len=Sr // 2)),
        "ring_flash": ("ring", dict(ring_job, impl="flash")),
        "plain": ("prefill", dict(base, mesh=SEQ8)),
        "plain_flash": ("prefill", dict(base, attn_impl="flash", mesh=SEQ8)),
        "knorm": ("prefill", dict(base, press=knorm[1], mesh=SEQ8)),
        "knorm_flash": ("prefill", dict(base, press=knorm[1], attn_impl="flash", mesh=SEQ8)),
        "knorm_2d": ("prefill", dict(base, press=knorm[1], mesh=MS24)),
        "int8": ("prefill", dict(base, params=numpy_tree(q8), mesh=SEQ8)),
        "q8": ("prefill", dict(base, press=stream[1], quantized=True, kv_bits=8, mesh=SEQ8)),
        "q4": ("prefill", dict(base, press=stream[1], quantized=True, kv_bits=4, mesh=SEQ8)),
        "q8_2d": ("prefill", dict(base, press=stream[1], quantized=True, kv_bits=8, mesh=SM42)),
        "sliding": ("prefill", dict(base, cfg=scfg_t, mesh=SEQ8)),
        "sliding_flash": ("prefill", dict(base, cfg=scfg_t, attn_impl="flash", mesh=SEQ8)),
        "sliding_knorm": ("prefill", dict(base, cfg=scfg_t, press=knorm[1], plain=True,
                                          mesh=SEQ8)),
    }
    jobs.update({f"press-{k}": ("prefill", dict(base, press=tp, mesh=SEQ8))
                 for k, (_, tp) in PRESSES.items()})
    for agg in (("max", "mean"), ("mean", "max")):
        press = kt.KVComposePress(compression_ratio=0.5, structured=False, agg_task=agg[0],
                                  agg_group=agg[1])
        jobs[f"kvcompose-{agg[0]}"] = ("decode", dict(base, kvcompose=press, grow=4,
                                                      tokens=[ids[:, -1:]], mesh=SEQ8))
    handle = start_world(8, jobs, tmp_path_factory.mktemp("cp8"), cases=CASES)

    # The JAX references, while the ranks run.
    runner, srunner = kj.Runner.create(cfg_j), kj.Runner.create(scfg_j)
    jids = jnp.asarray(ids)

    def pre(shape, p=params, r=runner, **kw):
        mesh, axes = jax_mesh(shape)
        return jax_shards(jprefill(p, jids, runner=r, mesh=mesh, **axes, **kw), mesh)

    want = {
        "plain": pre(SEQ8), "knorm": pre(SEQ8, press=knorm[0]),
        "knorm_2d": pre(MS24, press=knorm[0]), "int8": pre(SEQ8, p=q8),
        "q8": pre(SEQ8, press=stream[0], quantized=True, kv_bits=8),
        "q4": pre(SEQ8, press=stream[0], quantized=True, kv_bits=4),
        "q8_2d": pre(SM42, press=stream[0], quantized=True, kv_bits=8),
        "sliding": pre(SEQ8, r=srunner),
        "sliding_knorm": pre(SEQ8, r=srunner, press=knorm[0]),
    }
    want.update({f"press-{k}": pre(SEQ8, press=jp) for k, (jp, _) in PRESSES.items()})

    # Ring references: the dense attention, and JAX's own ring functions.
    q, k, v = (jnp.asarray(t) for t in qkv)
    mesh = jax_mesh(SEQ8)[0]
    want["ring_dense"] = np.asarray(gqa_attention(q, k, v, attention_bias(
        jnp.asarray(0, jnp.int32), Sr, Sr), D ** -0.5)[0])
    want["ring_windowed_dense"] = np.asarray(gqa_attention(q, k, v, attention_bias(
        jnp.asarray(0, jnp.int32), Sr, Sr, sliding_window=WINDOW), D ** -0.5)[0])
    spec = P(None, None, "seq", None)
    lse_fn = shard_map(lambda a, b, c: jring.ring_self_attention_lse(
        a, b, c, axis_name="seq", sm_scale=D ** -0.5), mesh=mesh, in_specs=(spec,) * 3,
        out_specs=(spec, P(None, None, "seq")), check_vma=False)
    want["lse_out"], want["lse"] = (np.asarray(t) for t in lse_fn(q, k, v))
    for agg in ("max", "sum"):
        fn = shard_map(lambda a, b, c, agg=agg: jring.ring_colagg(
            a, b, c, axis_name="seq", sm_scale=D ** -0.5, ctx_len=Sr // 2, agg=agg),
            mesh=mesh, in_specs=(spec, spec, P(None, None, "seq")),
            out_specs=P(None, None, "seq"), check_vma=False)
        want[f"colagg_{agg}"] = np.asarray(fn(q, k, jnp.asarray(want["lse"])))
    win_fn = shard_map(lambda a, b, c: jring.ring_flash_self_attention(
        a, b, c, axis_name="seq", sm_scale=D ** -0.5, window=WINDOW), mesh=mesh,
        in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
    want["windowed"] = np.asarray(win_fn(q, k, v))

    # KVCompose: JAX's masked shards and one decode step over them.
    for agg in (("max", "mean"), ("mean", "max")):
        press = kj.KVComposePress(compression_ratio=0.5, structured=False, agg_task=agg[0],
                                  agg_group=agg[1])
        shards = jkvcompose(params, jids, runner=runner, press=press, mesh=mesh)
        d = jax_shards(shards, mesh)
        lg, *_ = jstep(params, jids[:, -1:], jgrow(shards, N, 4), jnp.asarray(S, jnp.int32),
                       runner=runner, mesh=mesh)
        d["logits"] = np.asarray(lg)
        want[f"kvcompose-{agg[0]}"] = d

    # The single-device ChunkPress prefill of the port.
    port = kt.params_from_jax(numpy_tree(params), cfg_t, device="cpu", dtype=torch.float32)
    chunk = {}
    for shape, n in ((SEQ8, N), (MS24, 4)):
        _, cache, _ = kt.Runner.create(cfg_t, device="cpu").prefill(
            port, torch.from_numpy(ids.astype(np.int64)), dtype=torch.float32,
            press=kt.ChunkPress(knorm[1], chunk_length=S // n))
        chunk[n] = cache
    got = finish_world(handle)
    return dict(got=got, want=want, chunk=chunk, cfg=cfg_t, port=port, ids=ids)


def test_ring_attention_matches_reference(world):
    """context_parallel_attention (the plain ring) over 8 ranks equals the
    single-device causal attention (tests/test_parallel.py's shapes)."""
    np.testing.assert_allclose(world["got"]["ring_xla"]["out"], world["want"]["ring_dense"],
                               atol=2e-5)


def test_ring_flash_attention_matches_reference(world):
    """The flash ring (flash_attention's plain version on each block, at
    prior 0, Sl, 2 Sl, ...; future blocks skipped) equals it too."""
    np.testing.assert_allclose(world["got"]["ring_flash"]["out"], world["want"]["ring_dense"],
                               atol=2e-3)


def test_ring_lse_and_colagg_match_jax(world):
    """ring_self_attention_lse (output and row LSE) and ring_colagg (max and
    sum over the re-fed half's queries) equal JAX's under shard_map."""
    got, want = world["got"]["ring_xla"], world["want"]
    np.testing.assert_allclose(got["lse_out"], want["lse_out"], atol=2e-5)
    np.testing.assert_allclose(got["lse"], want["lse"], atol=2e-5, rtol=1e-5)
    for agg in ("max", "sum"):
        np.testing.assert_allclose(got[f"colagg_{agg}"], want[f"colagg_{agg}"], atol=1e-5,
                                   rtol=1e-4)
    assert (want["colagg_max"][..., RING["S"] // 2:] == 0).all()


def test_windowed_flash_ring_with_rows_seeing_no_key(world):
    """A window of 24 over blocks of 32: in each block one behind the
    diagonal, rows 23.. see no key (the plain version's LSE is finite and
    very negative, the kernel's -inf). Their weight is 0: the ring equals the
    dense windowed attention and JAX's windowed flash ring, with no NaN."""
    got = world["got"]["ring_xla"]["windowed"]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, world["want"]["ring_windowed_dense"], atol=2e-3)
    np.testing.assert_allclose(got, world["want"]["windowed"], atol=2e-3)


def test_windowed_block_weights_dead_rows_zero():
    """One ring step's combine on the CPU with a block whose late rows see
    no key: the plain flash gives them a finite LSE near -2e38 (the kernel
    gives -inf), and the ring's result for every row equals the block that
    holds its keys alone."""
    from kvpress_tpu_torch.ops.flash import flash_attention

    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 2, 16, 8, generator=g) for _ in range(3))
    _, lse = flash_attention(q, k, v, 16, sm_scale=0.3, window=4, return_lse=True)
    assert torch.isfinite(lse).all() and (lse[..., 3:] < -1e37).all()
    seq = SeqShard(group=None, rank=0, size=1, device=torch.device("cpu"))
    out = ring_flash_self_attention(q, k, v, seq=seq, sm_scale=0.3, window=4)
    torch.testing.assert_close(out, ring_self_attention(q, k, v, seq=seq, sm_scale=0.3,
                                                        window=4))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("label", ["plain", "plain_flash"])
def test_uncompressed_keys_match_single_device(world, label):
    """No press: every rank's keys, values, lengths (Sl) and masks equal
    JAX's context_parallel_prefill, on the plain and the flash ring."""
    got, want = world["got"][label], world["want"]["plain"]
    for name in ("keys", "values"):
        np.testing.assert_allclose(got[name], want[name], **TOL)
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert (got["lengths"] == S // N).all() and got["masks"].all()


def _chunk_sets(got, cache, n_seq, kept):
    """Each layer's kept keys, over every shard, are the single-device
    ChunkPress cache's (as sets)."""
    Sl = S // n_seq
    ref = cache.keys.numpy()
    for l in range(ref.shape[0]):
        for h in range(ref.shape[2]):
            mine = np.concatenate([got["keys"][l, 0, h, s * Sl:s * Sl + kept]
                                   for s in range(n_seq)])
            d = np.linalg.norm(mine[:, None] - ref[l, 0, h, :n_seq * kept][None], axis=-1)
            assert (d.min(axis=1) < 1e-4).all() and (d.min(axis=0) < 1e-4).all(), (l, h)


@pytest.mark.parametrize("label", ["knorm", "knorm_flash"])
def test_compressed_matches_chunk_press(world, label):
    """Knorm(0.5) shard by shard: each shard keeps 8 of its 16 tokens, the
    sets JAX keeps and the single-device ChunkPress(Knorm, 16) keeps."""
    got = world["got"][label]
    assert (got["lengths"] == kj.KnormPress(0.5).n_kept(S // N)).all()
    assert_same_shards(got, world["want"]["knorm"])
    _chunk_sets(got, world["chunk"][N], N, kj.KnormPress(0.5).n_kept(S // N))


def test_2d_tp_sp_matches_chunk_press(world):
    """("model", "seq") 2 x 4: local heads, the model all-reduces, the ring
    over each seq group; the shards gathered over both axes equal JAX's, and
    the kept sets the single-device ChunkPress(Knorm, 32)'s."""
    got = world["got"]["knorm_2d"]
    assert_same_shards(got, world["want"]["knorm_2d"])
    _chunk_sets(got, world["chunk"][4], 4, kj.KnormPress(0.5).n_kept(S // 4))


@pytest.mark.parametrize("label", list(PRESSES))
def test_seq_presses_match_jax(world, label):
    """Every prefill press of SEQ_PRESSES besides Knorm keeps JAX's
    shard-local sets: StreamingLLM's sinks per shard, SnapKV's window of the
    shard's last queries, KeyDiff."""
    assert_same_shards(world["got"][f"press-{label}"], world["want"][f"press-{label}"])


def test_int8_weights_prefill(world):
    """int8 weights with the embedding and head: the shards equal JAX's."""
    got, want = world["got"]["int8"], world["want"]["int8"]
    np.testing.assert_allclose(got["keys"], want["keys"], **TOL)
    np.testing.assert_allclose(got["values"], want["values"], **TOL)


@pytest.mark.parametrize("label", ["q8", "q4", "q8_2d"])
def test_quantized_shards_match_jax(world, label):
    """quantized=True at 8 and 4 bits (and 8 over ("seq", "model") 4 x 2):
    StreamingLLM's kept payloads equal JAX's code for code, the per-token
    scales within the tolerance, the payload dtype int8 / packed uint8."""
    got, want = world["got"][label], world["want"][label]
    assert got["keys"].dtype == want["keys"].dtype
    assert got["keys"].shape == want["keys"].shape
    assert_same_shards(got, want, tol=QTOL)


@pytest.mark.parametrize("label", ["sliding", "sliding_flash"])
def test_sliding_window_context_parallel_prefill(world, label):
    """Gemma3-style sliding and global layers with their two RoPE bases
    through the ring (windowed blocks, skipped blocks behind the window):
    keys and values equal JAX's."""
    got, want = world["got"][label], world["want"]["sliding"]
    np.testing.assert_allclose(got["keys"], want["keys"], **TOL)
    np.testing.assert_allclose(got["values"], want["values"], **TOL)


def test_sliding_window_press_skips_sliding_shards(world):
    """Knorm on the sliding model compresses the global layer only: the
    sliding layer keeps every shard whole (its keys those of the pressless
    prefill), and the shards equal JAX's."""
    got = world["got"]["sliding_knorm"]
    for l, sliding in enumerate(SLIDING["layer_is_sliding"]):
        assert (got["lengths"][:, l] == (S // N if sliding else 8)).all()
        if sliding:
            np.testing.assert_array_equal(got["keys"][l], got["plain_keys"][l])
    assert_same_shards(got, world["want"]["sliding_knorm"])


def test_rerotating_press_rejected():
    """A key-rerotating press renumbers positions per shard: refused before
    any work."""
    with pytest.raises(ValueError, match="rerotating"):
        context_parallel_prefill(None, None, runner=None, mesh=None,
                                 press=kt.KeyRerotationPress(kt.KnormPress(0.5)))


@pytest.mark.parametrize("press", [kt.ObservedAttentionPress(0.5), kt.TOVAPress(0.5),
                                   kt.AdaKVPress(kt.KnormPress(0.5))],
                         ids=["observed", "tova", "adakv"])
def test_unheld_presses_refused_over_seq_mesh(press):
    """A press outside SEQ_PRESSES raises NotImplementedError naming ROADMAP
    item 19."""
    assert type(press).__name__ not in SEQ_PRESSES
    with pytest.raises(NotImplementedError, match="item 19 "):
        context_parallel_prefill(None, None, runner=None, mesh=None, press=press)


@pytest.mark.parametrize("agg", ["max", "mean"])
def test_context_parallel_kvcompose_matches_jax(world, agg):
    """KVCompose's doubled-sequence ring pass, both aggregations: the keep
    masks equal JAX's exactly (30-70% dropped), the context keys within the
    tolerance, and one decode step over the masked shards JAX's logits."""
    got, want = world["got"][f"kvcompose-{agg}"], world["want"][f"kvcompose-{agg}"]
    shards = got["before"]
    np.testing.assert_array_equal(shards["masks"], want["masks"])
    assert 0.3 < (~want["masks"]).mean() < 0.7
    np.testing.assert_allclose(shards["keys"], want["keys"], **TOL)
    np.testing.assert_array_equal(shards["lengths"], want["lengths"])
    np.testing.assert_allclose(got["steps"][0]["logits"], want["logits"], **TOL)
