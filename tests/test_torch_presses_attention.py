"""The attention-reading presses of kvpress_tpu_torch (SnapKV, TOVA,
ObservedAttention, PyramidKV) and what they stand on, against the JAX package
on the same seeded numpy inputs (CPU, float32, tiny config).

Tolerances: helper outputs and scores agree to 1e-5 (float32 sums taken in
another order); kept sets, lengths and greedy answers are equal. The Pallas
column-sum kernel runs in interpret mode, as in tests/test_observed_chunked.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.ops import attention as jatt
from kvpress_tpu.ops.flash import flash_attention as jflash
from kvpress_tpu.ops.observed_colsum import observed_colsums_flash as jcolsums
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
from kvpress_tpu.presses.base import LayerCtx as JaxCtx
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.ops import attention as tatt
from kvpress_tpu_torch.ops import observed_colsum as toc
from kvpress_tpu_torch.ops.flash import flash_attention_plain
from toy_tokenizer import ToyTokenizer

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _qk(seed, B=2, Hq=4, Hkv=2, S=96, D=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32))


def _row_lse(q, k, scale, softcap=None):
    """Exact causal row logsumexp (numpy, float64): what the flash pass gives."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    s = np.einsum("bhgtd,bhsd->bhgts", q.reshape(B, Hkv, Hq // Hkv, S, D).astype(np.float64),
                  k.astype(np.float64)) * scale
    if softcap is not None:
        s = np.tanh(s / softcap) * softcap
    s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m[..., 0] + np.log(np.exp(s - m).sum(-1))).reshape(B, Hq, S).astype(np.float32)


# --------------------------------------------------------------------- #
# ops/attention.py helpers


@pytest.mark.parametrize("W", [1, 8])
def test_window_attention_probs_matches_jax(W):
    q, k = _qk(0)
    S = q.shape[2]
    got = tatt.window_attention_probs(_t(q[:, :, S - W:]), _t(k), 0.25, S - W)
    want = jatt.window_attention_probs(jnp.asarray(q[:, :, S - W:]), jnp.asarray(k), 0.25,
                                       jnp.asarray(S - W, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("chunk", [32, 40, 4096])
def test_chunked_window_probs_mean_matches_jax(chunk):
    q, k = _qk(1)
    S, W = q.shape[2], 8
    got = tatt.chunked_window_probs_mean(_t(q[:, :, S - W:]), _t(k), 0.25, S - W, chunk=chunk)
    want = jatt.chunked_window_probs_mean(jnp.asarray(q[:, :, S - W:]), jnp.asarray(k), 0.25,
                                          jnp.asarray(S - W, jnp.int32), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("chunk", [32, 4096])
def test_window_probs_mean_from_lse_matches_jax(chunk, softcap):
    q, k = _qk(2)
    S, W = q.shape[2], 8
    lse = _row_lse(q, k, 0.25, softcap)[:, :, S - W:]
    got = tatt.window_probs_mean_from_lse(_t(q[:, :, S - W:]), _t(k), _t(lse), 0.25, S - W,
                                          softcap=softcap, chunk=chunk)
    want = jatt.window_probs_mean_from_lse(
        jnp.asarray(q[:, :, S - W:]), jnp.asarray(k), jnp.asarray(lse), 0.25,
        jnp.asarray(S - W, jnp.int32), softcap=softcap, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("chunk", [8, 40, 64])
def test_chunked_observed_colsums_matches_jax(chunk, softcap):
    q, k = _qk(3, S=50)
    got = tatt.chunked_observed_colsums(_t(q), _t(k), 0.25, softcap=softcap, chunk=chunk)
    want = jatt.chunked_observed_colsums(jnp.asarray(q), jnp.asarray(k), 0.25,
                                         softcap=softcap, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_avg_pool_1d_is_torch_avg_pool():
    x = _t(np.random.default_rng(4).standard_normal((2, 4, 37)).astype(np.float32))
    from kvpress_tpu.presses.snapkv import avg_pool_1d as javg
    from kvpress_tpu_torch.presses.snapkv import avg_pool_1d as tavg

    for kernel in (1, 5, 7):
        want = torch.nn.functional.avg_pool1d(x, kernel, stride=1, padding=kernel // 2,
                                              count_include_pad=True)
        torch.testing.assert_close(tavg(x, kernel), want)
        np.testing.assert_allclose(np.asarray(javg(jnp.asarray(x.numpy()), kernel)),
                                   want.numpy(), **TOL)
    with pytest.raises(ValueError):
        tavg(x, 4)


# --------------------------------------------------------------------- #
# ops/observed_colsum.py: the plain version against the Pallas kernels

COLSUM_CASES = [(50, 16, 128), (200, 64, 128), (300, 256, 1024)]


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("S,bq,bk", COLSUM_CASES)
def test_observed_colsums_plain_matches_pallas(S, bq, bk, softcap):
    q, k = _qk(5, S=S)
    got = toc.observed_colsums_flash(_t(q), _t(k), sm_scale=0.25, softcap=softcap)
    want = jcolsums(jnp.asarray(q), jnp.asarray(k), sm_scale=0.25, softcap=softcap,
                    block_q=bq, block_k=bk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S,bq,bk", COLSUM_CASES[:2])
def test_observed_colsums_plain_with_flash_lse_matches_pallas(S, bq, bk):
    """Pass 1 skipped on both sides: each takes its own flash pass's LSE."""
    q, k = _qk(6, S=S)
    v = np.random.default_rng(7).standard_normal(k.shape).astype(np.float32)
    _, jlse = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(0, jnp.int32),
                     sm_scale=0.25, block_q=bq, block_k=bk, interpret=True, return_lse=True)
    _, tlse = flash_attention_plain(_t(q), _t(k), _t(v), 0, sm_scale=0.25, return_lse=True)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(toc.observed_lse(_t(q), _t(k), sm_scale=0.25).numpy(),
                               np.asarray(jlse), atol=2e-5, rtol=2e-5)
    got = toc.observed_colsums_flash(_t(q), _t(k), tlse, sm_scale=0.25)
    want = jcolsums(jnp.asarray(q), jnp.asarray(k), jlse, sm_scale=0.25,
                    block_q=bq, block_k=bk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


# Tile edges: the Pallas kernels' key tiles of 128 and the flash loop's (128
# keys at head_dim 64, so the row-logsumexp pass's), query stages of 128 / G
# positions, 1 and 8 query heads per kv head, head_dim 128.
COLSUM_EDGE_CASES = [
    # S, Hq, Hkv, D, bq, bk
    (127, 4, 2, 16, 32, 128),
    (128, 4, 2, 16, 32, 128),
    (129, 4, 2, 16, 32, 128),
    (257, 4, 2, 16, 64, 128),
    (129, 2, 2, 16, 64, 128),
    (257, 8, 1, 16, 16, 128),
    (200, 4, 2, 128, 64, 128),
]


@pytest.mark.parametrize("S,Hq,Hkv,D,bq,bk", COLSUM_EDGE_CASES)
def test_observed_colsums_plain_matches_pallas_at_tile_edges(S, Hq, Hkv, D, bq, bk):
    q, k = _qk(9, B=1, Hq=Hq, Hkv=Hkv, S=S, D=D)
    scale = D ** -0.5
    np.testing.assert_allclose(toc.observed_lse_plain(_t(q), _t(k), sm_scale=scale).numpy(),
                               _row_lse(q, k, scale), atol=2e-5, rtol=2e-5)
    got = toc.observed_colsums_flash(_t(q), _t(k), sm_scale=scale)
    want = jcolsums(jnp.asarray(q), jnp.asarray(k), sm_scale=scale, block_q=bq, block_k=bk,
                    interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("G,S,D,takes", [
    (4, 32768, 64, True),          # the flagship prefill
    (8, 2**21 - 1, 128, True),     # the longest S at G 8, head_dim 128
    (8, 2**21, 128, False),        # 2**31 query elements in a group
    (1, 2**25, 64, False),
    (3, 1024, 64, False),          # a group the kernel is not built for
    (16, 1024, 64, False),
])
def test_colsum_kernel_refuses_shapes_past_its_offsets(G, S, D, takes):
    if takes:
        toc._check_colsum(G, S, D)
    else:
        with pytest.raises(ValueError):
            toc._check_colsum(G, S, D)


def test_observed_colsums_plain_row_without_keys_adds_nothing():
    q, k = _qk(8, S=40)
    lse = toc.observed_lse_plain(_t(q), _t(k), sm_scale=0.25)
    full = toc.observed_colsums_plain(_t(q), _t(k), lse, sm_scale=0.25)
    holed = lse.clone()
    holed[:, :, 17] = float("-inf")        # as the flash kernel stores l == 0
    got = toc.observed_colsums_plain(_t(q), _t(k), holed, sm_scale=0.25)
    assert torch.isfinite(got).all()
    probs = tatt.window_attention_probs(_t(q[:, :, 17:18]), _t(k), 0.25, 17)[:, :, 0]
    torch.testing.assert_close(got, full - probs, **TOL)


# --------------------------------------------------------------------- #
# press scores


def _ctxs(q, k, cfg_j, cfg_t, probs=None, lse=None):
    B, _, S, D = q.shape
    jctx = JaxCtx(
        layer_idx=jnp.asarray(0), hidden=jnp.zeros((B, S, cfg_j.hidden_size)),
        queries=jnp.asarray(q), queries_prerope=jnp.asarray(q), keys_prerope=jnp.asarray(k),
        positions=jnp.arange(S)[None], attn_probs=None if probs is None else jnp.asarray(probs),
        layer_params={}, inv_freq=jnp.ones((D // 2,)), cfg=cfg_j, attention_scaling=1.0,
        attn_lse=None if lse is None else jnp.asarray(lse))
    tctx = kt.LayerCtx(
        layer_idx=0, hidden=torch.zeros((B, S, cfg_t.hidden_size)), queries=_t(q),
        queries_prerope=_t(q), keys_prerope=_t(k), positions=torch.arange(S)[None],
        attn_probs=None if probs is None else _t(probs), layer_params=None,
        inv_freq=torch.ones(D // 2), cfg=cfg_t, attention_scaling=1.0,
        attn_lse=None if lse is None else _t(lse))
    return jctx, tctx


def _probs(q, k, scale):
    S = q.shape[2]
    p = tatt.window_attention_probs(_t(q), _t(k), scale, 0)
    assert p.shape[-2:] == (S, S)
    return p.numpy()


SCORERS = {
    "snapkv": lambda m: m.SnapKVPress(0.5, window_size=8),
    "snapkv_k7": lambda m: m.SnapKVPress(0.5, window_size=16, kernel_size=7),
    "tova": lambda m: m.TOVAPress(0.5),
    "observed": lambda m: m.ObservedAttentionPress(0.5),
    "pyramidkv": lambda m: m.PyramidKVPress(0.5, window_size=8),
}


@pytest.mark.parametrize("inputs", ["queries", "probs", "lse"])
@pytest.mark.parametrize("name", sorted(SCORERS))
def test_scores_match_jax(name, inputs):
    cfg_j, cfg_t = kj.tiny_config(), kt.tiny_config()
    q, k = _qk(9, B=2, Hq=cfg_j.num_heads, Hkv=cfg_j.num_kv_heads, S=64, D=cfg_j.head_dim)
    scale = cfg_j.head_dim ** -0.5
    probs = _probs(q, k, scale) if inputs == "probs" else None
    lse = _row_lse(q, k, scale) if inputs == "lse" else None
    jctx, tctx = _ctxs(q, k, cfg_j, cfg_t, probs, lse)
    v = np.zeros_like(k)
    want = SCORERS[name](kj).score(jctx, jnp.asarray(k), jnp.asarray(v))
    got = SCORERS[name](kt).score(tctx, _t(k), _t(v))
    assert got.shape == (2, cfg_t.num_kv_heads, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_snapkv_three_branches_agree():
    """Probs, flash LSE and the chunked two-pass sweep give one score."""
    cfg_j, cfg_t = kj.tiny_config(), kt.tiny_config()
    q, k = _qk(10, B=1, Hq=cfg_t.num_heads, Hkv=cfg_t.num_kv_heads, S=64, D=cfg_t.head_dim)
    scale = cfg_t.head_dim ** -0.5

    class Chunked(kt.SnapKVPress):
        chunked_threshold = 0

    v = _t(np.zeros_like(k))
    press = kt.SnapKVPress(0.5, window_size=8)
    plain = press.score(_ctxs(q, k, cfg_j, cfg_t)[1], _t(k), v)
    from_probs = press.score(_ctxs(q, k, cfg_j, cfg_t, probs=_probs(q, k, scale))[1], _t(k), v)
    from_lse = press.score(_ctxs(q, k, cfg_j, cfg_t, lse=_row_lse(q, k, scale))[1], _t(k), v)
    chunked = Chunked(0.5, window_size=8).score(_ctxs(q, k, cfg_j, cfg_t)[1], _t(k), v)
    for other in (from_probs, from_lse, chunked):
        torch.testing.assert_close(other, plain, **TOL)
    assert press.wants_lse(8192) and not press.wants_lse(8191)


def test_pyramidkv_budgets_match_jax():
    for S, L, ratio, window, beta in [(64, 2, 0.5, 8, 20), (300, 16, 0.3, 64, 20),
                                      (32768, 16, 0.5, 64, 20), (100, 4, 0.9, 64, 5)]:
        tp = kt.PyramidKVPress(ratio, window_size=window, beta=beta)
        jp = kj.PyramidKVPress(ratio, window_size=window, beta=beta)
        assert tp._budgets(S, L) == jp._budgets(S, L)
        assert tp.exact_kept(S) is None and kt.SnapKVPress(ratio).exact_kept(S) == \
            kj.SnapKVPress(ratio).exact_kept(S)


def test_bucketed_prefill_hooks_name_the_roadmap():
    """Bucketed prefill, a valid length inside the one-shot prefill's layer
    (``ctx.kv_len``), still names its ROADMAP item. (``dynamic_score`` and
    ``dynamic_budget``, which this test first held to raise, came with
    chunked prefill; tests/test_torch_chunked.py holds them against JAX.)"""
    cfg = kt.tiny_config()
    q, k = _qk(11, B=1, Hq=cfg.num_heads, Hkv=cfg.num_kv_heads, S=32, D=cfg.head_dim)
    tctx = dataclasses.replace(_ctxs(q, k, kj.tiny_config(), cfg)[1], kv_len=20)
    mask = torch.ones(k.shape[:3], dtype=torch.bool)
    for press in (kt.ObservedAttentionPress(0.5), kt.KnormPress(0.5)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            press.layer_compress(tctx, _t(k), _t(k), 20, mask)


# --------------------------------------------------------------------- #
# through Runner.prefill and the pipeline


@pytest.fixture(scope="module")
def models():
    """Tiny-config weights in both packages. wq and wk are scaled up so that
    attention is peaked and heads differ (N(0, 0.02) weights at this width
    give near-uniform attention)."""
    cfg_j, cfg_t = kj.tiny_config(), kt.tiny_config()
    params_j = kj.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    layers = dict(params_j["layers"])
    layers["wq"], layers["wk"] = layers["wq"] * 6.0, layers["wk"] * 6.0
    params_j = dict(params_j, layers=layers)
    params_t = kt.params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), cfg_t,
                                  device="cpu", dtype=torch.float32)
    return cfg_j, cfg_t, params_j, params_t


def _ids(vocab, n, seed):
    return np.random.default_rng(seed).permutation(np.arange(3, vocab))[:n][None].astype(np.int32)


def _kept_rows(keys, layer, n):
    """Kept key rows of each (batch, head) of one layer, as a set: rows
    sorted by their first channel."""
    k = np.asarray(keys, np.float64)[layer, :, :, :n]
    order = np.argsort(k[..., 0], axis=-1)
    return np.take_along_axis(k, order[..., None], axis=2)


class _JChunked(kj.ObservedAttentionPress):
    chunked_threshold = 0


class _TChunked(kt.ObservedAttentionPress):
    chunked_threshold = 0


PREFILL_PRESSES = {
    "snapkv": lambda m, c: m.SnapKVPress(0.5, window_size=8),
    "tova": lambda m, c: m.TOVAPress(0.4),
    "observed_probs": lambda m, c: m.ObservedAttentionPress(0.5),
    "observed_chunked": lambda m, c: c(0.5),
    "pyramidkv": lambda m, c: m.PyramidKVPress(0.5, window_size=4, beta=4),
}


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("name", sorted(PREFILL_PRESSES))
def test_prefill_keeps_what_jax_keeps(models, name, attn_impl):
    """Kept entries and lengths of every layer equal the JAX dense runner's,
    on the port's dense route and on its kernel route (flash with the row
    LSE; plain versions on the CPU)."""
    cfg_j, cfg_t, params_j, params_t = models
    ids = _ids(cfg_j.vocab_size, 72, 12)
    jr = kj.Runner.create(cfg_j, attn_impl="xla")
    tr = kt.Runner.create(cfg_t, attn_impl=attn_impl, decode_kernel=False, device="cpu")
    jl, jc, _ = jr.prefill(params_j, jnp.asarray(ids), press=PREFILL_PRESSES[name](kj, _JChunked),
                           dtype=jnp.float32, compute_logits=True)
    tl, tc, _ = tr.prefill(params_t, torch.from_numpy(ids).long(),
                           press=PREFILL_PRESSES[name](kt, _TChunked), compute_logits=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    lengths = np.asarray(jc.length)
    np.testing.assert_array_equal(tc.length.numpy(), lengths)
    if name == "pyramidkv":
        assert lengths[0] > lengths[1]
    for layer, n in enumerate(lengths):
        np.testing.assert_allclose(_kept_rows(tc.keys.numpy(), layer, n),
                                   _kept_rows(jc.keys, layer, n), atol=1e-5)


def test_flash_route_hands_the_press_an_lse_and_no_probs(models):
    _, cfg_t, _, params_t = models
    seen = []

    class Spy(_TChunked):
        def score(self, ctx, keys, values):
            seen.append((ctx.attn_probs, ctx.attn_lse))
            return super().score(ctx, keys, values)

    ids = torch.from_numpy(_ids(cfg_t.vocab_size, 40, 13)).long()
    for impl in ("flash", "xla"):
        kt.Runner.create(cfg_t, attn_impl=impl, device="cpu").prefill(
            params_t, ids, press=Spy(0.5))
    (p0, l0), (p1, l1) = seen[0], seen[cfg_t.num_layers]
    assert p0 is None and tuple(l0.shape) == (1, cfg_t.num_heads, 40)
    assert p1 is None and l1 is None
    seen.clear()
    kt.Runner.create(cfg_t, attn_impl="flash", device="cpu").prefill(
        params_t, ids, press=kt.ObservedAttentionPress(0.5), quantized=True, kv_bits=8)
    kt.Runner.create(cfg_t, attn_impl="flash", device="cpu").prefill(
        params_t, ids, press=Spy(0.5), quantized=True, kv_bits=8)
    assert seen[0][1] is not None          # quantized cache: dense-dequant flash route


@pytest.mark.parametrize("press", ["observed", "snapkv", "pyramidkv"])
def test_pipeline_same_greedy_answers_as_jax(models, press):
    cfg_j, cfg_t, params_j, params_t = models
    tok = ToyTokenizer(cfg_j.vocab_size)
    seen, words, i = set(), [], 0
    while len(words) < 70:
        t = tok.encode(f"word{i}")[0]
        if t not in seen:
            seen.add(t)
            words.append(f"word{i}")
        i += 1
    context, questions = " ".join(words[:60]), ["what is " + words[60] + " ?",
                                                " ".join(words[61:70])]
    make = {"observed": lambda m: m.ObservedAttentionPress(0.5),
            "snapkv": lambda m: m.SnapKVPress(0.5, window_size=8),
            "pyramidkv": lambda m: m.PyramidKVPress(0.5, window_size=4, beta=4)}[press]
    jp = JaxPipeline(kj.Runner.create(cfg_j, attn_impl="xla"), params_j, tok)
    tp = kt.KVPressPipeline(kt.Runner.create(cfg_t, device="cpu"), params_t, tok)
    want = jp(context, questions=questions, press=make(kj), max_new_tokens=6)["answers"]
    got = tp(context, questions=questions, press=make(kt), max_new_tokens=6)["answers"]
    assert got == want and all(len(a.split()) == 6 for a in got)
