"""The scorer presses of kvpress_tpu_torch that score without a kernel (ExpectedAttention
and its stats variant, KeyDiff, LagKV, CUR, QFilter, CAP, the Compactor
family, KVzap) and ``rope.mean_rotation_matrix``, against the JAX package on
the same seeded numpy inputs (CPU, float32, tiny config): ``score`` and
``dynamic_score`` of each press, the leverage arithmetic on one injected
sketch, the adaptive-jitter Cholesky, the artifacts' files.

Tolerances: scores and rotation matrices agree to 1e-5 (float32 sums taken
in another order), 1e-4 where a linear solve or a Cholesky factor stands
between (CAP, the leverage scores, Compactor). The random sketches come from
the JAX package on both sides (tests/torch_scorer_cases.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu import presses as jp
from kvpress_tpu.presses.base import LayerCtx as JaxCtx
from kvpress_tpu.rope import mean_rotation_matrix as j_mean_rotation
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.presses import compactor as tcompactor
from kvpress_tpu_torch.rope import mean_rotation_matrix as t_mean_rotation
from torch_scorer_cases import (ART, PRESSES, SOLVE_TOL, TOL, as_torch as _t, jax_sketch, tol,
                                use_jax_sketches)

torch.set_num_threads(2)


@pytest.fixture
def jax_sketches(monkeypatch):
    use_jax_sketches(monkeypatch)


@pytest.mark.parametrize("start,n_future", [(0, 1), (40, 16), (96, 512), (32768, 512),
                                             (131072, 64)])
def test_mean_rotation_matrix_matches_jax(start, n_future):
    inv = kj.Runner.create(kj.tiny_config(head_dim=64)).inv_freq()
    want = j_mean_rotation(inv, jnp.asarray(start, jnp.float32), n_future)
    got = t_mean_rotation(_t(inv), start, n_future)
    assert got.dtype == torch.float32 and got.shape == (64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


B, S, LAYER = 2, 80, 1
# The JAX stats press broadcasts its (1, Hq, D) statistics over batch 1 only.
BATCH_1 = ("expected_attention_stats",)


@pytest.fixture(scope="module")
def inputs():
    cfg_j, cfg_t = kj.tiny_config(), kt.tiny_config()
    Hq, Hkv, D, E = cfg_j.num_heads, cfg_j.num_kv_heads, cfg_j.head_dim, cfg_j.hidden_size
    rng = np.random.default_rng(0)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    a = dict(q=f(B, Hq, S, D), q_pre=f(B, Hq, S, D), k_pre=f(B, Hkv, S, D), k=f(B, Hkv, S, D),
             v=f(B, Hkv, S, D), h=f(B, S, E))
    inv = np.asarray(kj.Runner.create(cfg_j).inv_freq())
    jctx = JaxCtx(layer_idx=jnp.asarray(LAYER), hidden=jnp.asarray(a["h"]),
                  queries=jnp.asarray(a["q"]), queries_prerope=jnp.asarray(a["q_pre"]),
                  keys_prerope=jnp.asarray(a["k_pre"]), positions=jnp.arange(S)[None],
                  attn_probs=None, layer_params={}, inv_freq=jnp.asarray(inv), cfg=cfg_j,
                  attention_scaling=1.0)
    tctx = kt.LayerCtx(layer_idx=LAYER, hidden=_t(a["h"]), queries=_t(a["q"]),
                       queries_prerope=_t(a["q_pre"]), keys_prerope=_t(a["k_pre"]),
                       positions=torch.arange(S)[None], attn_probs=None, layer_params=None,
                       inv_freq=_t(inv), cfg=cfg_t, attention_scaling=1.0)
    return a, jctx, tctx


def _inputs_for(inputs, name):
    """The inputs, cut to the first batch row for a press of BATCH_1."""
    a, jctx, tctx = inputs
    if name not in BATCH_1:
        return inputs
    cut = lambda ctx: dataclasses.replace(
        ctx, **{f: getattr(ctx, f)[:1] for f in ("hidden", "queries", "queries_prerope",
                                                 "keys_prerope")})
    return {n: x[:1] for n, x in a.items()}, cut(jctx), cut(tctx)


@pytest.mark.usefixtures("jax_sketches")
@pytest.mark.parametrize("name", sorted(PRESSES))
def test_scores_match_jax(inputs, name):
    a, jctx, tctx = _inputs_for(inputs, name)
    want = PRESSES[name](jp).score(jctx, jnp.asarray(a["k"]), jnp.asarray(a["v"]))
    got = PRESSES[name](kt).score(tctx, _t(a["k"]), _t(a["v"]))
    assert got.shape == (a["k"].shape[0], kt.tiny_config().num_kv_heads, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol(name))


@pytest.mark.usefixtures("jax_sketches")
@pytest.mark.parametrize("length", [9, 57, S])
@pytest.mark.parametrize("name", sorted(PRESSES))
def test_dynamic_scores_match_jax(inputs, name, length):
    """Against a valid length: the scores of the valid slots (the caller
    masks the rest)."""
    a, jctx, tctx = _inputs_for(inputs, name)
    want = PRESSES[name](jp).dynamic_score(jctx, jnp.asarray(a["k"]), jnp.asarray(a["v"]),
                                           jnp.asarray(length, jnp.int32))
    got = PRESSES[name](kt).dynamic_score(tctx, _t(a["k"]), _t(a["v"]), length)
    np.testing.assert_allclose(got[..., :length].numpy(), np.asarray(want)[..., :length],
                               **tol(name))


@pytest.mark.parametrize("valid_len", [None, 50])
def test_leverage_arithmetic_with_jax_sketch(inputs, valid_len):
    """``compute_leverage_scores`` and CUR's ``leverage_scores`` (each
    leverage type) on one injected sketch."""
    a, jctx, _ = inputs
    valid = None if valid_len is None else np.arange(S) < valid_len
    jvalid = None if valid is None else jnp.asarray(valid)
    tvalid = None if valid is None else _t(valid)
    phi = jax_sketch(0, LAYER, (B, 2, 16, 8))
    want = jp.LeverageScorePress.compute_leverage_scores(jnp.asarray(a["k_pre"]),
                                                         jnp.asarray(phi), jvalid)
    got = kt.LeverageScorePress.compute_leverage_scores(_t(a["k_pre"]), _t(phi), tvalid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SOLVE_TOL)
    G = jax_sketch(4, LAYER, (16, 20))
    for lt in ("key", "value", "kv_avg", "kv_product"):
        # JAX: no sketch inside the press, the keys and values projected here.
        want = jp.CURPress(0.5, leverage_type=lt).score(
            jctx, jnp.asarray(a["k"] @ G), jnp.asarray(a["v"] @ G), valid=jvalid)
        got = kt.CURPress(0.5, leverage_type=lt).leverage_scores(_t(a["k"]), _t(a["v"]),
                                                                 _t(G), tvalid)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sketches_are_seeded():
    ctx = kt.LayerCtx(layer_idx=3, hidden=None, queries=None, queries_prerope=None,
                      keys_prerope=None, positions=None, attn_probs=None, layer_params=None,
                      inv_freq=None)
    lev = kt.LeverageScorePress(0.5, sketch_dimension=8, seed=1)
    one, two = lev.sketch(ctx, (1, 2, 16), "cpu"), lev.sketch(ctx, (1, 2, 16), "cpu")
    other = lev.sketch(dataclasses.replace(ctx, layer_idx=4), (1, 2, 16), "cpu")
    assert one.shape == (1, 2, 16, 8) and torch.equal(one, two) and not torch.equal(one, other)
    cur = kt.CURPress(0.5, use_random_leverage=True, seed=1)
    assert torch.equal(cur.sketch(ctx, 16, "cpu"), cur.sketch(ctx, 16, "cpu"))


def _rank_deficient_keys(seed):
    """Eight keys on one line through the origin (rank 1 after centring) of
    norm about 1e3, and a (8, 3) sketch: the Gram matrix's float32 rounding
    outweighs the first jitters."""
    rng = np.random.default_rng(seed)
    base = (rng.standard_normal((1, 1, 1, 8)) * 1000).astype(np.float32)
    keys = base * np.array([-1.0, 1.0] * 4, np.float32)[None, None, :, None]
    return keys, (rng.standard_normal((1, 1, 8, 3)) / np.sqrt(3)).astype(np.float32)


def _gram(xp, keys, phi):
    """The Gram matrix as each side's compute_leverage_scores forms it."""
    X = (keys - keys.mean(-2, keepdims=True) if xp is jnp
         else keys - keys.mean(-2, keepdim=True)) @ phi
    G = X.swapaxes(-2, -1) @ X if xp is jnp else X.transpose(-2, -1) @ X
    return 0.5 * (G + (G.swapaxes(-2, -1) if xp is jnp else G.transpose(-2, -1)))


# seed: how many jitters fail before one factors (the same on both sides)
@pytest.mark.parametrize("seed,failing", [(8, 1), (5, 2)])
def test_leverage_cholesky_takes_the_jitter_path_on_both_sides(seed, failing):
    keys, phi = _rank_deficient_keys(seed)
    Gj, Gt = _gram(jnp, jnp.asarray(keys), jnp.asarray(phi)), _gram(torch, _t(keys), _t(phi))
    eye = np.eye(3, dtype=np.float32)
    for i, jitter in enumerate(tcompactor.JITTERS):
        # JAX: a failed factor is NaN; the port: cholesky_ex reports it in info.
        assert bool(np.isnan(np.asarray(jnp.linalg.cholesky(Gj + jitter * eye))).any()) == \
            (i < failing)
        assert (int(torch.linalg.cholesky_ex(Gt + jitter * _t(eye)).info.max()) > 0) == \
            (i < failing)
    assert torch.isfinite(tcompactor.cholesky_with_jitter(Gt)).all()
    want = jp.LeverageScorePress.compute_leverage_scores(jnp.asarray(keys), jnp.asarray(phi))
    got = kt.LeverageScorePress.compute_leverage_scores(_t(keys), _t(phi))
    assert np.isfinite(np.asarray(want)).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SOLVE_TOL)


def test_artifacts_round_trip(tmp_path):
    kt.save_query_stats(str(tmp_path / "stats.npz"), ART["stats"])
    got = kt.load_query_stats(str(tmp_path / "stats.npz"))
    assert all(np.array_equal(got[k], ART["stats"][k]) for k in ("mu", "cov"))
    kt.save_kvzap_model(str(tmp_path / "kvzap.npz"), ART["mlp"])
    got = kt.load_kvzap_model(str(tmp_path / "kvzap.npz"))
    assert got.keys() == ART["mlp"].keys()
    assert all(np.array_equal(got[k], ART["mlp"][k]) for k in got)
    np.savez(tmp_path / "filt.npz", q_filters=ART["q_filters"])
    np.save(tmp_path / "filt.npy", ART["q_filters"])
    for name in ("filt.npz", "filt.npy"):
        assert np.array_equal(kt.load_q_filters(str(tmp_path / name)), ART["q_filters"])


def test_chunk_score_fn_is_the_surrogate(inputs):
    a, _, tctx = inputs
    press = kt.KVzapPress(0.5, surrogate=ART["mlp"])
    got = press.chunk_score_fn(press.chunk_score_arg, LAYER, _t(a["h"]), None, None)
    torch.testing.assert_close(got, press.score(tctx, _t(a["k"]), _t(a["v"])))
    # a window scorer has none (Knorm's is held in test_torch_chunked_mask_presses.py)
    assert kt.SnapKVPress(0.5).chunk_score_fn is None
