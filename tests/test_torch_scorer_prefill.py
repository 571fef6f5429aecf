"""The scorer presses of kvpress_tpu_torch that score without a kernel
(ExpectedAttention, KeyDiff, LagKV, CUR, QFilter, CAP, Compactor, KVzap) through
``Runner.prefill``, ``collect_query_stats``, ``KVPressPipeline`` and chunked
prefill, against the JAX package on the same weights and inputs (CPU,
float32, tiny config).

Tolerances: logits within 1e-4; kept sets (key rows within 1e-5, 1e-4 after
chunked prefill), lengths and greedy answers equal; query statistics within
1e-5. The random sketches come from the JAX package on both sides
(tests/torch_scorer_cases.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
from kvpress_tpu.presses.expected_attention_stats import collect_query_stats as j_collect
import kvpress_tpu_torch as kt
from toy_tokenizer import ToyTokenizer
from torch_scorer_cases import (both, distinct_words, kept_rows, seeded_ids, tiny_models,
                                use_jax_sketches)

torch.set_num_threads(2)


@pytest.fixture
def jax_sketches(monkeypatch):
    use_jax_sketches(monkeypatch)


@pytest.fixture(scope="module")
def models():
    return tiny_models()


PREFILL = ["expected_attention", "expected_attention_stats", "keydiff", "lagkv", "cur_random",
           "qfilter", "cap", "noncausal", "leverage", "compactor", "kvzap_mlp"]
_JAX_PREFILLS = {}


def _jax_prefill(models, name, ids):
    """The JAX dense runner's prefill of one press, once per module."""
    cfg_j, _, params_j, _ = models
    if name not in _JAX_PREFILLS:
        _JAX_PREFILLS[name] = kj.Runner.create(cfg_j, attn_impl="xla").prefill(
            params_j, jnp.asarray(ids), press=both(name)[0], dtype=jnp.float32,
            compute_logits=True)
    return _JAX_PREFILLS[name]


@pytest.mark.usefixtures("jax_sketches")
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("name", PREFILL)
def test_prefill_keeps_what_jax_keeps(models, name, attn_impl):
    """Kept entries and lengths of every layer equal the JAX dense runner's,
    on the port's dense route and on its kernel route (plain versions on the
    CPU)."""
    cfg_j, cfg_t, _, params_t = models
    ids = seeded_ids(cfg_j.vocab_size, 72, 12)
    jl, jc, _ = _jax_prefill(models, name, ids)
    tr = kt.Runner.create(cfg_t, attn_impl=attn_impl, decode_kernel=False, device="cpu")
    tl, tc, _ = tr.prefill(params_t, torch.from_numpy(ids).long(), press=both(name)[1],
                           compute_logits=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    lengths = np.asarray(jc.length)
    np.testing.assert_array_equal(tc.length.numpy(), lengths)
    assert (lengths == 36).all()
    for layer, n in enumerate(lengths):
        np.testing.assert_allclose(kept_rows(tc.keys.numpy(), layer, n),
                                   kept_rows(jc.keys, layer, n), atol=1e-5)


def test_collect_query_stats_matches_jax(models):
    cfg_j, cfg_t, params_j, params_t = models
    samples = [seeded_ids(cfg_j.vocab_size, 40, 20), seeded_ids(cfg_j.vocab_size, 24, 21)]
    want = j_collect(kj.Runner.create(cfg_j, attn_impl="xla"), params_j,
                     [jnp.asarray(s) for s in samples])
    got = kt.collect_query_stats(kt.Runner.create(cfg_t, device="cpu"), params_t,
                                 [torch.from_numpy(s).long() for s in samples])
    assert got["mu"].shape == (2, 4, 16) and got["cov"].shape == (2, 4, 16, 16)
    for k in ("mu", "cov"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5, rtol=1e-5)


@pytest.mark.usefixtures("jax_sketches")
@pytest.mark.parametrize("name", ["expected_attention", "compactor", "kvzap_mlp", "cap"])
def test_pipeline_same_greedy_answers_as_jax(models, name):
    cfg_j, cfg_t, params_j, params_t = models
    tok = ToyTokenizer(cfg_j.vocab_size)
    words = distinct_words(tok, 70)
    context, questions = " ".join(words[:60]), ["what is " + words[60] + " ?",
                                                " ".join(words[61:70])]
    jpress, tpress = both(name)
    jpipe = JaxPipeline(kj.Runner.create(cfg_j, attn_impl="xla"), params_j, tok)
    tpipe = kt.KVPressPipeline(kt.Runner.create(cfg_t, device="cpu"), params_t, tok)
    want = jpipe(context, questions=questions, press=jpress, max_new_tokens=6)["answers"]
    got = tpipe(context, questions=questions, press=tpress, max_new_tokens=6)["answers"]
    assert got == want and all(len(a.split()) == 6 for a in got)


# The presses the JAX chunked prefill cannot compress: its compression pass
# has the last window's post-RoPE queries and hidden states only (no
# pre-RoPE queries or keys, no query a slot).
CHUNK_REFUSED = {"expected_attention", "expected_attention_stats", "cap", "noncausal",
                 "leverage", "compactor", "kvzap_mlp"}


@pytest.mark.usefixtures("jax_sketches")
@pytest.mark.parametrize("name", PREFILL)
def test_context_chunk_as_jax_takes_it(models, name):
    """Through ``prefill_chunked`` (chunks of 16, a scoring window of 16
    re-projected queries): where the JAX runner compresses, the kept sets
    match; where it fails, the port raises a ValueError that says why."""
    cfg_j, cfg_t, params_j, params_t = models
    ids = seeded_ids(cfg_j.vocab_size, 64, 14)
    kw = dict(chunk_size=16, compute_logits=True)
    jpress, tpress = both(name)
    tr = kt.Runner.create(cfg_t, attn_impl="flash", device="cpu")
    jr = kj.Runner.create(cfg_j, attn_impl="xla")
    if name in CHUNK_REFUSED:
        with pytest.raises((AttributeError, AssertionError, ValueError, TypeError)):
            jr.prefill_chunked(params_j, jnp.asarray(ids), press=jpress, dtype=jnp.float32, **kw)
        with pytest.raises(ValueError, match="prefill"):
            tr.prefill_chunked(params_t, torch.from_numpy(ids).long(), press=tpress, **kw)
        return
    jl, jc, _ = jr.prefill_chunked(params_j, jnp.asarray(ids), press=jpress, dtype=jnp.float32,
                                   **kw)
    tl, tc, _ = tr.prefill_chunked(params_t, torch.from_numpy(ids).long(), press=tpress, **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    for layer, n in enumerate(np.asarray(jc.length)):
        np.testing.assert_allclose(kept_rows(tc.keys.numpy(), layer, n),
                                   kept_rows(jc.keys, layer, n), atol=1e-4)
