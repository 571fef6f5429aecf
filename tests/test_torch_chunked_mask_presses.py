"""The mask and head-split presses of kvpress_tpu_torch through chunked
prefill (``Runner.prefill_chunked``, the pipeline's ``context_chunk``) against
the JAX package on the same weights and inputs (CPU, float32, tiny config):
DMS over Knorm and KVzap (each chunk's tokens scored through the wrapped
press's ``chunk_score_fn``, the threshold mask and ring set after the last
chunk), Duo, SimLayerKV and Finch (``chunked_compress`` over float32 KV and
``chunked_compress_quantized`` over int8 and int4 KV), and the refusals.

Tolerances: logits within 1e-4; lengths, masks, rings' counts and greedy
answers equal; kept entries and ring scores within 1e-5 (kept entries as sets,
dequantized on a quantized cache). Finch's rerotated keys over a quantized
cache are requantized: slot by slot within one code of their own scale (JAX's
compiled quantizer rounds x * (1 / scale), eager code x / scale).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
from kvpress_tpu.presses.knorm import _knorm_chunk_scores as j_knorm_chunk_scores
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.presses.knorm import _knorm_chunk_scores
from toy_tokenizer import ToyTokenizer
from torch_mask_cases import both
from torch_scorer_cases import distinct_words, kept_rows, seeded_ids, tiny_models

torch.set_num_threads(2)

S, CHUNK, SLACK = 64, 16, 16
CHUNKED = ["dms_knorm", "dms_kvzap", "duo", "simlayerkv", "simlayerkv_all_lazy", "finch",
           "finch_chunks"]
KV = {"float32": {}, "int8": dict(quantized=True, kv_bits=8),
      "int4": dict(quantized=True, kv_bits=4)}


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def _rows(cache, field, bits):
    """(L, B, H, S, D) float64 entries: dequantized payloads on a quantized
    cache."""
    x = getattr(cache, field)
    x = torch.from_numpy(np.array(x)) if not isinstance(x, torch.Tensor) else x
    if cache.key_scales is None:
        return x.numpy().astype(np.float64)
    s = getattr(cache, "key_scales" if field == "keys" else "value_scales")
    s = torch.from_numpy(np.array(s)) if not isinstance(s, torch.Tensor) else s
    return kt.dequantize_kv(x, s, bits, torch.float64).numpy()


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("name", CHUNKED)
def test_chunked_matches_jax(models, name, kv):
    """Chunks of 16 into a buffer 16 slots longer than the context (slots
    past the valid length hold zeros), compressed after the last chunk."""
    cfg_j, cfg_t, params_j, params_t = models
    ids = seeded_ids(cfg_t.vocab_size, S, 14)
    kw = dict(chunk_size=CHUNK, compute_logits=True, max_size=S + SLACK, **KV[kv])
    jpress, tpress = both(name)
    jl, jc, js = kj.Runner.create(cfg_j, attn_impl="xla").prefill_chunked(
        params_j, jnp.asarray(ids), press=jpress, dtype=jnp.float32, **kw)
    tr = kt.Runner.create(cfg_t, attn_impl="flash", device="cpu")
    tl, tc, ts = tr.prefill_chunked(params_t, torch.from_numpy(ids).long(), press=tpress, **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    if jc.mask is not None:
        np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    bits = KV[kv].get("kv_bits")
    for field in ("keys", "values"):
        got, want = _rows(tc, field, bits), _rows(jc, field, bits)
        for layer, n in enumerate(np.asarray(jc.length)):
            if bits and field == "keys" and name == "finch":
                # rerotated and requantized, in position order: within one code
                step = np.asarray(jc.key_scales, np.float64)[layer, :, :, :n]
                assert (np.abs(got[layer, :, :, :n] - want[layer, :, :, :n])
                        < step + 1e-5).all(), layer
                continue
            np.testing.assert_allclose(kept_rows(got, layer, n), kept_rows(want, layer, n),
                                       atol=1e-5, rtol=1e-5)
    if name.startswith("dms"):
        assert js is not None and len(ts) == cfg_t.num_layers
        for l, ring in enumerate(ts):
            np.testing.assert_allclose(ring["scores"].numpy(), np.asarray(js["scores"][l]),
                                       atol=1e-5, rtol=1e-5)
            assert (ring["count"], ring["first_slot"]) == (
                int(js["count"][l]), int(js["first_slot"][l])) == (16, S - 16)
        assert 0 < float(kt.masked_fraction(tc)) < 1
    else:
        assert ts is None


@pytest.mark.parametrize("name", ["dms_knorm", "dms_kvzap", "duo", "simlayerkv"])
def test_chunked_keeps_what_one_shot_keeps(models, name):
    """Over float32 KV a per-token or position-only press keeps in chunks
    what it keeps in one shot: DMS's scores read a token's own hidden state
    or key, Duo's mask positions alone; SimLayerKV decides from the last
    query, which the scoring window holds (its threshold set between the two
    layers' one-shot lazy scores, so that one layer is lazy)."""
    _, cfg_t, _, params_t = models
    ids = torch.from_numpy(seeded_ids(cfg_t.vocab_size, S, 14)).long()
    press = both(name)[1]
    runner = kt.Runner.create(cfg_t, attn_impl="flash", device="cpu")
    if name == "simlayerkv":
        lazy = []

        class Recording(kt.SimLayerKVPress):
            def lazy_score(self, ctx, keys, length):
                lazy.append(float(super().lazy_score(ctx, keys, length)))
                return lazy[-1]

        runner.prefill(params_t, ids, press=Recording(0.5, n_recent=16))
        press = kt.SimLayerKVPress(sum(lazy) / 2, n_recent=16)
    _, one, _ = runner.prefill(params_t, ids, press=press)
    _, chunked, _ = runner.prefill_chunked(params_t, ids, press=press, chunk_size=CHUNK)
    assert chunked.length.tolist() == one.length.tolist()
    if name == "simlayerkv":
        assert sorted(one.length.tolist()) == [4 + 15, S]
        for layer, n in enumerate(one.length.tolist()):
            np.testing.assert_allclose(chunked.keys[layer, :, :, :n], one.keys[layer, :, :, :n],
                                       atol=1e-5)
    else:
        np.testing.assert_array_equal(chunked.mask.numpy(), one.mask.numpy())


def test_knorm_chunk_scores_match_jax(models):
    rng = np.random.default_rng(0)
    keys = rng.standard_normal((1, 2, 9, 16)).astype(np.float32)
    got = _knorm_chunk_scores(None, 0, None, torch.from_numpy(keys), None)
    want = j_knorm_chunk_scores(None, 0, None, jnp.asarray(keys), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert kt.KnormPress.chunk_score_fn is not None and kt.SnapKVPress.chunk_score_fn is None


@pytest.mark.parametrize("quantized", [False, True])
def test_lean_forward_collects_each_chunks_scores(models, quantized):
    """``_chunk_forward_lean(collect_fn=...)``: one (L, B, H, T) block a
    chunk, the chunk's own keys' norms (dequantized from the chunk's stored
    payload over a quantized cache)."""
    _, cfg_t, _, params_t = models
    runner = kt.Runner.create(cfg_t, attn_impl="flash", device="cpu")
    cache = kt.init_cache(cfg_t, 1, 32, dtype=torch.float32, quantized=quantized, device="cpu")
    ids = torch.from_numpy(seeded_ids(cfg_t.vocab_size, 32, 2)).long()
    out = []
    for start in (0, 16):
        _, cache, _ = runner._chunk_forward_lean(params_t, ids[:, start:start + 16], cache,
                                                 collect_fn=_knorm_chunk_scores,
                                                 scores_out=out)
    assert [tuple(o.shape) for o in out] == [(cfg_t.num_layers, 1, cfg_t.num_kv_heads, 16)] * 2
    keys = cache.keys if not quantized else kt.dequantize_kv(cache.keys, cache.key_scales, 8,
                                                             torch.float32)
    want = -torch.linalg.vector_norm(keys, dim=-1)
    torch.testing.assert_close(torch.cat(out, dim=-1), want, atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------------ #
# Refusals


@pytest.mark.parametrize("name", ["merging_knorm", "lukv_knorm"])
def test_presses_without_a_chunked_form_refused(models, name):
    """JAX asserts; the port raises a TypeError naming what it takes."""
    cfg_j, cfg_t, params_j, params_t = models
    ids = seeded_ids(cfg_t.vocab_size, S, 14)
    jpress, tpress = both(name)
    with pytest.raises(AssertionError, match="prefill_chunked cannot compress"):
        kj.Runner.create(cfg_j, attn_impl="xla").prefill_chunked(
            params_j, jnp.asarray(ids), press=jpress, chunk_size=CHUNK, dtype=jnp.float32)
    with pytest.raises(TypeError, match="prefill_chunked cannot compress"):
        kt.Runner.create(cfg_t, device="cpu").prefill_chunked(
            params_t, torch.from_numpy(ids).long(), press=tpress, chunk_size=CHUNK)


def test_dms_over_a_window_scorer_refused_with_its_reason(models):
    cfg_j, cfg_t, params_j, params_t = models
    ids = seeded_ids(cfg_t.vocab_size, S, 14)
    with pytest.raises(AssertionError, match="per-token chunk_score_fn"):
        kj.Runner.create(cfg_j, attn_impl="xla").prefill_chunked(
            params_j, jnp.asarray(ids), press=kj.DMSPress(kj.SnapKVPress()), chunk_size=CHUNK,
            dtype=jnp.float32)
    with pytest.raises(ValueError, match="per-token chunk_score_fn"):
        kt.Runner.create(cfg_t, device="cpu").prefill_chunked(
            params_t, torch.from_numpy(ids).long(), press=kt.DMSPress(kt.SnapKVPress()),
            chunk_size=CHUNK)


def test_finch_window_past_the_scoring_window(models):
    _, cfg_t, _, params_t = models
    ids = torch.from_numpy(seeded_ids(cfg_t.vocab_size, S, 14)).long()
    with pytest.raises(ValueError, match="scoring window"):
        kt.Runner.create(cfg_t, device="cpu").prefill_chunked(
            params_t, ids, press=kt.FinchPress(0.5, window_size=20), chunk_size=CHUNK)


# ------------------------------------------------------------------ #
# Pipeline


@pytest.mark.parametrize("name", ["dms_kvzap_mlp_compact", "duo", "simlayerkv"])
def test_pipeline_context_chunk_same_answers_as_jax(models, name):
    cfg_j, cfg_t, params_j, params_t = models
    tok = ToyTokenizer(cfg_j.vocab_size)
    words = distinct_words(tok, 70)
    jpress, tpress = both(name)
    kw = dict(max_new_tokens=6, context_chunk=CHUNK,
              questions=["what is " + words[60] + " ?", " ".join(words[61:70])])
    context = " ".join(words[:60])
    jpipe = JaxPipeline(kj.Runner.create(cfg_j, attn_impl="xla"), params_j, tok)
    tpipe = kt.KVPressPipeline(kt.Runner.create(
        cfg_t, attn_impl="flash", decode_kernel=False, device="cpu",
        headwise_kernel=name.endswith("compact")), params_t, tok)
    want = jpipe(context, press=jpress, **kw)["answers"]
    got = tpipe(context, press=tpress, **kw)["answers"]
    assert got == want and all(len(a.split()) == 6 for a in got)


def test_pipeline_finch_context_chunk_answers_as_jax_one_shot(models):
    """Finch's query-aware form (context, delimiter, question; no question)
    with context_chunk answers as the JAX one-shot pipeline: its window (12
    tokens) fits the scoring window, so the chunked keep is the one-shot
    keep. (The JAX pipeline cannot decode after a chunked Finch prefill: its
    cache comes out without a keep-mask and the decode loop's carry gains
    one.)"""
    cfg_j, cfg_t, params_j, params_t = models
    tok = ToyTokenizer(cfg_j.vocab_size)
    words = distinct_words(tok, 70)
    context = " ".join(words[:50]) + " </s> " + " ".join(words[50:62])
    jpipe = JaxPipeline(kj.Runner.create(cfg_j, attn_impl="xla"), params_j, tok)
    tpipe = kt.KVPressPipeline(kt.Runner.create(cfg_t, attn_impl="flash", decode_kernel=False,
                                                device="cpu"), params_t, tok)
    want = jpipe(context, question="", press=kj.FinchPress(0.5, delimiter_token_id=2),
                 max_new_tokens=6)["answer"]
    got = tpipe(context, question="", press=kt.FinchPress(0.5, delimiter_token_id=2),
                max_new_tokens=6, context_chunk=CHUNK)["answer"]
    assert got == want and len(got.split()) == 6
