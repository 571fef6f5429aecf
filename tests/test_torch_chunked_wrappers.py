"""The wrapper presses of kvpress_tpu_torch through chunked prefill
(``Runner.prefill_chunked``, the pipeline's ``context_chunk``) against the
JAX package on the same weights and inputs (CPU, float32, tiny config):
each ``chunked_compress`` over float32 KV and ``chunked_compress_quantized``
over int8 and int4 KV, the scorer-like wrappers (CriticalKV,
PerLayerCompression) through ``BudgetDecodingPress``, and the refusals.

Tolerances: logits within 1e-4; lengths, head-wise masks and greedy answers
equal; kept entries within 1e-5 as sets (two slots whose scores differ by
rounding may trade places), dequantized on a quantized cache. Keys that are
requantized (KeyRerotation, ThinK) are held slot by slot within one code of
their own scale: the JAX package's compiled quantizer rounds x * (1 / scale)
where eager code rounds x / scale, so a value half a step from two codes goes
either way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
import kvpress_tpu_torch as kt
from toy_tokenizer import ToyTokenizer
from torch_scorer_cases import distinct_words, kept_rows, seeded_ids, tiny_models
from torch_wrapper_cases import WRAPPERS, both

torch.set_num_threads(2)

S, CHUNK, SLACK = 64, 16, 16
# The JAX chunked compression pass has no pre-RoPE queries: ExpectedAttention
# cannot score there (ROADMAP, standing records), wrapped or not.
REFUSED_SCORER = ["critical_expected_attention", "critical_adakv_expected_attention"]
CHUNKED = [n for n in WRAPPERS if n not in REFUSED_SCORER + ["block_keydiff"]]
REQUANTIZED = ("key_rerotation", "think", "snap_think")
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
    past the valid length hold zeros), compressed once after the last chunk."""
    cfg_j, cfg_t, params_j, params_t = models
    ids = seeded_ids(cfg_t.vocab_size, S, 14)
    kw = dict(chunk_size=CHUNK, compute_logits=True, max_size=S + SLACK, **KV[kv])
    jpress, tpress = both(name)
    jl, jc, _ = kj.Runner.create(cfg_j, attn_impl="xla").prefill_chunked(
        params_j, jnp.asarray(ids), press=jpress, dtype=jnp.float32, **kw)
    tr = kt.Runner.create(cfg_t, attn_impl="flash", device="cpu")
    tl, tc, _ = tr.prefill_chunked(params_t, torch.from_numpy(ids).long(), press=tpress, **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    if jc.mask is not None:
        np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    bits = KV[kv].get("kv_bits")
    for field in ("keys", "values"):
        got, want = _rows(tc, field, bits), _rows(jc, field, bits)
        for layer, n in enumerate(np.asarray(jc.length)):
            if jc.mask is not None and not getattr(jpress, "compact", False):
                n = S          # mask bits only: the kept slots stay where they were
            if bits and field == "keys" and name in REQUANTIZED:
                # kept in position order: slot by slot, within one code
                step = np.asarray(jc.key_scales, np.float64)[layer, :, :, :n]
                assert (np.abs(got[layer, :, :, :n] - want[layer, :, :, :n])
                        < step + 1e-5).all(), (name, layer)
                continue
            np.testing.assert_allclose(kept_rows(got, layer, n), kept_rows(want, layer, n),
                                       atol=1e-5, rtol=1e-5)
    if name == "think":
        zero = (tc.keys[:, :, :, :S] == 0).all(dim=3) if not bits else None
        if zero is not None:
            assert zero.sum(-1).tolist() == [[[8, 8]]] * cfg_t.num_layers


def test_scorer_like_wrappers_take_the_budget_route(models, monkeypatch):
    """CriticalKV and PerLayerCompression have no ``chunked_compress``: each
    layer is compressed by a ``BudgetDecodingPress`` over the wrapper, with
    the wrapper's own per-layer budget."""
    from kvpress_tpu_torch.presses import decoding

    _, cfg_t, _, params_t = models
    seen = []
    original = decoding.BudgetDecodingPress.target_value
    monkeypatch.setattr(decoding.BudgetDecodingPress, "target_value",
                        lambda self, ctx, length: seen.append(type(self.base_press).__name__)
                        or original(self, ctx, length))
    ids = torch.from_numpy(seeded_ids(cfg_t.vocab_size, S, 14)).long()
    runner = kt.Runner.create(cfg_t, attn_impl="flash", device="cpu")
    for name in ("critical_snapkv", "per_layer"):
        _, cache, _ = runner.prefill_chunked(params_t, ids, press=both(name)[1],
                                             chunk_size=CHUNK)
        assert cache.length.tolist() == ([32, 32] if name != "per_layer" else [48, 16])
    assert seen == ["CriticalKVPress"] * 2 + ["PerLayerCompressionPress"] * 2


def test_block_press_refused_with_its_reason(models):
    cfg_j, cfg_t, params_j, params_t = models
    ids = seeded_ids(cfg_t.vocab_size, S, 14)
    jpress, tpress = both("block_keydiff")
    with pytest.raises(AssertionError, match="hidden"):
        kj.Runner.create(cfg_j, attn_impl="xla").prefill_chunked(
            params_j, jnp.asarray(ids), press=jpress, chunk_size=CHUNK, dtype=jnp.float32)
    with pytest.raises(ValueError, match="every position's hidden states"):
        kt.Runner.create(cfg_t, device="cpu").prefill_chunked(
            params_t, torch.from_numpy(ids).long(), press=tpress, chunk_size=CHUNK)


@pytest.mark.parametrize("composed", [False, True])
def test_think_window_past_the_scoring_window(models, composed):
    """ThinK's window of 32 queries does not fit a scoring window of 16
    (chunks of 16): JAX asserts, the port raises a ValueError that says
    why. Inside ComposedPress, both take the scoring window as it is."""
    cfg_j, cfg_t, params_j, params_t = models
    ids = seeded_ids(cfg_t.vocab_size, S, 14)
    press = lambda m: (m.ComposedPress((m.KnormPress(0.5), m.ThinKPress(0.5, window_size=32)))
                       if composed else m.ThinKPress(0.5, window_size=32))
    from kvpress_tpu import presses as jp
    run_j = lambda: kj.Runner.create(cfg_j, attn_impl="xla").prefill_chunked(
        params_j, jnp.asarray(ids), press=press(jp), chunk_size=CHUNK, dtype=jnp.float32)
    run_t = lambda: kt.Runner.create(cfg_t, device="cpu").prefill_chunked(
        params_t, torch.from_numpy(ids).long(), press=press(kt), chunk_size=CHUNK)
    if composed:
        _, jc, _ = run_j()
        _, tc, _ = run_t()
        np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
        return
    with pytest.raises(AssertionError, match="window"):
        run_j()
    with pytest.raises(ValueError, match="scoring window"):
        run_t()


@pytest.mark.parametrize("name", REFUSED_SCORER)
def test_wrapped_expected_attention_refused(models, name):
    cfg_j, cfg_t, params_j, params_t = models
    ids = seeded_ids(cfg_t.vocab_size, S, 14)
    jpress, tpress = both(name)
    with pytest.raises((AttributeError, AssertionError, ValueError, TypeError)):
        kj.Runner.create(cfg_j, attn_impl="xla").prefill_chunked(
            params_j, jnp.asarray(ids), press=jpress, chunk_size=CHUNK, dtype=jnp.float32)
    with pytest.raises(ValueError, match="prefill"):
        kt.Runner.create(cfg_t, device="cpu").prefill_chunked(
            params_t, torch.from_numpy(ids).long(), press=tpress, chunk_size=CHUNK)


def test_other_presses_refused_naming_the_accepted_kinds(models):
    _, cfg_t, _, params_t = models
    with pytest.raises(TypeError, match="scorer-like wrapper .*CriticalKVPress.*ComposedPress"):
        kt.Runner.create(cfg_t, device="cpu").prefill_chunked(
            params_t, torch.zeros((1, S), dtype=torch.long), press=kt.BasePress(),
            chunk_size=CHUNK)


@pytest.mark.parametrize("name", ["key_rerotation", "snap_think", "critical_adakv_knorm",
                                  "critical_knorm"])
def test_pipeline_context_chunk_same_answers_as_jax(models, name):
    cfg_j, cfg_t, params_j, params_t = models
    tok = ToyTokenizer(cfg_j.vocab_size)
    words = distinct_words(tok, 70)
    context, questions = " ".join(words[:60]), ["what is " + words[60] + " ?",
                                                " ".join(words[61:70])]
    jpress, tpress = both(name)
    jpipe = JaxPipeline(kj.Runner.create(cfg_j, attn_impl="xla"), params_j, tok)
    tpipe = kt.KVPressPipeline(kt.Runner.create(cfg_t, attn_impl="flash", device="cpu"),
                               params_t, tok)
    kw = dict(questions=questions, max_new_tokens=6, context_chunk=CHUNK)
    want = jpipe(context, press=jpress, **kw)["answers"]
    got = tpipe(context, press=tpress, **kw)["answers"]
    assert got == want and all(len(a.split()) == 6 for a in got)
