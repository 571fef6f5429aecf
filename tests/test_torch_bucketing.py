"""Bucketed prefill in kvpress_tpu_torch (``Runner.prefill(valid_len=)``, the
pipeline's ``context_bucket``), mirroring tests/test_bucketing.py's 14
scorers: for each, the bucketed prefill of the port equals its exact-length
prefill, and equals the JAX package's bucketed prefill on the same weights
(CPU, float32, tiny config).

Tolerances: logits within 1e-4; compressed lengths, offsets and greedy
answers equal; kept sets equal (every kept key row within 1e-4 of one on the
other side, as in tests/test_bucketing.py). The random sketches of
LeverageScorePress and Compactor come from the JAX package on both sides
(tests/torch_scorer_cases.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu import presses as jp
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
import kvpress_tpu_torch as kt
from kvpress_tpu_torch import presses as tp
from toy_tokenizer import ToyTokenizer
from torch_scorer_cases import distinct_words, seeded_ids, tiny_models, use_jax_sketches

torch.set_num_threads(2)

BUCKET = 64

# tests/test_bucketing.py's presses, by the same arguments.
PRESSES = {
    "KnormPress": lambda m: m.KnormPress(0.5),
    "StreamingLLMPress": lambda m: m.StreamingLLMPress(0.5),
    "SnapKVPress": lambda m: m.SnapKVPress(0.5, window_size=8, kernel_size=3),
    "TOVAPress": lambda m: m.TOVAPress(0.5),
    "ObservedAttentionPress": lambda m: m.ObservedAttentionPress(0.5),
    "ExpectedAttentionPress": lambda m: m.ExpectedAttentionPress(0.5),
    "PyramidKVPress": lambda m: m.PyramidKVPress(0.5, window_size=8, kernel_size=3),
    "KeyDiffPress": lambda m: m.KeyDiffPress(0.5),
    "CapPress": lambda m: m.CapPress(0.5, n_future_positions=16),
    "CURPress": lambda m: m.CURPress(0.5, local_window_size=8),
    "LagKVPress": lambda m: m.LagKVPress(0.5, lag_size=8),
    "NonCausalAttnPress": lambda m: m.NonCausalAttnPress(0.5, chunk_size=16),
    "LeverageScorePress": lambda m: m.LeverageScorePress(0.5, sketch_dimension=8),
    "CompactorPress": lambda m: m.CompactorPress(0.5, chunk_size=16, sketch_dimension=8),
}


@pytest.fixture
def jax_sketches(monkeypatch):
    use_jax_sketches(monkeypatch)


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def _same_kept(c_a, c_b, num_layers, num_kv_heads):
    """Every kept key row of ``c_a`` lies within 1e-4 of one of ``c_b``."""
    for layer in range(num_layers):
        n = int(c_a.length[layer])
        for h in range(num_kv_heads):
            a = np.asarray(c_a.keys[layer, 0, h, :n])
            b = np.asarray(c_b.keys[layer, 0, h, :n])
            d = np.linalg.norm(a[:, None] - b[None], axis=-1)
            assert (d.min(axis=1) < 1e-4).all(), (layer, h)


_JAX_BUCKETED = {}


def _jax_bucketed(models, name, ids_pad, true_len):
    """The JAX runner's bucketed prefill (its valid length is traced: one
    compile a press for both lengths)."""
    cfg_j, _, params_j, _ = models
    key = (name, true_len)
    if key not in _JAX_BUCKETED:
        _JAX_BUCKETED[key] = kj.Runner.create(cfg_j, attn_impl="xla").prefill(
            params_j, jnp.asarray(ids_pad), press=PRESSES[name](jp), dtype=jnp.float32,
            compute_logits=True, valid_len=jnp.asarray(true_len, jnp.int32))
    return _JAX_BUCKETED[key]


@pytest.mark.usefixtures("jax_sketches")
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("true_len", [40, 57])
@pytest.mark.parametrize("name", list(PRESSES))
def test_bucketed_matches_exact_and_jax(models, name, true_len, attn_impl):
    cfg_j, cfg_t, _, params_t = models
    ids = seeded_ids(cfg_t.vocab_size, true_len, 1)
    ids_pad = np.pad(ids, ((0, 0), (0, BUCKET - true_len)))
    runner = kt.Runner.create(cfg_t, attn_impl=attn_impl, decode_kernel=False, device="cpu")
    press = PRESSES[name](kt)
    lg_exact, c_exact, _ = runner.prefill(params_t, torch.from_numpy(ids).long(), press=press,
                                          compute_logits=True)
    lg_buck, c_buck, _ = runner.prefill(params_t, torch.from_numpy(ids_pad).long(),
                                        press=press, compute_logits=True, valid_len=true_len)
    assert c_buck.keys.shape[3] == BUCKET and int(c_buck.offset) == true_len
    np.testing.assert_array_equal(c_buck.length.numpy(), c_exact.length.numpy())
    np.testing.assert_allclose(lg_buck.numpy(), lg_exact.numpy(), atol=1e-4, rtol=1e-4)
    _same_kept(c_exact, c_buck, cfg_t.num_layers, cfg_t.num_kv_heads)

    lg_j, c_j, _ = _jax_bucketed(models, name, ids_pad, true_len)
    np.testing.assert_array_equal(c_buck.length.numpy(), np.asarray(c_j.length))
    assert int(c_j.offset) == true_len
    np.testing.assert_allclose(lg_buck.numpy(), np.asarray(lg_j), atol=1e-4, rtol=1e-4)
    _same_kept(c_buck, c_j, cfg_t.num_layers, cfg_t.num_kv_heads)


def test_all_scorers_padding_safe():
    """Every scorer press of the port takes a bucketed prefill, as every one
    of the JAX package does (tests/test_bucketing.py)."""
    bad = [name for name in dir(tp)
           if isinstance(c := getattr(tp, name), type) and issubclass(c, tp.ScorerPress)
           and not c.supports_padding]
    assert bad == [], bad


def test_bucketed_prefill_without_a_press(models):
    """No press: the lengths and the offset are the valid length, and the
    logits those of the last real token."""
    _, cfg_t, _, params_t = models
    runner = kt.Runner.create(cfg_t, attn_impl="flash", device="cpu")
    ids = torch.from_numpy(seeded_ids(cfg_t.vocab_size, 50, 2)).long()
    lg, c, _ = runner.prefill(params_t, ids, compute_logits=True)
    lg_b, c_b, _ = runner.prefill(params_t, torch.nn.functional.pad(ids, (0, 14)),
                                  compute_logits=True, valid_len=50)
    assert c_b.length.tolist() == [50] * cfg_t.num_layers and int(c_b.offset) == 50
    torch.testing.assert_close(lg_b, lg, atol=1e-5, rtol=1e-5)
    # one decode step after each reads the same cache
    step = lambda cache: runner.forward(params_t, ids[:, -1:], kt.resize(cache, 70),
                                        logits_last_only=True)[0]
    torch.testing.assert_close(step(c_b), step(c), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def pipes(models):
    cfg_j, cfg_t, params_j, params_t = models
    tok = ToyTokenizer(cfg_t.vocab_size)
    words = distinct_words(tok, 60)
    return dict(jax=JaxPipeline(kj.Runner.create(cfg_j, attn_impl="xla"), params_j, tok),
                torch=kt.KVPressPipeline(kt.Runner.create(cfg_t, device="cpu"), params_t, tok),
                context=" ".join(words[:45]), questions=["what is " + words[50] + " ?",
                                                         " ".join(words[51:58])])


@pytest.mark.usefixtures("jax_sketches")
@pytest.mark.parametrize("name", ["KnormPress", "ExpectedAttentionPress", "CompactorPress"])
def test_pipeline_context_bucket_same_answers(pipes, name):
    """The bucketed pipeline answers as the exact one and as the JAX
    package's bucketed pipeline."""
    kw = dict(questions=pipes["questions"], max_new_tokens=6)
    exact = pipes["torch"](pipes["context"], press=PRESSES[name](kt), **kw)["answers"]
    got = pipes["torch"](pipes["context"], press=PRESSES[name](kt), context_bucket=32,
                         **kw)["answers"]
    want = pipes["jax"](pipes["context"], press=PRESSES[name](jp), context_bucket=32,
                        **kw)["answers"]
    assert got == exact == want and all(len(a.split()) == 6 for a in got)


class _MultiPass(kt.KnormPress):
    multi_pass = True


@pytest.mark.parametrize("case", ["multi-pass press", "context_chunk", "pixel_values",
                                  "head-wise press"])
def test_context_bucket_refusals(pipes, case):
    kw = {"multi-pass press": dict(press=_MultiPass(0.5)),
          "context_chunk": dict(press=kt.KnormPress(0.5), context_chunk=16),
          "pixel_values": dict(press=kt.KnormPress(0.5), pixel_values=torch.zeros(1, 3, 8, 8)),
          "head-wise press": dict(press=kt.AdaKVPress(kt.KnormPress(0.5)))}[case]
    with pytest.raises(ValueError, match="bucket"):
        pipes["torch"](pipes["context"], context_bucket=32, max_new_tokens=2, **kw)
