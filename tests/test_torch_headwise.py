"""Head-wise eviction in kvpress_tpu_torch (AdaKV, per-head compaction, the
per-head-length decode attention) and two small presses (StreamingLLM,
Random), against the JAX package on the same seeded numpy
inputs (CPU, float32, tiny config).

Tolerances: attention outputs agree to 2e-5 with the Pallas kernel in
interpret mode (as tests/test_decode_headwise.py holds it to the dense path);
masks, lengths, compacted entries and greedy answers are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.ops.decode_headwise import decode_attention_headwise as jheadwise
from kvpress_tpu.ops.decode_headwise import prefix_tail_from_mask as jprefix_tail
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
from kvpress_tpu.presses import wrappers as jwrap
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.ops import decode_headwise as thw
from kvpress_tpu_torch.ops.decode import decode_attention_plain
from kvpress_tpu_torch.presses import wrappers as twrap
from toy_tokenizer import ToyTokenizer

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _t(a):
    return torch.from_numpy(np.array(a))


def make_case(seed, B=2, Hq=4, Hkv=2, S=96, D=16, T=1, tail=3, slack=7):
    """A cache compacted head by head: per-head live prefix, then a shared
    appended tail (the case of tests/test_decode_headwise.py, from numpy)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    prefix = rng.integers(5, 40, (B, Hkv)).astype(np.int32)
    tail_start = int(prefix.max()) + slack
    length = tail_start + tail
    mask = np.arange(S)[None, None] < prefix[..., None]
    mask[:, :, tail_start:length] = True
    mask[:, :, length:] = rng.random((B, Hkv, S - length)) < 0.5      # stale bits
    return q, k, v, prefix, mask, tail_start, length


def _same_ranges(mask, length):
    want = jprefix_tail(jnp.asarray(mask), jnp.asarray(length))
    got = thw.prefix_tail_from_mask(_t(mask), length)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_tail_from_mask_matches_jax(seed):
    _, _, _, prefix, mask, tail_start, length = make_case(seed)
    pfx, ts, tl = _same_ranges(mask, length)
    np.testing.assert_array_equal(pfx.numpy(), prefix)
    assert int(ts) == tail_start and int(tl) == length - tail_start


def test_prefix_tail_uncompacted_mask_matches_jax():
    """All-True mask (no compaction): prefix = length, empty tail."""
    pfx, _, tl = _same_ranges(np.ones((1, 2, 32), bool), 20)
    assert (pfx.numpy() == 20).all() and int(tl) == 0
    pfx, _, tl = _same_ranges(np.ones((1, 2, 32), bool), 32)       # a full buffer
    assert (pfx.numpy() == 32).all() and int(tl) == 0


def test_prefix_tail_scattered_mask_matches_jax():
    """Not a prefix-plus-tail mask: the contract is the JAX function's, exact
    or not."""
    mask = np.random.default_rng(3).random((2, 2, 48)) < 0.6
    _same_ranges(mask, 40)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("T", [1, 4])
def test_headwise_plain_matches_pallas(seed, T):
    q, k, v, _, mask, _, length = make_case(seed, T=T, tail=6)
    ranges = thw.prefix_tail_from_mask(_t(mask), length)
    got = thw.decode_attention_headwise(_t(q), _t(k), _t(v), *ranges, sm_scale=0.25)
    want = jheadwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     *jprefix_tail(jnp.asarray(mask), jnp.asarray(length)),
                     sm_scale=0.25, block_k=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    if T == 1:
        dense = decode_attention_plain(_t(q), _t(k), _t(v), length, mask=_t(mask), sm_scale=0.25)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_headwise_plain_empty_head_and_softcap_match_pallas(softcap):
    q, k, v, prefix, mask, tail_start, length = make_case(2)
    mask[0, 0, :tail_start] = False                      # head (0, 0): tail only
    ranges = thw.prefix_tail_from_mask(_t(mask), length)
    assert int(ranges[0][0, 0]) == 0
    got = thw.decode_attention_headwise(_t(q), _t(k), _t(v), *ranges, sm_scale=0.25,
                                        softcap=softcap)
    want = jheadwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     *jprefix_tail(jnp.asarray(mask), jnp.asarray(length)),
                     sm_scale=0.25, softcap=softcap, block_k=32, interpret=True)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_headwise_plain_head_with_nothing_to_read_gives_zeros():
    q, k, v, prefix, _, _, _ = make_case(4)
    prefix[1, 0] = 0
    zero = torch.zeros((), dtype=torch.int32)
    got = thw.decode_attention_headwise(_t(q), _t(k), _t(v), _t(prefix), zero + 50, zero,
                                        sm_scale=0.25)
    want = jheadwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(prefix),
                     jnp.asarray(50, jnp.int32), jnp.asarray(0, jnp.int32),
                     sm_scale=0.25, block_k=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    assert (got[1, :2] == 0).all() and (got[0] != 0).any()


def test_headwise_plain_reads_an_absorbed_tail_once():
    """The longest head's prefix runs into the appended tokens (no slack, as
    after compact_headwise): its live set is the union of the two ranges, so
    the result is dense attention under the mask."""
    q, k, v, _, mask, tail_start, length = make_case(5, slack=0)
    pfx, ts, _ = thw.prefix_tail_from_mask(_t(mask), length)
    assert int(pfx.max()) == length and int(ts) == tail_start
    got = thw.decode_attention_headwise(_t(q), _t(k), _t(v), pfx, ts, length - ts,
                                        sm_scale=0.25)
    dense = decode_attention_plain(_t(q), _t(k), _t(v), length, mask=_t(mask), sm_scale=0.25)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-5, rtol=2e-5)


# --------------------------------------------------------------------- #
# compaction helpers


@pytest.mark.parametrize("seed", [0, 1])
def test_compact_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((2, 2, 40, 8)).astype(np.float32)
    v = rng.standard_normal((2, 2, 40, 8)).astype(np.float32)
    keep = rng.random((2, 2, 40)) < 0.5
    jk, jv, jlen, jmask = jwrap.compact_headwise(jnp.asarray(k), jnp.asarray(v),
                                                 jnp.asarray(keep))
    tk, tv, tlen, tmask = twrap.compact_headwise(_t(k), _t(v), _t(keep))
    assert tlen == int(jlen) == keep.sum(-1).max()
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jk, jv, jlen = jwrap.compact_by_mask(jnp.asarray(k), jnp.asarray(v), jnp.asarray(keep))
    tk, tv, tlen = twrap.compact_by_mask(_t(k), _t(v), _t(keep))
    assert tlen == int(jlen) == keep.sum(-1).min()
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_rank_desc_breaks_ties_as_jax():
    scores = np.random.default_rng(2).integers(0, 4, (3, 50)).astype(np.float32)   # many ties
    want = jnp.argsort(jnp.argsort(-jnp.asarray(scores), axis=-1), axis=-1)
    np.testing.assert_array_equal(twrap._rank_desc(_t(scores)).numpy(), np.asarray(want))


# --------------------------------------------------------------------- #
# through Runner.prefill and the pipeline


@pytest.fixture(scope="module")
def models():
    """Tiny-config weights in both packages, wq and wk scaled up so that
    attention is peaked and AdaKV gives the heads different budgets."""
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


ADAKV = {
    "knorm": lambda m: m.AdaKVPress(m.KnormPress(0.5)),
    "knorm_compact": lambda m: m.AdaKVPress(m.KnormPress(0.5), compact=True),
    "observed_compact": lambda m: m.AdaKVPress(m.ObservedAttentionPress(0.5), compact=True),
    "snapkv_alpha": lambda m: m.AdaKVPress(m.SnapKVPress(0.6, window_size=8),
                                           alpha_safeguard=0.5),
}


@pytest.mark.parametrize("name", sorted(ADAKV))
def test_adakv_masks_and_lengths_match_jax(models, name):
    cfg_j, cfg_t, params_j, params_t = models
    ids = _ids(cfg_j.vocab_size, 72, 20)
    jr = kj.Runner.create(cfg_j, attn_impl="xla")
    tr = kt.Runner.create(cfg_t, attn_impl="xla", device="cpu")
    jl, jc, _ = jr.prefill(params_j, jnp.asarray(ids), press=ADAKV[name](kj),
                           dtype=jnp.float32, compute_logits=True)
    tl, tc, _ = tr.prefill(params_t, torch.from_numpy(ids).long(), press=ADAKV[name](kt),
                           compute_logits=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    counts = tc.mask.sum(-1)
    assert int(counts.sum()) == cfg_t.num_layers * cfg_t.num_kv_heads * int(
        72 * (1 - ADAKV[name](kt).compression_ratio))
    assert counts.min() < counts.max()                   # head-wise budgets differ
    if "compact" in name:
        live = tc.mask.numpy()[..., None]
        np.testing.assert_allclose(tc.keys.numpy() * live, np.asarray(jc.keys) * live, atol=1e-5)
        assert tc.length.tolist() == counts.amax(dim=(1, 2)).tolist()


@pytest.mark.parametrize("name", ["knorm", "observed_compact"])
def test_adakv_pipeline_same_greedy_answers_as_jax(models, name):
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
    jp = JaxPipeline(kj.Runner.create(cfg_j, attn_impl="xla"), params_j, tok)
    want = jp(context, questions=questions, press=ADAKV[name](kj), max_new_tokens=6)["answers"]
    # the port's dense route, and its head-wise route (flash wrappers for the
    # questions, the per-head-length decode for each new token)
    for kw in (dict(attn_impl="xla"),
               dict(attn_impl="flash", decode_kernel=False, headwise_kernel=True)):
        if name == "knorm" and "headwise_kernel" in kw:
            continue        # a scattered mask is not what the head-wise decode takes
        tp = kt.KVPressPipeline(kt.Runner.create(cfg_t, device="cpu", **kw), params_t, tok)
        got = tp(context, questions=questions, press=ADAKV[name](kt),
                 max_new_tokens=6)["answers"]
        assert got == want and all(len(a.split()) == 6 for a in got)


def test_headwise_route_matches_dense_route_step_by_step(models, monkeypatch):
    """After a compacting AdaKV prefill and a question, each one-token step
    through decode_attention_headwise gives the dense route's logits; the
    shrunken cache is as long as its longest head."""
    _, cfg_t, _, params_t = models
    ids = torch.from_numpy(_ids(cfg_t.vocab_size, 72, 21)).long()
    question = torch.from_numpy(_ids(cfg_t.vocab_size, 5, 22)).long()
    press = ADAKV["observed_compact"](kt)
    dense = kt.Runner.create(cfg_t, attn_impl="xla", device="cpu")
    headwise = kt.Runner.create(cfg_t, attn_impl="flash", decode_kernel=False,
                                headwise_kernel=True, device="cpu")
    _, cache, _ = dense.prefill(params_t, ids, press=press)
    longest = int(cache.length.max())
    assert longest < 72 and longest == int(cache.mask.sum(-1).max())
    cache = kt.resize(cache, longest + 5 + 4)
    calls = []
    real = thw.decode_attention_headwise_plain

    def counting(*args, **kwargs):
        calls.append(args[0].shape[2])
        return real(*args, **kwargs)

    monkeypatch.setattr(thw, "decode_attention_headwise_plain", counting)
    logits = {}
    for label, runner in (("dense", dense), ("headwise", headwise)):
        c = dataclasses.replace(cache, keys=cache.keys.clone(), values=cache.values.clone(),
                                mask=cache.mask.clone())
        out, c, _ = runner.forward(params_t, question, c, logits_last_only=True)
        steps = [out]
        for _ in range(3):
            tok = torch.argmax(steps[-1][:, -1:], dim=-1)
            out, c, _ = runner.forward(params_t, tok, c, logits_last_only=True)
            steps.append(out)
        logits[label] = torch.cat(steps, dim=1)
    assert calls == [1] * (3 * cfg_t.num_layers)          # one-token calls only, headwise only
    torch.testing.assert_close(logits["headwise"], logits["dense"], atol=1e-4, rtol=1e-4)


def test_headwise_route_conditions():
    """The head-wise route is taken only with the decode kernel off, for one
    token over an unquantized cache."""
    cfg = kt.tiny_config()
    r = kt.Runner.create(cfg, attn_impl="flash", headwise_kernel=True, device="cpu")
    assert r.headwise_kernel and not r.decode_kernel
    assert not kt.Runner.create(cfg, device="cpu").headwise_kernel


# --------------------------------------------------------------------- #
# StreamingLLM and Random


@pytest.mark.parametrize("ratio,n_sink", [(0.5, 4), (0.3, 0), (0.75, 8)])
def test_streaming_llm_matches_jax(models, ratio, n_sink):
    cfg_j, cfg_t, params_j, params_t = models
    k = np.random.default_rng(30).standard_normal((2, 2, 40, 16)).astype(np.float32)
    want = kj.StreamingLLMPress(ratio, n_sink=n_sink).score(None, jnp.asarray(k), None)
    got = kt.StreamingLLMPress(ratio, n_sink=n_sink).score(None, _t(k), None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ids = _ids(cfg_j.vocab_size, 40, 31)
    _, jc, _ = kj.Runner.create(cfg_j, attn_impl="xla").prefill(
        params_j, jnp.asarray(ids), press=kj.StreamingLLMPress(ratio, n_sink=n_sink),
        dtype=jnp.float32)
    _, tc, _ = kt.Runner.create(cfg_t, device="cpu").prefill(
        params_t, torch.from_numpy(ids).long(), press=kt.StreamingLLMPress(ratio, n_sink=n_sink))
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    n = int(tc.length[0])

    def rows(keys):     # kept rows as a set: the scores of the kept are float-equal
        kk = np.asarray(keys, np.float64)[:, :, :, :n]
        return np.take_along_axis(kk, np.argsort(kk[..., 0], axis=-1)[..., None], axis=3)

    np.testing.assert_allclose(rows(tc.keys.numpy()), rows(jc.keys), atol=1e-5)


def test_random_press_kept_count_and_determinism(models):
    _, cfg_t, _, params_t = models
    ids = torch.from_numpy(_ids(cfg_t.vocab_size, 50, 32)).long()
    runner = kt.Runner.create(cfg_t, device="cpu")

    def kept(seed):
        press = kt.RandomPress(0.6, generator=torch.Generator().manual_seed(seed))
        _, c, _ = runner.prefill(params_t, ids, press=press)
        assert c.length.tolist() == [20] * cfg_t.num_layers
        return c.keys[:, :, :, :20]

    a, b, other = kept(7), kept(7), kept(8)
    assert torch.equal(a, b) and not torch.equal(a, other)
    with pytest.raises(TypeError):
        kt.RandomPress(0.5)
