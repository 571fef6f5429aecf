"""The mask, merge and head-split presses of kvpress_tpu_torch (Merging,
LUKV, SimLayerKV, Finch, DuoAttention, DMS), one-shot, against the JAX package
on the same seeded inputs (CPU, float32, tiny config): ``layer_compress`` on
one layer's captured inputs, ``Runner.prefill`` on the dense and the kernel
(plain) routes, ``KVPressPipeline`` (Finch's delimiter and DMS's
``compact=True`` included), ``cache.masked_fraction`` and
``cache.compact_masked``, LU-KV's per-head counts, Duo's streaming heads and
its split-cache decode, ``duo_attention_on_the_fly``, the loaders, JAX's
quantile over ``-inf`` fills, and every refusal.

Tolerances: scores, kept entries and Merging's merged values within 1e-5
(relative and absolute; Merging's float32 scatter-adds accumulate in another
order than JAX's; after a prefill as sets, since two slots whose scores differ
by rounding may trade places); logits within 1e-4; kept sets, lengths,
masks, counts, rings, offsets and greedy answers equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.cache import KVCache as JaxCache
from kvpress_tpu.cache import compact_masked as j_compact_masked
from kvpress_tpu.cache import grow as j_grow
from kvpress_tpu.cache import masked_fraction as j_masked_fraction
from kvpress_tpu.ops import duo_decode as jduo
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
from kvpress_tpu.presses import duo as jduo_press
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.presses.merging import jax_quantile
from toy_tokenizer import ToyTokenizer
from torch_mask_cases import MERGE_TOL, MERGING, PRESSES, both
from torch_scorer_cases import distinct_words, kept_rows, seeded_ids, tiny_models
from torch_wrapper_cases import as_numpy, capture, jax_ctx

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
S = 72


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(scope="module")
def layer_inputs(models):
    """Layer 1's press inputs of a prefill of S tokens, in both packages."""
    cfg_j, cfg_t, params_j, params_t = models
    ids = seeded_ids(cfg_t.vocab_size, S, 12)
    runner = kt.Runner.create(cfg_t, attn_impl="xla", decode_kernel=False, device="cpu")
    ctx, keys, values = capture(runner, params_t, ids, 1)
    return ctx, keys, values, jax_ctx(ctx, cfg_j, params_j)


def _ring(state):
    return {k: np.asarray(state[k]) for k in ("scores", "count", "first_slot")}


@pytest.mark.parametrize("name", list(PRESSES))
def test_layer_compress_matches_jax(layer_inputs, name):
    ctx, keys, values, jctx = layer_inputs
    jpress, tpress = both(name)
    mask = torch.ones(keys.shape[:3], dtype=torch.bool)
    got = tpress.layer_compress(ctx, keys, values, S, mask)
    want = jpress.layer_compress(jctx, jnp.asarray(keys.numpy()), jnp.asarray(values.numpy()),
                                 jnp.asarray(S, jnp.int32), jnp.asarray(mask.numpy()))
    k, v, n, m = (as_numpy(x) for x in got[:4])
    jk, jv, jn, jm = (as_numpy(x) for x in want[:4])
    assert int(n) == int(jn)
    np.testing.assert_array_equal(m, jm)
    n = int(n)
    np.testing.assert_allclose(k[:, :, :n], jk[:, :, :n], **TOL)
    np.testing.assert_allclose(v[:, :, :n], jv[:, :, :n],
                               **(MERGE_TOL if name in MERGING else TOL))
    # the inputs are left as they were
    assert torch.equal(keys, layer_inputs[1]) and torch.equal(values, layer_inputs[2])
    if name.startswith("dms"):
        ring, jring = got[4], _ring(want[4])
        np.testing.assert_allclose(ring["scores"].numpy(), jring["scores"], **TOL)
        assert (ring["count"], ring["first_slot"]) == (16, S - 16) == (
            int(jring["count"]), int(jring["first_slot"]))
        assert 0 < (~m).sum() < m.size
    if name in MERGING:
        # the kept keys are the wrapped press's; some kept values took merges
        assert not np.allclose(v[:, :, :n], values.numpy()[..., :n, :])


def test_merging_keeps_the_scorer_keys(layer_inputs):
    """MergingPress(Knorm) keeps KnormPress's keys bit for bit."""
    ctx, keys, values, _ = layer_inputs
    mask = torch.ones(keys.shape[:3], dtype=torch.bool)
    mk, _, mn, _, _ = kt.MergingPress(kt.KnormPress(0.5)).layer_compress(ctx, keys, values, S,
                                                                         mask)
    kk, _, kn, _, _ = kt.KnormPress(0.5).layer_compress(ctx, keys, values, S, mask)
    assert mn == kn == S // 2
    assert torch.equal(mk[:, :, :mn], kk[:, :, :kn])


@pytest.mark.parametrize("sim_bytes", [None, 2048])
def test_merging_similarity_by_slices(layer_inputs, monkeypatch, sim_bytes):
    """The row max and argmax over slices of the evicted rows (2,048 bytes:
    8 rows a slice) equal those of the whole product."""
    from kvpress_tpu_torch.presses import merging

    _, keys, _, _ = layer_inputs
    ev, kp = keys[:, :, :40].float(), keys[:, :, 40:].float()
    whole = merging.MergingPress.nearest_kept(ev, kp)
    if sim_bytes:
        monkeypatch.setattr(merging, "SIM_BYTES", sim_bytes)
    got = merging.MergingPress.nearest_kept(ev, kp)
    assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.7, 0.9, 1.0])
@pytest.mark.parametrize("n_inf", [0, 3, 9, 16])
def test_quantile_over_minus_inf_matches_jax(q, n_inf):
    """JAX's linear quantile over rows with -inf fills: -inf where a -inf
    takes part with a weight above 0, NaN where it takes part with weight 0
    (torch.quantile would give NaN for both)."""
    rng = np.random.default_rng(n_inf)
    a = rng.standard_normal((2, 3, 17)).astype(np.float32)
    for row in a.reshape(-1, 17):
        row[rng.permutation(17)[:n_inf]] = -np.inf
    want = np.asarray(jnp.quantile(jnp.asarray(a), q, axis=-1, keepdims=True))
    got = jax_quantile(torch.from_numpy(a), q).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ratio", [0.1, 0.3, 0.5, 0.77, 0.99])
@pytest.mark.parametrize("S_", [7, 72, 1000])
def test_lukv_head_keep_counts_match_jax(ratio, S_):
    jpress, tpress = both("lukv")
    jpress = dataclasses.replace(jpress, compression_ratio=ratio)
    tpress = dataclasses.replace(tpress, compression_ratio=ratio)
    for layer in range(2):
        want = np.asarray(jpress._head_keep_counts(jnp.asarray(layer), S_, 2))
        got = tpress._head_keep_counts(layer, S_, 2).numpy()
        np.testing.assert_array_equal(got, want)
    # the remainder goes by the largest fractional parts: 3 heads of 10
    # slots whose ideal counts are 3.6, 3.3, 3.3 keep 4, 3, 3
    curve = np.zeros((99, 1, 3), np.float32)
    curve[49, 0] = [0.64, 0.67, 0.67]
    p = kt.LUKVPress(kt.KnormPress(0.5), compression_ratio=0.5, budget_curves=curve)
    assert p._head_keep_counts(0, 10, 3).tolist() == [4, 3, 3]


@pytest.mark.parametrize("ratio", [0.25, 0.5, 0.75])
def test_duo_streaming_mask_with_tied_scores(ratio):
    """numpy's default (unstable) argsort over tied scores prunes the same
    heads as the JAX package."""
    scores = np.round(np.random.default_rng(3).standard_normal((4, 8)), 0)
    jp = jduo_press.DuoAttentionPress(ratio, head_scores=scores)
    tp = kt.DuoAttentionPress(ratio, head_scores=scores)
    np.testing.assert_array_equal(tp.streaming_mask(), jp.streaming_mask())
    assert tp.streaming_mask().sum() == round(32 * ratio)


def _caches(seed, quantized):
    """The same random cache in both packages: 2 layers, B2, 3 heads, 24
    slots of which layer 0 has 20 valid and layer 1 24; a random keep-mask,
    True past the length."""
    rng = np.random.default_rng(seed)
    L_, B, H, Smax, D = 2, 2, 3, 24, 8
    keys = rng.standard_normal((L_, B, H, Smax, D)).astype(np.float32)
    values = rng.standard_normal((L_, B, H, Smax, D)).astype(np.float32)
    length = np.array([20, 24], np.int32)
    mask = rng.random((L_, B, H, Smax)) > 0.4
    mask[0, :, :, 20:] = True
    tc = kt.KVCache(keys=torch.from_numpy(keys), values=torch.from_numpy(values),
                    length=torch.from_numpy(length), offset=torch.tensor(24, dtype=torch.int32),
                    mask=torch.from_numpy(mask))
    jc = JaxCache(keys=jnp.asarray(keys), values=jnp.asarray(values), length=jnp.asarray(length),
                  offset=jnp.asarray(24, jnp.int32), mask=jnp.asarray(mask))
    if quantized:
        (qk, ks), (qv, vs) = kt.quantize_kv(tc.keys), kt.quantize_kv(tc.values)
        tc = dataclasses.replace(tc, keys=qk, values=qv, key_scales=ks, value_scales=vs)
        jc = dataclasses.replace(jc, keys=jnp.asarray(qk.numpy()), values=jnp.asarray(qv.numpy()),
                                 key_scales=jnp.asarray(ks.numpy()),
                                 value_scales=jnp.asarray(vs.numpy()))
    return tc, jc


@pytest.mark.parametrize("quantized", [False, True])
def test_masked_fraction_and_compact_masked_match_jax(quantized):
    tc, jc = _caches(5, quantized)
    assert float(kt.masked_fraction(tc)) == pytest.approx(float(j_masked_fraction(jc)), abs=1e-7)
    assert float(kt.masked_fraction(dataclasses.replace(tc, mask=None))) == 0.0
    jmask = np.asarray(jc.mask).copy()
    want = jax.device_get(j_compact_masked(jc))      # donates jc
    got = kt.compact_masked(tc)
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    # each head's kept entries first, in their order; the slots past layer
    # 0's length (mask True) are not among them
    for f in ("keys", "values") + (("key_scales", "value_scales") if quantized else ()):
        g, w = as_numpy(getattr(got, f)), np.asarray(getattr(want, f))
        for l in range(2):
            for b in range(2):
                for h in range(3):
                    n = int(got.mask[l, b, h].sum())
                    np.testing.assert_array_equal(g[l, b, h, :n], w[l, b, h, :n])
    kept0 = (torch.from_numpy(jmask)[0] &
             (torch.arange(24) < 20)).sum(-1)
    assert got.length[0] == int(kept0.max()) and torch.equal(got.mask[0].sum(-1), kept0)


def test_compact_masked_without_a_mask_is_the_cache():
    tc, _ = _caches(6, False)
    tc = dataclasses.replace(tc, mask=None)
    assert kt.compact_masked(tc) is tc


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("name", list(PRESSES))
def test_prefill_keeps_what_jax_keeps(models, name, attn_impl):
    """Lengths, masks, kept entries of every layer and the logits equal the
    JAX dense runner's, on the port's dense and kernel (plain) routes; DMS's
    rings too."""
    cfg_j, cfg_t, params_j, params_t = models
    ids = seeded_ids(cfg_t.vocab_size, S, 3)
    jpress, tpress = both(name)
    jl, jc, js = kj.Runner.create(cfg_j, attn_impl="xla").prefill(
        params_j, jnp.asarray(ids), press=jpress, dtype=jnp.float32, compute_logits=True)
    tr = kt.Runner.create(cfg_t, attn_impl=attn_impl, decode_kernel=False, device="cpu")
    tl, tc, ts = tr.prefill(params_t, torch.from_numpy(ids).long(), press=tpress,
                            compute_logits=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    if jc.mask is not None:
        np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    for layer, n in enumerate(np.asarray(jc.length)):
        for a, b in ((tc.keys, jc.keys), (tc.values, jc.values)):
            np.testing.assert_allclose(kept_rows(a.numpy(), layer, n), kept_rows(b, layer, n),
                                       **TOL)
    if name.startswith("dms"):
        for l, ring in enumerate(ts):
            np.testing.assert_allclose(ring["scores"].numpy(), np.asarray(js["scores"][l]), **TOL)
            assert ring["first_slot"] == int(js["first_slot"][l]) == S - 16
    if name == "simlayerkv":
        assert tc.length.tolist() == [S, 4 + 15]


def test_masked_fraction_of_duo_is_its_closed_form(models):
    """Streaming heads times (S - sink - recent), over all heads times S."""
    _, cfg_t, _, params_t = models
    press = both("duo")[1]
    _, cache, _ = kt.Runner.create(cfg_t, device="cpu").prefill(
        params_t, torch.from_numpy(seeded_ids(cfg_t.vocab_size, S, 3)).long(), press=press)
    n_stream = int(press.streaming_mask().sum())
    want = n_stream * (S - 20) / (cfg_t.num_layers * cfg_t.num_kv_heads * S)
    assert float(kt.masked_fraction(cache)) == pytest.approx(want, rel=1e-6)


# ------------------------------------------------------------------ #
# Duo: loaders, on-the-fly scores, split-cache decode


def test_load_duo_head_scores_and_budget_curve(tmp_path):
    scores = np.random.default_rng(0).random((3, 4))
    np.savetxt(tmp_path / "heads.tsv", scores, delimiter="\t")
    np.savez(tmp_path / "heads.npz", sink_size=64, recent_size=128, head_scores=scores)
    for name in ("heads.tsv", "heads.npz"):
        got = kt.load_duo_head_scores(str(tmp_path / name))
        want = jduo_press.load_duo_head_scores(str(tmp_path / name))
        assert got[:2] == want[:2] == ((128, 256) if name.endswith("tsv") else (64, 128))
        np.testing.assert_array_equal(got[2], want[2])
    curve = np.random.default_rng(1).random((99, 3, 4)).astype(np.float32)
    np.save(tmp_path / "curve.npy", curve)
    np.testing.assert_array_equal(kt.load_budget_curve(str(tmp_path / "curve.npy")),
                                  kj.load_budget_curve(str(tmp_path / "curve.npy")))
    np.save(tmp_path / "bad.npy", curve[:50])
    with pytest.raises(ValueError, match="99"):
        kt.load_budget_curve(str(tmp_path / "bad.npy"))


def test_duo_attention_on_the_fly_matches_jax(models):
    cfg_j, cfg_t, params_j, params_t = models
    samples = [seeded_ids(cfg_t.vocab_size, 40, s) for s in (1, 2)]
    want = jduo_press.duo_attention_on_the_fly(kj.Runner.create(cfg_j), params_j,
                                               [jnp.asarray(x) for x in samples], q_len=64)
    got = kt.duo_attention_on_the_fly(kt.Runner.create(cfg_t, device="cpu"), params_t,
                                      [torch.from_numpy(x).long() for x in samples], q_len=64)
    assert got.shape == (cfg_t.num_layers, cfg_t.num_kv_heads)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-5)


@pytest.fixture(scope="module")
def duo_caches(models):
    """A Duo prefill (sink 3, recent 5, two sequences of 40) in both
    packages, grown by 8 slots."""
    cfg_j, cfg_t, params_j, params_t = models
    rng = np.random.default_rng(0)
    scores = rng.random((cfg_t.num_layers, cfg_t.num_kv_heads)).astype(np.float32)
    ids = rng.permutation(np.arange(3, cfg_t.vocab_size))[:80].reshape(2, 40).astype(np.int32)
    jp = jduo_press.DuoAttentionPress(0.5, sink_size=3, recent_size=5, head_scores=scores)
    tp = kt.DuoAttentionPress(0.5, sink_size=3, recent_size=5, head_scores=scores)
    jr = kj.Runner.create(cfg_j)
    tr = kt.Runner.create(cfg_t, device="cpu")
    _, jc, _ = jr.prefill(params_j, jnp.asarray(ids), press=jp, dtype=jnp.float32)
    _, tc, _ = tr.prefill(params_t, torch.from_numpy(ids).long(), press=tp)
    return jr, tr, jp, tp, j_grow(jc, 8), kt.resize(tc, 48), ids


def test_build_duo_split_matches_jax(duo_caches):
    """The port's Duo cache given to both packages."""
    _, _, jp, tp, _, tc, _ = duo_caches
    jc = JaxCache(keys=jnp.asarray(tc.keys.numpy()), values=jnp.asarray(tc.values.numpy()),
                  length=jnp.asarray(tc.length.numpy()), offset=jnp.asarray(int(tc.offset)),
                  mask=jnp.asarray(tc.mask.numpy()))
    want = jax.device_get(jduo.build_duo_split(jc, jp.streaming_mask(), 3, 5, room=8))
    got = kt.build_duo_split(tc, tp.streaming_mask(), 3, 5, room=8)
    for f in ("keys_r", "values_r", "keys_s", "values_s", "len_r", "len_s", "retr_idx",
              "stream_idx", "inv_idx", "offset"):
        np.testing.assert_array_equal(as_numpy(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_duo_decode_step_matches_jax_and_the_masked_decode(models, duo_caches):
    """Six greedy steps over the split cache: the logits equal JAX's split
    step and the port's masked decode (the keep-mask on the dense route),
    teacher-forced on the masked decode's tokens."""
    _, _, params_j, params_t = models
    jr, tr, jp, tp, jc, tc, ids = duo_caches
    jds = jduo.build_duo_split(jc, jp.streaming_mask(), 3, 5, room=8)
    tds = kt.build_duo_split(tc, tp.streaming_mask(), 3, 5, room=8)
    masked = dataclasses.replace(tc, keys=tc.keys.clone(), values=tc.values.clone(),
                                 mask=tc.mask.clone())
    tok = torch.from_numpy(ids[:, -1:]).long()
    for step in range(6):
        lm, masked, _ = tr.forward(params_t, tok, masked, logits_last_only=True)
        nxt, lt, tds = kt.duo_decode_step(params_t, tok, tds, runner=tr)
        _, lj, jds = jduo.duo_decode_step(params_j, jnp.asarray(tok.numpy(), jnp.int32), jds,
                                          runner=jr)
        np.testing.assert_allclose(lt.numpy(), lm[:, -1].numpy(), atol=1e-4, err_msg=str(step))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, err_msg=str(step))
        assert torch.equal(nxt[:, 0], lm[:, -1].argmax(-1))
        tok = nxt
    assert tds.len_r.tolist() == [46, 46] and int(tds.offset) == 46


def test_duo_split_refusals(models, duo_caches):
    _, cfg_t, _, params_t = models
    _, tr, _, tp, _, tc, _ = duo_caches
    qk, ks = kt.quantize_kv(tc.keys)
    with pytest.raises(ValueError, match="bf16"):
        kt.build_duo_split(dataclasses.replace(tc, keys=qk, key_scales=ks, value_scales=ks),
                           tp.streaming_mask(), 3, 5, 8)
    with pytest.raises(ValueError, match="sink\\+recent"):
        kt.build_duo_split(tc, tp.streaming_mask(), 30, 30, 8)
    ds = kt.build_duo_split(tc, tp.streaming_mask(), 3, 5, 8)
    windowed = dataclasses.replace(tr, cfg=dataclasses.replace(cfg_t, sliding_window=8))
    with pytest.raises(ValueError, match="sliding"):
        kt.duo_decode_step(params_t, torch.zeros((2, 1), dtype=torch.long), ds, runner=windowed)


# ------------------------------------------------------------------ #
# Pipeline


@pytest.fixture(scope="module")
def texts(models):
    tok = ToyTokenizer(models[0].vocab_size)
    words = distinct_words(tok, 70)
    return tok, words


PIPELINE = {"merging_knorm": {}, "lukv_knorm": {}, "simlayerkv": {}, "duo": {},
            "dms_knorm": {}, "dms_kvzap_mlp_compact": dict(headwise_kernel=True)}


@pytest.mark.parametrize("name", list(PIPELINE))
def test_pipeline_same_greedy_answers_as_jax(models, texts, name):
    cfg_j, cfg_t, params_j, params_t = models
    tok, words = texts
    context, questions = " ".join(words[:60]), ["what is " + words[60] + " ?",
                                                " ".join(words[61:70])]
    jpress, tpress = both(name)
    jpipe = JaxPipeline(kj.Runner.create(cfg_j, attn_impl="xla"), params_j, tok)
    tpipe = kt.KVPressPipeline(kt.Runner.create(cfg_t, attn_impl="flash", decode_kernel=False,
                                                device="cpu", **PIPELINE[name]), params_t, tok)
    want = jpipe(context, questions=questions, press=jpress, max_new_tokens=6)["answers"]
    got = tpipe(context, questions=questions, press=tpress, max_new_tokens=6)["answers"]
    assert got == want and all(len(a.split()) == 6 for a in got)


def test_pipeline_compacts_a_host_compact_press(models, texts):
    """DMS compact=True: after the prefill each head's kept entries are at
    the front and the cache is as long as the longest head, so the decode
    steps take the head-wise kernel's route."""
    _, cfg_t, _, params_t = models
    tok, words = texts
    seen = []

    @dataclasses.dataclass(frozen=True)
    class Recording(kt.Runner):
        def forward(self, params, ids, cache, *args, **kw):
            if kw.get("phase") == "decode":
                seen.append((int(cache.length.max()), cache.max_size,
                             cache.mask.sum(-1).amax().tolist()))
            return super().forward(params, ids, cache, *args, **kw)

    base = kt.Runner.create(cfg_t, attn_impl="flash", decode_kernel=False, headwise_kernel=True,
                            device="cpu")
    pipe = kt.KVPressPipeline(Recording(**{f.name: getattr(base, f.name)
                                           for f in dataclasses.fields(base)}), params_t, tok)
    pipe(" ".join(words[:60]), question="what is " + words[60] + " ?",
         press=both("dms_kvzap_mlp_compact")[1], max_new_tokens=3)
    longest, size, _ = seen[0]
    assert longest < 61 and size == longest + 4 + 3 + 1


@pytest.mark.parametrize("name", ["finch", "finch_chunks"])
def test_pipeline_finch_delimiter_same_answers_as_jax(models, texts, name):
    """The query-aware form (evaluation/evaluate.py): context, delimiter,
    question; an empty question. The delimiter is stripped, the window is
    what follows it, and the answer continues from the compressed length."""
    cfg_j, cfg_t, params_j, params_t = models
    tok, words = texts
    context = " ".join(words[:50]) + " </s> " + " ".join(words[50:62])
    jpress, tpress = both(name)
    jpress = dataclasses.replace(jpress, delimiter_token_id=tok.eos_token_id, window_size=None)
    tpress = dataclasses.replace(tpress, delimiter_token_id=tok.eos_token_id, window_size=None)
    offsets = []

    @dataclasses.dataclass(frozen=True)
    class Recording(kt.Runner):
        def forward(self, params, ids, cache, *args, **kw):
            if kw.get("phase") == "decode":
                offsets.append(int(cache.offset))
            return super().forward(params, ids, cache, *args, **kw)

    base = kt.Runner.create(cfg_t, attn_impl="flash", decode_kernel=False, device="cpu")
    tpipe = kt.KVPressPipeline(Recording(**{f.name: getattr(base, f.name)
                                            for f in dataclasses.fields(base)}), params_t, tok)
    jpipe = JaxPipeline(kj.Runner.create(cfg_j, attn_impl="xla"), params_j, tok)
    want = jpipe(context, question="", press=jpress, max_new_tokens=5)["answer"]
    got = tpipe(context, question="", press=tpress, max_new_tokens=5)["answer"]
    assert got == want and len(got.split()) == 5
    # 62 tokens with the BOS-joined first word, the delimiter stripped: the
    # first decode step continues from the kept count after rerotation
    kept = tpress.with_window(12).max_kept(62, cfg_t)
    assert offsets[0] == (kept if tpress.rerotates else 62) and kept == 31


@pytest.mark.parametrize("n_delim", [0, 2])
def test_pipeline_finch_needs_one_delimiter(models, texts, n_delim):
    _, cfg_t, _, params_t = models
    tok, words = texts
    context = " ".join(words[:30]) + " </s>" * n_delim + " " + " ".join(words[30:40])
    pipe = kt.KVPressPipeline(kt.Runner.create(cfg_t, device="cpu"), params_t, tok)
    with pytest.raises(ValueError, match="delimiter"):
        pipe(context, question="", press=kt.FinchPress(0.5, delimiter_token_id=tok.eos_token_id),
             max_new_tokens=2)


# ------------------------------------------------------------------ #
# Refusals


@pytest.mark.parametrize("name", list(PRESSES))
def test_bucketed_refusals(models, name):
    """None of these JAX presses reads the valid length: the port raises."""
    _, cfg_t, _, params_t = models
    ids = np.pad(seeded_ids(cfg_t.vocab_size, 40, 1), ((0, 0), (0, 24)))
    with pytest.raises(ValueError, match="bucketed prefill"):
        kt.Runner.create(cfg_t, device="cpu").prefill(
            params_t, torch.from_numpy(ids).long(), press=both(name)[1], valid_len=40)


def test_dms_decoding_is_refused():
    with pytest.raises(NotImplementedError, match="item 12"):
        kt.DMSPress(kt.KnormPress(), decoding=True)
    with pytest.raises(ValueError, match="prefill-only"):
        kt.DMSPress(kt.KnormPress(), decoding=True, compact=True)
    with pytest.raises(AssertionError):
        kj.DMSPress(kj.KnormPress(), decoding=True, compact=True)


@pytest.mark.parametrize("cls", ["MergingPress", "LUKVPress", "DMSPress"])
def test_wrappers_take_a_scorer(cls):
    with pytest.raises(TypeError, match="ScorerPress"):
        getattr(kt, cls)(kt.AdaKVPress(kt.KnormPress(0.5)))


def test_pipeline_refuses_several_questions_for_a_decode_press(models, texts):
    from kvpress_tpu_torch.presses.decoding import DecodingPress

    _, cfg_t, _, params_t = models
    tok, words = texts
    pipe = kt.KVPressPipeline(kt.Runner.create(cfg_t, device="cpu"), params_t, tok)
    with pytest.raises(ValueError, match="single question"):
        pipe(" ".join(words[:20]), questions=["a", "b"],
             press=DecodingPress(base_press=kt.KnormPress(0.5)), max_new_tokens=2)
