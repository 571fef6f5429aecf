"""The wrapper presses of kvpress_tpu_torch (CriticalKV, CriticalAdaKV,
KeyRerotation, Chunk, ChunkKV, Block, ThinK, Composed, PerLayerCompression)
one-shot and bucketed, against the JAX package on the same seeded inputs
(CPU, float32, tiny config): ``layer_compress`` on one layer's captured
inputs, ``Runner.prefill`` on the dense and the kernel (plain) routes,
``KVPressPipeline``, and ``rope.rerotate_cos_sin``.

Tolerances: scores, ||Wo.v||_1 norms, rerotated keys and kept entries within
1e-5 (relative and absolute; after a prefill as sets, since two slots whose
scores differ by rounding may trade places); logits within 1e-4; kept sets,
lengths, masks, ThinK's zeroed channels, offsets and greedy answers equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
from kvpress_tpu.presses import wrappers as jwrap
from kvpress_tpu.rope import rerotate_cos_sin as j_rerotate_cos_sin
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.presses import wrappers as twrap
from kvpress_tpu_torch.rope import rerotate_cos_sin
from toy_tokenizer import ToyTokenizer
from torch_scorer_cases import distinct_words, kept_rows, seeded_ids, tiny_models
from torch_wrapper_cases import WRAPPERS, as_numpy, both, capture, jax_ctx

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


def test_rerotate_cos_sin_matches_jax():
    rng = np.random.default_rng(0)
    inv = kt.rope.compute_inv_freq(kt.tiny_config())[0]
    old = rng.integers(0, 4096, (2, 3, 50)).astype(np.int32)
    new = np.sort(rng.integers(0, 4096, (2, 3, 50)), axis=-1).astype(np.int32)
    want = j_rerotate_cos_sin(jnp.asarray(inv), jnp.asarray(old), jnp.asarray(new), 1.25)
    got = rerotate_cos_sin(torch.from_numpy(inv), torch.from_numpy(old), torch.from_numpy(new),
                           1.25)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (2, 3, 50, 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_rerotate_matches_jax():
    """The kept keys rotated from their slots to 0..n-1."""
    rng = np.random.default_rng(1)
    inv = kt.rope.compute_inv_freq(kt.tiny_config())[0]
    keys = rng.standard_normal((2, 2, 20, 16)).astype(np.float32)
    idx = np.sort(rng.permutation(60)[:20].reshape(1, 1, 20).repeat(2, 0).repeat(2, 1), axis=-1)
    want = jwrap.KeyRerotationPress.rerotate(jnp.asarray(keys), jnp.asarray(idx),
                                             jnp.asarray(inv))
    got = twrap.KeyRerotationPress.rerotate(torch.from_numpy(keys), torch.from_numpy(idx),
                                            torch.from_numpy(inv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a key that stays in its slot is not rotated
    same = twrap.KeyRerotationPress.rerotate(torch.from_numpy(keys),
                                             torch.arange(20).expand(2, 2, 20),
                                             torch.from_numpy(inv))
    np.testing.assert_allclose(same.numpy(), keys, **TOL)


@pytest.mark.parametrize("slice_bytes", [None, 4096])
def test_vwl1norm_matches_jax(layer_inputs, monkeypatch, slice_bytes):
    """||Wo.v||_1 by slices of the sequence (4096 bytes: 4 slots a slice)
    equals the JAX einsum's."""
    ctx, _, values, jctx = layer_inputs
    if slice_bytes:
        monkeypatch.setattr(twrap, "WOV_BYTES", slice_bytes)
    got = twrap.CriticalKVPress.vwl1norm(ctx, values)
    want = jwrap.CriticalKVPress.vwl1norm(jctx, jnp.asarray(values.numpy()))
    assert got.shape == (1, 2, S) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_vwl1norm_reads_quantized_weights(models, layer_inputs, quantize):
    """With int8 or int4 weights, ||Wo.v||_1 is that of the dequantized Wo."""
    _, _, _, params_t = models
    ctx, _, values, _ = layer_inputs
    q = {"int8": kt.quantize_params_int8, "int4": kt.quantize_params_int4}[quantize](params_t)
    layer = q.layers[ctx.layer_idx]
    assert layer.get("wo_scale") is not None
    wo = kt.models.llama.dequant_weight(layer, "wo")
    plain = kt.models.llama.DecoderLayer({"wo": wo})
    got = twrap.CriticalKVPress.vwl1norm(dataclasses.replace(ctx, layer_params=layer), values)
    want = twrap.CriticalKVPress.vwl1norm(dataclasses.replace(ctx, layer_params=plain), values)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


CRITICAL = ["critical_knorm", "critical_snapkv", "critical_expected_attention"]


@pytest.mark.parametrize("name", CRITICAL)
def test_critical_scores_match_jax(layer_inputs, name):
    ctx, keys, values, jctx = layer_inputs
    jpress, tpress = both(name)
    got = tpress.score(ctx, keys, values)
    want = jpress.score(jctx, jnp.asarray(keys.numpy()), jnp.asarray(values.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got == twrap.BIG).sum() == 2 * int(0.5 * S * 0.5)        # the first stage's pins


@pytest.mark.parametrize("name", CRITICAL)
def test_critical_dynamic_score_over_zero_pads(layer_inputs, name):
    """A bucketed buffer whose slots past the valid length hold zeros: the
    pads score NEG_INF (0 * -inf would be a NaN that a descending sort puts
    first), the rest as JAX scores them."""
    ctx, keys, values, jctx = layer_inputs
    length = S - 12
    keys, values = keys.clone(), values.clone()
    keys[:, :, length:] = 0
    values[:, :, length:] = 0
    jpress, tpress = both(name)
    got = tpress.dynamic_score(dataclasses.replace(ctx, kv_len=length), keys, values, length)
    want = jpress.dynamic_score(dataclasses.replace(jctx, kv_len=jnp.asarray(length)),
                                jnp.asarray(keys.numpy()), jnp.asarray(values.numpy()),
                                jnp.asarray(length, jnp.int32))
    assert not torch.isnan(got).any()
    assert (got[..., length:] == twrap.NEG_INF).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _same_compression(got, want, S_):
    """Kept entries, length and mask of two ``layer_compress`` results."""
    k, v, n, m = (as_numpy(x) for x in got[:4])
    jk, jv, jn, jm = (as_numpy(x) for x in want[:4])
    assert int(n) == int(jn)
    np.testing.assert_array_equal(m, jm[..., :S_])
    n = int(n)
    np.testing.assert_allclose(k[:, :, :n], jk[:, :, :n], **TOL)
    np.testing.assert_allclose(v[:, :, :n], jv[:, :, :n], **TOL)


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_layer_compress_matches_jax(layer_inputs, name):
    ctx, keys, values, jctx = layer_inputs
    jpress, tpress = both(name)
    mask = torch.ones(keys.shape[:3], dtype=torch.bool)
    got = tpress.layer_compress(ctx, keys, values, S, mask)
    want = jpress.layer_compress(jctx, jnp.asarray(keys.numpy()), jnp.asarray(values.numpy()),
                                 jnp.asarray(S, jnp.int32), jnp.asarray(mask.numpy()))
    _same_compression(got, want, S)
    # the inputs are left as they were
    assert torch.equal(keys, layer_inputs[1]) and torch.equal(values, layer_inputs[2])
    if name == "think":
        zero = (got[0] == 0).all(dim=2)                                 # (B, H, D)
        assert zero.sum(-1).tolist() == [[8, 8]]
        np.testing.assert_array_equal(zero.numpy(), (np.asarray(want[0]) == 0).all(axis=2))
    if name == "key_rerotation":
        # slot j holds the key of the j-th kept position, rotated to j
        idx = torch.sort(kt.presses.base.order_desc(keys.norm(dim=-1).neg(), 36), -1).values
        kept = torch.gather(keys, 2, idx[..., None].expand(-1, -1, -1, keys.shape[-1]))
        np.testing.assert_allclose(
            got[0][:, :, :36].numpy(),
            twrap.KeyRerotationPress.rerotate(kept, idx, ctx.inv_freq).numpy(), **TOL)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_prefill_keeps_what_jax_keeps(models, name, attn_impl):
    """Kept entries, lengths and masks of every layer, and the logits, equal
    the JAX dense runner's, on the port's dense and kernel (plain) routes."""
    cfg_j, cfg_t, params_j, params_t = models
    ids = seeded_ids(cfg_t.vocab_size, S, 3)
    jpress, tpress = both(name)
    jl, jc, _ = kj.Runner.create(cfg_j, attn_impl="xla").prefill(
        params_j, jnp.asarray(ids), press=jpress, dtype=jnp.float32, compute_logits=True)
    tr = kt.Runner.create(cfg_t, attn_impl=attn_impl, decode_kernel=False, device="cpu")
    tl, tc, _ = tr.prefill(params_t, torch.from_numpy(ids).long(), press=tpress,
                           compute_logits=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    if jc.mask is not None:
        np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    # as sets: two slots whose scores differ by rounding may trade places
    for layer, n in enumerate(np.asarray(jc.length)):
        for a, b in ((tc.keys, jc.keys), (tc.values, jc.values)):
            np.testing.assert_allclose(kept_rows(a.numpy(), layer, n),
                                       kept_rows(b, layer, n), **TOL)


def test_composed_refuses_headwise_presses():
    with pytest.raises(TypeError, match="ComposedPress"):
        kt.ComposedPress((kt.KnormPress(0.5), kt.CriticalAdaKVPress(kt.KnormPress(0.5))))
    with pytest.raises(TypeError, match="ComposedPress"):
        kt.ComposedPress((kt.AdaKVPress(kt.KnormPress(0.5)),))
    with pytest.raises(ValueError, match="composable"):
        kt.ComposedPress((kt.ChunkKVPress(kt.KnormPress(0.5)),)).max_kept(64, None)


@pytest.mark.parametrize("cls", ["CriticalKVPress", "CriticalAdaKVPress", "KeyRerotationPress",
                                 "ChunkPress", "ChunkKVPress", "BlockPress",
                                 "PerLayerCompressionPress"])
def test_wrappers_take_a_scorer(cls):
    with pytest.raises(TypeError, match="ScorerPress"):
        getattr(kt, cls)(kt.AdaKVPress(kt.KnormPress(0.5)))


# ------------------------------------------------------------------ #
# Pipeline


@dataclasses.dataclass(frozen=True)
class _Recording(kt.Runner):
    """A runner that records the offset each multi-token decode-phase
    forward (a question) starts from."""
    offsets: list = dataclasses.field(default_factory=list, compare=False)

    def forward(self, params, ids, cache, *args, **kw):
        if kw.get("phase") == "decode" and ids is not None and ids.shape[1] > 1:
            self.offsets.append(int(cache.offset))
        return super().forward(params, ids, cache, *args, **kw)


PIPELINE = {"key_rerotation": {}, "critical_adakv_snapkv_compact": dict(headwise_kernel=True),
            "snap_think": {}, "per_layer": {}, "critical_snapkv": {}}


@pytest.fixture(scope="module")
def texts(models):
    tok = ToyTokenizer(models[0].vocab_size)
    words = distinct_words(tok, 70)
    return tok, " ".join(words[:60]), ["what is " + words[60] + " ?", " ".join(words[61:70])]


@pytest.mark.parametrize("name", list(PIPELINE))
def test_pipeline_same_greedy_answers_as_jax(models, texts, name):
    """Greedy answers equal the JAX pipeline's; after KeyRerotation the
    questions continue from the compressed length."""
    cfg_j, cfg_t, params_j, params_t = models
    tok, context, questions = texts
    jpress, tpress = both(name)
    base = kt.Runner.create(cfg_t, attn_impl="flash", decode_kernel=False, device="cpu",
                            **PIPELINE[name])
    runner = _Recording(**{f.name: getattr(base, f.name) for f in dataclasses.fields(base)})
    jpipe = JaxPipeline(kj.Runner.create(cfg_j, attn_impl="xla"), params_j, tok)
    tpipe = kt.KVPressPipeline(runner, params_t, tok)
    want = jpipe(context, questions=questions, press=jpress, max_new_tokens=6)["answers"]
    got = tpipe(context, questions=questions, press=tpress, max_new_tokens=6)["answers"]
    assert got == want and all(len(a.split()) == 6 for a in got)
    n_context = len(tpipe.preprocess(context, questions, "", None, False)[0])
    start = n_context // 2 if name == "key_rerotation" else n_context
    assert runner.offsets == [start, start]


# ------------------------------------------------------------------ #
# Bucketed prefill

BUCKET = 64


@pytest.mark.parametrize("true_len", [40, 57])
@pytest.mark.parametrize("name", CRITICAL)
def test_critical_bucketed_matches_exact_and_jax(models, name, true_len):
    """CriticalKV takes the valid length: its bucketed prefill keeps what
    its exact prefill keeps, and what the JAX bucketed prefill keeps."""
    cfg_j, cfg_t, params_j, params_t = models
    ids = seeded_ids(cfg_t.vocab_size, true_len, 1)
    ids_pad = np.pad(ids, ((0, 0), (0, BUCKET - true_len)))
    jpress, tpress = both(name)
    runner = kt.Runner.create(cfg_t, attn_impl="flash", decode_kernel=False, device="cpu")
    lg_e, c_e, _ = runner.prefill(params_t, torch.from_numpy(ids).long(), press=tpress,
                                  compute_logits=True)
    lg_b, c_b, _ = runner.prefill(params_t, torch.from_numpy(ids_pad).long(), press=tpress,
                                  compute_logits=True, valid_len=true_len)
    lg_j, c_j, _ = kj.Runner.create(cfg_j, attn_impl="xla").prefill(
        params_j, jnp.asarray(ids_pad), press=jpress, dtype=jnp.float32, compute_logits=True,
        valid_len=jnp.asarray(true_len, jnp.int32))
    assert int(c_b.offset) == int(c_j.offset) == true_len
    np.testing.assert_array_equal(c_b.length.numpy(), c_e.length.numpy())
    np.testing.assert_array_equal(c_b.length.numpy(), np.asarray(c_j.length))
    np.testing.assert_allclose(lg_b.numpy(), lg_e.numpy(), atol=1e-4)
    np.testing.assert_allclose(lg_b.numpy(), np.asarray(lg_j), atol=1e-4)
    for layer, n in enumerate(c_e.length.tolist()):
        for cache in (c_e, c_j):
            np.testing.assert_allclose(c_b.keys[layer, :, :, :n].numpy(),
                                       as_numpy(cache.keys)[layer, :, :, :n], atol=1e-5)


REFUSED = ["critical_adakv_knorm", "key_rerotation", "chunk_knorm", "chunkkv",
           "block_keydiff", "think", "snap_think", "per_layer"]


@pytest.mark.parametrize("name", REFUSED)
def test_bucketed_refusals(models, name):
    """The JAX counterparts score the pads and size their budgets from the
    padded length: the port raises instead."""
    _, cfg_t, _, params_t = models
    ids = np.pad(seeded_ids(cfg_t.vocab_size, 40, 1), ((0, 0), (0, BUCKET - 40)))
    runner = kt.Runner.create(cfg_t, device="cpu")
    with pytest.raises(ValueError, match="bucketed prefill"):
        runner.prefill(params_t, torch.from_numpy(ids).long(), press=both(name)[1],
                       valid_len=40)


def test_pipeline_context_bucket_refuses_key_rerotation(models, texts):
    _, cfg_t, _, params_t = models
    tok, context, questions = texts
    pipe = kt.KVPressPipeline(kt.Runner.create(cfg_t, device="cpu"), params_t, tok)
    with pytest.raises(ValueError, match="context_bucket"):
        pipe(context, question=questions[0], press=kt.KeyRerotationPress(kt.KnormPress(0.5)),
             context_bucket=32, max_new_tokens=2)
