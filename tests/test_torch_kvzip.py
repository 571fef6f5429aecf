"""KVzip, KVzip+, RestoreKV and FastKVzip in kvpress_tpu_torch against the
JAX package on the same weights and inputs (CPU, float32, tiny config; the
port on its kernel routes, whose plain versions run here): the repeat
prompts and the presize bound, the bottom-k head mask with tied scores, the
subset scores, the chunk scorer (plain and plus, over float32, int8 and int4
weights), the lean repeat pass against both JAX forms (float32, int8 and
int4 KV, a sliding config), the scoring passes leaving the context's slots,
length and offset as they were, LoRA merging, the gates, chunked FastKVzip
against one-shot, and the repeat passes of a multimodal context. The
pipelines are in tests/test_torch_kvzip_pipeline.py.

Tolerances: scores within 1e-6 absolute / 1e-5 relative, as JAX's own test
holds its two repeat-pass forms; masks and answers equal. JAX's artifacts
reach the port through the ``.npz`` files (tests/torch_multipass_cases.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu import presses as jp
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
from kvpress_tpu.pipeline import _chat_affixes as j_affixes
from kvpress_tpu.pipeline import kvzip_repeat_bound as j_bound
from kvpress_tpu.presses import fastkvzip as jfast
from kvpress_tpu.presses import kvzip as jkvzip
from kvpress_tpu.presses import restorekv as jrestore
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.pipeline import _chat_affixes as t_affixes
from kvpress_tpu_torch.pipeline import kvzip_repeat_bound as t_bound
from kvpress_tpu_torch.presses import fastkvzip as tfast
from kvpress_tpu_torch.presses.kvzip import subset_max_scores
from test_chat_template import make_chat_tokenizer
from test_torch_multimodal import IMAGE_TOKEN_ID, ImageTokenizer, mm  # noqa: F401 (fixture)
from torch_multipass_cases import Pipelines, artifacts, make_press
from torch_scorer_cases import seeded_ids
from torch_wrapper_cases import jax_ctx

torch.set_num_threads(2)

TOL = dict(atol=1e-6, rtol=1e-5)
S = 60
KV = {"float32": dict(quantized=False, kv_bits=8), "int8": dict(quantized=True, kv_bits=8),
      "int4": dict(quantized=True, kv_bits=4)}


@pytest.fixture(scope="module")
def pipes():
    return Pipelines.tiny()


@pytest.fixture(scope="module")
def art(pipes, tmp_path_factory):
    return artifacts(pipes.cfg_j, tmp_path_factory.mktemp("multipass"))


def _runners(p, decode_kernel=True):
    return (kj.Runner.create(p.cfg_j, attn_impl="xla"),
            kt.Runner.create(p.cfg_t, attn_impl="flash", decode_kernel=decode_kernel,
                             device="cpu"))


def _prefill_both(p, ids, room, kv, decode_kernel=True):
    """The uncompressed prefill of ``ids`` in both packages, ``room`` slots
    after the context."""
    rj, rt = _runners(p, decode_kernel)
    _, cj, _ = rj.prefill(p.params_j, jnp.asarray(ids), max_size=ids.shape[1] + room,
                          dtype=jnp.float32, **kv)
    _, ct, _ = rt.prefill(p.params_t, torch.from_numpy(ids).long(),
                          max_size=ids.shape[1] + room, **kv)
    return rj, rt, cj, ct


# --------------------------------------------------------------------- #
# Repeat prompts, presize bound, head mask, subset scores


@pytest.mark.parametrize("template", [False, True])
def test_chunk_pairs_and_repeat_bound_match_jax(pipes, template):
    tok = make_chat_tokenizer() if template else pipes.tok
    ids = list(range(3, 90)) if template else seeded_ids(pipes.cfg_t.vocab_size, 87, 1)[0].tolist()
    for chunk in (16, 24, 200):
        jpress, tpress = jp.KVzipPress(0.5, chunk_size=chunk), kt.KVzipPress(0.5, chunk_size=chunk)
        jprefix, jsuffix = j_affixes(tok)
        assert t_affixes(tok) == (jprefix, list(jsuffix))
        assert (tpress.chunk_pairs(ids, jprefix, jsuffix, tok)
                == jpress.chunk_pairs(ids, jprefix, jsuffix, tok))
        assert t_bound(tpress, ids, tok) == j_bound(jpress, ids, tok)
        assert t_bound(tpress, ids, None) == tpress.repeat_room() == jpress.repeat_room()
    assert t_bound(kt.KVzipPress(0.0), ids, tok) == kt.KVzipPress(0.0).repeat_room()


def test_chat_affixes_are_memoised_by_template():
    tok = make_chat_tokenizer()
    first = t_affixes(tok)
    assert tok._kvpress_chat_affixes == (tok.chat_template, first)
    tok.chat_template = tok.chat_template.replace("<user>", "<u>")
    second = t_affixes(tok)
    assert second != first and second == j_affixes(tok)


@pytest.mark.parametrize("layerwise", [False, True])
@pytest.mark.parametrize("ratio", [0.3, 0.5, 0.0])
def test_head_mask_from_scores_with_ties_matches_jax(layerwise, ratio):
    """Scores rounded to a tenth: every value ties with many others (numpy's
    unstable argsort on the same float32 array on both sides)."""
    rng = np.random.default_rng(4)
    scores = np.round(rng.random((3, 1, 2, 40)), 1).astype(np.float32)
    scores[..., :4] = 1.0
    kw = dict(compression_ratio=ratio, layerwise=layerwise)
    got = kt.KVzipPress(**kw).head_mask_from_scores(scores)
    np.testing.assert_array_equal(got, jp.KVzipPress(**kw).head_mask_from_scores(scores))
    if ratio:
        assert not got.all()


@pytest.mark.parametrize("sink", [0, 4])
def test_subset_max_scores_matches_jax(sink):
    rng = np.random.default_rng(sink)
    T, cl = 12, 20
    q = rng.standard_normal((1, 4, T, 16)).astype(np.float32) * 2
    ks = rng.standard_normal((1, 2, sink + cl + T, 16)).astype(np.float32) * 2
    want = jkvzip.subset_max_scores(jnp.asarray(q), jnp.asarray(ks), sink, cl)
    got = subset_max_scores(torch.from_numpy(q), torch.from_numpy(ks), sink, cl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------- #
# The chunk scorer (KVzip+ route) and the lean repeat pass


def _quantized_models(p, weights):
    if weights == "float32":
        return p.params_j, p.params_t
    from kvpress_tpu.models.llama import quantize_params_int4, quantize_params_int8

    qj = {"int8": quantize_params_int8, "int4": quantize_params_int4}[weights](p.params_j)
    return qj, kt.params_from_jax(jax.tree_util.tree_map(np.asarray, qj), p.cfg_t,
                                  device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("weights", ["float32", "int8", "int4"])
@pytest.mark.parametrize("plus", [False, True])
def test_chunk_scorer_matches_jax(pipes, plus, weights):
    """decode_compress on one decode LayerCtx of layer 1 and a 96-slot
    buffer: the chunk 10..40 with 4 sink slots, 16 repeat tokens after the
    60-slot context; plus reads ||Wo . v|| from the dequantized Wo."""
    p = pipes
    params_j, params_t = _quantized_models(p, weights)
    rng = np.random.default_rng(11)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    cfg, T = p.cfg_t, 16
    keys, values = f(1, cfg.num_kv_heads, 96, cfg.head_dim), f(1, cfg.num_kv_heads, 96,
                                                               cfg.head_dim)
    ctx = kt.LayerCtx(layer_idx=1, hidden=f(1, T, cfg.hidden_size),
                      queries=f(1, cfg.num_heads, T, cfg.head_dim), queries_prerope=None,
                      keys_prerope=None, positions=(S + torch.arange(T))[None],
                      attn_probs=None, layer_params=params_t.layers[1], inv_freq=None, cfg=cfg)
    kw = dict(start_idx=10, end_idx=40, context_length=S, n_sink=4, plus=plus)
    *_, got = kt.KVzipChunkScorer(**kw).decode_compress(ctx, keys, values, S + T, None)
    *_, want = jkvzip.KVzipChunkScorer(**kw).decode_compress(
        jax_ctx(ctx, p.cfg_j, params_j), jnp.asarray(keys.numpy()), jnp.asarray(values.numpy()),
        S + T, None)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), **TOL)


def _sliding_pipes():
    over = dict(num_layers=4, sliding_window=8, rope_local_base_freq=500.0,
                layer_is_sliding=tuple(i % 2 == 0 for i in range(4)))
    cfg_j, cfg_t = kj.tiny_config(**over), kt.tiny_config(**over)
    params_j = kj.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    params_t = kt.params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), cfg_t,
                                  device="cpu", dtype=torch.float32)
    return dataclasses.replace(Pipelines.tiny(), cfg_j=cfg_j, cfg_t=cfg_t, params_j=params_j,
                               params_t=params_t)


@pytest.mark.parametrize("config,kv", [("tiny", "float32"), ("tiny", "int8"), ("tiny", "int4"),
                                       ("sliding", "float32")])
def test_repeat_pass_matches_jax_both_forms(pipes, kv, config):
    """Runner.kvzip_repeat_pass against JAX's scan form and its host-loop
    form (scan_max_bytes=0), the chunk 2..50 with 2 sink slots; the
    context's slots, length and offset untouched. The sliding config is
    JAX's own test_kvzip_lean_pass_sliding_window_model (its sliding layers
    attend their window of 8)."""
    p = pipes if config == "tiny" else _sliding_pipes()
    ids = seeded_ids(p.cfg_t.vocab_size, 64 if config == "sliding" else S, 3)
    rep = [11, 12, 5, 6] + ids[0, 2:50].tolist()
    rj, rt, cj, ct = _prefill_both(p, ids, len(rep) + 4, KV[kv])
    before = _snapshot(ct, ids.shape[1])
    rep_t = torch.tensor([rep])
    got_cache, got = rt.kvzip_repeat_pass(p.params_t, rep_t, ct, 2, 2, 48)
    assert got_cache is ct and got.shape == (p.cfg_t.num_layers, 1, p.cfg_t.num_kv_heads, 48)
    _assert_untouched(ct, before)
    for scan_max in (3 << 30, 0):
        _, want = rj.kvzip_repeat_pass(p.params_j, jnp.asarray([rep], jnp.int32), cj, 2, 2, 48,
                                       scan_max_bytes=scan_max)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_repeat_pass_with_embeds_equals_ids(pipes):
    p = pipes
    ids = seeded_ids(p.cfg_t.vocab_size, S, 3)
    rep = torch.tensor([[11, 12, 5, 6] + ids[0, 2:50].tolist()])
    _, rt, _, ct = _prefill_both(p, ids, rep.shape[1] + 4, KV["float32"])
    _, by_ids = rt.kvzip_repeat_pass(p.params_t, rep, ct, 2, 2, 48)
    embeds = kt.models.llama.embed_tokens(p.params_t, rep, p.cfg_t)
    _, by_embeds = rt.kvzip_repeat_pass(p.params_t, None, ct, 2, 2, 48, rep_embeds=embeds)
    torch.testing.assert_close(by_embeds, by_ids, rtol=0, atol=0)


def test_repeat_pass_refuses_a_full_buffer(pipes):
    p = pipes
    ids = seeded_ids(p.cfg_t.vocab_size, S, 3)
    _, rt, _, ct = _prefill_both(p, ids, 4, KV["int8"])
    with pytest.raises(ValueError, match="presize or grow"):
        rt.kvzip_repeat_pass(p.params_t, torch.tensor([list(range(3, 20))]), ct, 0, 0, 10)


def _snapshot(cache, n):
    return ([None if t is None else t[:, :, :, :n].clone()
             for t in (cache.keys, cache.values, cache.key_scales, cache.value_scales)],
            cache.length.clone(), cache.offset.clone())


def _assert_untouched(cache, snap):
    tensors, length, offset = snap
    n = tensors[0].shape[3]
    for t, before in zip((cache.keys, cache.values, cache.key_scales, cache.value_scales),
                         tensors):
        if before is not None:
            assert torch.equal(t[:, :, :, :n], before)
    assert torch.equal(cache.length, length) and torch.equal(cache.offset, offset)


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("plus", [False, True])
def test_run_kvzip_leaves_the_context(pipes, plus, kv):
    """_run_kvzip over a cache with room: every repeat pass (the lean pass,
    or the scorer route through Runner.forward, which must not requantize
    the layer) leaves the context's payloads, scales, length and offset
    bit-equal; only the keep-mask changes."""
    p = pipes
    ids = seeded_ids(p.cfg_t.vocab_size, S, 5)
    _, rt, _, ct = _prefill_both(p, ids, 40, KV[kv], decode_kernel=False)
    before = _snapshot(ct, S)
    pipe = kt.KVPressPipeline(rt, p.params_t, p.tok)
    out = pipe._run_kvzip(ct, ids[0].tolist(),
                          kt.KVzipPress(0.5, chunk_size=24, kvzip_plus_normalization=plus))
    _assert_untouched(ct, before)
    _assert_untouched(out, before)
    assert 0.45 < (~out.mask[..., :S]).float().mean() < 0.55


# --------------------------------------------------------------------- #
# RestoreKV's LoRA, FastKVzip's gates


def test_apply_lora_matches_jax(pipes, art):
    p = pipes
    _, (_, lora_j, scaling) = art["jax"]
    _, (_, lora_t, _) = art["torch"]
    want = jrestore.apply_lora(p.params_j, lora_j, scaling)
    got = kt.apply_lora(p.params_t, lora_t, scaling)
    for name in ("wq", "wk", "wv", "wo", "wg"):
        for l, layer in enumerate(got.layers):
            np.testing.assert_allclose(getattr(layer, name).numpy(),
                                       np.asarray(want["layers"][name][l]), atol=1e-7)
    assert got.layers[0].wg is p.params_t.layers[0].wg or torch.equal(got.layers[0].wg,
                                                                      p.params_t.layers[0].wg)
    assert not torch.equal(got.layers[0].wq, p.params_t.layers[0].wq)


@pytest.mark.parametrize("weights", ["int8", "int4"])
def test_apply_lora_refuses_quantized_weights(pipes, art, weights):
    """A LoRA sum with a quantized payload has no meaning: the port refuses
    it. (JAX adds the delta to the payload: the int4 payload's half-height
    shape makes that an error, the int8 one a silent sum of codes.)"""
    p = pipes
    params_j, params_t = _quantized_models(p, weights)
    with pytest.raises(ValueError, match="quantized"):
        kt.apply_lora(params_t, art["torch"][1][1])
    if weights == "int4":
        with pytest.raises((TypeError, ValueError)):
            jrestore.apply_lora(params_j, art["jax"][1][1])


def test_artifacts_round_trip(pipes, art, tmp_path):
    gates, (emb, lora, scaling) = art["torch"]
    kt.save_fastkvzip_gates(str(tmp_path / "g.npz"), gates)
    again = kt.load_fastkvzip_gates(str(tmp_path / "g.npz"), device="cpu")
    assert all(torch.equal(again[k], gates[k]) for k in gates)
    kt.save_restore_artifacts(str(tmp_path / "r.npz"), emb, lora, scaling)
    emb2, lora2, scaling2 = kt.load_restore_artifacts(str(tmp_path / "r.npz"), device="cpu")
    assert torch.equal(emb2, emb) and scaling2 == scaling
    assert all(torch.equal(lora2[n][ab], lora[n][ab]) for n in lora for ab in "ab")
    drawn = kt.init_random_gates(torch.Generator().manual_seed(0), pipes.cfg_t, device="cpu")
    assert {k: v.shape for k, v in drawn.items()} == {k: v.shape for k, v in gates.items()}
    lora_r = kt.init_random_lora(torch.Generator().manual_seed(0), pipes.cfg_t, device="cpu")
    assert all(lora_r[n]["a"].shape == lora[n]["a"].shape and not lora_r[n]["b"].any()
               for n in lora)


def test_gate_scores_protect_and_post_mask_match_jax(pipes, art):
    p = pipes
    gates_j, gates_t = art["jax"][0], art["torch"][0]
    hidden = np.random.default_rng(6).standard_normal((1, 50, p.cfg_t.hidden_size)).astype(
        np.float32)
    for l in range(p.cfg_t.num_layers):
        got = tfast.gate_scores(gates_t, l, torch.from_numpy(hidden))
        want = jfast.gate_scores(gates_j, l, jnp.asarray(hidden))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    rng = np.random.default_rng(7)
    scores = np.round(rng.random((p.cfg_t.num_layers, 1, p.cfg_t.num_kv_heads, 50)),
                      2).astype(np.float32)
    for kw in (dict(n_sink=2), dict(n_sink=4, window_ratio=0.1, layerwise=True)):
        jpress = jp.FastKVzipPress(0.5, gates=gates_j, **kw)
        tpress = kt.FastKVzipPress(0.5, gates=gates_t, **kw)
        protected = tpress.protect_scores(torch.from_numpy(scores), 50)
        np.testing.assert_array_equal(protected.numpy(),
                                      np.asarray(jpress.protect_scores(jnp.asarray(scores), 50)))
        cache_t = kt.init_cache(p.cfg_t, 1, 64, dtype=torch.float32, device="cpu")
        cache_j = kj.init_cache(p.cfg_j, 1, 64, dtype=jnp.float32)
        got = tpress.apply_post_mask(cache_t, [{"scores": s} for s in protected])
        want = jpress.apply_post_mask(cache_j, {"scores": jnp.asarray(protected.numpy())})
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        assert got.mask[..., 50:].all() and not got.mask.all()


@pytest.mark.parametrize("kv", list(KV))
def test_fastkvzip_chunked_equals_one_shot_and_jax(pipes, art, kv):
    """The gate scores collected chunk by chunk (chunks of 16) and protected
    over the whole context equal the one-shot prefill's, and JAX's."""
    p = pipes
    ids = seeded_ids(p.cfg_t.vocab_size, S, 8)
    rj, rt = _runners(p)
    tpress, jpress = (make_press(kt, "fastkvzip", art["torch"]),
                      make_press(jp, "fastkvzip", art["jax"]))
    _, c1, one = rt.prefill(p.params_t, torch.from_numpy(ids).long(), press=tpress, **KV[kv])
    _, c2, chunked = rt.prefill_chunked(p.params_t, torch.from_numpy(ids).long(), press=tpress,
                                        chunk_size=16, **KV[kv])
    _, _, jstate = rj.prefill_chunked(p.params_j, jnp.asarray(ids), press=jpress, chunk_size=16,
                                      dtype=jnp.float32, **KV[kv])
    got1, got2 = (torch.stack([s["scores"] for s in st]).numpy() for st in (one, chunked))
    np.testing.assert_allclose(got2, got1, **TOL)
    np.testing.assert_allclose(got2, np.asarray(jstate["scores"]), **TOL)
    assert (c1.mask is None or c1.mask.all()) and c2.mask is None
    assert c1.length.tolist() == c2.length.tolist() == [S] * p.cfg_t.num_layers


# --------------------------------------------------------------------- #
# A multimodal context


def test_multimodal_repeat_embeds_match_jax(mm):
    """A tiny Gemma3 (one sliding, one global layer) with two images,
    chunked by 8: the repeat prompts re-feed each chunk's captured
    embeddings, and the answer equals JAX's."""
    tok = ImageTokenizer(vocab_size=498)
    jpipe = JaxPipeline(kj.Runner.create(mm["cfg_j"], attn_impl="xla"), mm["params_j"], tok,
                        vision_params=mm["embed_j"].vparams, vision_cfg=mm["embed_j"].vcfg,
                        image_token_id=IMAGE_TOKEN_ID)
    tpipe = kt.KVPressPipeline(
        kt.Runner.create(mm["cfg_t"], attn_impl="flash", device="cpu"), mm["params_t"], tok,
        vision_params=mm["tower"], vision_cfg=mm["tower"].vcfg, image_token_id=IMAGE_TOKEN_ID)
    words = " ".join(f"w{i}" for i in range(12))
    context = (f"{words} <image> <image> <image> <image> mid0 mid1 mid2 <image> <image> "
               f"<image> <image> tail0 tail1")
    px = np.random.default_rng(4).standard_normal((2, 3, 28, 28)).astype(np.float32)
    kw = dict(question="what w3 ?", pixel_values=px, max_new_tokens=6, context_chunk=8)
    want = jpipe(context, press=jp.KVzipPress(0.5, chunk_size=10), **kw)
    assert tpipe(context, press=kt.KVzipPress(0.5, chunk_size=10), **kw) == want
