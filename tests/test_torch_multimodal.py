"""Gemma3 multimodal prefill in kvpress_tpu_torch against kvpress_tpu (CPU,
float32): the same-image or-mask of ``flash_attention``'s plain version
against the Pallas kernel in interpret mode, the SigLIP tower and
``multimodal_embeds`` against the JAX ones (and HF), same-image prefill
logits against HF with ``token_type_ids``, and the multimodal pipeline's
greedy answers and kept sets against the JAX pipeline's, one-shot and
chunked. A tiny ``Gemma3ForConditionalGeneration`` built from a config (one
sliding and one global layer) is converted by both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.models import llama as jllama
from kvpress_tpu.models.convert import from_torch_multimodal as jfrom_mm
from kvpress_tpu.models.convert import multimodal_embeds as jembeds
from kvpress_tpu.ops.flash import flash_attention as jflash
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.ops import flash as tfl
from toy_tokenizer import ToyTokenizer

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

IMAGE_TOKEN_ID = 500
SPAN = 4            # mm_tokens_per_image of the tiny model
TOL = 1e-4          # float32 on both sides, sums in another order


# --------------------------------------------------------------------- #
# The or-mask: plain version against the Pallas kernel in interpret mode

# B, Hq, Hkv, T, S, D, prior, window, softcap, image spans (slot, length),
# keep-mask, LSE. The Pallas kernel runs with 16-row q-tiles and 128-key
# tiles, so spans cross its tile edges.
OR_CASES = {
    "spans across tile edges": (1, 4, 2, 384, 384, 64, 0, None, None,
                                ((100, 40), (250, 20), (300, 9)), False, False),
    "window shorter than a span": (1, 4, 2, 256, 256, 64, 0, 16, None,
                                   ((60, 40), (130, 33)), False, False),
    "prior > 0, one image in the prior": (2, 4, 2, 64, 320, 64, 192, None, None,
                                          ((50, 30), (200, 20)), True, False),
    "LSE and softcap": (1, 8, 2, 200, 200, 64, 0, 24, 30.0,
                        ((10, 25), (120, 25)), True, True),
}


@pytest.mark.parametrize("case", list(OR_CASES))
def test_or_mask_plain_matches_pallas(case):
    B, Hq, Hkv, T, S, D, prior, window, softcap, spans, masked, lse = OR_CASES[case]
    rng = np.random.default_rng(list(OR_CASES).index(case))
    q = rng.standard_normal((B, Hq, T, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Hkv, S, D)).astype(np.float32) for _ in range(2))
    mask = rng.random((B, Hkv, S)) < (0.8 if masked else 1.0)
    kg = np.full((B, S), -1, np.int32)
    for g, (start, n) in enumerate(spans):
        kg[:, start:start + n] = g
    qg = kg[:, prior:prior + T].copy()
    span = max(n for _, n in spans)
    kw = dict(sm_scale=D ** -0.5, softcap=softcap, window=window, or_span=span,
              return_lse=lse)
    want = jflash(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(prior, jnp.int32),
                  jnp.asarray(mask), jnp.asarray(qg), jnp.asarray(kg), block_q=16,
                  block_k=128, interpret=True, **kw)
    got = tfl.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), prior,
                              *(torch.from_numpy(a) for a in (mask, qg, kg)), **kw)
    want, got = (want, got) if lse else ((want,), (got,))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=TOL, rtol=TOL)
    # the or-mask matters here, and the split launch's plain version agrees
    plain = tfl.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), prior,
                                      torch.from_numpy(mask), **{**kw, "or_span": None})
    assert (plain[0] if lse else plain).sub(got[0]).abs().max() > 1e-3
    split = tfl.flash_attention_split_plain(*(torch.from_numpy(a) for a in (q, k, v)), prior,
                                            torch.from_numpy(mask), torch.from_numpy(qg),
                                            torch.from_numpy(kg), splits=3, **kw)
    np.testing.assert_allclose((split[0] if lse else split).numpy(), got[0].numpy(),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", [
    # B, Hkv, G, T, S, D, prior, window, or_span
    (1, 2, 4, 64, 4160, 128, 4096, 200, 256),
    (1, 2, 4, 64, 4160, 128, 4096, 200, None),
    (1, 2, 4, 64, 8192, 64, 0, None, 256),
])
def test_flash_splits_cover_the_or_mask_reach(shape):
    """The host's split count reads the same key range as the kernel: the
    last q-tile's range widened by or_span - 1 on both sides, its tiles
    counted as the JAX kernel's tile skip counts them."""
    B, Hkv, G, T, S, D, prior, window, or_span = shape
    nk, bq = tfl.key_tile(D), tfl.BLOCK_ROWS // G
    reach = or_span - 1 if or_span else 0
    t0 = (-(-T // bq) - 1) * bq
    lo = max(0, prior + t0 - max(window - 1, reach)) if window else 0
    hi = min(S, prior + T + reach)
    tiles = [i for i in range(S // nk + 1) if i * nk < hi and (i + 1) * nk > lo // nk * nk]
    blocks = -(-T // bq) * Hkv * B
    want = max(1, min(-(-tfl.TARGET_BLOCKS // blocks), len(tiles), tfl.MAX_SPLITS))
    assert tfl.flash_splits(B, Hkv, G, T, S, D, prior, window, or_span) == want


# --------------------------------------------------------------------- #
# The tiny multimodal model, converted by both packages


class ImageTokenizer(ToyTokenizer):
    """ToyTokenizer with the word ``<image>`` as the placeholder id."""

    def _tok2id(self, tok):
        return IMAGE_TOKEN_ID if tok == "<image>" else super()._tok2id(tok)


def _perturb_norms(model):
    """Norm weights off their init values: with q/k-norm every key of a
    freshly made model has the same norm, and KnormPress would choose among
    ties."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(torch.randn_like(p) * 0.3)


@pytest.fixture(scope="module")
def mm():
    from transformers import Gemma3Config, Gemma3ForConditionalGeneration
    from transformers.models.gemma3 import Gemma3TextConfig
    from transformers.models.siglip import SiglipVisionConfig

    torch.manual_seed(0)
    vc = SiglipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=2, image_size=28, patch_size=7,
                            num_channels=3)
    tc = Gemma3TextConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                          head_dim=16, max_position_embeddings=512, pad_token_id=0,
                          bos_token_id=1, eos_token_id=2, sliding_window=8,
                          tie_word_embeddings=False,
                          layer_types=["sliding_attention", "full_attention"])
    model = Gemma3ForConditionalGeneration(Gemma3Config(
        text_config=tc, vision_config=vc, mm_tokens_per_image=SPAN,
        image_token_index=IMAGE_TOKEN_ID, boi_token_index=498, eoi_token_index=499))
    model.eval()
    _perturb_norms(model)
    params_j, cfg_j, embed_j = jfrom_mm(model, dtype=jnp.float32)
    params_t, cfg_t, tower = kt.from_torch_multimodal(model, dtype=torch.float32, device="cpu")
    return dict(model=model, params_j=params_j, cfg_j=cfg_j, embed_j=embed_j,
                params_t=params_t, cfg_t=cfg_t, tower=tower)


def test_vision_tower_and_embeds_match_jax_and_hf(mm):
    """Features (4 x 4 patches pooled to 2 x 2) against the JAX tower and HF
    ``get_image_features``; the JAX tree through ``vision_from_jax`` gives
    the same; ``multimodal_embeds`` equals the JAX one."""
    from kvpress_tpu_torch.models.siglip import vision_from_jax

    px = np.random.default_rng(0).standard_normal((2, 3, 28, 28)).astype(np.float32)
    got = mm["tower"](px)
    assert tuple(got.shape) == (2, SPAN, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(mm["embed_j"](px)), atol=TOL, rtol=TOL)
    with torch.no_grad():
        ref = mm["model"].get_image_features(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got.numpy(), ref.reshape(got.shape), atol=TOL, rtol=TOL)
    tree = jax.tree_util.tree_map(np.asarray, mm["embed_j"].vparams)
    again = vision_from_jax(tree, mm["tower"].vcfg, device="cpu")(px)
    np.testing.assert_allclose(again.numpy(), got.numpy(), atol=1e-6, rtol=1e-6)

    ids = np.random.default_rng(1).integers(1, 498, (1, 20))
    ids[0, 3:7] = ids[0, 12:16] = IMAGE_TOKEN_ID
    want = jembeds(mm["params_j"], mm["cfg_j"], ids, np.asarray(mm["embed_j"](px)),
                   IMAGE_TOKEN_ID)
    emb = kt.multimodal_embeds(mm["params_t"], mm["cfg_t"], torch.from_numpy(ids), got,
                               IMAGE_TOKEN_ID)
    np.testing.assert_allclose(emb.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def _image_ids(seed, T, spans):
    ids = np.random.default_rng(seed).integers(1, 498, (1, T))
    for start in spans:
        ids[0, start:start + SPAN] = IMAGE_TOKEN_ID
    return ids


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_same_image_prefill_matches_hf(mm, attn_impl):
    """Two images: the prefill's logits with ``token_types`` against HF's
    forward with ``token_type_ids`` (the image tokens see their whole image,
    not the other one's later tokens), on the dense path and through
    ``flash_attention``'s or-mask (its plain version here)."""
    ids = _image_ids(2, 20, (3, 10))
    px = np.random.default_rng(2).standard_normal((2, 3, 28, 28)).astype(np.float32)
    tt = (ids == IMAGE_TOKEN_ID).astype(np.int64)
    with torch.no_grad():
        ref = mm["model"](input_ids=torch.from_numpy(ids), pixel_values=torch.from_numpy(px),
                          token_type_ids=torch.from_numpy(tt)).logits.float().numpy()
    runner = kt.Runner.create(mm["cfg_t"], attn_impl=attn_impl, device="cpu")
    emb = kt.multimodal_embeds(mm["params_t"], mm["cfg_t"], torch.from_numpy(ids),
                               mm["tower"](px), IMAGE_TOKEN_ID)
    got, _, _ = runner.forward(mm["params_t"], None, kt.init_cache(mm["cfg_t"], 1, 20,
                                                                   dtype=torch.float32,
                                                                   device="cpu"),
                               inputs_embeds=emb, token_types=torch.from_numpy(tt),
                               image_span=SPAN)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


def _kept_rows(cache, n_layers):
    """Each layer's kept key rows, sorted by their first channel."""
    out = []
    for l in range(n_layers):
        n = int(cache.length[l])
        k = np.asarray(cache.keys[l], np.float64)[:, :, :n]
        out.append(np.take_along_axis(k, np.argsort(k[..., 0], -1)[..., None], -2))
    return out


@pytest.mark.parametrize("chunk", [None, 8])
def test_prefill_kept_sets_match_jax(mm, chunk):
    """A KnormPress(0.5) prefill of three images with token types, one-shot
    and in chunks of 8 (whose starts must move back around two of the
    images): the same chunk starts, logits and kept key rows as the JAX
    runner, the global layer compressed and the sliding one whole."""
    T = 28
    ids = _image_ids(3, T, (2, 10, 22))
    px = np.random.default_rng(3).standard_normal((3, 3, 28, 28)).astype(np.float32)
    tt = (ids == IMAGE_TOKEN_ID).astype(np.int32)
    emb_t = kt.multimodal_embeds(mm["params_t"], mm["cfg_t"], torch.from_numpy(ids),
                                 mm["tower"](px), IMAGE_TOKEN_ID)
    emb_j = jembeds(mm["params_j"], mm["cfg_j"], ids, np.asarray(mm["embed_j"](px)),
                    IMAGE_TOKEN_ID)
    runner_j = kj.Runner.create(mm["cfg_j"], attn_impl="xla")
    common = dict(compute_logits=True, image_span=SPAN)
    widths = {"jax": [], "torch": []}
    if chunk is None:
        lj, cj, _ = runner_j.prefill(mm["params_j"], None, press=kj.KnormPress(0.5),
                                     dtype=jnp.float32, inputs_embeds=emb_j,
                                     token_types=jnp.asarray(tt), **common)
    else:
        lean = jllama._chunk_forward_lean

        def spy(params, chunk_ids, cache, **kw):
            widths["jax"].append(kw["chunk_embeds"].shape[1])
            return lean(params, chunk_ids, cache, **kw)

        jllama._chunk_forward_lean = spy
        try:
            lj, cj, _ = runner_j.prefill_chunked(
                mm["params_j"], jnp.asarray(ids, jnp.int32), press=kj.KnormPress(0.5),
                chunk_size=chunk, dtype=jnp.float32, inputs_embeds=emb_j,
                token_types=jnp.asarray(tt), **common)
        finally:
            jllama._chunk_forward_lean = lean
    for attn_impl in ("xla", "flash"):
        runner = kt.Runner.create(mm["cfg_t"], attn_impl=attn_impl, device="cpu")
        kw = dict(press=kt.KnormPress(0.5), dtype=torch.float32, inputs_embeds=emb_t,
                  token_types=torch.from_numpy(tt), **common)
        if chunk is None:
            lt, ct, _ = runner.prefill(mm["params_t"], None, **kw)
        else:
            lean_t = runner._chunk_forward_lean
            widths["torch"] = []
            object.__setattr__(runner, "_chunk_forward_lean", lambda p, c, cache, **k: (
                widths["torch"].append(k["chunk_embeds"].shape[1]) or lean_t(p, c, cache, **k)))
            lt, ct, _ = runner.prefill_chunked(mm["params_t"], torch.from_numpy(ids),
                                               chunk_size=chunk, **kw)
            # chunks of 8 after a remainder of 4, two starts moved back to an
            # image's first token
            assert widths["torch"] == widths["jax"] == [2, 8, 10, 8]
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)
        assert ct.length.tolist() == np.asarray(cj.length).tolist() == [T, T // 2]
        for a, b in zip(_kept_rows(ct, 2), _kept_rows(cj, 2)):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def pipes(mm):
    tok = ImageTokenizer(vocab_size=498)
    jpipe = JaxPipeline(kj.Runner.create(mm["cfg_j"], attn_impl="xla"), mm["params_j"], tok,
                        vision_params=mm["embed_j"].vparams, vision_cfg=mm["embed_j"].vcfg,
                        image_token_id=IMAGE_TOKEN_ID)
    tpipes = {impl: kt.KVPressPipeline(
        kt.Runner.create(mm["cfg_t"], attn_impl=impl, device="cpu"), mm["params_t"], tok,
        vision_params=mm["tower"], vision_cfg=mm["tower"].vcfg, image_token_id=IMAGE_TOKEN_ID)
        for impl in ("xla", "flash")}
    words = " ".join(f"w{i}" for i in range(12))
    context = (f"{words} <image> <image> <image> <image> mid0 mid1 mid2 <image> <image> "
               f"<image> <image> tail0 tail1")
    px = np.random.default_rng(4).standard_normal((2, 3, 28, 28)).astype(np.float32)
    return dict(jax=jpipe, torch=tpipes, context=context, px=px)


@pytest.mark.parametrize("chunk", [None, 8])
def test_multimodal_pipeline_same_answers_as_jax(pipes, chunk):
    """pipe(context, pixel_values=...) with KnormPress(0.5), one-shot and
    with context_chunk=8: the same greedy answers as the JAX pipeline on
    both attention routes."""
    kw = dict(questions=["q0 q1", "what w3 ?"], pixel_values=pipes["px"], max_new_tokens=6,
              context_chunk=chunk)
    want = pipes["jax"](pipes["context"], press=kj.KnormPress(0.5), **kw)["answers"]
    for impl, pipe in pipes["torch"].items():
        assert pipe(pipes["context"], press=kt.KnormPress(0.5), **kw)["answers"] == want, impl


def test_pixel_values_need_a_multimodal_pipeline(mm):
    pipe = kt.KVPressPipeline(kt.Runner.create(mm["cfg_t"], device="cpu"), mm["params_t"],
                              ImageTokenizer(vocab_size=498))
    with pytest.raises(ValueError, match="multimodal"):
        pipe("w0 <image>", pixel_values=np.zeros((1, 3, 28, 28), np.float32))


class _Chunked(kt.ObservedAttentionPress):
    chunked_threshold = 0


class _JChunked(kj.ObservedAttentionPress):
    chunked_threshold = 0


@pytest.mark.parametrize("above_threshold", [False, True])
def test_observed_attention_on_a_multimodal_flash_runner(above_threshold):
    """ObservedAttentionPress with images on a flash runner routes as in JAX.
    Below its threshold it wants probabilities, so every layer takes the
    dense path, which must apply the or-mask (a flash runner that dropped
    token_types there was a bug of the JAX package): logits and lengths as
    the dense runner's and the JAX runner's, and unlike a prefill without
    token types. Above it the column sums are taken without the or-mask on
    both sides (ROADMAP, Standing records): the kept rows still equal
    JAX's."""
    cfg_j, cfg_t = kj.tiny_config(), kt.tiny_config()
    params_j = kj.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    params_t = kt.params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), cfg_t,
                                  device="cpu", dtype=torch.float32)
    T = 24
    ids = np.random.default_rng(4).permutation(np.arange(3, cfg_t.vocab_size))[:T][None]
    tt = np.zeros((1, T), np.int64)
    tt[0, 3:7] = tt[0, 12:16] = 1
    press_t = _Chunked(0.5) if above_threshold else kt.ObservedAttentionPress(0.5)
    press_j = _JChunked(0.5) if above_threshold else kj.ObservedAttentionPress(0.5)
    kw = dict(dtype=torch.float32, compute_logits=True, press=press_t)
    flash = kt.Runner.create(cfg_t, attn_impl="flash", device="cpu")
    dense = kt.Runner.create(cfg_t, attn_impl="xla", device="cpu")
    lf, cf, _ = flash.prefill(params_t, torch.from_numpy(ids), token_types=torch.from_numpy(tt),
                              image_span=4, **kw)
    lx, cx, _ = dense.prefill(params_t, torch.from_numpy(ids), token_types=torch.from_numpy(tt),
                              **kw)
    lplain, _, _ = flash.prefill(params_t, torch.from_numpy(ids), **kw)
    lj, cj, _ = kj.Runner.create(cfg_j, attn_impl="xla").prefill(
        params_j, jnp.asarray(ids, jnp.int32), press=press_j, dtype=jnp.float32,
        compute_logits=True, token_types=jnp.asarray(tt))
    for got in (lf, lx):
        np.testing.assert_allclose(got.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)
    assert cf.length.tolist() == cx.length.tolist() == np.asarray(cj.length).tolist()
    assert (lf - lplain).abs().max() > 1e-5
    for a, b in zip(_kept_rows(cf, 2), _kept_rows(cj, 2)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


def test_token_types_need_an_empty_cache_and_no_decode_kernel(mm):
    """Same-image attention is for a prefill from empty, and the decode
    kernels take no image groups (as the JAX runner asserts)."""
    cfg = mm["cfg_t"]
    runner = kt.Runner.create(cfg, device="cpu")
    tt = torch.ones((1, 4), dtype=torch.int64)
    ids = torch.full((1, 4), 5)
    _, cache, _ = runner.prefill(mm["params_t"], ids, max_size=12)
    with pytest.raises(ValueError, match="empty cache"):
        runner.forward(mm["params_t"], ids, cache, token_types=tt)
    decode = kt.Runner.create(cfg, attn_impl="flash", decode_kernel=True, device="cpu")
    with pytest.raises(ValueError, match="decode kernels"):
        decode.prefill(mm["params_t"], ids, token_types=tt, image_span=SPAN)
    with pytest.raises(ValueError, match="image_span"):
        kt.Runner.create(cfg, attn_impl="flash", device="cpu").prefill(
            mm["params_t"], ids, token_types=tt)
    assert dataclasses.replace(runner).inv_freq_local is not None
