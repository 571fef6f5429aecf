"""kvpress_tpu_torch's chunked prefill (Runner.prefill_chunked, the pipeline's
context_chunk) against kvpress_tpu's on the same weights and inputs (CPU,
float32, tiny config): logits within 1e-4, equal compressed lengths, equal
kept sets and cache contents, for the window and content scorers, AdaKV,
bf16 / int8 / int4 KV, and both quantized attention routes (fused_kv).

The torch runner takes its kernel routes (attn_impl="flash"): on the CPU
each kernel wrapper runs its plain version. The JAX runner takes its dense
routes (attn_impl="xla"), which compute the same attention."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.models import llama as tllama
from kvpress_tpu_torch.presses.decoding import DecodingPress
from toy_tokenizer import ToyTokenizer

torch.set_num_threads(2)

S, CHUNK = 64, 16


@pytest.fixture(scope="module")
def models():
    cfg_j, cfg_t = kj.tiny_config(), kt.tiny_config()
    params_j = kj.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    params_t = kt.params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), cfg_t,
                                  device="cpu", dtype=torch.float32)
    return dict(cfg=cfg_t, params_j=params_j, params_t=params_t,
                jax=kj.Runner.create(cfg_j, attn_impl="xla"),
                torch=kt.Runner.create(cfg_t, attn_impl="flash", decode_kernel=True,
                                       device="cpu"))


def _ids(vocab, n, seed):
    # distinct token ids: tied Knorm scores would be broken apart differently
    return np.random.default_rng(seed).permutation(np.arange(3, vocab))[:n][None].astype(np.int32)


def _presses(name):
    """(JAX press, torch press) of one name."""
    def make(m):
        return {
            "knorm": lambda: m.KnormPress(0.5),
            "streaming": lambda: m.StreamingLLMPress(0.5),
            "tova": lambda: m.TOVAPress(0.5),
            "snapkv": lambda: m.SnapKVPress(0.5, window_size=8, kernel_size=3),
            "pyramidkv": lambda: m.PyramidKVPress(0.5, window_size=8, kernel_size=3),
            "adakv_compact": lambda: m.AdaKVPress(m.KnormPress(0.5), compact=True),
            "adakv_snapkv_compact": lambda: m.AdaKVPress(
                m.SnapKVPress(0.5, window_size=8, kernel_size=3), compact=True),
        }[name]()
    from kvpress_tpu import presses as jp
    return make(jp), make(kt)


def _sorted_rows(a, n, col=0):
    """The first n slots' rows of each (batch, head) of ``a`` (B, H, S, C) as
    a set: float64, sorted by column ``col``."""
    a = np.asarray(a, np.float64)[..., :n, :]
    order = np.argsort(a[..., col], axis=-1)
    return np.take_along_axis(a, order[..., None], axis=-2)


def _check_caches(tc, jc, L):
    """Equal lengths, offsets and masks; per layer the same kept rows (float
    K/V within 1e-4; quantized payloads equal, scales within 1e-5)."""
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    assert int(tc.offset) == int(jc.offset)
    for l in range(L):
        n = int(jc.length[l])
        if jc.key_scales is None:
            for t, j in ((tc.keys, jc.keys), (tc.values, jc.values)):
                np.testing.assert_allclose(_sorted_rows(t[l].numpy(), n),
                                           _sorted_rows(np.asarray(j[l]), n), atol=1e-4)
            continue
        for tp, ts, jp, js in ((tc.keys, tc.key_scales, jc.keys, jc.key_scales),
                               (tc.values, tc.value_scales, jc.values, jc.value_scales)):
            a = _sorted_rows(np.concatenate([tp[l].numpy(), ts[l].numpy()], -1), n, col=-1)
            b = _sorted_rows(np.concatenate([np.asarray(jp[l], np.float64),
                                             np.asarray(js[l], np.float64)], -1), n, col=-1)
            np.testing.assert_array_equal(a[..., :-1], b[..., :-1])
            np.testing.assert_allclose(a[..., -1], b[..., -1], rtol=1e-5)
    if jc.mask is not None:
        np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))


def _run_both(models, press_name, ids, quantized=False, bits=8, fused_kv=None, chunk=CHUNK):
    jpress, tpress = _presses(press_name)
    kw = dict(chunk_size=chunk, compute_logits=True, quantized=quantized, kv_bits=bits,
              fused_kv=fused_kv)
    jl, jc, _ = models["jax"].prefill_chunked(models["params_j"], jnp.asarray(ids), press=jpress,
                                              dtype=jnp.float32, **kw)
    tl, tc, _ = models["torch"].prefill_chunked(models["params_t"], torch.from_numpy(ids).long(),
                                                press=tpress, dtype=torch.float32, **kw)
    return tl, tc, jl, jc


CASES = [
    ("knorm", False, 8, None), ("streaming", False, 8, None), ("tova", False, 8, None),
    ("snapkv", False, 8, None), ("pyramidkv", False, 8, None),
    ("knorm", True, 8, None), ("knorm", True, 4, False), ("knorm", True, 4, True),
    ("snapkv", True, 4, None), ("adakv_compact", False, 8, None),
    ("adakv_snapkv_compact", True, 8, None), ("adakv_compact", True, 4, True),
]


@pytest.mark.parametrize("press,quantized,bits,fused", CASES,
                         ids=[f"{p}-{f'int{b}' if q else 'bf16'}kv-fused{f}"
                              for p, q, b, f in CASES])
def test_prefill_chunked_matches_jax(models, press, quantized, bits, fused):
    ids = _ids(models["cfg"].vocab_size, S, 1)
    tl, tc, jl, jc = _run_both(models, press, ids, quantized, bits, fused)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _check_caches(tc, jc, models["cfg"].num_layers)


def test_ragged_length_runs_the_remainder_first(models):
    ids = _ids(models["cfg"].vocab_size, 50, 2)
    tl, tc, jl, jc = _run_both(models, "snapkv", ids)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _check_caches(tc, jc, models["cfg"].num_layers)
    assert int(tc.offset) == 50


@pytest.mark.parametrize("fused,kernel", [(True, "flash_attention_quant"),
                                          (False, "flash_attention")])
def test_fused_kv_routes_int4_chunks(models, monkeypatch, fused, kernel):
    """fused_kv=True sends each int4 chunk to flash_attention_quant at 4 bits;
    False dequantizes the layer and sends it to flash_attention."""
    calls = []
    original = getattr(tllama, kernel)

    def recording(*args, **kw):
        calls.append(kw.get("bits"))
        return original(*args, **kw)

    monkeypatch.setattr(tllama, kernel, recording)
    ids = torch.from_numpy(_ids(models["cfg"].vocab_size, S, 3)).long()
    models["torch"].prefill_chunked(models["params_t"], ids, press=kt.KnormPress(0.5),
                                    chunk_size=CHUNK, quantized=True, kv_bits=4,
                                    fused_kv=fused)
    layers = models["cfg"].num_layers
    assert calls == [4 if fused else None] * (layers * S // CHUNK)


def test_chunked_matches_one_shot_prefill(models):
    """A content scorer keeps what the one-shot prefill keeps."""
    ids = torch.from_numpy(_ids(models["cfg"].vocab_size, S, 4)).long()
    r, p = models["torch"], models["params_t"]
    press = kt.KnormPress(0.5)
    _, one, _ = r.prefill(p, ids, press=press, dtype=torch.float32)
    _, chunked, _ = r.prefill_chunked(p, ids, press=press, chunk_size=CHUNK)
    assert one.length.tolist() == chunked.length.tolist()
    for l in range(models["cfg"].num_layers):
        n = int(one.length[l])
        np.testing.assert_allclose(_sorted_rows(chunked.keys[l].numpy(), n),
                                   _sorted_rows(one.keys[l].numpy(), n), atol=1e-5)


class _NotAScorer(kt.BasePress):
    pass


UNSUPPORTED = {
    "not a scorer": (dict(press=_NotAScorer()), TypeError),
    # a decode-time press that also compresses the prefill: refused, as by
    # JAX's assertion (a plain decode-time press leaves the prefill whole)
    "decode-time press": (dict(press=kt.PrefillDecodingPress(
        kt.KnormPress(0.5), DecodingPress(base_press=kt.KnormPress(0.5)))), TypeError),
    "no chunk size": (dict(chunk_size=0), ValueError),
    "no room for the context": (dict(max_size=S - 1), ValueError),
}


@pytest.mark.parametrize("case", list(UNSUPPORTED))
def test_unsupported_presses_and_options_raise(models, case):
    kw, error = UNSUPPORTED[case]
    ids = torch.zeros((1, S), dtype=torch.long)
    with pytest.raises(error):
        models["torch"].prefill_chunked(models["params_t"], ids, **{"chunk_size": CHUNK, **kw})


# The lean forward's branches of later slices name their ROADMAP item.
# Image groups came with the multimodal slice: they are refused only without
# the keys' groups (tests/test_torch_multimodal.py holds the branch itself).
LEAN_BRANCHES = {"kvzip_spec": (NotImplementedError, "item"),
                 "kvcompose_spec": (NotImplementedError, "item"),
                 "collect_fn": (TypeError, "callable"),
                 "img_groups": (ValueError, "k_groups")}


@pytest.mark.parametrize("spec", list(LEAN_BRANCHES))
def test_lean_forward_branches_of_later_slices_raise(models, spec):
    cache = kt.init_cache(models["cfg"], 1, S, dtype=torch.float32, device="cpu")
    error, match = LEAN_BRANCHES[spec]
    with pytest.raises(error, match=match):
        models["torch"]._chunk_forward_lean(models["params_t"],
                                            torch.zeros((1, CHUNK), dtype=torch.long), cache,
                                            **{spec: object()})


def test_dynamic_budgets_match_jax(models):
    cfg = models["cfg"]
    from kvpress_tpu import PyramidKVPress as JPyramid
    from kvpress_tpu.presses.base import LayerCtx as JCtx
    for ratio in (0.25, 0.5, 0.7):
        jp, tp = JPyramid(ratio, window_size=8), kt.PyramidKVPress(ratio, window_size=8)
        for length in (9, 40, 64, 1000, 131072):
            for l in range(cfg.num_layers):
                jctx = JCtx(layer_idx=jnp.asarray(l, jnp.int32), hidden=None, queries=None,
                            queries_prerope=None, keys_prerope=None, positions=None,
                            attn_probs=None, layer_params=None, inv_freq=None,
                            cfg=kj.tiny_config())
                tctx = kt.LayerCtx(layer_idx=l, hidden=None, queries=None,
                                   queries_prerope=None, keys_prerope=None, positions=None,
                                   attn_probs=None, layer_params=None, inv_freq=None, cfg=cfg)
                want = jp.dynamic_budget(jctx, jnp.asarray(length, jnp.int32))
                assert tp.dynamic_budget(tctx, length) == int(want)
                want = kj.KnormPress(ratio).dynamic_budget(jctx, jnp.asarray(length, jnp.int32))
                assert kt.KnormPress(ratio).dynamic_budget(tctx, length) == int(want)


def test_observed_dynamic_score_matches_jax(models):
    """ObservedAttention against a valid length, its queries one a slot."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 4, 24, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, 24, 16)).astype(np.float32)
    from kvpress_tpu.presses.base import LayerCtx as JCtx
    jctx = JCtx(layer_idx=0, hidden=None, queries=jnp.asarray(q), queries_prerope=None,
                keys_prerope=None, positions=None, attn_probs=None, layer_params=None,
                inv_freq=None, cfg=kj.tiny_config())
    tctx = kt.LayerCtx(layer_idx=0, hidden=None, queries=torch.from_numpy(q),
                       queries_prerope=None, keys_prerope=None, positions=None,
                       attn_probs=None, layer_params=None, inv_freq=None, cfg=models["cfg"])
    want = kj.ObservedAttentionPress(0.5).dynamic_score(jctx, jnp.asarray(k), None,
                                                        jnp.asarray(19, jnp.int32))
    got = kt.ObservedAttentionPress(0.5).dynamic_score(tctx, torch.from_numpy(k), None, 19)
    np.testing.assert_allclose(got[..., :19].numpy(), np.asarray(want)[..., :19], atol=1e-6)
    with pytest.raises(ValueError):
        kt.ObservedAttentionPress(0.5).dynamic_score(tctx, torch.from_numpy(k[:, :, :20]),
                                                     None, 19)


@pytest.fixture(scope="module")
def pipes(models):
    tok = ToyTokenizer(models["cfg"].vocab_size)
    headwise = kt.Runner.create(models["cfg"], attn_impl="flash", decode_kernel=False,
                                headwise_kernel=True, device="cpu")
    return dict(
        jax=JaxPipeline(models["jax"], models["params_j"], tok),
        torch=kt.KVPressPipeline(models["torch"], models["params_t"], tok),
        headwise=kt.KVPressPipeline(headwise, models["params_t"], tok),
        context=" ".join(f"w{i}" for i in range(45)))


@pytest.mark.parametrize("press,pipe,kv", [
    ("snapkv", "torch", {}),
    ("knorm", "torch", dict(quantized=True, kv_bits=4)),
    ("adakv_compact", "headwise", {}),
], ids=["snapkv-bf16kv", "knorm-int4kv", "adakv_compact-headwise"])
def test_pipeline_context_chunk_same_answers_as_jax(pipes, press, pipe, kv):
    jpress, tpress = _presses(press)
    kw = dict(questions=["what ?", "w3 w9 w1"], max_new_tokens=6, context_chunk=CHUNK, **kv)
    got = pipes[pipe](pipes["context"], press=tpress, **kw)["answers"]
    want = pipes["jax"](pipes["context"], press=jpress, **kw)["answers"]
    assert got == want


def test_context_chunk_refuses_context_bucket(pipes):
    with pytest.raises(ValueError, match="context_bucket"):
        pipes["torch"](pipes["context"], context_chunk=CHUNK, context_bucket=CHUNK)
