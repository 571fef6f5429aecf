"""kvpress_tpu_torch's runner against the JAX runner (attn_impl="xla") on the
same weights, carried across with params_from_jax: logits, cache lengths and
the KV entries KnormPress(0.5) keeps (CPU, float32, tiny config)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.models import llama as jllama
from kvpress_tpu.models.llama import quantize_params_int8 as jquant8
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.models import llama as tllama
from kvpress_tpu_torch.models.llama import quantize_params_int8 as tquant8

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CTX = 40


@pytest.fixture(scope="module")
def models():
    cfg_j, cfg_t = kj.tiny_config(), kt.tiny_config()
    params_j = kj.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, params_j)
    params_t = kt.params_from_jax(np_params, cfg_t, device="cpu", dtype=torch.float32)
    return cfg_j, cfg_t, params_j, params_t


def _ids(vocab, n, seed):
    # unique token ids: duplicate tokens give tied Knorm scores (the key norm
    # of a token is position-free in layer 0) that XLA and torch break apart
    # differently
    return np.random.default_rng(seed).permutation(np.arange(3, vocab))[:n][None].astype(np.int32)


def _kept_rows(keys, n):
    """Kept key rows of each (layer, batch, head), as a set: rows sorted by
    their first channel (score order may swap between float-equal norms)."""
    k = np.asarray(keys, np.float64)[:, :, :, :n]
    order = np.argsort(k[..., 0], axis=-1)
    return np.take_along_axis(k, order[..., None], axis=3)


def _run_jax(runner, params, ids, q_ids, quantized, bits, max_size):
    logits, cache, _ = runner.prefill(params, jnp.asarray(ids), press=kj.KnormPress(0.5),
                                      max_size=max_size, dtype=jnp.float32,
                                      compute_logits=True, quantized=quantized, kv_bits=bits)
    out = [np.asarray(logits)]
    pre = cache
    logits, cache, _ = runner.forward(params, jnp.asarray(q_ids), cache, logits_last_only=True)
    out.append(np.asarray(logits))
    for _ in range(3):
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        logits, cache, _ = runner.forward(params, tok, cache, logits_last_only=True)
        out.append(np.asarray(logits))
    return out, pre, cache


def _run_torch(runner, params, ids, q_ids, quantized, bits, max_size):
    logits, cache, _ = runner.prefill(params, torch.from_numpy(ids).long(),
                                      press=kt.KnormPress(0.5), max_size=max_size,
                                      dtype=torch.float32, compute_logits=True,
                                      quantized=quantized, kv_bits=bits)
    out = [logits.numpy()]
    pre = cache
    logits, cache, _ = runner.forward(params, torch.from_numpy(q_ids).long(), cache,
                                      logits_last_only=True)
    out.append(logits.numpy())
    for _ in range(3):
        tok = torch.argmax(logits[:, -1:], dim=-1)
        logits, cache, _ = runner.forward(params, tok, cache, logits_last_only=True)
        out.append(logits.numpy())
    return out, pre, cache


VARIANTS = [(False, 8), (True, 8), (True, 4)]


@pytest.mark.parametrize("quantized,bits", VARIANTS, ids=["bf16kv", "int8kv", "int4kv"])
def test_prefill_forward_logits_and_kept_set_match_jax(models, quantized, bits):
    cfg_j, cfg_t, params_j, params_t = models
    ids = _ids(cfg_j.vocab_size, CTX, 0)
    q_ids = _ids(cfg_j.vocab_size, 6, 1)
    jr = kj.Runner.create(cfg_j, attn_impl="xla")
    tr = kt.Runner.create(cfg_t, attn_impl="xla", device="cpu")
    jl, jpre, jc = _run_jax(jr, params_j, ids, q_ids, quantized, bits, 64)
    tl, tpre, tc = _run_torch(tr, params_t, ids, q_ids, quantized, bits, 64)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, atol=1e-4)
    np.testing.assert_array_equal(tpre.length.numpy(), np.asarray(jpre.length))
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    assert int(tc.offset) == int(jc.offset) == CTX + 6 + 3
    n = int(jpre.length[0])
    assert n == CTX // 2
    if quantized:
        # kept entries: scales per token identify the kept set
        np.testing.assert_allclose(_kept_rows(tpre.key_scales.numpy(), n),
                                   _kept_rows(jpre.key_scales, n), rtol=1e-5)
    else:
        np.testing.assert_allclose(_kept_rows(tpre.keys.numpy(), n),
                                   _kept_rows(jpre.keys, n), atol=1e-5)


def test_int8_weights_match_jax(models):
    cfg_j, cfg_t, params_j, params_t = models
    ids = _ids(cfg_j.vocab_size, CTX, 2)
    q_ids = _ids(cfg_j.vocab_size, 5, 3)
    pj8 = jquant8(params_j, include_embeddings=True)
    pt8 = tquant8(params_t, include_embeddings=True)
    for name, p in pt8.layers[0].named_parameters():
        np.testing.assert_array_equal(p.numpy(), np.asarray(pj8["layers"][name][0]))
    np.testing.assert_array_equal(pt8.embed.numpy(), np.asarray(pj8["embed"]))
    jr = kj.Runner.create(cfg_j, attn_impl="xla")
    tr = kt.Runner.create(cfg_t, attn_impl="xla", device="cpu")
    jl, _, _ = _run_jax(jr, pj8, ids, q_ids, True, 4, 64)
    tl, _, _ = _run_torch(tr, pt8, ids, q_ids, True, 4, 64)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("after_int8", [False, True], ids=["from_float", "after_int8"])
def test_int4_weights_match_jax(models, after_int8):
    """quantize_params_int4 gives JAX's payloads and scales bit for bit (on
    float weights, and after quantize_params_int8 with embeddings); _lin,
    dequant_weight and the runner's logits agree with JAX's."""
    cfg_j, cfg_t, params_j, params_t = models
    if after_int8:
        params_j = jquant8(params_j, include_embeddings=True)
        params_t = tquant8(params_t, include_embeddings=True)
    pj4 = jllama.quantize_params_int4(params_j)
    pt4 = tllama.quantize_params_int4(params_t)
    for l, layer in enumerate(pt4.layers):
        for name, p in layer.named_parameters():
            np.testing.assert_array_equal(p.numpy(), np.asarray(pj4["layers"][name][l]))
        assert layer.wq.dtype == torch.uint8 and tuple(layer.wq_scale.shape) == (2, 64)
    np.testing.assert_array_equal(pt4.embed.numpy(), np.asarray(pj4["embed"]))
    h = np.random.default_rng(8).standard_normal((2, 5, cfg_t.hidden_size)).astype(np.float32)
    jlayer = jax.tree_util.tree_map(lambda a: a[1], pj4["layers"])
    for name in ("wq", "wd"):
        x = h if name == "wq" else np.tile(h, (1, 1, 2))
        np.testing.assert_allclose(tllama._lin(torch.from_numpy(x), pt4.layers[1], name).numpy(),
                                   np.asarray(jllama._lin(jnp.asarray(x), jlayer, name)),
                                   atol=1e-5)
        np.testing.assert_allclose(tllama.dequant_weight(pt4.layers[1], name).numpy(),
                                   np.asarray(jllama.dequant_weight(jlayer, name)), atol=1e-7)
    ids = _ids(cfg_j.vocab_size, CTX, 9)
    q_ids = _ids(cfg_j.vocab_size, 5, 10)
    jr = kj.Runner.create(cfg_j, attn_impl="xla")
    tr = kt.Runner.create(cfg_t, attn_impl="xla", device="cpu")
    jl, _, _ = _run_jax(jr, pj4, ids, q_ids, True, 4, 64)
    tl, _, _ = _run_torch(tr, pt4, ids, q_ids, True, 4, 64)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_params_from_jax_carries_int4_trees(models):
    cfg_j, cfg_t, params_j, _ = models
    np4 = jax.tree_util.tree_map(np.asarray, jllama.quantize_params_int4(params_j))
    pt = kt.params_from_jax(np4, cfg_t, device="cpu", dtype=torch.float32)
    assert pt.layers[0].wg.dtype == torch.uint8
    assert pt.layers[0].wg_scale.dtype == torch.float32
    np.testing.assert_array_equal(pt.layers[0].wg_scale.numpy(), np4["layers"]["wg_scale"][0])
    np.testing.assert_array_equal(pt.layers[1].wo.numpy(), np4["layers"]["wo"][1])


def test_params_from_jax_carries_int8_trees(models):
    cfg_j, cfg_t, params_j, _ = models
    np8 = jax.tree_util.tree_map(np.asarray, jquant8(params_j))
    pt = kt.params_from_jax(np8, cfg_t, device="cpu", dtype=torch.float32)
    assert pt.layers[1].wq.dtype == torch.int8
    assert tuple(pt.layers[1].wq_scale.shape) == np8["layers"]["wq_scale"].shape[1:]
    np.testing.assert_array_equal(pt.layers[1].wd.numpy(), np8["layers"]["wd"][1])
    assert pt.ln_f.dtype == torch.float32


@pytest.mark.parametrize("quantized,bits", VARIANTS, ids=["bf16kv", "int8kv", "int4kv"])
def test_kernel_routing_on_cpu_matches_jax_dense(models, quantized, bits):
    """attn_impl="flash" with the decode kernel routes through the kernel
    wrappers (their plain versions on the CPU), as the runner does on the
    card: multi-token calls above the decode gate (T > 128) go to the flash
    wrappers, the rest to decode_attention. Same logits as the JAX dense
    path up to the routing's own storage differences."""
    cfg_j, cfg_t, params_j, params_t = models
    ids = _ids(cfg_j.vocab_size, 300, 4)
    q_ids = _ids(cfg_j.vocab_size, 140, 5)
    jr = kj.Runner.create(cfg_j, attn_impl="xla")
    tr = kt.Runner.create(cfg_t, attn_impl="flash", decode_kernel=True, device="cpu")
    jl, _, jc = _run_jax(jr, params_j, ids, q_ids, quantized, bits, 300)
    tl, _, tc = _run_torch(tr, params_t, ids, q_ids, quantized, bits, 300)
    # int4: the flash route attends a >128-token block at full precision
    # (dequantized buffer + fresh K/V), the dense route reads it back from
    # the int4 payload, as the JAX runner's two paths do.
    atol = 2e-2 if (quantized and bits == 4) else 1e-4
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, atol=atol)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def test_rollback_restores_the_cache(models):
    _, cfg_t, _, params_t = models
    tr = kt.Runner.create(cfg_t, device="cpu")
    ids = torch.from_numpy(_ids(cfg_t.vocab_size, CTX, 6)).long()
    _, cache, _ = tr.prefill(params_t, ids, press=kt.KnormPress(0.5), max_size=CTX)
    cache = kt.resize(cache, 30)
    q = torch.from_numpy(_ids(cfg_t.vocab_size, 4, 7)).long()
    first, after, _ = tr.forward(params_t, q, cache, logits_last_only=True)
    assert after.length.tolist() == [24, 24] and cache.length.tolist() == [20, 20]
    tr.forward(params_t, q[:, :2], after)          # write past the question
    again, _, _ = tr.forward(params_t, q, dataclasses.replace(cache), logits_last_only=True)
    torch.testing.assert_close(again, first)


def test_entry_points_refuse_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    cfg = kt.tiny_config()
    with pytest.raises(RuntimeError, match="cuda"):
        kt.Runner.create(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        kt.init_params(cfg, torch.Generator())
    assert kt.Runner.create(cfg, device="cpu").decode_kernel is False
