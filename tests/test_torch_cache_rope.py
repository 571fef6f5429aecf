"""kvpress_tpu_torch config / rope / cache / dense attention against the JAX
package on the same numpy inputs (CPU, float32)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvpress_tpu import cache as jcache
from kvpress_tpu import rope as jrope
from kvpress_tpu.config import tiny_config as jtiny
from kvpress_tpu.ops import attention as jattn
from kvpress_tpu_torch import cache as tcache
from kvpress_tpu_torch import rope as trope
from kvpress_tpu_torch.config import ModelConfig, tiny_config
from kvpress_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROPE_SCALINGS = [
    None,
    {"rope_type": "linear", "factor": 4.0},
    {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 4096},
]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("scaling", ROPE_SCALINGS,
                         ids=["default", "linear", "llama3", "yarn"])
def test_inv_freq_and_cos_sin_match_jax(scaling):
    kw = dict(head_dim=64, rope_theta=500000.0, rope_scaling=scaling)
    jinv, jscale = jrope.compute_inv_freq(jtiny(**kw))
    tinv, tscale = trope.compute_inv_freq(tiny_config(**kw))
    np.testing.assert_array_equal(tinv, jinv)
    assert tscale == jscale
    pos = np.random.default_rng(0).integers(0, 40000, (2, 33)).astype(np.int32)
    jc, js = jrope.rope_cos_sin(jnp.asarray(jinv), jnp.asarray(pos), jscale)
    tc, ts = trope.rope_cos_sin(_t(tinv), _t(pos), tscale)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 17, 16)).astype(np.float32)
    inv, sc = jrope.compute_inv_freq(jtiny())
    pos = np.arange(17, dtype=np.int32)[None]
    jc, js = jrope.rope_cos_sin(jnp.asarray(inv), jnp.asarray(pos), sc)
    tc, ts = trope.rope_cos_sin(_t(inv), _t(pos), sc)
    want = jrope.apply_rope(jnp.asarray(x), jc[:, None], js[:, None])
    got = trope.apply_rope(_t(x), tc[:, None], ts[:, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_config_is_a_copy_of_the_jax_config():
    jf = {f.name for f in dataclasses.fields(jtiny())}
    tf = {f.name for f in dataclasses.fields(ModelConfig)}
    assert jf == tf
    assert dataclasses.asdict(jtiny()) == dataclasses.asdict(tiny_config())


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("scale", [1.0, 1e-3, 50.0])
def test_quantize_kv_bit_equal(bits, scale):
    x = (np.random.default_rng(bits).standard_normal((2, 3, 37, 64)) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0                          # all-zero row: scale floor 1e-8
    jp, js = jcache.quantize_kv(jnp.asarray(x), bits)
    tp, ts = tcache.quantize_kv(_t(x), bits)
    assert str(tp.dtype).split(".")[-1] == str(np.asarray(jp).dtype)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jcache.dequantize_kv(jp, js, bits, jnp.float32)
    td = tcache.dequantize_kv(tp, ts, bits, torch.float32)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_int4_layout_low_nibble_c_high_nibble_c_plus_half():
    x = np.random.default_rng(3).standard_normal((1, 1, 4, 16)).astype(np.float32)
    p, s = tcache.quantize_kv(_t(x), 4)
    q = np.clip(np.round(x / s.numpy()), -8, 7).astype(np.int32) + 8
    np.testing.assert_array_equal(p.numpy() & 0xF, q[..., :8])
    np.testing.assert_array_equal(p.numpy() >> 4, q[..., 8:])


@pytest.mark.parametrize("quantized,bits", [(False, 8), (True, 8), (True, 4)])
def test_init_cache_resize_valid_mask_match_jax(quantized, bits):
    cfg_j, cfg_t = jtiny(), tiny_config()
    jc = jcache.init_cache(cfg_j, 2, 24, dtype=jnp.float32, quantized=quantized, bits=bits)
    tc = tcache.init_cache(cfg_t, 2, 24, dtype=torch.float32, quantized=quantized, bits=bits,
                           device="cpu")
    for name in ("keys", "values", "key_scales", "value_scales"):
        a, b = getattr(jc, name), getattr(tc, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    lengths = np.array([10, 7], np.int32)
    mask = np.random.default_rng(4).random((2, 2, 2, 24)) > 0.3
    jc = dataclasses.replace(jc, length=jnp.asarray(lengths), mask=jnp.asarray(mask))
    tc = dataclasses.replace(tc, length=_t(lengths), mask=_t(mask))
    np.testing.assert_array_equal(tcache.valid_mask(tc).numpy(),
                                  np.asarray(jcache.valid_mask(jc)))
    for size in (16, 24, 40):
        a, b = jcache.resize(jc, size), tcache.resize(tc, size)
        assert b.max_size == a.max_size == size
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        np.testing.assert_array_equal(b.keys.numpy(), np.asarray(a.keys))
        if quantized:
            np.testing.assert_array_equal(b.key_scales.numpy(), np.asarray(a.key_scales))


def test_append_layer_kv_matches_jax():
    rng = np.random.default_rng(5)
    buf = rng.standard_normal((1, 2, 12, 8)).astype(np.float32)
    new = rng.standard_normal((1, 2, 3, 8)).astype(np.float32)
    jk, _, jl = jcache.append_layer_kv(jnp.asarray(buf), jnp.asarray(buf), 4,
                                       jnp.asarray(new), jnp.asarray(new))
    tk, _, tl = tcache.append_layer_kv(_t(buf.copy()), _t(buf.copy()), 4, _t(new), _t(new))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert tl == int(jl) == 7


BIAS_CASES = [  # prior, T, S, window, masked
    (0, 8, 8, None, False), (5, 3, 16, None, True), (10, 6, 20, 4, True), (0, 1, 9, None, True),
]


@pytest.mark.parametrize("case", BIAS_CASES, ids=[str(c) for c in BIAS_CASES])
def test_attention_bias_matches_jax(case):
    prior, T, S, window, masked = case
    mask = (np.random.default_rng(6).random((2, 3, S)) > 0.4) if masked else None
    jb = jattn.attention_bias(jnp.asarray(prior, jnp.int32), T, S, sliding_window=window,
                              head_mask=None if mask is None else jnp.asarray(mask))
    tb = tattn.attention_bias(prior, T, S, sliding_window=window,
                              head_mask=None if mask is None else _t(mask))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


ATTN_CASES = [  # B, Hq, Hkv, T, S, D, prior, softcap
    (1, 4, 2, 8, 8, 16, 0, None), (2, 8, 2, 5, 30, 32, 20, None), (1, 4, 4, 3, 12, 16, 9, 30.0),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=[str(c) for c in ATTN_CASES])
def test_gqa_attention_matches_jax(case):
    B, Hq, Hkv, T, S, D, prior, softcap = case
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hq, T, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    mask = rng.random((B, Hkv, S)) > 0.3
    mask[..., :1] = True
    jb = jattn.attention_bias(jnp.asarray(prior, jnp.int32), T, S, head_mask=jnp.asarray(mask))
    tb = tattn.attention_bias(prior, T, S, head_mask=_t(mask))
    jo, jp = jattn.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, D ** -0.5,
                                 softcap=softcap, return_probs=True)
    to, tp = tattn.gqa_attention(_t(q), _t(k), _t(v), tb, D ** -0.5, softcap=softcap,
                                 return_probs=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=2e-6)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", ATTN_CASES, ids=[str(c) for c in ATTN_CASES])
def test_quant_gqa_attention_matches_jax(case, bits):
    B, Hq, Hkv, T, S, D, prior, softcap = case
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hq, T, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    jk, jks = jcache.quantize_kv(jnp.asarray(k), bits)
    jv, jvs = jcache.quantize_kv(jnp.asarray(v), bits)
    tk, tks = tcache.quantize_kv(_t(k), bits)
    tv, tvs = tcache.quantize_kv(_t(v), bits)
    jb = jattn.attention_bias(jnp.asarray(prior, jnp.int32), T, S)
    tb = tattn.attention_bias(prior, T, S)
    jo = jattn.quant_gqa_attention(jnp.asarray(q), jk, jv, jks, jvs, jb, D ** -0.5, bits,
                                   softcap=softcap)
    to = tattn.quant_gqa_attention(_t(q), tk, tv, tks, tvs, tb, D ** -0.5, bits,
                                   softcap=softcap)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5)
