"""The plain versions of kvpress_tpu_torch's kernels (what their wrappers run
on CPU tensors) against the JAX Pallas kernels in interpret mode, on the
cases of tests/test_flash_kernel.py and tests/test_decode_kernel.py. The
Hopper kernels themselves are held against these plain versions on the card
by tests/test_torch_kernels_card.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvpress_tpu.cache import quantize_kv as jquantize
from kvpress_tpu.ops.decode import decode_attention as jdecode
from kvpress_tpu.ops.decode import live_block_table as jtable
from kvpress_tpu.ops.flash import flash_attention as jflash
from kvpress_tpu.ops.flash import flash_attention_quant as jflash_quant
from kvpress_tpu_torch.cache import quantize_kv
from kvpress_tpu_torch.ops import decode as tdec
from kvpress_tpu_torch.ops import flash as tfl

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, B, Hq, Hkv, T, S, D, p_keep=0.8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    mask = rng.random((B, Hkv, S)) < p_keep
    mask[:, :, :8] = True
    return q, k, v, mask


FLASH_CASES = [
    # B, Hq, Hkv, T, S, D, prior, window, softcap
    (1, 4, 2, 256, 256, 64, 0, None, None),
    (2, 8, 4, 200, 200, 64, 0, None, None),
    (1, 4, 2, 128, 640, 128, 512, None, None),
    (1, 4, 4, 256, 256, 64, 0, 64, None),
    (1, 4, 2, 130, 130, 64, 0, None, 30.0),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[f"T{c[3]}S{c[4]}p{c[6]}" for c in FLASH_CASES])
def test_flash_plain_matches_pallas(case):
    B, Hq, Hkv, T, S, D, prior, window, softcap = case
    q, k, v, mask = _inputs(T + S + prior, B, Hq, Hkv, T, S, D)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(prior, jnp.int32),
                  jnp.asarray(mask), sm_scale=D ** -0.5, window=window, softcap=softcap,
                  block_q=64, block_k=128, interpret=True)
    got = tfl.flash_attention(_t(q), _t(k), _t(v), prior, _t(mask), sm_scale=D ** -0.5,
                              window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_flash_plain_lse_matches_pallas():
    B, Hq, Hkv, T, S, D, prior = 1, 4, 2, 64, 192, 64, 128
    q, k, v, mask = _inputs(5, B, Hq, Hkv, T, S, D)
    wo, wl = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(prior, jnp.int32), jnp.asarray(mask), sm_scale=D ** -0.5,
                    block_q=32, block_k=64, interpret=True, return_lse=True)
    go, gl = tfl.flash_attention(_t(q), _t(k), _t(v), prior, _t(mask), sm_scale=D ** -0.5,
                                 return_lse=True)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), atol=2e-5)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=2e-4)


QUANT_CASES = [
    # bits, B, Hq, Hkv, T, S, D, prior, window, softcap
    (8, 1, 4, 2, 128, 128, 64, 0, None, None),
    (4, 1, 4, 2, 128, 128, 64, 0, None, None),
    (8, 2, 8, 4, 100, 356, 64, 256, None, None),
    (4, 1, 4, 2, 130, 386, 128, 256, 64, 30.0),
]


@pytest.mark.parametrize("case", QUANT_CASES,
                         ids=[f"b{c[0]}T{c[4]}S{c[5]}p{c[7]}" for c in QUANT_CASES])
def test_flash_quant_plain_matches_pallas(case):
    bits, B, Hq, Hkv, T, S, D, prior, window, softcap = case
    q, k, v, mask = _inputs(bits + T + S, B, Hq, Hkv, T, S, D)
    jk, jks = jquantize(jnp.asarray(k), bits)
    jv, jvs = jquantize(jnp.asarray(v), bits)
    tk, tks = quantize_kv(_t(k), bits)
    tv, tvs = quantize_kv(_t(v), bits)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    want = jflash_quant(jnp.asarray(q), jk, jv, jks, jvs, jnp.asarray(prior, jnp.int32),
                        jnp.asarray(mask), bits=bits, sm_scale=D ** -0.5, window=window,
                        softcap=softcap, block_q=64, block_k=128, interpret=True)
    got = tfl.flash_attention_quant(_t(q), tk, tv, tks, tvs, prior, _t(mask), bits=bits,
                                    sm_scale=D ** -0.5, window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


DECODE_CASES = [
    # B, Hq, Hkv, T, S, length, D, window, softcap, masked
    (1, 4, 2, 1, 512, 300, 64, None, None, False),
    (2, 8, 2, 1, 512, 512, 64, None, None, True),
    (1, 4, 2, 4, 640, 500, 64, None, None, True),
    (1, 4, 4, 1, 512, 400, 64, 128, None, False),
    (1, 4, 2, 1, 512, 333, 64, None, 30.0, True),
    (1, 2, 2, 2, 384, 200, 128, None, None, True),
]


def _decode_mask(mask, length, T, masked):
    if not masked:
        return None
    mask = mask.copy()
    mask[:, :, length - T:length] = True
    return mask


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[f"T{c[3]}S{c[4]}L{c[5]}D{c[6]}m{c[9]}" for c in DECODE_CASES])
def test_decode_plain_matches_pallas(case):
    B, Hq, Hkv, T, S, length, D, window, softcap, masked = case
    q, k, v, mask = _inputs(length + S, B, Hq, Hkv, T, S, D, p_keep=0.6)
    mask = _decode_mask(mask, length, T, masked)
    want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(length, jnp.int32),
                   mask=None if mask is None else jnp.asarray(mask), sm_scale=D ** -0.5,
                   window=window, softcap=softcap, block_k=128, interpret=True)
    got = tdec.decode_attention(_t(q), _t(k), _t(v), length,
                                mask=None if mask is None else _t(mask), sm_scale=D ** -0.5,
                                window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_decode_quant_plain_matches_pallas(bits, masked):
    B, Hq, Hkv, T, S, length, D = 2, 8, 2, 1, 512, 400, 64
    q, k, v, mask = _inputs(bits + masked, B, Hq, Hkv, T, S, D, p_keep=0.6)
    mask = _decode_mask(mask, length, T, masked)
    jk, jks = jquantize(jnp.asarray(k), bits)
    jv, jvs = jquantize(jnp.asarray(v), bits)
    tk, tks = quantize_kv(_t(k), bits)
    tv, tvs = quantize_kv(_t(v), bits)
    want = jdecode(jnp.asarray(q), jk, jv, jnp.asarray(length, jnp.int32), k_scales=jks,
                   v_scales=jvs, mask=None if mask is None else jnp.asarray(mask), bits=bits,
                   sm_scale=D ** -0.5, block_k=128, interpret=True)
    got = tdec.decode_attention(_t(q), tk, tv, length, tks, tvs,
                                None if mask is None else _t(mask), bits=bits,
                                sm_scale=D ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_live_block_table_matches_jax(masked):
    B, H, S, bk, length = 2, 2, 512, 128, 450
    mask = np.zeros((B, H, S), bool)
    mask[0, 0, :100] = mask[0, 0, 440:450] = True
    mask[0, 1, :300] = mask[0, 1, 440:450] = True
    mask[1, :, 200:260] = True
    m = mask if masked else None
    jt, jc = jtable(None if m is None else jnp.asarray(m), jnp.asarray(length, jnp.int32),
                    B, H, S, bk)
    tt, tc = tdec.live_block_table(None if m is None else _t(m), length, B, H, S, bk)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for b in range(B):
        for h in range(H):
            n = int(tc[b, h])
            assert sorted(tt[b, h, :n].tolist()) == sorted(np.asarray(jt)[b, h, :n].tolist())


def test_wrappers_refuse_the_or_mask():
    q, k, v, _ = _inputs(0, 1, 2, 1, 4, 4, 16)
    with pytest.raises(NotImplementedError):
        tfl.flash_attention(_t(q), _t(k), _t(v), 0, q_groups=torch.zeros(1, 4, dtype=torch.int32),
                            sm_scale=0.25)
