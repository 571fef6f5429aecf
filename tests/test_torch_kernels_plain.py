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


def _shape_mask(kind, mask, prior):
    """The keep-mask of a case. "random": as drawn. "run-clear": every bit set
    but a whole 128-slot run. "one-clear": every bit set but one. "dead-rows":
    as drawn, with every slot the first 10 query rows can see cleared, so
    those rows meet no live key."""
    if kind == "run-clear":
        mask = np.ones_like(mask)
        mask[:, :, 128:256] = False
    elif kind == "one-clear":
        mask = np.ones_like(mask)
        mask[:, :, 70] = False
    elif kind == "dead-rows":
        mask = mask.copy()
        mask[:, :, :prior + 10] = False
        mask[:, :, prior + 10] = True
    return mask


def _live_rows(kind):
    """Rows held against the Pallas kernel: a row that meets no live key is
    padding, which the two fill differently (both with finite values)."""
    return slice(10, None) if kind == "dead-rows" else slice(None)


def _case_id(T, S, prior, kind):
    return f"T{T}S{S}p{prior}" + ("" if kind == "random" else f"-{kind}")


FLASH_CASES = [
    # B, Hq, Hkv, T, S, D, prior, window, softcap, keep-mask
    (1, 4, 2, 256, 256, 64, 0, None, None, "random"),
    (2, 8, 4, 200, 200, 64, 0, None, None, "random"),
    (1, 4, 2, 128, 640, 128, 512, None, None, "random"),
    (1, 4, 4, 256, 256, 64, 0, 64, None, "random"),
    (1, 4, 2, 130, 130, 64, 0, None, 30.0, "random"),
    # the edges of the Hopper kernel's tiles: a prior that is no multiple of
    # 64, 8 and 1 query heads per kv head, a whole 128-slot run clear, one
    # clear bit in a live run, rows without a live key, a window across a tile
    # edge behind a prior, head_dim 128 with ragged T
    (1, 4, 2, 100, 400, 64, 300, None, None, "random"),
    (1, 8, 1, 64, 192, 64, 128, None, None, "random"),
    (1, 2, 2, 130, 130, 64, 0, None, None, "one-clear"),
    (1, 4, 2, 200, 456, 64, 256, None, None, "run-clear"),
    (1, 4, 2, 100, 100, 64, 0, None, None, "dead-rows"),
    (1, 4, 2, 100, 500, 64, 400, 130, None, "random"),
    (1, 4, 2, 77, 333, 128, 256, None, None, "random"),
]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[_case_id(c[3], c[4], c[6], c[9]) for c in FLASH_CASES])
def test_flash_plain_matches_pallas(case):
    B, Hq, Hkv, T, S, D, prior, window, softcap, kind = case
    q, k, v, mask = _inputs(T + S + prior, B, Hq, Hkv, T, S, D)
    mask = _shape_mask(kind, mask, prior)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(prior, jnp.int32),
                  jnp.asarray(mask), sm_scale=D ** -0.5, window=window, softcap=softcap,
                  block_q=64, block_k=128, interpret=True)
    got = tfl.flash_attention(_t(q), _t(k), _t(v), prior, _t(mask), sm_scale=D ** -0.5,
                              window=window, softcap=softcap)
    assert np.isfinite(got.numpy()).all()
    rows = _live_rows(kind)
    np.testing.assert_allclose(got.numpy()[:, :, rows], np.asarray(want)[:, :, rows], atol=2e-5)


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
    # bits, B, Hq, Hkv, T, S, D, prior, window, softcap, keep-mask
    (8, 1, 4, 2, 128, 128, 64, 0, None, None, "random"),
    (4, 1, 4, 2, 128, 128, 64, 0, None, None, "random"),
    (8, 2, 8, 4, 100, 356, 64, 256, None, None, "random"),
    (4, 1, 4, 2, 130, 386, 128, 256, 64, 30.0, "random"),
    # the tile edges, as for the bf16 kernel
    (8, 1, 8, 1, 64, 364, 64, 300, None, None, "random"),
    (4, 1, 2, 2, 130, 130, 64, 0, None, None, "one-clear"),
    (8, 1, 4, 2, 200, 456, 64, 256, None, None, "run-clear"),
    (4, 1, 4, 2, 100, 100, 64, 0, None, None, "dead-rows"),
    (8, 1, 4, 2, 100, 500, 64, 400, 130, None, "random"),
    (8, 1, 4, 2, 77, 333, 128, 256, None, None, "random"),
]


@pytest.mark.parametrize("case", QUANT_CASES,
                         ids=[f"b{c[0]}" + _case_id(c[4], c[5], c[7], c[10])
                              for c in QUANT_CASES])
def test_flash_quant_plain_matches_pallas(case):
    bits, B, Hq, Hkv, T, S, D, prior, window, softcap, kind = case
    q, k, v, mask = _inputs(bits + T + S, B, Hq, Hkv, T, S, D)
    mask = _shape_mask(kind, mask, prior)
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
    assert np.isfinite(got.numpy()).all()
    rows = _live_rows(kind)
    np.testing.assert_allclose(got.numpy()[:, :, rows], np.asarray(want)[:, :, rows], atol=3e-5)


# A launch with few query rows cuts the key range of a q-tile into several
# ranges and merges them. The plain version of that arithmetic differs from
# the unsplit one only in the order of its float32 sums.
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("bits", [None, 8, 4])
def test_split_plain_matches_unsplit(bits, splits):
    B, Hq, Hkv, T, S, D, prior = 2, 8, 2, 70, 900, 64, 830
    q, k, v, mask = _inputs(splits, B, Hq, Hkv, T, S, D, p_keep=0.6)
    kw = dict(sm_scale=D ** -0.5, window=700, softcap=30.0, return_lse=True)
    if bits is None:
        args = (_t(q), _t(k), _t(v), prior, _t(mask))
        ref, ref_lse = tfl.flash_attention_plain(*args, **kw)
        got, lse = tfl.flash_attention_split_plain(*args, splits=splits, **kw)
    else:
        (tk, tks), (tv, tvs) = quantize_kv(_t(k), bits), quantize_kv(_t(v), bits)
        args = (_t(q), tk, tv, tks, tvs, prior, _t(mask))
        ref, ref_lse = tfl.flash_attention_quant_plain(*args, bits=bits, **kw)
        got, lse = tfl.flash_attention_quant_split_plain(*args, bits=bits, splits=splits, **kw)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-5)


def test_merge_of_ranges_without_a_live_key():
    """A range that met no live key (max -inf, sum 0) adds nothing, and a row
    that met none in any range comes out 0 with logsumexp -inf."""
    inf = float("inf")
    o = torch.tensor([[[1.0, 2.0], [0.0, 0.0]], [[0.0, 0.0], [0.0, 0.0]]])     # (2 ranges, 2 rows, D 2)
    m = torch.tensor([[0.5, -inf], [-inf, -inf]])
    l = torch.tensor([[2.0, 0.0], [0.0, 0.0]])
    out, lse = tfl.merge_key_ranges(o, m, l)
    np.testing.assert_allclose(out.numpy(), [[0.5, 1.0], [0.0, 0.0]])
    np.testing.assert_allclose(lse.numpy(), [0.5 + np.log(2.0), -inf])


SPLIT_SHAPES = [
    # B, Hkv, G, T, S, D, prior, window -> key ranges a q-tile
    ((1, 8, 4, 32768, 32768, 64, 0, None), 1),        # the 32K prefill: q-tiles fill the card
    ((1, 8, 4, 152, 16536, 64, 16384, None), 7),      # a question over a compressed cache
    ((1, 8, 4, 256, 16640, 64, 16384, None), 5),
    ((4, 8, 4, 152, 16536, 64, 16384, None), 2),      # four of them
    ((1, 1, 1, 8, 100, 64, 0, None), 1),              # no more ranges than key tiles
    ((1, 2, 4, 64, 4160, 128, 4096, None), 16),       # at most MAX_SPLITS
    ((1, 2, 4, 64, 4160, 128, 4096, 200), 4),         # a window leaves 4 tiles of 64 keys
]


@pytest.mark.parametrize("shape,want", SPLIT_SHAPES,
                         ids=[f"B{s[0]}T{s[3]}S{s[4]}D{s[5]}w{s[7]}" for s, _ in SPLIT_SHAPES])
def test_flash_splits_at_the_paths_shapes(shape, want):
    B, Hkv, G, T, S, D, prior, window = shape
    assert tfl.flash_splits(B, Hkv, G, T, S, D, prior, window) == want


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
