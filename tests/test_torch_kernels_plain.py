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
from kvpress_tpu.ops.decode_headwise import decode_attention_headwise as jheadwise
from kvpress_tpu.ops.decode_headwise import prefix_tail_from_mask as jprefix_tail
from kvpress_tpu.ops.flash import flash_attention as jflash
from kvpress_tpu.ops.flash import flash_attention_quant as jflash_quant
from kvpress_tpu_torch.cache import quantize_kv
from kvpress_tpu_torch.ops import decode as tdec
from kvpress_tpu_torch.ops import decode_headwise as thw
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
    """The or-mask is ``flash_attention``'s alone, and comes whole: group ids
    without the span bound, the bound without group ids, or a bound under 1
    are refused, and ``flash_attention_quant`` takes no groups (as in JAX).
    tests/test_torch_multimodal.py holds the or-mask itself against the
    Pallas kernel."""
    q, k, v, _ = _inputs(0, 1, 2, 1, 4, 4, 16)
    groups = torch.zeros(1, 4, dtype=torch.int32)
    for kw in (dict(q_groups=groups, k_groups=groups), dict(or_span=4),
               dict(q_groups=groups, or_span=4), dict(q_groups=groups, k_groups=groups, or_span=0)):
        with pytest.raises(ValueError):
            tfl.flash_attention(_t(q), _t(k), _t(v), 0, sm_scale=0.25, **kw)
        with pytest.raises(ValueError):
            tfl.flash_attention_plain(_t(q), _t(k), _t(v), 0, sm_scale=0.25, **kw)
    kq, ks = quantize_kv(_t(k), 8)
    with pytest.raises(TypeError):
        tfl.flash_attention_quant(_t(q), kq, kq, ks, ks, 0, bits=8, sm_scale=0.25,
                                  q_groups=groups, k_groups=groups, or_span=4)


# A decode launch cuts the key range of a kv head into key ranges of whole
# kernel steps (64 keys at bf16, 128 at int8, 256 at int4, head_dim 64) and
# merges them. Its plain version is held against the Pallas kernel (live
# tiles of 128 keys, so a range edge at a 64-key step lies inside a live
# tile). "dead-range": every keep-bit of range 1 cleared but the new tokens',
# so that range has no live step. Tolerance: float32 on both sides, sums
# taken in another order (as for the unsplit plain version).
DECODE_SPLIT_CASES = [
    # bits, B, Hq, Hkv, T, S, length, D, window, softcap, splits, keep-mask
    (None, 1, 4, 2, 1, 900, 833, 64, None, None, 1, "random"),
    (None, 2, 8, 2, 4, 900, 833, 64, None, None, 2, "random"),
    (8, 1, 4, 2, 1, 900, 833, 64, 300, 30.0, 3, "random"),
    (4, 2, 8, 2, 4, 1000, 997, 64, None, None, 7, "random"),
    (None, 1, 4, 2, 1, 900, 833, 64, None, None, 3, "dead-range"),
    (8, 1, 8, 2, 4, 1100, 1090, 64, None, 30.0, 7, "dead-range"),
    (4, 1, 4, 2, 4, 700, 650, 128, 260, None, 2, "random"),
    (8, 1, 2, 2, 1, 517, 517, 64, 200, None, 2, "none"),
]


def _split_case_mask(kind, mask, length, T, window, bits, D, splits):
    if kind == "none":
        return None
    mask = mask.copy()
    if kind == "dead-range":
        lo, hi = tdec.decode_key_ranges(length, T, window, tdec.step_keys(D, bits), splits)[1]
        mask[:, :, lo:hi] = False
    mask[:, :, length - T:length] = True
    return mask


@pytest.mark.parametrize("case", DECODE_SPLIT_CASES,
                         ids=[f"b{c[0]}T{c[4]}L{c[6]}D{c[7]}n{c[10]}-{c[11]}"
                              for c in DECODE_SPLIT_CASES])
def test_decode_split_plain_matches_pallas(case):
    bits, B, Hq, Hkv, T, S, length, D, window, softcap, splits, kind = case
    q, k, v, mask = _inputs(splits + length, B, Hq, Hkv, T, S, D, p_keep=0.6)
    mask = _split_case_mask(kind, mask, length, T, window, bits, D, splits)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    kw = dict(sm_scale=D ** -0.5, window=window, softcap=softcap)
    if bits is None:
        want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(length, jnp.int32), mask=jm, block_k=128, interpret=True, **kw)
        got = tdec.decode_attention_split_plain(_t(q), _t(k), _t(v), length, mask=tm,
                                                splits=splits, **kw)
    else:
        (jk, jks), (jv, jvs) = jquantize(jnp.asarray(k), bits), jquantize(jnp.asarray(v), bits)
        (tk, tks), (tv, tvs) = quantize_kv(_t(k), bits), quantize_kv(_t(v), bits)
        want = jdecode(jnp.asarray(q), jk, jv, jnp.asarray(length, jnp.int32), k_scales=jks,
                       v_scales=jvs, mask=jm, bits=bits, block_k=128, interpret=True, **kw)
        got = tdec.decode_attention_split_plain(_t(q), tk, tv, length, tks, tvs, tm, bits=bits,
                                                splits=splits, **kw)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_decode_key_ranges_cover_the_visible_slots_in_whole_steps():
    ranges = tdec.decode_key_ranges(833, 1, None, 64, 3)
    assert ranges == [(0, 320), (320, 640), (640, 833)]
    # a window starts the first step at the step holding the first visible slot
    assert tdec.decode_key_ranges(833, 1, 300, 64, 2) == [(512, 704), (704, 833)]
    # more ranges than steps: the last ones are empty
    assert tdec.decode_key_ranges(100, 1, None, 64, 7)[2:] == [(100, 100)] * 5


DECODE_SPLIT_SHAPES = [
    # B, Hkv, G, T, S, D, length, step keys -> key ranges a kv head
    ((1, 8, 4, 1, 33000, 64, 33000, 256), 32),    # a half-live 33K buffer, int4, B1
    ((1, 8, 4, 1, 33000, 64, 33000, 64), 32),     # the same in bf16
    ((4, 8, 4, 1, 16448, 64, 16385, 256), 8),     # phase-2 rows, int4 B4
    ((4, 8, 4, 1, 16448, 64, 16385, 64), 8),      # phase-2 rows, bf16 B4
    ((4, 8, 4, 1, 16920, 64, 16920, 64), 8),      # the path B cache at B4 (head-wise)
    ((1, 8, 4, 1, 65600, 64, 65600, 64), 32),     # a longer buffer: no more ranges
    ((1, 8, 4, 1, 2048, 64, 2048, 64), 8),        # a ring of steps a range at most
    ((1, 8, 4, 4, 16600, 64, 16500, 128), 32),    # a 4-token question, int8
    ((4, 8, 4, 128, 16640, 64, 16512, 64), 1),    # 128 tokens: row groups fill the card
    ((1, 1, 1, 1, 100, 64, 100, 64), 1),          # fewer steps than a ring
]


@pytest.mark.parametrize("shape,want", DECODE_SPLIT_SHAPES,
                         ids=[f"B{s[0]}T{s[3]}S{s[4]}k{s[7]}" for s, _ in DECODE_SPLIT_SHAPES])
def test_decode_splits_at_the_paths_shapes(shape, want):
    assert tdec.decode_splits(*shape) == want


def test_decode_step_keys_follow_the_payload():
    assert [tdec.step_keys(64, b) for b in (None, 8, 4)] == [64, 128, 256]
    assert [tdec.step_keys(128, b) for b in (None, 8, 4)] == [64, 64, 128]


def _headwise_ranges(seed, B, Hkv, S, tail, empty, absorbed):
    """A cache compacted head by head (prefix lengths, then a shared tail of
    ``tail`` slots) as a keep-mask, and its valid length."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(5, S - tail - 8, (B, Hkv)).astype(np.int32)
    if empty:
        prefix[0, 0] = 0
    tail_start = int(prefix.max()) + (0 if absorbed else 7)
    length = tail_start + tail
    mask = np.arange(S)[None, None] < prefix[..., None]
    mask[:, :, tail_start:length] = True
    mask[:, :, length:] = rng.random((B, Hkv, S - length)) < 0.5     # stale bits
    return mask, length


# The head-wise launch cuts each head's steps (prefix, then tail) into chunks
# of a length fixed by S. Its plain version against the Pallas kernel, at
# head_dim 64 (64-key steps), so chunk edges fall inside heads' prefixes and
# tails; a head with an empty prefix, a tail the longest prefix absorbs. The
# JAX kernel reads an absorbed tail twice (ROADMAP Queue C), so those cases
# are held against dense attention under the mask (T = 1) and the unsplit
# plain version instead. Tolerance as tests/test_torch_headwise.py holds the
# unsplit version.
HEADWISE_SPLIT_CASES = [
    # B, Hq, Hkv, T, S, tail, softcap, empty head, absorbed tail, splits
    (2, 4, 2, 1, 700, 6, None, False, False, 1),
    (2, 8, 2, 4, 700, 6, None, True, False, 2),
    (1, 4, 2, 1, 700, 70, 30.0, False, True, 3),
    (2, 4, 2, 4, 900, 9, None, True, True, 7),
    (1, 8, 1, 1, 500, 3, 30.0, True, False, 7),
]


@pytest.mark.parametrize("case", HEADWISE_SPLIT_CASES,
                         ids=[f"T{c[3]}S{c[4]}e{int(c[7])}a{int(c[8])}n{c[9]}"
                              for c in HEADWISE_SPLIT_CASES])
def test_headwise_split_plain_matches_pallas(case):
    B, Hq, Hkv, T, S, tail, softcap, empty, absorbed, splits = case
    D = 64
    q, k, v, _ = _inputs(splits + S, B, Hq, Hkv, T, S, D)
    mask, length = _headwise_ranges(splits, B, Hkv, S, tail, empty, absorbed)
    ranges = thw.prefix_tail_from_mask(_t(mask), length)
    if empty:
        assert int(ranges[0][0, 0]) == 0
    if absorbed:
        assert int(ranges[0].max()) == length
    kw = dict(sm_scale=D ** -0.5, softcap=softcap)
    got = thw.decode_attention_headwise_split_plain(_t(q), _t(k), _t(v), *ranges,
                                                    splits=splits, **kw)
    assert np.isfinite(got.numpy()).all()
    if absorbed:
        want = thw.decode_attention_headwise_plain(_t(q), _t(k), _t(v), *ranges, **kw)
        if T == 1:
            dense = tdec.decode_attention_plain(_t(q), _t(k), _t(v), length, mask=_t(mask), **kw)
            np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-5, rtol=2e-5)
    else:
        want = jheadwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         *jprefix_tail(jnp.asarray(mask), jnp.asarray(length)),
                         block_k=128, interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
