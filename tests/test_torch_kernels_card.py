"""Each Hopper kernel of kvpress_tpu_torch against its plain PyTorch version,
on a CUDA card (skipped without one: the kernels have no CPU mode). The cases
are those of tests/test_torch_kernels_plain.py, where the plain versions are
held against the JAX Pallas kernels.

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_card.py
"""

import numpy as np
import pytest
import torch

from kvpress_tpu_torch.cache import quantize_kv
from kvpress_tpu_torch.ops import decode as tdec
from kvpress_tpu_torch.ops import decode_headwise as thw
from kvpress_tpu_torch.ops import flash as tfl
from kvpress_tpu_torch.ops import observed_colsum as toc

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FLASH_CASES = [
    # B, Hq, Hkv, T, S, D, prior, window, softcap, keep-mask
    (1, 4, 2, 256, 256, 64, 0, None, None, "random"),
    (2, 8, 4, 200, 200, 64, 0, None, None, "random"),
    (1, 4, 2, 128, 640, 128, 512, None, None, "random"),
    (1, 4, 4, 256, 256, 64, 0, 64, None, "random"),
    (1, 4, 2, 130, 130, 64, 0, None, 30.0, "random"),
    # the edges of the kernel's tiles: a prior that is no multiple of 64, 8
    # and 1 query heads per kv head, a whole 128-slot run clear, one clear bit
    # in a live run, rows without a live key, a window across a tile edge
    # behind a prior, head_dim 128 with ragged T
    (1, 4, 2, 100, 400, 64, 300, None, None, "random"),
    (1, 8, 1, 64, 192, 64, 128, None, None, "random"),
    (1, 2, 2, 130, 130, 64, 0, None, None, "one-clear"),
    (1, 4, 2, 200, 456, 64, 256, None, None, "run-clear"),
    (1, 4, 2, 100, 100, 64, 0, None, None, "dead-rows"),
    (1, 4, 2, 100, 500, 64, 400, 130, None, "random"),
    (1, 4, 2, 77, 333, 128, 256, None, None, "random"),
    # few query rows over a long cache: the key range of a q-tile is split
    (1, 8, 2, 152, 4248, 64, 4096, None, None, "random"),
    # a handful of rows over a ragged buffer; 5 and 7 query heads per kv head
    (3, 8, 2, 5, 37, 64, 32, None, None, "random"),
    (1, 10, 2, 77, 203, 64, 126, None, None, "random"),
    (2, 7, 1, 33, 1000, 128, 967, 300, 20.0, "random"),
]
QUANT_CASES = [
    # bits, B, Hq, Hkv, T, S, D, prior, window, softcap, keep-mask
    (8, 1, 4, 2, 128, 128, 64, 0, None, None, "random"),
    (4, 1, 4, 2, 128, 128, 64, 0, None, None, "random"),
    (8, 2, 8, 4, 100, 356, 64, 256, None, None, "random"),
    (4, 1, 4, 2, 130, 386, 128, 256, 64, 30.0, "random"),
    (8, 1, 8, 1, 64, 364, 64, 300, None, None, "random"),
    (4, 1, 2, 2, 130, 130, 64, 0, None, None, "one-clear"),
    (8, 1, 4, 2, 200, 456, 64, 256, None, None, "run-clear"),
    (4, 1, 4, 2, 100, 100, 64, 0, None, None, "dead-rows"),
    (8, 1, 4, 2, 100, 500, 64, 400, 130, None, "random"),
    (8, 1, 4, 2, 77, 333, 128, 256, None, None, "random"),
    (8, 1, 8, 2, 152, 4248, 64, 4096, None, None, "random"),
    (4, 3, 8, 2, 5, 37, 64, 32, None, None, "random"),
    (8, 1, 10, 2, 77, 203, 64, 126, None, None, "random"),
    (4, 2, 7, 1, 33, 1000, 128, 967, 300, 20.0, "random"),
]
DECODE_CASES = [
    # B, Hq, Hkv, T, S, length, D, window, softcap, masked
    (1, 4, 2, 1, 512, 300, 64, None, None, False),
    (2, 8, 2, 1, 512, 512, 64, None, None, True),
    (1, 4, 2, 4, 640, 500, 64, None, None, True),
    (1, 4, 4, 1, 512, 400, 64, 128, None, False),
    (1, 4, 2, 1, 512, 333, 64, None, 30.0, True),
    (1, 2, 2, 2, 384, 200, 128, None, None, True),
]
COLSUM_CASES = [
    # B, Hq, Hkv, S, D, softcap
    (2, 4, 2, 50, 64, None),
    (2, 4, 2, 200, 64, 30.0),
    (1, 8, 2, 300, 64, None),
    (1, 8, 1, 200, 64, None),
    (1, 4, 4, 257, 64, None),
    (1, 8, 1, 130, 128, 30.0),
    (1, 4, 2, 1000, 128, None),
    # tile edges: the row-logsumexp pass's key tiles (128 keys at head_dim 64),
    # the column-sum kernel's key blocks (192 keys, 64 a consumer warpgroup)
    # and its query stages of 128 / G positions; 1 and 8 query heads per kv
    # head, head_dim 128, and a key block of its own past 4,096
    (1, 4, 2, 127, 64, None),
    (1, 4, 2, 128, 64, None),
    (1, 4, 2, 129, 64, None),
    (1, 4, 2, 257, 64, None),
    (1, 4, 2, 191, 64, None),
    (1, 4, 2, 192, 64, None),
    (1, 4, 2, 193, 64, None),
    (1, 4, 2, 385, 64, None),
    (1, 8, 1, 193, 128, None),
    (1, 2, 2, 257, 128, 30.0),
    (1, 8, 1, 129, 128, None),
    (1, 32, 8, 4097, 64, None),
]
HEADWISE_CASES = [
    # B, Hq, Hkv, T, S, D, tail, softcap, empty head, longest head absorbs the tail
    (2, 4, 2, 1, 96, 64, 6, None, False, False),
    (2, 4, 2, 4, 96, 64, 6, None, False, False),
    (2, 8, 2, 1, 700, 64, 3, None, True, False),
    (1, 4, 2, 1, 700, 64, 5, 30.0, False, True),
    (4, 32, 8, 1, 1200, 64, 9, None, True, True),
    (1, 2, 2, 2, 400, 128, 4, None, False, False),
]


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


def _case_id(T, S, prior, kind):
    return f"T{T}S{S}p{prior}" + ("" if kind == "random" else f"-{kind}")


def _decode_mask(mask, length, T, masked):
    if not masked:
        return None
    mask = mask.copy()
    mask[:, :, length - T:length] = True
    return mask


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


# The worst output row (one query head at one position) may differ from the
# plain version by at most this share of that row's largest value, as in
# chip_smoke.py: rows over few keys are large, rows over many keys small.
ROW_LIMIT = 2e-2


def _row_error(got, ref):
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs().amax(-1)
    return (diff / ref.abs().amax(-1).clamp_min(1e-3)).max().item()


def _close(got, ref):
    assert torch.isfinite(got).all()
    err = _row_error(got, ref)
    assert err <= ROW_LIMIT, f"worst row differs by {err:.3e} of its scale"


def _flash_close(kind, got, lse, ref, ref_lse):
    """Output and row logsumexp against the plain version. A row that meets
    no live key is padding: the kernel stores 0 and logsumexp -inf there."""
    if kind == "dead-rows":
        assert (got[:, :, :10] == 0).all()
        assert (lse[:, :, :10] == float("-inf")).all()
        got, lse, ref, ref_lse = (x[:, :, 10:] for x in (got, lse, ref, ref_lse))
    _close(got, ref)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[_case_id(c[3], c[4], c[6], c[9]) for c in FLASH_CASES])
def test_flash_kernel_matches_plain_on_card(cuda, case):
    B, Hq, Hkv, T, S, D, prior, window, softcap, kind = case
    q, k, v, mask = _inputs(1, B, Hq, Hkv, T, S, D)
    q, k, v, mask = (_t(a).to(cuda) for a in (q, k, v, _shape_mask(kind, mask, prior)))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    kw = dict(sm_scale=D ** -0.5, window=window, softcap=softcap, return_lse=True)
    n = tfl.flash_attention.launches
    got, lse = tfl.flash_attention(q, k, v, prior, mask, **kw)
    torch.cuda.synchronize()
    assert tfl.flash_attention.launches == n + 1
    _flash_close(kind, got, lse, *tfl.flash_attention_plain(q, k, v, prior, mask, **kw))
    # the same bits on every launch (a split launch merges its key ranges in order)
    again, lse_again = tfl.flash_attention(q, k, v, prior, mask, **kw)
    assert torch.equal(got, again) and torch.equal(lse, lse_again)
    # without a keep-mask: every slot of the buffer is live
    _close(tfl.flash_attention(q, k, v, prior, **kw)[0],
           tfl.flash_attention_plain(q, k, v, prior, **kw)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("case", QUANT_CASES,
                         ids=[f"b{c[0]}" + _case_id(c[4], c[5], c[7], c[10])
                              for c in QUANT_CASES])
def test_flash_quant_kernel_matches_plain_on_card(cuda, case):
    bits, B, Hq, Hkv, T, S, D, prior, window, softcap, kind = case
    q, k, v, mask = _inputs(2, B, Hq, Hkv, T, S, D)
    q, k, v, mask = (_t(a).to(cuda) for a in (q, k, v, _shape_mask(kind, mask, prior)))
    q = q.to(torch.bfloat16)
    (kq, ks), (vq, vs) = quantize_kv(k, bits), quantize_kv(v, bits)
    kw = dict(bits=bits, sm_scale=D ** -0.5, window=window, softcap=softcap, return_lse=True)
    n = tfl.flash_attention_quant.launches
    got, lse = tfl.flash_attention_quant(q, kq, vq, ks, vs, prior, mask, **kw)
    torch.cuda.synchronize()
    assert tfl.flash_attention_quant.launches == n + 1
    _flash_close(kind, got, lse,
                 *tfl.flash_attention_quant_plain(q, kq, vq, ks, vs, prior, mask, **kw))
    again, lse_again = tfl.flash_attention_quant(q, kq, vq, ks, vs, prior, mask, **kw)
    assert torch.equal(got, again) and torch.equal(lse, lse_again)


@pytest.mark.cuda
@pytest.mark.parametrize("prior", [0, 1536])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_quant_int4_at_chunk_shapes_on_card(cuda, prior, D):
    """A chunk of chunked prefill over an int4 cache (the fused route): 512
    new queries over a 2,048-slot buffer of which ``prior`` slots came
    before, GQA 32/8, no keep-mask (the chunk forward passes none) and a
    random one; launched twice with equal bits."""
    B, Hq, Hkv, T, S = 1, 32, 8, 512, 2048
    q, k, v, mask = _inputs(3, B, Hq, Hkv, T, S, D)
    q, k, v, mask = (_t(a).to(cuda) for a in (q, k, v, mask))
    q = q.to(torch.bfloat16)
    (kq, ks), (vq, vs) = quantize_kv(k, 4), quantize_kv(v, 4)
    kw = dict(bits=4, sm_scale=D ** -0.5, return_lse=True)
    for m in (None, mask):
        n = tfl.flash_attention_quant.launches_by_bits[4]
        got, lse = tfl.flash_attention_quant(q, kq, vq, ks, vs, prior, m, **kw)
        torch.cuda.synchronize()
        assert tfl.flash_attention_quant.launches_by_bits[4] == n + 1
        _flash_close("random", got, lse,
                     *tfl.flash_attention_quant_plain(q, kq, vq, ks, vs, prior, m, **kw))
        again, lse_again = tfl.flash_attention_quant(q, kq, vq, ks, vs, prior, m, **kw)
        assert torch.equal(got, again) and torch.equal(lse, lse_again)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_split_plain_matches_unsplit_on_card(cuda, splits):
    """The plain version of a split launch against the unsplit plain version,
    in float32 on the card."""
    B, Hq, Hkv, T, S, D, prior = 2, 8, 2, 70, 900, 64, 830
    q, k, v, mask = (_t(a).to(cuda) for a in _inputs(splits, B, Hq, Hkv, T, S, D, p_keep=0.6))
    kw = dict(sm_scale=D ** -0.5, return_lse=True)
    ref, ref_lse = tfl.flash_attention_plain(q, k, v, prior, mask, **kw)
    got, lse = tfl.flash_attention_split_plain(q, k, v, prior, mask, splits=splits, **kw)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[f"T{c[3]}S{c[4]}L{c[5]}D{c[6]}m{c[9]}" for c in DECODE_CASES])
def test_decode_kernel_matches_plain_on_card(cuda, case, bits):
    B, Hq, Hkv, T, S, length, D, window, softcap, masked = case
    q, k, v, mask = _inputs(3, B, Hq, Hkv, T, S, D, p_keep=0.6)
    mask = _decode_mask(mask, length, T, masked)
    q, k, v = (_t(a).to(cuda) for a in (q, k, v))
    mask = None if mask is None else _t(mask).to(cuda)
    q = q.to(torch.bfloat16)
    ks = vs = None
    if bits is None:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    else:
        (k, ks), (v, vs) = quantize_kv(k, bits), quantize_kv(v, bits)
    kw = dict(bits=bits, sm_scale=D ** -0.5, window=window, softcap=softcap)
    got = tdec.decode_attention(q, k, v, length, ks, vs, mask, block_k=256, **kw)
    ref = tdec.decode_attention_plain(q, k, v, length, ks, vs, mask, **kw)
    _close(got, ref)


def _sums_close(got, ref):
    """Column sums (and row LSE) are one number per slot: each is held to
    ROW_LIMIT of its own size."""
    assert torch.isfinite(got).all()
    err = ((got - ref).abs() / ref.abs().clamp_min(1e-3)).max().item()
    assert err <= ROW_LIMIT, f"worst entry differs by {err:.3e} of its size"


@pytest.mark.cuda
@pytest.mark.parametrize("case", COLSUM_CASES,
                         ids=[f"Hq{c[1]}Hkv{c[2]}S{c[3]}D{c[4]}" for c in COLSUM_CASES])
def test_observed_colsum_kernels_match_plain_on_card(cuda, case):
    B, Hq, Hkv, S, D, softcap = case
    q, k, v, _ = (_t(a).to(cuda) for a in _inputs(4, B, Hq, Hkv, S, S, D))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    kw = dict(sm_scale=D ** -0.5, softcap=softcap)
    n_lse, n_sum = toc.observed_lse.launches, toc.observed_colsums_flash.launches
    lse = toc.observed_lse(q, k, **kw)
    got = toc.observed_colsums_flash(q, k, **kw)
    torch.cuda.synchronize()
    assert toc.observed_lse.launches == n_lse + 2
    assert toc.observed_colsums_flash.launches == n_sum + 1
    torch.testing.assert_close(lse, toc.observed_lse_plain(q, k, **kw), atol=1e-3, rtol=1e-4)
    ref = toc.observed_colsums_plain(q, k, **kw)
    _sums_close(got, ref)
    # the same bits on every run (the sums feed a top-k)
    assert torch.equal(got, toc.observed_colsums_flash(q, k, **kw))
    # with the flash prefill kernel's row LSE, pass 1 is skipped
    _, flash_lse = tfl.flash_attention(q, k, v, 0, sm_scale=D ** -0.5, softcap=softcap,
                                       return_lse=True)
    n_lse = toc.observed_lse.launches
    _sums_close(toc.observed_colsums_flash(q, k, flash_lse, **kw), ref)
    assert toc.observed_lse.launches == n_lse
    # a row that saw no key (lse = -inf) adds nothing, and nothing is NaN
    holed = flash_lse.clone()
    holed[:, :, S // 2] = float("-inf")
    _sums_close(toc.observed_colsums_flash(q, k, holed, **kw),
                toc.observed_colsums_plain(q, k, holed, **kw))


@pytest.mark.cuda
def test_observed_colsum_refuses_offsets_past_32_bits(cuda):
    # 8 query heads of 2**21 positions at head_dim 128: 2**31 query elements
    # in one kv head's group, past the column-sum producer's 32-bit offsets
    S = 2**21
    q = torch.empty((1, 8, S, 128), dtype=torch.bfloat16, device=cuda)
    k = torch.empty((1, 1, S, 128), dtype=torch.bfloat16, device=cuda)
    n_lse, n_sum = toc.observed_lse.launches, toc.observed_colsums_flash.launches
    with pytest.raises(ValueError, match="2\\*\\*31"):
        toc.observed_colsums_flash(q, k, sm_scale=0.1)
    assert (toc.observed_lse.launches, toc.observed_colsums_flash.launches) == (n_lse, n_sum)
    # the C entry point refuses it too, before it launches
    spare = torch.empty(16, device=cuda)
    fn = toc._build.entry("observed_colsum", "kvp_observed_colsum")
    assert fn(q.data_ptr(), k.data_ptr(), spare.data_ptr(), spare.data_ptr(), 1, 8, 1, S, 128,
              0.1, 0.0, torch.cuda.current_stream(cuda).cuda_stream) != 0


def _headwise_case(seed, B, Hkv, S, tail, empty, absorbed):
    """A cache compacted head by head: prefix lengths, then a shared tail."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(5, S - tail - 8, (B, Hkv)).astype(np.int32)
    tail_start = int(prefix.max()) + (0 if absorbed else 7)
    if empty:
        prefix[0, 0] = 0
    length = tail_start + tail
    mask = np.arange(S)[None, None] < prefix[..., None]
    mask[:, :, tail_start:length] = True
    mask[:, :, length:] = rng.random((B, Hkv, S - length)) < 0.5     # stale bits
    return mask, length


@pytest.mark.cuda
@pytest.mark.parametrize("case", HEADWISE_CASES,
                         ids=[f"B{c[0]}T{c[3]}S{c[4]}D{c[5]}e{int(c[8])}a{int(c[9])}"
                              for c in HEADWISE_CASES])
def test_headwise_kernel_matches_plain_on_card(cuda, case):
    B, Hq, Hkv, T, S, D, tail, softcap, empty, absorbed = case
    q, k, v, _ = (_t(a).to(cuda) for a in _inputs(5, B, Hq, Hkv, T, S, D))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    mask, length = _headwise_case(6, B, Hkv, S, tail, empty, absorbed)
    ranges = thw.prefix_tail_from_mask(_t(mask).to(cuda), length)
    kw = dict(sm_scale=D ** -0.5, softcap=softcap)
    n = thw.decode_attention_headwise.launches
    got = thw.decode_attention_headwise(q, k, v, *ranges, **kw)
    torch.cuda.synchronize()
    assert thw.decode_attention_headwise.launches == n + 1
    _close(got, thw.decode_attention_headwise_plain(q, k, v, *ranges, **kw))
    if T == 1:
        # the ranges say what the mask says: dense attention under the mask
        _close(got, tdec.decode_attention_plain(q, k, v, length, mask=_t(mask).to(cuda), **kw))


# The edges of a split launch (key ranges of whole kernel steps, merged in
# order), as tests/test_torch_kernels_plain.py holds the split plain version
# against the Pallas kernel: 1, 2, 3 and 7 ranges; range edges inside live
# runs; a range with no live step ("dead-range"); window and softcap; int8
# and int4; T = 1 and 4; head_dim 128; S not a multiple of 16 or 4 (keep-mask
# bytes and scales copied by hand), S a multiple of 16 with a length that
# ends inside a step; and the default split count at a shape near the paths'.
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
    (4, 1, 8, 2, 1, 1024, 1000, 64, None, None, 3, "random"),
    (None, 1, 32, 8, 1, 4160, 4097, 64, None, None, None, "random"),
    (4, 1, 32, 8, 4, 4160, 4100, 64, None, None, None, "dead-range"),
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


def _fix_splits(monkeypatch, splits, *shape):
    """The key ranges of the next launches: ``splits``, or (None) the count
    ``decode_splits`` gives for ``shape``."""
    if splits is None:
        return tdec.decode_splits(*shape)
    monkeypatch.setattr(tdec, "decode_splits", lambda *args: splits)
    return splits


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_SPLIT_CASES,
                         ids=[f"b{c[0]}T{c[4]}L{c[6]}D{c[7]}n{c[10]}-{c[11]}"
                              for c in DECODE_SPLIT_CASES])
def test_decode_kernel_split_edges_on_card(cuda, monkeypatch, case):
    bits, B, Hq, Hkv, T, S, length, D, window, softcap, splits, kind = case
    q, k, v, mask = _inputs(7, B, Hq, Hkv, T, S, D, p_keep=0.6)
    splits = _fix_splits(monkeypatch, splits, B, Hkv, Hq // Hkv, T, S, D, length,
                         tdec.step_keys(D, bits))
    mask = _split_case_mask(kind, mask, length, T, window, bits, D, splits)
    q, k, v = (_t(a).to(cuda) for a in (q, k, v))
    mask = None if mask is None else _t(mask).to(cuda)
    q = q.to(torch.bfloat16)
    ks = vs = None
    if bits is None:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    else:
        (k, ks), (v, vs) = quantize_kv(k, bits), quantize_kv(v, bits)
    kw = dict(bits=bits, sm_scale=D ** -0.5, window=window, softcap=softcap)
    n = tdec.decode_attention.launches
    got = tdec.decode_attention(q, k, v, length, ks, vs, mask, **kw)
    torch.cuda.synchronize()
    again = tdec.decode_attention(q, k, v, length, ks, vs, mask, **kw)
    assert tdec.decode_attention.launches == n + 2
    assert torch.equal(got, again)
    _close(got, tdec.decode_attention_split_plain(q, k, v, length, ks, vs, mask,
                                                  splits=splits, **kw))
    _close(got, tdec.decode_attention_plain(q, k, v, length, ks, vs, mask, **kw))


HEADWISE_SPLIT_CASES = [
    # B, Hq, Hkv, T, S, D, tail, softcap, empty head, absorbed tail, splits
    (2, 4, 2, 1, 700, 64, 6, None, False, False, 1),
    (2, 8, 2, 4, 700, 64, 6, None, True, False, 2),
    (1, 4, 2, 1, 700, 64, 70, 30.0, False, True, 3),
    (2, 4, 2, 4, 900, 64, 9, None, True, True, 7),
    (1, 8, 1, 1, 500, 128, 3, 30.0, True, False, 7),
    (4, 32, 8, 1, 4160, 64, 33, None, True, True, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", HEADWISE_SPLIT_CASES,
                         ids=[f"T{c[3]}S{c[4]}D{c[5]}e{int(c[8])}a{int(c[9])}n{c[10]}"
                              for c in HEADWISE_SPLIT_CASES])
def test_headwise_kernel_split_edges_on_card(cuda, monkeypatch, case):
    B, Hq, Hkv, T, S, D, tail, softcap, empty, absorbed, splits = case
    splits = _fix_splits(monkeypatch, splits, B, Hkv, Hq // Hkv, T, S, D, S,
                         tdec.step_keys(D, None))
    q, k, v, _ = (_t(a).to(cuda) for a in _inputs(8, B, Hq, Hkv, T, S, D))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    mask, length = _headwise_case(9, B, Hkv, S, tail, empty, absorbed)
    ranges = thw.prefix_tail_from_mask(_t(mask).to(cuda), length)
    kw = dict(sm_scale=D ** -0.5, softcap=softcap)
    n = thw.decode_attention_headwise.launches
    got = thw.decode_attention_headwise(q, k, v, *ranges, **kw)
    torch.cuda.synchronize()
    again = thw.decode_attention_headwise(q, k, v, *ranges, **kw)
    assert thw.decode_attention_headwise.launches == n + 2
    assert torch.equal(got, again)
    _close(got, thw.decode_attention_headwise_split_plain(q, k, v, *ranges,
                                                          splits=splits, **kw))
    _close(got, thw.decode_attention_headwise_plain(q, k, v, *ranges, **kw))
    if T == 1:
        _close(got, tdec.decode_attention_plain(q, k, v, length, mask=_t(mask).to(cuda), **kw))
