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
    # B, Hq, Hkv, T, S, D, prior, window, softcap
    (1, 4, 2, 256, 256, 64, 0, None, None),
    (2, 8, 4, 200, 200, 64, 0, None, None),
    (1, 4, 2, 128, 640, 128, 512, None, None),
    (1, 4, 4, 256, 256, 64, 0, 64, None),
    (1, 4, 2, 130, 130, 64, 0, None, 30.0),
]
QUANT_CASES = [
    # bits, B, Hq, Hkv, T, S, D, prior, window, softcap
    (8, 1, 4, 2, 128, 128, 64, 0, None, None),
    (4, 1, 4, 2, 128, 128, 64, 0, None, None),
    (8, 2, 8, 4, 100, 356, 64, 256, None, None),
    (4, 1, 4, 2, 130, 386, 128, 256, 64, 30.0),
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=[f"T{c[3]}S{c[4]}p{c[6]}" for c in FLASH_CASES])
def test_flash_kernel_matches_plain_on_card(cuda, case):
    B, Hq, Hkv, T, S, D, prior, window, softcap = case
    q, k, v, mask = (_t(a).to(cuda) for a in _inputs(1, B, Hq, Hkv, T, S, D))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    n = tfl.flash_attention.launches
    got, lse = tfl.flash_attention(q, k, v, prior, mask, sm_scale=D ** -0.5, window=window,
                                   softcap=softcap, return_lse=True)
    torch.cuda.synchronize()
    assert tfl.flash_attention.launches == n + 1
    ref, ref_lse = tfl.flash_attention_plain(q, k, v, prior, mask, sm_scale=D ** -0.5,
                                             window=window, softcap=softcap, return_lse=True)
    _close(got, ref)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", QUANT_CASES,
                         ids=[f"b{c[0]}T{c[4]}S{c[5]}p{c[7]}" for c in QUANT_CASES])
def test_flash_quant_kernel_matches_plain_on_card(cuda, case):
    bits, B, Hq, Hkv, T, S, D, prior, window, softcap = case
    q, k, v, mask = (_t(a).to(cuda) for a in _inputs(2, B, Hq, Hkv, T, S, D))
    q = q.to(torch.bfloat16)
    (kq, ks), (vq, vs) = quantize_kv(k, bits), quantize_kv(v, bits)
    got = tfl.flash_attention_quant(q, kq, vq, ks, vs, prior, mask, bits=bits,
                                    sm_scale=D ** -0.5, window=window, softcap=softcap)
    ref = tfl.flash_attention_quant_plain(q, kq, vq, ks, vs, prior, mask, bits=bits,
                                          sm_scale=D ** -0.5, window=window, softcap=softcap)
    _close(got, ref)


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
