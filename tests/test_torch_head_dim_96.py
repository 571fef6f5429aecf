"""kvpress_tpu_torch at head_dim 96 (Phi-3-mini) against kvpress_tpu on the
CPU, in float32: each kernel's plain version (what its wrapper runs on a CPU
tensor) at the Hopper kernels' head_dim-96 geometry (64-key flash tiles: a
row laid out as head_dim 128's two panels; decode steps of 64 keys for bf16
and int8 and 128 for int4), held against the JAX Pallas kernel in interpret
mode: ``flash_attention`` (with the same-image or-mask too),
``flash_attention_quant`` at int8 and int4, ``decode_attention`` at every
payload and ``observed_colsums_flash``. The Pallas head-wise decode rejects
head_dim 96 (``kvpress_tpu/ops/decode_headwise.py`` asserts it), so the
head-wise plain version is held against the JAX package's dense attention
(``ops/attention.py``), and so is the row-logsumexp pass. Then a tiny Phi3
model with head_dim 96 and one query head per kv head, built in
``transformers`` and converted by both packages, through the port's
pipeline on its kernel route (``attn_impl="flash"``) and the JAX pipeline:
the same kept key rows and greedy answers under Knorm (float32 and int8 KV),
``ObservedAttentionPress`` on its route without probabilities (the column
sums), and ``AdaKVPress(KnormPress, compact=True)`` decoded head by head. The
Hopper kernels themselves are held against these plain versions on the card by
tests/test_torch_kernels_card.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.cache import quantize_kv as jquantize
from kvpress_tpu.models.convert import from_torch_model as jfrom_torch
from kvpress_tpu.ops import attention as jatt
from kvpress_tpu.ops.decode import decode_attention as jdecode
from kvpress_tpu.ops.flash import flash_attention as jflash
from kvpress_tpu.ops.flash import flash_attention_quant as jflash_quant
from kvpress_tpu.ops.observed_colsum import observed_colsums_flash as jcolsums
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.cache import quantize_kv
from kvpress_tpu_torch.ops import decode as tdec
from kvpress_tpu_torch.ops import decode_headwise as thw
from kvpress_tpu_torch.ops import flash as tfl
from kvpress_tpu_torch.ops import observed_colsum as toc
from kvpress_tpu_torch.presses import snapkv as tsnap
from toy_tokenizer import ToyTokenizer

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

D = 96
# float32 on both sides, sums taken in another order: the tolerances of
# tests/test_torch_kernels_plain.py (2e-5, 3e-5 over a quantized payload; a
# row logsumexp 2e-4) and of the model tests (1e-4).
ATOL, QATOL, LSE_TOL, TOL = 2e-5, 3e-5, 2e-4, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, B, Hq, Hkv, T, S, p_keep=0.8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    mask = rng.random((B, Hkv, S)) < p_keep
    mask[:, :, :8] = True
    return q, k, v, mask


def _jax_dense(q, k, v, prior, mask, *, sm_scale, softcap=None, length=None):
    """The JAX package's dense attention as its runner computes it on the
    CPU: (out (B, Hq, T, D), row logsumexp (B, Hq, T)). ``length`` hides the
    slots from it on (a decode call's buffer)."""
    T, S = q.shape[2], k.shape[2]
    if length is not None:
        mask = mask & (np.arange(S) < length)
    bias = jatt.attention_bias(jnp.asarray(prior, jnp.int32), T, S,
                               head_mask=jnp.asarray(mask))
    q, k, v = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    out, _ = jatt.gqa_attention(q, k, v, bias, sm_scale, softcap=softcap)
    B, Hq, _, Dh = q.shape
    Hkv = k.shape[1]
    logits = jnp.einsum("bhgtd,bhsd->bhgts", q.reshape(B, Hkv, Hq // Hkv, T, Dh), k) * sm_scale
    if softcap is not None:
        logits = jnp.tanh(logits / softcap) * softcap
    logits = logits + (bias[None, None, None] if bias.ndim == 2 else bias[:, :, None])
    return np.asarray(out), np.asarray(jax.nn.logsumexp(logits, -1).reshape(B, Hq, T))


# --------------------------------------------------------------------- #
# The kernels' plain versions against the JAX reference

FLASH_CASES = {
    # B, Hq, Hkv, T, S, prior, window, softcap, splits: one query head per kv
    # head behind a prior that is no multiple of the 64-key tile, a window
    # with softcap, and a question over a longer cache cut into key ranges
    "keep-mask, prior, MHA": (1, 2, 2, 70, 170, 100, None, None, 1),
    "window, softcap": (1, 4, 2, 96, 96, 0, 40, 30.0, 1),
    "split ranges, MHA": (1, 2, 2, 20, 300, 280, None, None, 3),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_plain_matches_pallas(case):
    """``flash_attention``'s plain version (and, split, the plain version of
    a split launch's arithmetic over 64-key tiles) against the Pallas
    kernel: output and row LSE."""
    B, Hq, Hkv, T, S, prior, window, softcap, splits = FLASH_CASES[case]
    q, k, v, mask = _inputs(list(FLASH_CASES).index(case), B, Hq, Hkv, T, S)
    kw = dict(sm_scale=D ** -0.5, window=window, softcap=softcap, return_lse=True)
    wo, wl = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(prior, jnp.int32), jnp.asarray(mask), block_q=32, block_k=128,
                    interpret=True, **kw)
    args = (_t(q), _t(k), _t(v), prior, _t(mask))
    go, gl = tfl.flash_attention(*args, **kw)
    if splits > 1:
        go, gl = tfl.flash_attention_split_plain(*args, splits=splits, **kw)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), atol=ATOL)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=LSE_TOL)


def test_flash_or_mask_plain_matches_pallas():
    """The same-image or-mask at one query head per kv head with a window
    shorter than a span, spans across the 64-key tiles, against the Pallas
    kernel; the split plain version agrees."""
    B, Hq, Hkv, T, S = 1, 2, 2, 160, 160
    q, k, v, mask = _inputs(7, B, Hq, Hkv, T, S)
    kg = np.full((B, S), -1, np.int32)
    kg[:, 20:60] = 0
    kg[:, 100:133] = 1
    qg = kg.copy()
    kw = dict(sm_scale=D ** -0.5, window=24, or_span=40, return_lse=True)
    wo, wl = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(0, jnp.int32),
                    jnp.asarray(mask), jnp.asarray(qg), jnp.asarray(kg), block_q=32,
                    block_k=128, interpret=True, **kw)
    args = (_t(q), _t(k), _t(v), 0, _t(mask), _t(qg), _t(kg))
    go, gl = tfl.flash_attention(*args, **kw)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=TOL, rtol=TOL)
    so, _ = tfl.flash_attention_split_plain(*args, splits=3, **kw)
    np.testing.assert_allclose(so.numpy(), go.numpy(), atol=TOL, rtol=TOL)
    plain = tfl.flash_attention_plain(*args[:5], **{**kw, "or_span": None})[0]
    assert (plain - go).abs().max() > 1e-3       # the or-mask matters here


@pytest.mark.parametrize("bits", [8, 4])
def test_flash_quant_plain_matches_pallas(bits):
    """``flash_attention_quant`` over int8 rows of 96 bytes and int4 rows of
    48 (the payload split at D/2 = 48) behind a prior, with a window and
    softcap, against the Pallas kernel; then the split launch's plain
    version."""
    B, Hq, Hkv, T, S, prior = 1, 2, 2, 70, 230, 160
    q, k, v, mask = _inputs(bits, B, Hq, Hkv, T, S)
    kw = dict(bits=bits, sm_scale=D ** -0.5, window=100, softcap=30.0)
    (jk, jks), (jv, jvs) = jquantize(jnp.asarray(k), bits), jquantize(jnp.asarray(v), bits)
    (tk, tks), (tv, tvs) = quantize_kv(_t(k), bits), quantize_kv(_t(v), bits)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert tk.shape[-1] == (D if bits == 8 else D // 2)
    want = jflash_quant(jnp.asarray(q), jk, jv, jks, jvs, jnp.asarray(prior, jnp.int32),
                        jnp.asarray(mask), block_q=32, block_k=128, interpret=True, **kw)
    args = (_t(q), tk, tv, tks, tvs, prior, _t(mask))
    got = tfl.flash_attention_quant(*args, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=QATOL)
    np.testing.assert_allclose(tfl.flash_attention_quant_split_plain(*args, splits=3, **kw)
                               .numpy(), np.asarray(want), atol=QATOL)


# bits, B, Hq, Hkv, T, S, length, window, softcap, splits, keep-mask: the
# decode kernel's steps (64 keys for bf16 and int8, 128 for int4) at every
# payload, a split launch with a range that holds no live step, a window.
DECODE_CASES = [
    (None, 1, 2, 2, 1, 400, 333, None, None, 1, "random"),
    (None, 2, 4, 2, 4, 500, 450, None, 30.0, 3, "dead-range"),
    (8, 1, 2, 2, 1, 500, 433, 150, None, 2, "random"),
    (4, 1, 4, 4, 4, 700, 650, None, None, 3, "dead-range"),
]


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[f"b{c[0]}T{c[4]}L{c[6]}n{c[9]}-{c[10]}" for c in DECODE_CASES])
def test_decode_plain_matches_pallas(case):
    """``decode_attention``'s plain version, and the plain version of its
    split launch over ranges of whole steps, against the Pallas kernel."""
    bits, B, Hq, Hkv, T, S, length, window, softcap, splits, kind = case
    q, k, v, mask = _inputs(length + splits, B, Hq, Hkv, T, S, p_keep=0.6)
    nk = tdec.step_keys(D, bits)
    assert nk == (128 if bits == 4 else 64)
    if kind == "dead-range":
        lo, hi = tdec.decode_key_ranges(length, T, window, nk, splits)[1]
        assert hi > lo
        mask[:, :, lo:hi] = False
    mask[:, :, length - T:length] = True
    kw = dict(sm_scale=D ** -0.5, window=window, softcap=softcap)
    if bits is None:
        jargs, jscales, targs = (jnp.asarray(k), jnp.asarray(v)), {}, (_t(k), _t(v), None, None)
    else:
        (jk, jks), (jv, jvs) = jquantize(jnp.asarray(k), bits), jquantize(jnp.asarray(v), bits)
        (tk, tks), (tv, tvs) = quantize_kv(_t(k), bits), quantize_kv(_t(v), bits)
        jargs, jscales, targs = (jk, jv), dict(k_scales=jks, v_scales=jvs), (tk, tv, tks, tvs)
    want = jdecode(jnp.asarray(q), *jargs, jnp.asarray(length, jnp.int32), mask=jnp.asarray(mask),
                   bits=bits, block_k=256, interpret=True, **jscales, **kw)
    got = tdec.decode_attention(_t(q), targs[0], targs[1], length, *targs[2:], _t(mask),
                                bits=bits, **kw)
    split = tdec.decode_attention_split_plain(_t(q), targs[0], targs[1], length, *targs[2:],
                                              _t(mask), bits=bits, splits=splits, **kw)
    tol = ATOL if bits is None else QATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)
    np.testing.assert_allclose(split.numpy(), np.asarray(want), atol=tol)


@pytest.mark.parametrize("splits", [1, 3])
def test_headwise_plain_matches_dense(splits):
    """``decode_attention_headwise``'s plain version over a cache compacted
    head by head (an empty head, a tail behind the longest prefix), and its
    split launch's plain version at 64-key steps, against the JAX dense
    attention under the same keep-mask (the Pallas head-wise kernel rejects
    head_dim 96)."""
    B, Hq, Hkv, T, S, tail = 2, 2, 2, 1, 400, 6
    q, k, v, _ = _inputs(splits, B, Hq, Hkv, T, S)
    rng = np.random.default_rng(splits)
    prefix = rng.integers(5, S - tail - 16, (B, Hkv)).astype(np.int32)
    prefix[0, 0] = 0
    tail_start = int(prefix.max()) + 7
    length = tail_start + tail
    mask = np.arange(S)[None, None] < prefix[..., None]
    mask[:, :, tail_start:length] = True
    ranges = thw.prefix_tail_from_mask(_t(mask), length)
    kw = dict(sm_scale=D ** -0.5, softcap=30.0)
    want, _ = _jax_dense(q, k, v, length - T, mask, length=length, **kw)
    got = thw.decode_attention_headwise(_t(q), _t(k), _t(v), *ranges, **kw)
    split = thw.decode_attention_headwise_split_plain(_t(q), _t(k), _t(v), *ranges,
                                                      splits=splits, **kw)
    for x in (got, split):
        np.testing.assert_allclose(x.numpy(), want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("Hq,Hkv,S", [(2, 2, 130), (4, 2, 97), (8, 2, 70), (8, 1, 65)])
def test_lse_and_column_sums_match_pallas(Hq, Hkv, S, softcap):
    """The row-logsumexp pass (against the JAX dense logits' logsumexp) and
    the column sums at 1, 2, 4 and 8 query heads per kv head (against the
    Pallas kernel), with their own LSE and with the flash prefill's."""
    q, k, v, _ = _inputs(S + Hq, 1, Hq, Hkv, S, S)
    kw = dict(sm_scale=D ** -0.5, softcap=softcap)
    _, jlse = _jax_dense(q, k, v, 0, np.ones((1, Hkv, S), bool), **kw)
    lse = toc.observed_lse(_t(q), _t(k), **kw)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=ATOL, rtol=ATOL)
    want = jcolsums(jnp.asarray(q), jnp.asarray(k), block_q=64, block_k=128, interpret=True,
                    **kw)
    _, flash_lse = tfl.flash_attention(_t(q), _t(k), _t(v), 0, return_lse=True, **kw)
    for given in (None, flash_lse):
        got = toc.observed_colsums_flash(_t(q), _t(k), given, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_the_kernels_geometry_at_96():
    """What the wrappers and plain versions take from the kernels' geometry:
    64-key flash tiles (head_dim 128's two panels), decode steps of 64, 64
    and 128 keys (whole 64-key steps of 8 KB of K payload), the split
    counts at Phi-3-mini's question and decode shapes (32 kv heads, one
    query head each), and the column sums' 32-bit offsets: at G 1 they take
    contexts below 22,369,622 tokens."""
    assert [tfl.key_tile(d) for d in (64, 96, 128, 256)] == [128, 64, 64, 32]
    assert [tdec.step_keys(D, b) for b in (None, 8, 4)] == [64, 64, 128]
    # the steps of the other head_dims are as they were
    assert [tdec.step_keys(64, b) for b in (None, 8, 4)] == [64, 128, 256]
    assert [tdec.step_keys(128, b) for b in (None, 8, 4)] == [64, 64, 128]
    # 152 question tokens (2 q-tiles of 128 positions x 32 kv heads) over the
    # 2,072 slots Knorm leaves of 3,840 and the question: 5 ranges bring the
    # 64 blocks to about two a SM
    assert tfl.flash_splits(1, 32, 1, 152, 2072, D, 1920) == 5
    # decode at B1 over 2,105 slots: 4 blocks a kv head
    assert tdec.decode_splits(1, 32, 1, 1, 2105, D, 2073, 64) == 8
    toc._check_colsum(1, 22369621, D)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        toc._check_colsum(1, 22369622, D)


def test_wrappers_take_head_dim_96():
    """Head_dim 96 has its instantiations: the check the CUDA wrappers run
    takes it and refuses a width no architecture has, and each wrapper
    counts its launches at 96 by kind."""
    tfl.check_head_dim(D)
    with pytest.raises(ValueError, match="got 80"):
        tfl.check_head_dim(80)
    assert (D, "or_mask") in tfl.flash_attention.launches_by_kind
    assert (D, "int4") in tfl.flash_attention_quant.launches_by_kind
    assert (D, "int8") in tdec.decode_attention.launches_by_kind
    assert (D, "bf16") in thw.decode_attention_headwise.launches_by_kind
    assert (D, "bf16") in toc.observed_colsums_flash.launches_by_kind


# --------------------------------------------------------------------- #
# A tiny Phi3 model at head_dim 96, converted by both packages


@pytest.fixture(scope="module")
def phi3():
    from transformers import AutoModelForCausalLM, Phi3Config

    cfg = Phi3Config(vocab_size=256, hidden_size=2 * D, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
                     max_position_embeddings=512, rope_theta=10000.0, sliding_window=2047,
                     tie_word_embeddings=False, pad_token_id=0, bos_token_id=1,
                     eos_token_id=2)
    torch.manual_seed(0)
    model = AutoModelForCausalLM.from_config(cfg).eval()
    # Norm weights off their init values, as tests/test_torch_models.py does.
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(torch.randn_like(p) * 0.3)
    params_j, cfg_j = jfrom_torch(model, dtype=jnp.float32)
    params_t, cfg_t = kt.from_torch_model(model, dtype=torch.float32, device="cpu")
    # Phi3's sliding_window is dropped on both sides: every layer is global
    assert cfg_t.head_dim == cfg_j.head_dim == D
    assert cfg_t.sliding_window is None and cfg_j.sliding_window is None
    return cfg_j, cfg_t, params_j, params_t


class _Chunked(kt.ObservedAttentionPress):
    """The long-context route at a tiny size: the flash prefill's LSE and
    the column sums, no probabilities."""
    chunked_threshold = 0


class _JChunked(kj.ObservedAttentionPress):
    chunked_threshold = 0


# name: (port press, JAX press, the port's runner options, KV options, the
# plain versions that must have run)
PRESSES = {
    "knorm": (lambda: kt.KnormPress(0.5), lambda: kj.KnormPress(0.5), dict(decode_kernel=True),
              {}, ("flash_attention_plain", "decode_attention_plain")),
    "knorm_int8": (lambda: kt.KnormPress(0.5), lambda: kj.KnormPress(0.5),
                   dict(decode_kernel=True), dict(quantized=True, kv_bits=8),
                   ("flash_attention_plain", "decode_attention_plain")),
    "observed": (lambda: _Chunked(0.5), lambda: _JChunked(0.5), dict(decode_kernel=True), {},
                 ("flash_attention_plain", "chunked_observed_colsums", "decode_attention_plain")),
    "adakv_compact": (lambda: kt.AdaKVPress(kt.KnormPress(0.5), compact=True),
                      lambda: kj.AdaKVPress(kj.KnormPress(0.5), compact=True),
                      dict(decode_kernel=False, headwise_kernel=True), {},
                      ("flash_attention_plain", "decode_attention_headwise_plain")),
}
# Where each runs from. Without probabilities the press takes its column
# sums on the CPU by the chunked sweep (on the card by the column-sum kernel,
# whose plain version is held against the Pallas kernel above).
PLAIN_MODULES = {"flash_attention_plain": tfl, "decode_attention_plain": tdec,
                 "chunked_observed_colsums": tsnap, "decode_attention_headwise_plain": thw}


def _kept_rows(keys, mask, n):
    """A layer's kept key rows (the live slots of each head below ``n``),
    sorted by their first channel. ``keys`` (B, Hkv, S, D), ``mask`` (B,
    Hkv, S) or None."""
    keys = np.asarray(keys, np.float64)
    live = np.ones(keys.shape[:3], bool) if mask is None else np.asarray(mask, bool)
    rows = [keys[b, h, :n][live[b, h, :n]] for b in range(keys.shape[0])
            for h in range(keys.shape[1])]
    return [r[np.argsort(r[:, 0])] for r in rows]


def _layer_keys(cache, layer, dequantize, dtype):
    """A layer's keys as values: an int8 cache's payload times its scales."""
    if cache.key_scales is None:
        return cache.keys[layer]
    return dequantize(cache.keys[layer], cache.key_scales[layer], cache.bits, dtype)


@pytest.mark.parametrize("press", list(PRESSES))
def test_prefill_keeps_what_jax_keeps(phi3, press):
    """A prefill on the port's kernel route (the wrappers' plain versions):
    the same logits, lengths and kept key rows as the JAX runner. 160
    tokens, past the decode kernel's 128-token reach: the prefill takes the
    flash wrapper, which attends the new block at full precision, as the
    JAX dense route does."""
    cfg_j, cfg_t, params_j, params_t = phi3
    T = 160
    ids = np.random.default_rng(3).permutation(np.arange(3, cfg_t.vocab_size))[:T][None]
    make_t, make_j, options, kv, _ = PRESSES[press]
    runner = kt.Runner.create(cfg_t, attn_impl="flash", device="cpu", **options)
    lt, ct, _ = runner.prefill(params_t, torch.from_numpy(ids), press=make_t(),
                               dtype=torch.float32, compute_logits=True, **kv)
    lj, cj, _ = kj.Runner.create(cfg_j, attn_impl="xla").prefill(
        params_j, jnp.asarray(ids, jnp.int32), press=make_j(), dtype=jnp.float32,
        compute_logits=True, **kv)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)
    assert ct.length.tolist() == np.asarray(cj.length).tolist()
    if press != "adakv_compact":
        assert ct.length.tolist() == [T // 2] * cfg_t.num_layers
    # An int8 code may round the other way on the two sides: one step of
    # the row's scale.
    atol = TOL if not kv else 1.01 * float(ct.key_scales.max())
    for layer in range(cfg_t.num_layers):
        n = int(ct.length[layer])
        got = _kept_rows(_layer_keys(ct, layer, kt.dequantize_kv, torch.float32),
                         None if ct.mask is None else ct.mask[layer], n)
        want = _kept_rows(_layer_keys(cj, layer, kj.cache.dequantize_kv, jnp.float32),
                          None if cj.mask is None else cj.mask[layer], n)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=atol, rtol=TOL)


@pytest.mark.parametrize("press", list(PRESSES))
def test_pipeline_same_greedy_answers_as_jax(phi3, press, monkeypatch):
    """Two questions and 6 new tokens each over a 150-word context: the
    port's pipeline on the kernel route answers as the JAX pipeline, and the
    kernels' plain versions ran (a wrapper on a CPU tensor runs its plain
    version; the column sums, the chunked sweep)."""
    cfg_j, cfg_t, params_j, params_t = phi3
    tok = ToyTokenizer(cfg_t.vocab_size)
    context = " ".join(f"w{i}" for i in range(150))
    make_t, make_j, options, kv, plains = PRESSES[press]
    kw = dict(questions=["w3 w4 ?", "what follows w7 ?"], max_new_tokens=6, **kv)
    calls = dict.fromkeys(plains, 0)
    for name in plains:
        module = PLAIN_MODULES[name]

        def counting(*args, _real=getattr(module, name), _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, name, counting)
    pt = kt.KVPressPipeline(kt.Runner.create(cfg_t, attn_impl="flash", device="cpu", **options),
                            params_t, tok)
    pj = JaxPipeline(kj.Runner.create(cfg_j, attn_impl="xla"), params_j, tok)
    got = pt(context, press=make_t(), **kw)["answers"]
    assert got == pj(context, press=make_j(), **kw)["answers"]
    assert all(len(a.split()) == 6 for a in got)
    assert all(calls.values()), calls
