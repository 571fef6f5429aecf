"""kvpress_tpu_torch at head_dim 256 (Gemma-3 1B/4B/12B) against kvpress_tpu
on the CPU, in float32: each kernel's plain version (what its wrapper runs
on a CPU tensor) against the JAX Pallas kernel in interpret mode, at the
Hopper kernels' head_dim-256 geometry (32-key flash tiles, 64-key decode
steps, column-sum query stages of 64 rows). The Pallas kernels whose
softmax scratch is one 128-lane row wide (``flash_attention``,
``flash_attention_quant`` at int8, ``decode_attention`` at bf16 and int8)
do not trace at head_dim 256 (their rescale takes ``alpha[:, :D]``), so
those plain versions are held against the JAX package's dense reference
(``ops/attention.py``: ``attention_bias`` with ``gqa_attention`` or
``quant_gqa_attention``), as the JAX runner computes attention on the CPU;
the int4 payloads, the head-wise decode and the column sums against the
Pallas kernels. Then a tiny Gemma3 text model with head_dim 256, built in
``transformers`` and converted by both packages, through the port's pipeline on its kernel route (``attn_impl="flash"``) and
the JAX pipeline: the same kept key rows and greedy answers under Knorm and
``ObservedAttentionPress`` (the flash route's LSE and column sums). The
Hopper kernels themselves are held against these plain versions on the card
by tests/test_torch_kernels_card.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.cache import quantize_kv as jquantize
from kvpress_tpu.models.convert import from_torch_model as jfrom_torch
from kvpress_tpu.ops.decode import decode_attention as jdecode
from kvpress_tpu.ops.decode_headwise import decode_attention_headwise as jheadwise
from kvpress_tpu.ops.decode_headwise import prefix_tail_from_mask as jprefix_tail
from kvpress_tpu.ops import attention as jatt
from kvpress_tpu.ops.flash import flash_attention_quant as jflash_quant
from kvpress_tpu.ops.observed_colsum import observed_colsums_flash as jcolsums
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.cache import quantize_kv
from kvpress_tpu_torch.ops import decode as tdec
from kvpress_tpu_torch.ops import decode_headwise as thw
from kvpress_tpu_torch.ops import flash as tfl
from kvpress_tpu_torch.ops import observed_colsum as toc
from toy_tokenizer import ToyTokenizer

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

D = 256
# float32 on both sides, sums taken in another order: the tolerances of
# tests/test_torch_kernels_plain.py (2e-5, 3e-5 over a quantized payload)
# and of the model tests (1e-4).
ATOL, QATOL, TOL = 2e-5, 3e-5, 1e-4


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


def _jax_dense(q, k, v, prior, mask, *, sm_scale, window=None, softcap=None, bits=None,
               scales=None, extra_allow=None, length=None):
    """The JAX package's dense attention as its runner computes it on the
    CPU: (out (B, Hq, T, D), row logsumexp (B, Hq, T); None over a quantized
    payload). ``length`` hides the slots from it on (a decode call's
    buffer)."""
    T, S = q.shape[2], k.shape[2]
    if length is not None:
        mask = mask & (np.arange(S) < length)
    bias = jatt.attention_bias(
        jnp.asarray(prior, jnp.int32), T, S, sliding_window=window, head_mask=jnp.asarray(mask),
        extra_allow=None if extra_allow is None else jnp.asarray(extra_allow))
    q, k, v = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    if bits is not None:
        out = jatt.quant_gqa_attention(q, k, v, *scales, bias, sm_scale, bits, softcap=softcap)
        return np.asarray(out), None
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
    # B, Hq, Hkv, T, S, prior, window, softcap, splits: a keep-mask behind a
    # prior that is no multiple of the 32-key tile, a window with softcap,
    # and a question over a longer cache cut into key ranges of 32-key tiles
    "keep-mask, prior": (1, 4, 2, 70, 170, 100, None, None, 1),
    "window, softcap": (1, 4, 2, 96, 96, 0, 40, 30.0, 1),
    "split ranges": (1, 4, 2, 20, 300, 280, None, None, 3),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_plain_matches_jax(case):
    """``flash_attention``'s plain version (and, split, the plain version of
    a split launch's arithmetic at 32-key tiles), output and row LSE."""
    B, Hq, Hkv, T, S, prior, window, softcap, splits = FLASH_CASES[case]
    q, k, v, mask = _inputs(list(FLASH_CASES).index(case), B, Hq, Hkv, T, S)
    kw = dict(sm_scale=D ** -0.5, window=window, softcap=softcap, return_lse=True)
    wo, wl = _jax_dense(q, k, v, prior, mask, sm_scale=D ** -0.5, window=window,
                        softcap=softcap)
    args = (_t(q), _t(k), _t(v), prior, _t(mask))
    go, gl = tfl.flash_attention(*args, **kw)
    if splits > 1:
        go, gl = tfl.flash_attention_split_plain(*args, splits=splits, **kw)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), atol=ATOL)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=2e-4)


def test_flash_or_mask_plain_matches_jax():
    """The same-image or-mask at GQA 4/2 with a window shorter than a span,
    spans across the 32-key tiles; the split plain version agrees."""
    B, Hq, Hkv, T, S = 1, 4, 2, 160, 160
    q, k, v, mask = _inputs(7, B, Hq, Hkv, T, S)
    kg = np.full((B, S), -1, np.int32)
    kg[:, 20:60] = 0
    kg[:, 100:133] = 1
    qg = kg.copy()
    kw = dict(sm_scale=D ** -0.5, window=24, or_span=40, return_lse=True)
    same = (qg[:, :, None] >= 0) & (qg[:, :, None] == kg[:, None, :])
    wo, wl = _jax_dense(q, k, v, 0, mask, sm_scale=D ** -0.5, window=24, extra_allow=same)
    args = (_t(q), _t(k), _t(v), 0, _t(mask), _t(qg), _t(kg))
    go, gl = tfl.flash_attention(*args, **kw)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=TOL, rtol=TOL)
    so, sl = tfl.flash_attention_split_plain(*args, splits=3, **kw)
    np.testing.assert_allclose(so.numpy(), go.numpy(), atol=TOL, rtol=TOL)
    plain = tfl.flash_attention_plain(*args[:5], **{**kw, "or_span": None})[0]
    assert (plain - go).abs().max() > 1e-3       # the or-mask matters here


@pytest.mark.parametrize("bits", [8, 4])
def test_flash_quant_plain_matches_jax(bits):
    """``flash_attention_quant`` over int8 and int4 payloads behind a prior,
    with a window and softcap (int4 also against the Pallas kernel); then the
    split launch's plain version."""
    B, Hq, Hkv, T, S, prior = 1, 4, 2, 70, 230, 160
    q, k, v, mask = _inputs(bits, B, Hq, Hkv, T, S)
    kw = dict(bits=bits, sm_scale=D ** -0.5, window=100, softcap=30.0)
    (jk, jks), (jv, jvs) = jquantize(jnp.asarray(k), bits), jquantize(jnp.asarray(v), bits)
    (tk, tks), (tv, tvs) = quantize_kv(_t(k), bits), quantize_kv(_t(v), bits)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    want, _ = _jax_dense(q, jk, jv, prior, mask, sm_scale=D ** -0.5, window=100,
                         softcap=30.0, bits=bits, scales=(jks, jvs))
    args = (_t(q), tk, tv, tks, tvs, prior, _t(mask))
    got = tfl.flash_attention_quant(*args, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=QATOL)
    np.testing.assert_allclose(tfl.flash_attention_quant_split_plain(*args, splits=3, **kw)
                               .numpy(), want, atol=QATOL)
    if bits == 4:
        pallas = jflash_quant(jnp.asarray(q), jk, jv, jks, jvs, jnp.asarray(prior, jnp.int32),
                              jnp.asarray(mask), block_q=32, block_k=128, interpret=True, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=QATOL)


# bits, B, Hq, Hkv, T, S, length, window, softcap, splits, keep-mask: the
# decode kernel's 64-key steps at every payload, a split launch with a range
# that holds no live step, a window.
DECODE_CASES = [
    (None, 1, 4, 2, 1, 400, 333, None, None, 1, "random"),
    (None, 2, 4, 2, 4, 500, 450, None, 30.0, 3, "dead-range"),
    (8, 1, 4, 2, 1, 500, 433, 150, None, 2, "random"),
    (4, 1, 8, 2, 4, 640, 600, None, None, 3, "random"),
]


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[f"b{c[0]}T{c[4]}L{c[6]}n{c[9]}-{c[10]}" for c in DECODE_CASES])
def test_decode_plain_matches_jax(case):
    """``decode_attention``'s plain version, and the plain version of its
    split launch over ranges of 64-key steps (int4 also against the Pallas
    kernel)."""
    bits, B, Hq, Hkv, T, S, length, window, softcap, splits, kind = case
    q, k, v, mask = _inputs(length + splits, B, Hq, Hkv, T, S, p_keep=0.6)
    assert tdec.step_keys(D, bits) == 64
    if kind == "dead-range":
        lo, hi = tdec.decode_key_ranges(length, T, window, 64, splits)[1]
        mask[:, :, lo:hi] = False
    mask[:, :, length - T:length] = True
    kw = dict(sm_scale=D ** -0.5, window=window, softcap=softcap)
    if bits is None:
        jargs, targs = (k, v), (_t(k), _t(v), None, None)
        want, _ = _jax_dense(q, k, v, length - T, mask, length=length, **kw)
    else:
        (jk, jks), (jv, jvs) = jquantize(jnp.asarray(k), bits), jquantize(jnp.asarray(v), bits)
        (tk, tks), (tv, tvs) = quantize_kv(_t(k), bits), quantize_kv(_t(v), bits)
        jargs, targs = (jk, jv), (tk, tv, tks, tvs)
        want, _ = _jax_dense(q, jk, jv, length - T, mask, length=length, bits=bits,
                             scales=(jks, jvs), **kw)
    if bits == 4:
        pallas = jdecode(jnp.asarray(q), *jargs, jnp.asarray(length, jnp.int32),
                         k_scales=jks, v_scales=jvs, mask=jnp.asarray(mask), bits=bits,
                         block_k=256, interpret=True, **kw)
        np.testing.assert_allclose(np.asarray(pallas), want, atol=QATOL)
    got = tdec.decode_attention(_t(q), targs[0], targs[1], length, *targs[2:], _t(mask),
                                bits=bits, **kw)
    split = tdec.decode_attention_split_plain(_t(q), targs[0], targs[1], length, *targs[2:],
                                              _t(mask), bits=bits, splits=splits, **kw)
    tol = ATOL if bits is None else QATOL
    np.testing.assert_allclose(got.numpy(), want, atol=tol)
    np.testing.assert_allclose(split.numpy(), want, atol=tol)


@pytest.mark.parametrize("splits", [1, 3])
def test_headwise_plain_matches_pallas(splits):
    """``decode_attention_headwise``'s plain version over a cache compacted
    head by head (an empty head, a tail behind the longest prefix), and its
    split launch's plain version at 64-key steps."""
    B, Hq, Hkv, T, S, tail = 2, 4, 2, 1, 400, 6
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
    want = jheadwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     *jprefix_tail(jnp.asarray(mask), jnp.asarray(length)), block_k=128,
                     interpret=True, **kw)
    got = thw.decode_attention_headwise(_t(q), _t(k), _t(v), *ranges, **kw)
    split = thw.decode_attention_headwise_split_plain(_t(q), _t(k), _t(v), *ranges,
                                                      splits=splits, **kw)
    for x in (got, split):
        np.testing.assert_allclose(x.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("Hq,Hkv,S", [(4, 2, 130), (8, 1, 97)])
def test_lse_and_column_sums_match_pallas(Hq, Hkv, S, softcap):
    """The row-logsumexp pass (against the JAX dense logits' logsumexp) and
    the column sums (query stages of 64 rows at head_dim 256: 64 / G
    positions), with their own LSE and with the flash prefill's."""
    q, k, v, _ = _inputs(S + Hq, 1, Hq, Hkv, S, S)
    kw = dict(sm_scale=D ** -0.5, softcap=softcap)
    _, jlse = _jax_dense(q, k, v, 0, np.ones((1, Hkv, S), bool), **kw)
    lse = toc.observed_lse(_t(q), _t(k), **kw)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL, rtol=ATOL)
    want = jcolsums(jnp.asarray(q), jnp.asarray(k), block_q=64, block_k=128, interpret=True,
                    **kw)
    _, flash_lse = tfl.flash_attention(_t(q), _t(k), _t(v), 0, return_lse=True, **kw)
    for given in (None, flash_lse):
        got = toc.observed_colsums_flash(_t(q), _t(k), given, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_the_kernels_geometry_at_256():
    """What the wrappers and plain versions take from the kernels' geometry:
    32-key flash tiles (16 KB of bf16 keys), 64-key decode steps at every
    payload, the split counts at Gemma-3-12B's question and decode shapes
    (GQA 16/8), and the column sums' 32-bit offsets: at G 2 they take
    contexts below 4,194,304 tokens."""
    assert [tfl.key_tile(d) for d in (64, 128, 256)] == [128, 64, 32]
    assert [tdec.step_keys(D, b) for b in (None, 8, 4)] == [64, 64, 64]
    # 152 question tokens (3 q-tiles of 64 positions x 8 kv heads) over the
    # global layers' 16,536 slots, and over a sliding layer's window: 11
    # ranges bring the 24 blocks to about two a SM
    assert tfl.flash_splits(1, 8, 2, 152, 16536, D, 16384) == 11
    assert tfl.flash_splits(1, 8, 2, 152, 32920, D, 32768, 1024) == 11
    assert tdec.decode_splits(1, 8, 2, 1, 16600, D, 16537, 64) == 32
    toc._check_colsum(2, 4194303, D)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        toc._check_colsum(2, 4194304, D)


def test_wrappers_name_the_queue_of_head_dim_96():
    """Head_dim 96 has its instantiations now (Phi-3-mini): the check the
    CUDA wrappers run takes it beside 256, and refuses a width that no
    architecture has, naming the widths it takes."""
    tfl.check_head_dim(D)
    tfl.check_head_dim(96)
    with pytest.raises(ValueError, match="head_dim \\(64, 96, 128, 256\\), got 80"):
        tfl.check_head_dim(80)


# --------------------------------------------------------------------- #
# A tiny Gemma3 text model at head_dim 256, converted by both packages


@pytest.fixture(scope="module")
def gemma():
    from transformers import AutoModelForCausalLM, Gemma3TextConfig

    cfg = Gemma3TextConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                           num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
                           head_dim=D, max_position_embeddings=512, sliding_window=8,
                           layer_types=["sliding_attention", "full_attention",
                                        "sliding_attention"],
                           tie_word_embeddings=True, pad_token_id=0)
    torch.manual_seed(0)
    model = AutoModelForCausalLM.from_config(cfg).eval()
    # Norm weights off their init values: with q/k-norm every fresh key has
    # the same norm, and KnormPress would choose among ties.
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(torch.randn_like(p) * 0.3)
    params_j, cfg_j = jfrom_torch(model, dtype=jnp.float32)
    params_t, cfg_t = kt.from_torch_model(model, dtype=torch.float32, device="cpu")
    assert cfg_t.head_dim == D and cfg_t.sliding_flags() == (True, False, True)
    return cfg_j, cfg_t, params_j, params_t


class _Chunked(kt.ObservedAttentionPress):
    """The long-context route at a tiny size: the flash prefill's LSE and
    the column sums, no probabilities."""
    chunked_threshold = 0


class _JChunked(kj.ObservedAttentionPress):
    chunked_threshold = 0


PRESSES = {"knorm": (kt.KnormPress, kj.KnormPress),
           "observed": (_Chunked, _JChunked)}


def _kept_rows(cache, layer):
    """A layer's kept key rows, sorted by their first channel."""
    n = int(cache.length[layer])
    k = np.asarray(cache.keys[layer], np.float64)[:, :, :n]
    return np.take_along_axis(k, np.argsort(k[..., 0], -1)[..., None], -2)


@pytest.mark.parametrize("press", list(PRESSES))
def test_prefill_keeps_what_jax_keeps(gemma, press):
    """A prefill on the port's kernel route (the wrappers' plain versions):
    the same logits, lengths and kept key rows as the JAX runner; the global
    layer compressed, the sliding ones whole."""
    cfg_j, cfg_t, params_j, params_t = gemma
    T = 40
    ids = np.random.default_rng(3).permutation(np.arange(3, cfg_t.vocab_size))[:T][None]
    make_t, make_j = PRESSES[press]
    runner = kt.Runner.create(cfg_t, attn_impl="flash", decode_kernel=True, device="cpu")
    lt, ct, _ = runner.prefill(params_t, torch.from_numpy(ids), press=make_t(0.5),
                               dtype=torch.float32, compute_logits=True)
    lj, cj, _ = kj.Runner.create(cfg_j, attn_impl="xla").prefill(
        params_j, jnp.asarray(ids, jnp.int32), press=make_j(0.5), dtype=jnp.float32,
        compute_logits=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)
    assert ct.length.tolist() == np.asarray(cj.length).tolist() == [T, T // 2, T]
    for layer in range(3):
        np.testing.assert_allclose(_kept_rows(ct, layer), _kept_rows(cj, layer), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("press", list(PRESSES))
def test_pipeline_same_greedy_answers_as_jax(gemma, press):
    """Two questions (one longer than the decode kernel's 128-token reach is
    not needed here: both take the decode wrapper) and 6 new tokens each:
    the port's pipeline on the kernel route answers as the JAX pipeline."""
    cfg_j, cfg_t, params_j, params_t = gemma
    tok = ToyTokenizer(cfg_t.vocab_size)
    context = " ".join(f"w{i}" for i in range(36))
    kw = dict(questions=["w3 w4 ?", "what follows w7 ?"], max_new_tokens=6)
    make_t, make_j = PRESSES[press]
    pt = kt.KVPressPipeline(kt.Runner.create(cfg_t, attn_impl="flash", decode_kernel=True,
                                             device="cpu"), params_t, tok)
    pj = JaxPipeline(kj.Runner.create(cfg_j, attn_impl="xla"), params_j, tok)
    got = pt(context, press=make_t(0.5), **kw)["answers"]
    assert got == pj(context, press=make_j(0.5), **kw)["answers"]
    assert all(len(a.split()) == 6 for a in got)
