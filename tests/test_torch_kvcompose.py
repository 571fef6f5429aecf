"""KVComposePress in kvpress_tpu_torch against the JAX package on the same
weights and inputs (CPU, float32, tiny config; the port on its kernel routes,
whose plain versions run here): the composite budgets and masks with tied
scores, ``refeed_colagg`` (max and sum, softcap, int8 and int4 blocks, a
context that is not a block multiple), the chunked re-feed's partials, the
chunked scoring against the one-shot collector (JAX's
test_kvcompose_chunked_refeed_matches_oneshot cases), the structured rebuild's
cache bit-equal to JAX's (payloads, scales, per-layer lengths), the
unstructured masks, ``add_v_norm``, the pipelines over float32 and int8 KV,
and the sliding-config refusal.

Tolerances: aggregated probabilities within 1e-6 absolute / 1e-5 relative;
budgets, masks, rebuilt caches and answers equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu import presses as jp
from kvpress_tpu.ops.attention import refeed_colagg as j_colagg
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.ops.attention import refeed_colagg
from torch_multipass_cases import Pipelines, assert_same, make_press
from torch_scorer_cases import seeded_ids

torch.set_num_threads(2)

TOL = dict(atol=1e-6, rtol=1e-5)
S = 64
KV = {"float32": dict(quantized=False, kv_bits=8), "int8": dict(quantized=True, kv_bits=8),
      "int4": dict(quantized=True, kv_bits=4)}
NO_ART = (None, (None, None, None))


@pytest.fixture(scope="module")
def pipes():
    return Pipelines.tiny(n_words=70)


def _both(name):
    return make_press(jp, name, NO_ART), make_press(kt, name, NO_ART)


# --------------------------------------------------------------------- #
# Budgets and masks


@pytest.mark.parametrize("structured", [True, False])
@pytest.mark.parametrize("kw", [{}, dict(agg_head="max", keep_token_lower_bound=3),
                                dict(add_mean_across_heads=False, compression_ratio=0.7)])
def test_budgets_and_masks_with_ties_match_jax(structured, kw):
    """Scores rounded to a tenth, so that most tie (stable sorts on both
    sides)."""
    rng = np.random.default_rng(2)
    scores = np.round(rng.random((3, 2, 40)), 1).astype(np.float32)
    values = rng.standard_normal((3, 2, 40, 8)).astype(np.float32)
    kw = dict(dict(compression_ratio=0.5, structured=structured), **kw)
    for v in (None, values):
        args = dict(kw, add_v_norm=v is not None)
        want = jp.KVComposePress(**args).budgets_and_masks(scores, v)
        got = kt.KVComposePress(**args).budgets_and_masks(scores, v)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        if structured:
            assert (got[1].sum(-1) == got[0][:, None]).all()


# --------------------------------------------------------------------- #
# refeed_colagg


@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("agg", ["max", "sum"])
@pytest.mark.parametrize("softcap", [None, 20.0])
def test_refeed_colagg_matches_jax(agg, softcap, bits):
    """A ragged context of 75 columns in blocks of 16, the re-feed's 12
    queries after a 100-slot prior; the lse each query's own over its
    visible range."""
    rng = np.random.default_rng(3)
    B, Hq, Hkv, T, D, ctx, S_buf = 1, 4, 2, 12, 16, 75, 120
    q = rng.standard_normal((B, Hq, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S_buf, D)).astype(np.float32)
    lse = (rng.standard_normal((B, Hq, T)) + 6).astype(np.float32)
    kt_k, ks_t = torch.from_numpy(k), None
    kj_k, ks_j = jnp.asarray(k), None
    if bits:
        kt_k, ks_t = kt.quantize_kv(torch.from_numpy(k), bits)
        kj_k, ks_j = jnp.asarray(kt_k.numpy()), jnp.asarray(ks_t.numpy())
    args = (lse, ctx, agg, 0.25, softcap)
    got = refeed_colagg(torch.from_numpy(q), kt_k, ks_t, bits or 8, torch.from_numpy(lse),
                        *args[1:], block=16)
    want = j_colagg(jnp.asarray(q), kj_k, ks_j, bits or 8, jnp.asarray(lse), *args[1:],
                    block=16)
    assert got.shape == (B, Hq, ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the block size does not change the result
    again = refeed_colagg(torch.from_numpy(q), kt_k, ks_t, bits or 8, torch.from_numpy(lse),
                          *args[1:], block=512)
    np.testing.assert_allclose(again.numpy(), got.numpy(), **TOL)


# --------------------------------------------------------------------- #
# The chunked re-feed


def _runners(p):
    return (kj.Runner.create(p.cfg_j, attn_impl="xla"),
            kt.Runner.create(p.cfg_t, attn_impl="flash", decode_kernel=True, device="cpu"))


@pytest.mark.parametrize("agg", ["max", "mean"])
@pytest.mark.parametrize("kv", list(KV))
def test_refeed_pass_partials_match_jax(pipes, kv, agg):
    """The first two 16-token chunks of the re-feed over a 64-token context
    in a 128-slot buffer: each pass's (L, B, Hq, 64) partial, the length and
    offset advanced by the chunk, the context's slots untouched."""
    p = pipes
    ids = seeded_ids(p.cfg_t.vocab_size, S, 12)
    rj, rt = _runners(p)
    _, cj, _ = rj.prefill(p.params_j, jnp.asarray(ids), max_size=2 * S, dtype=jnp.float32,
                          **KV[kv])
    _, ct, _ = rt.prefill(p.params_t, torch.from_numpy(ids).long(), max_size=2 * S, **KV[kv])
    before = [t[:, :, :, :S].clone() for t in (ct.keys, ct.values)]
    for start in (0, 16):
        chunk = ids[:, start:start + 16]
        cj, want = rj.kvcompose_refeed_pass(p.params_j, jnp.asarray(chunk), cj, S, agg)
        ct, got = rt.kvcompose_refeed_pass(p.params_t, torch.from_numpy(chunk).long(), ct, S,
                                           agg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert ct.length.tolist() == np.asarray(cj.length).tolist()
        assert int(ct.offset) == int(cj.offset) == S + start + 16
    assert all(torch.equal(t[:, :, :, :S], b) for t, b in zip((ct.keys, ct.values), before))


@pytest.mark.parametrize("structured", [True, False])
@pytest.mark.parametrize("agg", [("max", "mean"), ("mean", "max")])
def test_chunked_refeed_matches_one_shot(pipes, structured, agg):
    """JAX's test_kvcompose_chunked_refeed_matches_oneshot: the same answers
    one-shot and with context_chunk=16, and JAX's."""
    p = pipes
    context, question = p.context()
    press = kt.KVComposePress(compression_ratio=0.5, structured=structured, agg_task=agg[0],
                              agg_group=agg[1])
    tpipe = p.torch_pipe()
    one = tpipe(context, question=question, press=press, max_new_tokens=6)
    chunked = tpipe(context, question=question, press=press, max_new_tokens=6,
                    context_chunk=16)
    assert one == chunked


def _rebuild_both(p, name, kv, chunk):
    """_run_kvcompose in both packages on the same prefilled cache (a
    128-slot buffer)."""
    ids = seeded_ids(p.cfg_t.vocab_size, S, 13)
    rj, rt = _runners(p)
    jpress, tpress = _both(name)
    _, cj, _ = rj.prefill(p.params_j, jnp.asarray(ids), max_size=2 * S, dtype=jnp.float32,
                          **KV[kv])
    _, ct, _ = rt.prefill(p.params_t, torch.from_numpy(ids).long(), max_size=2 * S, **KV[kv])
    jpipe, tpipe = p.jax_pipe(), p.torch_pipe()
    ctx_ids = ids[0].tolist()
    cj = jpipe._run_kvcompose(cj, ctx_ids, jpress, context_chunk=chunk)
    ct = tpipe._run_kvcompose(ct, ctx_ids, tpress, context_chunk=chunk)
    return cj, ct


@pytest.mark.parametrize("chunk", [None, 16])
@pytest.mark.parametrize("kv", list(KV))
def test_structured_rebuild_matches_jax(pipes, monkeypatch, kv, chunk):
    """The budgets (per-layer lengths) equal JAX's and the kept entries
    match (within 1e-5, or one code of their scale over a quantized cache:
    the two prefills round K and V apart); JAX's in-place rebuild
    (``_kvcompose_rebuild_layer``), given the port's prefilled cache and
    keep-mask, gives the port's kept payloads and scales bit for bit."""
    import kvpress_tpu.pipeline as jpipeline
    from kvpress_tpu.cache import KVCache as JaxCache

    p = pipes
    seen = []
    original = kt.KVComposePress.budgets_and_masks
    monkeypatch.setattr(kt.KVComposePress, "budgets_and_masks",
                        lambda self, s, v: seen.append(original(self, s, v)) or seen[-1])
    before = []
    orig_run = kt.KVPressPipeline._run_kvcompose

    def keep_copy(self, cache, *a, **kw):
        before.append({n: None if getattr(cache, n) is None else getattr(cache, n).clone()
                       for n in ("keys", "values", "key_scales", "value_scales")})
        return orig_run(self, cache, *a, **kw)

    monkeypatch.setattr(kt.KVPressPipeline, "_run_kvcompose", keep_copy)
    cj, ct = _rebuild_both(p, "kvcompose", kv, chunk)
    lengths = np.asarray(cj.length)
    assert ct.length.tolist() == lengths.tolist()
    assert ct.mask.all()
    bits = KV[kv]["kv_bits"]
    for name in ("keys", "values"):
        scales = {"keys": "key_scales", "values": "value_scales"}[name]
        for l, n in enumerate(lengths):
            got = getattr(ct, name)[l, :, :, :n]
            want = torch.from_numpy(np.array(getattr(cj, name)[l, :, :, :n]))
            if ct.key_scales is None:
                np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
                continue
            # dequantized, within one code of the larger scale
            s_t = getattr(ct, scales)[l, :, :, :n]
            s_j = torch.from_numpy(np.array(getattr(cj, scales)[l, :, :, :n]))
            diff = (kt.dequantize_kv(got, s_t, bits, torch.float32)
                    - kt.dequantize_kv(want, s_j, bits, torch.float32)).abs()
            assert (diff <= 1.01 * torch.maximum(s_t, s_j) + 1e-6).all(), (name, l)
    budgets, keep = seen[0]
    src = before[0]
    arr = lambda t: None if t is None else jnp.asarray(t.numpy())
    jc = JaxCache(keys=arr(src["keys"]), values=arr(src["values"]),
                  length=jnp.asarray(budgets, jnp.int32), offset=jnp.asarray(S, jnp.int32),
                  mask=jnp.ones(src["keys"].shape[:4], bool), key_scales=arr(src["key_scales"]),
                  value_scales=arr(src["value_scales"]), bits=KV[kv]["kv_bits"])
    keep_buf = np.zeros(src["keys"].shape[:4], bool)
    keep_buf[..., :S] = keep[:, None]
    for l in range(p.cfg_t.num_layers):
        jc = jpipeline._kvcompose_rebuild_layer(jc, jnp.asarray(keep_buf[l]),
                                                jnp.asarray(l, jnp.int32))
    for name in ("keys", "values", "key_scales", "value_scales"):
        if src[name] is None:
            continue
        for l, n in enumerate(budgets):
            np.testing.assert_array_equal(getattr(ct, name)[l, :, :, :n].numpy(),
                                          np.asarray(getattr(jc, name)[l, :, :, :n]))


@pytest.mark.parametrize("chunk", [None, 16])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_unstructured_masks_equal_jax(pipes, kv, chunk):
    cj, ct = _rebuild_both(pipes, "kvcompose_unstructured", kv, chunk)
    np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
    assert 0.3 < (~ct.mask[..., :S]).float().mean() < 0.7
    assert ct.length.tolist() == [S] * pipes.cfg_t.num_layers


def test_add_v_norm_matches_jax(pipes):
    cj, ct = _rebuild_both(pipes, "kvcompose_vnorm", "float32", 16)
    assert ct.length.tolist() == np.asarray(cj.length).tolist()
    for l, n in enumerate(ct.length.tolist()):
        np.testing.assert_allclose(ct.keys[l, :, :, :n].numpy(), np.asarray(cj.keys[l, :, :, :n]),
                                   atol=1e-5)


def test_add_v_norm_reads_dequantized_values(pipes, monkeypatch):
    """Over int8 KV the values handed to budgets_and_masks are the cache's
    raw payload codes as float32 (not the dequantized values), as JAX reads
    them (kvpress_tpu/pipeline.py:879-880)."""
    p = pipes
    ids = seeded_ids(p.cfg_t.vocab_size, S, 13)
    _, rt = _runners(p)
    _, ct, _ = rt.prefill(p.params_t, torch.from_numpy(ids).long(), max_size=2 * S,
                          **KV["int8"])
    want = ct.values[:, 0, :, :S].float().numpy()
    seen = []
    original = kt.KVComposePress.budgets_and_masks
    monkeypatch.setattr(kt.KVComposePress, "budgets_and_masks",
                        lambda self, s, v: seen.append(v) or original(self, s, v))
    p.torch_pipe()._run_kvcompose(ct, ids[0].tolist(), make_press(kt, "kvcompose_vnorm", NO_ART),
                                  context_chunk=16)
    np.testing.assert_array_equal(seen[0], want)


@pytest.mark.parametrize("structured", [True, False])
@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_add_v_norm_over_quantized_kv_matches_jax(pipes, monkeypatch, kv, structured):
    """``add_v_norm`` over int8 and int4 KV (at int4 the packed bytes, D/2
    wide): JAX's budgets and kept sets exactly, on the same prefilled cache
    (the port's, handed to JAX)."""
    from kvpress_tpu.cache import KVCache as JaxCache

    p = pipes
    ids = seeded_ids(p.cfg_t.vocab_size, S, 13)
    rj, rt = _runners(p)
    _, ct, _ = rt.prefill(p.params_t, torch.from_numpy(ids).long(), max_size=2 * S, **KV[kv])
    arr = lambda t: None if t is None else jnp.asarray(t.numpy())
    cj = JaxCache(keys=arr(ct.keys), values=arr(ct.values), length=arr(ct.length),
                  offset=arr(ct.offset), mask=None, key_scales=arr(ct.key_scales),
                  value_scales=arr(ct.value_scales), bits=KV[kv]["kv_bits"])
    seen = {}
    for side, cls in (("jax", jp.KVComposePress), ("torch", kt.KVComposePress)):
        original = cls.budgets_and_masks
        monkeypatch.setattr(cls, "budgets_and_masks",
                            lambda self, s, v, side=side, original=original: seen.setdefault(
                                side, (s, original(self, s, v)))[1])
    over = dict(compression_ratio=0.4, add_v_norm=True, agg_head="max", keep_token_lower_bound=4,
                structured=structured)
    ctx_ids = ids[0].tolist()
    p.jax_pipe()._run_kvcompose(cj, ctx_ids, jp.KVComposePress(**over), context_chunk=16)
    p.torch_pipe()._run_kvcompose(ct, ctx_ids, kt.KVComposePress(**over), context_chunk=16)
    (scores, (budgets, keep)), (_, (budgets_j, keep_j)) = seen["torch"], seen["jax"]
    np.testing.assert_array_equal(budgets, budgets_j)
    np.testing.assert_array_equal(keep, keep_j)
    # the norms move the kept sets
    unweighted = original(kt.KVComposePress(**dict(over, add_v_norm=False)), scores, None)
    assert not np.array_equal(unweighted[1], keep)


# --------------------------------------------------------------------- #
# Pipelines and refusals


PIPELINE_CASES = [("kvcompose", {}), ("kvcompose", dict(context_chunk=16)),
                  ("kvcompose", dict(quantized=True)),
                  ("kvcompose", dict(quantized=True, context_chunk=16)),
                  ("kvcompose_unstructured", {}),
                  ("kvcompose_unstructured", dict(quantized=True, context_chunk=16)),
                  ("kvcompose_mean_max", dict(context_chunk=16))]


@pytest.mark.parametrize("name,kw", PIPELINE_CASES,
                         ids=[f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items()) or 'default'}"
                              for n, kw in PIPELINE_CASES])
def test_pipeline_matches_jax(pipes, name, kw):
    assert_same(pipes.run(*_both(name), **kw))


def test_sliding_config_refused_on_both_sides():
    """The chunked re-feed has no window: both packages refuse a sliding
    config (JAX by an assertion)."""
    over = dict(sliding_window=8, layer_is_sliding=(True, False))
    cfg_j, cfg_t = kj.tiny_config(**over), kt.tiny_config(**over)
    params_j = kj.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    params_t = kt.params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), cfg_t,
                                  device="cpu", dtype=torch.float32)
    ids = seeded_ids(cfg_t.vocab_size, 32, 1)
    rt = kt.Runner.create(cfg_t, attn_impl="flash", device="cpu")
    _, ct, _ = rt.prefill(params_t, torch.from_numpy(ids).long(), max_size=64)
    with pytest.raises(ValueError, match="sliding-window"):
        rt.kvcompose_refeed_pass(params_t, torch.from_numpy(ids[:, :16]).long(), ct, 32, "max")
    rj = kj.Runner.create(cfg_j, attn_impl="xla")
    _, cj, _ = rj.prefill(params_j, jnp.asarray(ids), max_size=64, dtype=jnp.float32)
    with pytest.raises(AssertionError, match="sliding-window"):
        rj.kvcompose_refeed_pass(params_j, jnp.asarray(ids[:, :16]), cj, 32, "max")
    with pytest.raises(TypeError, match="kvcompose_spec"):
        rt._chunk_forward_lean(params_t, torch.from_numpy(ids[:, :4]).long(), ct,
                               kvcompose_spec=(32, "median"))
