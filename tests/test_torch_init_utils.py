"""``init_params_int8`` and ``utils`` (checkpoints, profiling, memory
counters, the kernel cache) of kvpress_tpu_torch against the JAX package
(CPU, tiny config).

``init_params_int8``: the JAX draws, carried by ``params_from_jax``, give
JAX's logits (within the JAX tests' LOGIT_TOL) for int8 and int4 layers,
with and without int8 embeddings, tied and untied; the port's own draws have
the converted tree's names, shapes, dtypes and scales, payloads over their
whole range, and serve a prefill and decode steps. The checkpoint round trip
is bit-equal and gives equal logits."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.models.llama import init_params_int8 as j_init_int8
import kvpress_tpu_torch as kt
from kvpress_tpu_torch import utils
from kvpress_tpu_torch.ops import _build

torch.set_num_threads(2)

LOGIT_TOL = dict(atol=2e-4, rtol=1e-3)
# bits, int8_embeddings, tied
CASES = [(b, e, t) for b in (8, 4) for e in (False, True) for t in (True, False)]


def _ids(cfg, n=24, seed=1):
    return np.random.default_rng(seed).permutation(cfg.vocab_size)[:n][None]


def _tensors(model: kt.models.llama.LlamaModel) -> dict:
    out = {f"{l}.{n}": p.data for l, layer in enumerate(model.layers)
           for n, p in layer.named_parameters(recurse=False)}
    out.update({n: p.data for n, p in model.named_parameters(recurse=False)})
    return out


def _configs(tied: bool, **kw):
    kw = dict(tie_word_embeddings=tied, **kw)
    return kj.tiny_config(**kw), kt.tiny_config(**kw)


@pytest.mark.parametrize("bits,int8_embeddings,tied", CASES,
                         ids=[f"int{b}-{'emb8' if e else 'emb'}-{'tied' if t else 'untied'}"
                              for b, e, t in CASES])
def test_jax_draws_give_jax_logits(bits, int8_embeddings, tied):
    """JAX's ``init_params_int8`` tree converted by ``params_from_jax``: the
    port's prefill logits and one decode step equal JAX's."""
    cfg_j, cfg_t = _configs(tied)
    tree = j_init_int8(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32, bits=bits,
                       int8_embeddings=int8_embeddings)
    ids = _ids(cfg_j)
    jr = kj.Runner.create(cfg_j, attn_impl="xla")
    jl, jc, _ = jr.prefill(tree, jnp.asarray(ids), dtype=jnp.float32, compute_logits=True)
    tok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    jstep, _, _ = jr.forward(tree, tok, kj.cache.resize(jc, ids.shape[1] + 1),
                             logits_last_only=True)
    params = kt.params_from_jax(jax.tree_util.tree_map(np.asarray, tree), cfg_t, device="cpu",
                                dtype=torch.float32)
    tr = kt.Runner.create(cfg_t, device="cpu")
    tl, tc, _ = tr.prefill(params, torch.from_numpy(ids), dtype=torch.float32,
                           compute_logits=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    tstep, _, _ = tr.forward(params, torch.argmax(tl[:, -1:], dim=-1),
                             kt.resize(tc, ids.shape[1] + 1), logits_last_only=True)
    np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep), **LOGIT_TOL)


@pytest.mark.parametrize("bits,int8_embeddings,tied", CASES,
                         ids=[f"int{b}-{'emb8' if e else 'emb'}-{'tied' if t else 'untied'}"
                              for b, e, t in CASES])
def test_own_draws_have_the_converted_layout(bits, int8_embeddings, tied):
    """The port's draws have the converted JAX tree's names, shapes, dtypes
    and scales (a Gemma3-like config: q/k-norms and post-norms; qkv biases);
    int8 payloads span [-127, 127], int4 bytes 0..255, norms are ones,
    biases zeros; no float matrix exists when every payload is integer."""
    kw = dict(qk_norm=True, post_norms=True, attention_bias=True)
    cfg_j, cfg_t = _configs(tied, **kw)
    want = _tensors(kt.params_from_jax(jax.tree_util.tree_map(np.asarray, j_init_int8(
        cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32, bits=bits,
        int8_embeddings=int8_embeddings)), cfg_t, device="cpu", dtype=torch.bfloat16))
    got_model = kt.init_params_int8(cfg_t, torch.Generator().manual_seed(0), bits=bits,
                                    int8_embeddings=int8_embeddings, device="cpu")
    got = _tensors(got_model)
    assert got.keys() == want.keys()
    assert got_model.dtype == torch.bfloat16
    for name, t in got.items():
        assert (t.shape, t.dtype) == (want[name].shape, want[name].dtype), name
        short = name.split(".")[-1]
        if short.endswith("_scale"):
            assert torch.equal(t, want[name]), name
        elif t.dtype == torch.int8:
            assert int(t.min()) == -127 and int(t.max()) == 127, name
        elif t.dtype == torch.uint8:
            assert int(t.min()) == 0 and int(t.max()) == 255, name
        elif short.startswith(("ln", "q_norm", "k_norm")):
            assert bool((t == 1).all()), name
        elif short.startswith("b"):
            assert not t.any(), name
        else:
            assert short in ("embed", "lm_head") and not int8_embeddings, name
    assert (got_model.get("lm_head") is None) == tied


@pytest.mark.parametrize("bits", [8, 4])
def test_own_draws_serve_prefill_and_decode(bits):
    """The port's int8 / int4 draws (int8 embeddings, untied head) through a
    Knorm prefill and 4 greedy decode steps: finite logits, the kept
    length, and decode logits equal to a prefill of the whole sequence."""
    cfg = kt.tiny_config(tie_word_embeddings=False)
    params = kt.init_params_int8(cfg, torch.Generator().manual_seed(2), dtype=torch.float32,
                                 bits=bits, int8_embeddings=True, device="cpu")
    r = kt.Runner.create(cfg, device="cpu")
    ids = torch.from_numpy(_ids(cfg, 40))
    logits, cache, _ = r.prefill(params, ids, compute_logits=True)
    cache = kt.resize(cache, 44)
    seq = ids
    for _ in range(4):
        tok = torch.argmax(logits[:, -1:], dim=-1)
        seq = torch.cat([seq, tok], dim=1)
        logits, cache, _ = r.forward(params, tok, cache, logits_last_only=True)
        assert torch.isfinite(logits).all()
    full, _, _ = r.prefill(params, seq, compute_logits=True)
    torch.testing.assert_close(logits[:, -1], full[:, -1], atol=1e-4, rtol=1e-4)
    _, kc, _ = r.prefill(params, ids, press=kt.KnormPress(0.5))
    assert kc.length.tolist() == [20, 20]


@pytest.mark.parametrize("kind", ["float32", "int8_embeddings", "int4_draws"])
def test_checkpoint_round_trip_is_bit_equal(kind, tmp_path):
    """``save_params`` / ``load_params``: every tensor bit-equal with its
    dtype (int4 payloads and scales, ``embed_scale`` and ``lm_head_scale``
    included), the head kept or absent, and equal logits."""
    cfg = kt.tiny_config(tie_word_embeddings=kind == "float32", qk_norm=True)
    g = torch.Generator().manual_seed(4)
    if kind == "int4_draws":
        params = kt.init_params_int8(cfg, g, dtype=torch.float32, bits=4, int8_embeddings=True,
                                     device="cpu")
    else:
        params = kt.init_params(cfg, g, device="cpu")
        if kind == "int8_embeddings":
            params = kt.quantize_params_int8(params, include_embeddings=True)
    path = tmp_path / "params.pt"
    utils.save_params(str(path), params)
    back = utils.load_params(str(path), device="cpu")
    a, b = _tensors(params), _tensors(back)
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype and torch.equal(a[name], b[name]), name
    r = kt.Runner.create(cfg, device="cpu")
    ids = torch.from_numpy(_ids(cfg))
    want = r.prefill(params, ids, compute_logits=True)[0]
    assert torch.equal(r.prefill(back, ids, compute_logits=True)[0], want)


def test_memory_stats_and_profile_trace_on_the_cpu(tmp_path):
    """``memory_stats`` is {} on the CPU (as JAX's CPU backend); a
    ``profile_trace`` block writes a Chrome trace naming the ops it ran."""
    assert utils.memory_stats("cpu") == {}
    assert utils.memory_stats(torch.device("cpu")) == {}
    cfg = kt.tiny_config()
    params = kt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    r = kt.Runner.create(cfg, device="cpu")
    with utils.profile_trace(str(tmp_path / "trace"), device="cpu") as d:
        r.prefill(params, torch.from_numpy(_ids(cfg)))
    assert d == str(tmp_path / "trace")
    traces = glob.glob(os.path.join(d, "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        text = f.read()
    assert '"traceEvents"' in text and "aten::" in text


def test_enable_compile_cache_moves_the_build_dir(tmp_path):
    """The kernel libraries go under the given directory (made if absent),
    by default under the temporary directory; the default comes back with
    ``set_build_dir(None)``."""
    default = _build.build_dir()
    try:
        utils.enable_compile_cache(str(tmp_path / "kernels"), min_compile_secs=2.0)
        assert _build.build_dir() == (tmp_path / "kernels").resolve()
        assert (tmp_path / "kernels").is_dir()
        assert _build._library_path("flash").parent == _build.build_dir()
    finally:
        _build.set_build_dir(None)
    assert _build.build_dir() == default
