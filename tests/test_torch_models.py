"""kvpress_tpu_torch on the other architectures: Mistral, Qwen2 (qkv bias),
Qwen3 (q/k-norm), Phi3 (fused projections), Gemma3 (q/k-norm, post-norms,
(1 + w) norms, scaled embeddings, interleaved sliding-window layers with their
own RoPE base). Tiny ``transformers`` models built from configs are converted
by both packages' ``from_torch_model``; the port's logits are held against
``transformers`` and against the JAX runner (attn_impl="xla"), in float32 on
the CPU. Then the sliding layers' rules (never compressed, buffers and
payloads untouched, the pipeline keeps the whole context), windowed decode
through the decode wrapper's plain version, and ``params_from_jax`` for the
new weight names."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.models.convert import from_torch_model as jfrom_torch
from kvpress_tpu.models.llama import quantize_params_int4 as jquantize_int4
from kvpress_tpu.ops.decode import decode_attention as jdecode
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.ops import decode as tdec

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Logits: float32 on both sides, sums taken in another order (1e-4, as in
# tests/test_model_parity.py's tolerance class).
LOGIT_TOL = 1e-4
T = 24


def _hf(model_type):
    from transformers import (AutoModelForCausalLM, Gemma3TextConfig, LlamaConfig,
                              MistralConfig, Phi3Config, Qwen2Config, Qwen3Config)

    common = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
                  tie_word_embeddings=False, pad_token_id=0)
    cfg = {
        "llama": lambda: LlamaConfig(**common),
        "mistral": lambda: MistralConfig(**common),
        "qwen2": lambda: Qwen2Config(**common),
        "qwen3": lambda: Qwen3Config(head_dim=16, **common),
        "phi3": lambda: Phi3Config(**common),
        # four layers, sliding and global in turn, window 8 < T
        "gemma3": lambda: Gemma3TextConfig(
            **{**common, "num_hidden_layers": 4}, head_dim=16, sliding_window=8,
            layer_types=["sliding_attention" if (i + 1) % 2 else "full_attention"
                         for i in range(4)]),
    }[model_type]()
    torch.manual_seed(0)
    model = AutoModelForCausalLM.from_config(cfg)
    model.eval()
    # Norm weights off their init values: with q/k-norm every fresh key has
    # the same norm, and KnormPress would choose among ties.
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(torch.randn_like(p) * 0.3)
    return model


@pytest.fixture(scope="module")
def hf_models():
    return {}


def _converted(hf_models, model_type):
    if model_type not in hf_models:
        model = _hf(model_type)
        params_j, cfg_j = jfrom_torch(model, dtype=jnp.float32)
        params_t, cfg_t = kt.from_torch_model(model, dtype=torch.float32, device="cpu")
        hf_models[model_type] = (model, params_j, cfg_j, params_t, cfg_t)
    return hf_models[model_type]


ARCHS = ["llama", "mistral", "qwen2", "qwen3", "phi3", "gemma3"]


@pytest.mark.parametrize("model_type", ARCHS)
def test_logits_match_transformers_and_jax(hf_models, model_type):
    """Full-sequence logits, then a KnormPress(0.5) prefill and three decode
    steps over its cache: the port against HF (the forward) and against the
    JAX runner (everything), with equal compressed lengths."""
    model, params_j, cfg_j, params_t, cfg_t = _converted(hf_models, model_type)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    ids = np.random.default_rng(0).integers(1, cfg_t.vocab_size, (1, T))
    with torch.no_grad():
        ref = model(torch.tensor(ids)).logits.float().numpy()
    runner_t = kt.Runner.create(cfg_t, device="cpu")
    runner_j = kj.Runner.create(cfg_j, attn_impl="xla")
    got, _, _ = runner_t.forward(params_t, torch.tensor(ids),
                                 kt.init_cache(cfg_t, 1, T, dtype=torch.float32, device="cpu"))
    want, _, _ = runner_j.forward(params_j, jnp.asarray(ids),
                                  kj.init_cache(cfg_j, 1, T, dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), ref, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)

    ids = np.random.default_rng(1).permutation(np.arange(1, cfg_t.vocab_size))[:T][None]
    lt, ct, _ = runner_t.prefill(params_t, torch.tensor(ids), press=kt.KnormPress(0.5),
                                 max_size=T + 4, dtype=torch.float32, compute_logits=True)
    lj, cj, _ = runner_j.prefill(params_j, jnp.asarray(ids, jnp.int32), press=kj.KnormPress(0.5),
                                 max_size=T + 4, dtype=jnp.float32, compute_logits=True)
    assert ct.length.tolist() == np.asarray(cj.length).tolist()
    for _ in range(3):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_TOL, rtol=LOGIT_TOL)
        tok = int(np.argmax(np.asarray(lj)[0, -1]))
        lt, ct, _ = runner_t.forward(params_t, torch.tensor([[tok]]), ct, logits_last_only=True)
        lj, cj, _ = runner_j.forward(params_j, jnp.asarray([[tok]], jnp.int32), cj,
                                     logits_last_only=True)


def _sliding_cfgs():
    kw = dict(num_layers=4, sliding_window=8, layer_is_sliding=(True, False, True, False))
    return kj.tiny_config(**kw), kt.tiny_config(**kw)


@pytest.fixture(scope="module")
def sliding():
    cfg_j, cfg_t = _sliding_cfgs()
    params_j = kj.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    params_t = kt.params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), cfg_t,
                                  device="cpu", dtype=torch.float32)
    return cfg_j, cfg_t, params_j, params_t


@pytest.mark.parametrize("kv", [None, 8, 4])
def test_sliding_layers_stay_uncompressed_and_untouched(sliding, kv):
    """A press leaves a sliding layer as the pressless prefill leaves it:
    its whole length, its keep-mask and its buffers, and for a quantized
    cache the exact append-time payloads and scales (the baseline then is
    the identity press, so both runs attend alike). Lengths equal the JAX
    runner's."""
    cfg_j, cfg_t, params_j, params_t = sliding
    ids = torch.from_numpy(np.random.default_rng(1).integers(1, 256, (1, T)))
    runner = kt.Runner.create(cfg_t, device="cpu")
    kw = dict(dtype=torch.float32) if kv is None else dict(dtype=torch.float32, quantized=True,
                                                          kv_bits=kv)
    _, plain, _ = runner.prefill(params_t, ids, press=None if kv is None else kt.BasePress(), **kw)
    _, pressed, _ = runner.prefill(params_t, ids, press=kt.KnormPress(0.5), **kw)
    lengths = [T if s else T // 2 for s in cfg_t.sliding_flags()]
    assert pressed.length.tolist() == lengths
    _, jc, _ = kj.Runner.create(cfg_j).prefill(
        params_j, jnp.asarray(ids.numpy()), press=kj.KnormPress(0.5), dtype=jnp.float32,
        quantized=kv is not None, kv_bits=kv or 8)
    assert np.asarray(jc.length).tolist() == lengths
    fields = ("keys", "values") + (() if kv is None else ("key_scales", "value_scales"))
    for i, s in enumerate(cfg_t.sliding_flags()):
        if s:
            for f in fields:
                assert torch.equal(getattr(pressed, f)[i], getattr(plain, f)[i]), (i, f)
            assert pressed.mask is None or bool(pressed.mask[i].all())


def test_pipeline_keeps_the_whole_context_on_sliding_models(sliding, monkeypatch):
    """The pipeline resizes a sliding model's cache to the whole context,
    and answers as the JAX pipeline does."""
    from toy_tokenizer import ToyTokenizer
    import kvpress_tpu_torch.pipeline as tpipe

    cfg_j, cfg_t, params_j, params_t = sliding
    tok = ToyTokenizer(cfg_t.vocab_size)
    context = " ".join(f"w{i}" for i in range(30))
    sizes = []
    resize = tpipe.resize
    monkeypatch.setattr(tpipe, "resize", lambda c, n: sizes.append(n) or resize(c, n))
    pt = kt.KVPressPipeline(kt.Runner.create(cfg_t, device="cpu"), params_t, tok)
    pj = kj.KVPressPipeline(kj.Runner.create(cfg_j), params_j, tok)
    kw = dict(question="w3 w4 ?", press=kt.KnormPress(0.5), max_new_tokens=4)
    n_ctx = len(pt.preprocess(context, [""])[0])
    got = pt(context, **kw)["answer"]
    assert sizes and sizes[0] >= n_ctx
    assert got == pj(context, **{**kw, "press": kj.KnormPress(0.5)})["answer"]


def test_windowed_decode_matches_jax(sliding):
    """Decode on a sliding model through the decode wrapper (its plain
    version on the CPU) with the window on sliding layers only: the runner
    against the JAX runner, and the wrapper itself against the Pallas kernel
    in interpret mode with a window shorter than the live length."""
    cfg_j, cfg_t, params_j, params_t = sliding
    ids = np.random.default_rng(2).permutation(np.arange(3, 256))[:T][None]
    runner_t = kt.Runner.create(cfg_t, attn_impl="flash", decode_kernel=True, device="cpu")
    runner_j = kj.Runner.create(cfg_j, attn_impl="xla")
    lt, ct, _ = runner_t.prefill(params_t, torch.tensor(ids), press=kt.KnormPress(0.5),
                                 max_size=T + 8, dtype=torch.float32, compute_logits=True)
    lj, cj, _ = runner_j.prefill(params_j, jnp.asarray(ids, jnp.int32), press=kj.KnormPress(0.5),
                                 max_size=T + 8, dtype=jnp.float32, compute_logits=True)
    calls = []
    original = tdec.decode_attention

    def spy(*a, **k):
        calls.append(k.get("window"))
        return original(*a, **k)

    from kvpress_tpu_torch.models import llama as tllama
    tllama.decode_attention, saved = spy, tllama.decode_attention
    try:
        for _ in range(3):
            tok = int(np.argmax(np.asarray(lj)[0, -1]))
            lt, ct, _ = runner_t.forward(params_t, torch.tensor([[tok]]), ct,
                                         logits_last_only=True)
            lj, cj, _ = runner_j.forward(params_j, jnp.asarray([[tok]], jnp.int32), cj,
                                         logits_last_only=True)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL)
    finally:
        tllama.decode_attention = saved
    assert calls == [8, None, 8, None] * 3

    rng = np.random.default_rng(3)
    B, Hq, Hkv, S, D, length, window = 1, 4, 2, 640, 64, 600, 100
    q = rng.standard_normal((B, Hq, 2, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Hkv, S, D)).astype(np.float32) for _ in range(2))
    want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(length),
                   sm_scale=D ** -0.5, window=window, block_k=128, interpret=True)
    got = tdec.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                length, sm_scale=D ** -0.5, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_params_from_jax_carries_every_weight_name():
    """qkv bias, q/k-norm and Gemma3's post-norms (and int4 payloads of such
    a model) come across from the JAX tree, and give the JAX logits."""
    kw = dict(attention_bias=True, qk_norm=True, post_norms=True, rms_one_offset=True,
              scale_embeddings=True, act="gelu_tanh", query_pre_attn_scalar=16.0,
              rope_local_base_freq=10000.0, num_layers=2, sliding_window=8,
              layer_is_sliding=(True, False))
    cfg_j, cfg_t = kj.tiny_config(**kw), kt.tiny_config(**kw)
    params_j = kj.init_params(cfg_j, jax.random.PRNGKey(3), dtype=jnp.float32)
    rng = np.random.default_rng(4)
    # biases and norms away from their init values, so that each one counts
    layers = dict(params_j["layers"])
    for name in ("bq", "bk", "bv", "q_norm", "k_norm", "ln1_post", "ln2_post"):
        layers[name] = jnp.asarray(rng.standard_normal(layers[name].shape) * 0.3, jnp.float32)
    params_j = dict(params_j, layers=layers)
    ids = rng.integers(1, cfg_t.vocab_size, (1, T))
    for quant in (False, True):
        pj = jquantize_int4(params_j) if quant else params_j
        pt = kt.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), cfg_t, device="cpu",
                                dtype=torch.float32)
        for name in ("bq", "bk", "bv", "q_norm", "k_norm", "ln1_post", "ln2_post", "wq_scale"):
            if name in pj["layers"]:
                np.testing.assert_array_equal(pt.layers[1].get(name).numpy(),
                                              np.asarray(pj["layers"][name][1]))
        got, _, _ = kt.Runner.create(cfg_t, device="cpu").forward(
            pt, torch.from_numpy(ids), kt.init_cache(cfg_t, 1, T, dtype=torch.float32,
                                                     device="cpu"))
        want, _, _ = kj.Runner.create(cfg_j).forward(
            pj, jnp.asarray(ids), kj.init_cache(cfg_j, 1, T, dtype=jnp.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


def test_init_params_lays_out_the_jax_names():
    """init_params draws the JAX package's weight names and shapes for every
    option, and ``quantize_layer_int4`` gives ``quantize_params_int4``'s
    layer."""
    kw = dict(attention_bias=True, qk_norm=True, post_norms=True, tie_word_embeddings=True)
    cfg_j, cfg_t = kj.tiny_config(**kw), kt.tiny_config(**kw)
    pj = kj.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    pt = kt.init_params(cfg_t, torch.Generator().manual_seed(0), device="cpu")
    names = {n for n, _ in pt.layers[0].named_parameters(recurse=False)}
    assert names == set(pj["layers"])
    for n in names:
        assert tuple(pt.layers[0].get(n).shape) == pj["layers"][n].shape[1:]
    assert pt.get("lm_head") is None
    p4 = kt.quantize_params_int4(pt)
    one = kt.quantize_layer_int4({n: p.data.clone() for n, p in
                                  pt.layers[1].named_parameters(recurse=False)})
    for n, t in one.items():
        assert torch.equal(t, p4.layers[1].get(n)), n
