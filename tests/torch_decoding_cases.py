"""Shared cases of the decode-time press parity tests of kvpress_tpu_torch
(tests/test_torch_decoding_presses.py and test_torch_cam_dms_decode.py): the
registry's decode-time presses (evaluation/registry.py: ``decoding_*``,
``cam_*``) and the other decode-time presses at the tiny config's scale in
both packages by the same arguments, JAX's CAM draws for the port, a decode
``LayerCtx`` in both packages, and the pipelines of both packages with a
probe of each side's ``_generate_answer`` (as tests/test_decoding_press.py
reads the final per-layer lengths).

The context is 60 tokens (the BOS joins the first word), so a target of 40
binds from the first interval on; a question of 4 tokens and 24 new tokens
take six compressions at an interval of 4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import kvpress_tpu as kj
import kvpress_tpu.pipeline as jpipeline
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
import kvpress_tpu_torch as kt
import kvpress_tpu_torch.pipeline as tpipeline
from kvpress_tpu_torch.presses.cam import CAMPress
from toy_tokenizer import ToyTokenizer
from torch_scorer_cases import _surrogate, distinct_words, tiny_models
from torch_wrapper_cases import jax_ctx

DEC = dict(compression_interval=4, target_size=40, hidden_states_buffer_size=8)
SNAP = dict(window_size=8, kernel_size=3)


def _decoding(m, base, **kw):
    return m.DecodingPress(base_press=base, **{**DEC, **kw})


def _cam(m, base):
    return m.CAMPress(base_press=base, merge_budget=4, **DEC)


# name: press(module), made with the module's names.
PRESSES = {
    "decoding_knorm": lambda m: _decoding(m, m.KnormPress()),
    "decoding_streaming_llm": lambda m: _decoding(m, m.StreamingLLMPress()),
    "decoding_tova": lambda m: _decoding(m, m.TOVAPress()),
    "decoding_keydiff": lambda m: _decoding(m, m.KeyDiffPress()),
    "compression_ratio_decoding": lambda m: m.CompressionRatioDecodingPress(
        base_press=m.KnormPress(), target_compression_ratio=0.5, compression_interval=4,
        hidden_states_buffer_size=8),
    # SnapKV scores the prefill on the route the router takes (no probs
    # forwarded, as in JAX)
    "prefill_decoding_snapkv": lambda m: m.PrefillDecodingPress(
        m.SnapKVPress(0.5, **SNAP), _decoding(m, m.KnormPress(), target_size=24)),
    "prefill_decoding_none": lambda m: m.PrefillDecodingPress(
        None, _decoding(m, m.KnormPress())),
    "cam_knorm": lambda m: _cam(m, m.KnormPress()),
    "cam_streaming_llm": lambda m: _cam(m, m.StreamingLLMPress()),
    "cam_tova": lambda m: _cam(m, m.TOVAPress()),
    # thresholds near the tiny models' median scores (tests/torch_mask_cases.py)
    "dms_knorm_decoding": lambda m: m.DMSPress(m.KnormPress(), threshold=-3.86,
                                               sliding_window_size=16, decoding=True),
    "dms_kvzap_decoding": lambda m: m.DMSPress(m.KVzapPress(surrogate=_surrogate(m, "linear")),
                                               threshold=0.0, sliding_window_size=16,
                                               decoding=True),
}
DECODING = [n for n in PRESSES if n.startswith("decoding")]
CAM = [n for n in PRESSES if n.startswith("cam")]
DMS = [n for n in PRESSES if n.startswith("dms")]
# CAM's merged values: float32 scatter-adds whose order of accumulation
# differs from XLA's.
MERGE_TOL = dict(atol=1e-5, rtol=1e-5)


def both(name):
    """(JAX press, port press) of one name."""
    from kvpress_tpu import presses as jp
    return PRESSES[name](jp), PRESSES[name](kt)


def jax_uniforms(seed: int, layer_idx: int, rng_step: int, shape) -> np.ndarray:
    """The uniforms of JAX's ``bernoulli(fold_in(fold_in(PRNGKey(seed),
    layer), rng_step), p)``."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), layer_idx), rng_step)
    return np.asarray(jax.random.uniform(key, shape, jnp.float32))


def use_jax_uniforms(monkeypatch):
    """Replace the port's CAM draws by the JAX package's."""
    monkeypatch.setattr(CAMPress, "draw_uniforms", lambda self, layer, step, shape, device:
                        torch.tensor(jax_uniforms(self.seed, layer, step, shape), device=device))


def decode_ctx(runner, params_t, params_j, cfg_j, T: int, last_position: int, seed: int,
               layer: int = 1, B: int = 2):
    """A decode-phase LayerCtx of ``layer`` in both packages: seeded hidden
    states (B, T, E) and post-RoPE queries (B, Hq, T, D) at the positions
    ending at ``last_position``. Returns (port ctx, JAX ctx)."""
    cfg = runner.cfg
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    positions = (last_position - T + 1 + torch.arange(T))[None].expand(B, T)
    ctx = kt.LayerCtx(
        layer_idx=layer, hidden=f(B, T, cfg.hidden_size),
        queries=f(B, cfg.num_heads, T, cfg.head_dim), queries_prerope=None,
        keys_prerope=None, positions=positions, attn_probs=None,
        layer_params=params_t.layers[layer], inv_freq=runner.inv_freq, cfg=cfg,
        attention_scaling=runner.attention_scaling, last_position=last_position)
    return ctx, jax_ctx(ctx, cfg_j, params_j)


@dataclasses.dataclass
class Pipelines:
    """The tiny models' pipelines in both packages on one toy tokenizer; the
    port's on the kernel route (``attn_impl="flash"``, the decode kernel's
    plain version on the CPU)."""
    cfg_j: object
    cfg_t: object
    params_j: dict
    params_t: object
    tok: ToyTokenizer
    words: list

    @staticmethod
    def tiny(cfg_overrides=None):
        if cfg_overrides is None:
            cfg_j, cfg_t, params_j, params_t = tiny_models()
        else:
            cfg_j, cfg_t = kj.tiny_config(**cfg_overrides), kt.tiny_config(**cfg_overrides)
            params_j = kj.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
            layers = dict(params_j["layers"])
            layers["wq"], layers["wk"] = layers["wq"] * 6.0, layers["wk"] * 6.0
            params_j = dict(params_j, layers=layers)
            params_t = kt.params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), cfg_t,
                                          device="cpu", dtype=torch.float32)
        tok = ToyTokenizer(cfg_t.vocab_size)
        return Pipelines(cfg_j, cfg_t, params_j, params_t, tok, distinct_words(tok, 70))

    def context(self):
        return " ".join(self.words[:60]), "what is " + self.words[60] + " ?"

    def run(self, jpress, tpress, question=None, max_new_tokens=24, **kw):
        """Both pipelines on the context and ``question`` (the default one
        when None). Returns {"jax": (answer, final lengths), "torch": ...}."""
        context, default_q = self.context()
        question = default_q if question is None else question
        jpipe = JaxPipeline(kj.Runner.create(self.cfg_j, attn_impl="xla"), self.params_j,
                            self.tok)
        tpipe = kt.KVPressPipeline(kt.Runner.create(self.cfg_t, attn_impl="flash",
                                                    decode_kernel=True, device="cpu"),
                                   self.params_t, self.tok)
        out = {}
        for side, module, pipe, press in (("jax", jpipeline, jpipe, jpress),
                                          ("torch", tpipeline, tpipe, tpress)):
            seen = {}
            original = module._generate_answer

            def probe(*args, **kwargs):
                result = original(*args, **kwargs)
                seen["lengths"] = np.asarray(result[-1].length).tolist()
                return result

            module._generate_answer = probe
            try:
                answer = pipe(context, question=question, press=press,
                              max_new_tokens=max_new_tokens, **kw)["answer"]
            finally:
                module._generate_answer = original
            out[side] = (answer, seen["lengths"])
        return out
