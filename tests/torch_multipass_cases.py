"""Shared cases of the multi-pass press parity tests of kvpress_tpu_torch
(tests/test_torch_kvzip.py and test_torch_kvcompose.py): KVzip, KVzip+,
RestoreKV, FastKVzip and KVCompose in both packages by the same arguments,
JAX's random artifacts handed to the port through the ``.npz`` files the JAX
package writes, and both pipelines with a probe of the cache each hands to
its ``_generate_answer`` (the compressed cache: its lengths and keep-mask).

FastKVzip's gates and RestoreKV's LoRA factors are drawn by ``jax.random``
in the JAX package; torch generators cannot draw those numbers, so the tests
give both presses JAX's draws: ``save_fastkvzip_gates`` /
``save_restore_artifacts`` write them and the port's loaders read them. The
LoRA's B factors are drawn nonzero here (JAX's ``init_random_lora`` makes
them zero, which merges nothing)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import kvpress_tpu as kj
import kvpress_tpu.pipeline as jpipeline
from kvpress_tpu.pipeline import KVPressPipeline as JaxPipeline
from kvpress_tpu.presses import fastkvzip as jfast
from kvpress_tpu.presses import restorekv as jrestore
import kvpress_tpu_torch as kt
import kvpress_tpu_torch.pipeline as tpipeline
from toy_tokenizer import ToyTokenizer
from torch_scorer_cases import distinct_words, tiny_models

N_RESTORE = 8


def artifacts(cfg_j, tmp_dir):
    """JAX's random gates and restore artifacts, written by the JAX package
    and read back by each package's loader. Returns {"jax": (gates,
    (embeddings, lora, scaling)), "torch": (...)}."""
    gates = jfast.init_random_gates(jax.random.PRNGKey(1), cfg_j)
    key = jax.random.PRNGKey(2)
    embeddings = jax.random.normal(key, (N_RESTORE, cfg_j.hidden_size), jnp.float32) * 0.02
    lora = jrestore.init_random_lora(key, cfg_j)
    rng = np.random.default_rng(9)
    for ab in lora.values():
        ab["b"] = jnp.asarray(rng.standard_normal(ab["b"].shape).astype(np.float32) * 0.05)
    gpath, rpath = str(tmp_dir / "gates.npz"), str(tmp_dir / "restore.npz")
    jfast.save_fastkvzip_gates(gpath, gates)
    jrestore.save_restore_artifacts(rpath, embeddings, lora, scaling=2.0)
    return {"jax": (jfast.load_fastkvzip_gates(gpath), jrestore.load_restore_artifacts(rpath)),
            "torch": (kt.load_fastkvzip_gates(gpath, device="cpu"),
                      kt.load_restore_artifacts(rpath, device="cpu"))}


def make_press(m, name, art):
    """One press of ``name`` made with module ``m``'s names and artifacts
    ``art`` ((gates, (embeddings, lora, scaling)) of that package)."""
    gates, (emb, lora, scaling) = art
    return {
        "kvzip": lambda: m.KVzipPress(0.5, chunk_size=24),
        "kvzip_plus": lambda: m.KVzipPress(0.5, chunk_size=24, kvzip_plus_normalization=True),
        "kvzip_layerwise": lambda: m.KVzipPress(0.4, chunk_size=24, layerwise=True),
        "kvzip_compact": lambda: m.KVzipPress(0.5, chunk_size=24, compact=True),
        "restorekv": lambda: m.RestoreKVPress(0.5, chunk_size=24, restore_embeddings=emb,
                                              lora=lora, lora_scaling=scaling),
        "restorekv_plus": lambda: m.RestoreKVPress(0.5, chunk_size=24, restore_embeddings=emb,
                                                   lora=lora, lora_scaling=scaling,
                                                   kvzip_plus_normalization=True),
        "fastkvzip": lambda: m.FastKVzipPress(0.5, gates=gates, n_sink=2),
        "fastkvzip_layerwise": lambda: m.FastKVzipPress(0.5, gates=gates, layerwise=True),
        "fastkvzip_compact": lambda: m.FastKVzipPress(0.5, gates=gates, n_sink=2, compact=True),
        "kvcompose": lambda: m.KVComposePress(compression_ratio=0.5),
        "kvcompose_unstructured": lambda: m.KVComposePress(compression_ratio=0.5,
                                                           structured=False),
        "kvcompose_mean_max": lambda: m.KVComposePress(compression_ratio=0.5, agg_task="mean",
                                                       agg_group="max"),
        "kvcompose_vnorm": lambda: m.KVComposePress(compression_ratio=0.4, add_v_norm=True,
                                                    agg_head="max", keep_token_lower_bound=4),
    }[name]()


@dataclasses.dataclass
class Pipelines:
    """The tiny models' pipelines in both packages on one toy tokenizer: the
    JAX one on its dense route, the port's on the kernel routes
    (``attn_impl="flash"``, the decode kernel; their plain versions on the
    CPU)."""
    cfg_j: object
    cfg_t: object
    params_j: dict
    params_t: object
    tok: ToyTokenizer
    words: list
    headwise: bool = False

    @staticmethod
    def tiny(n_words: int = 64):
        cfg_j, cfg_t, params_j, params_t = tiny_models()
        tok = ToyTokenizer(cfg_t.vocab_size)
        return Pipelines(cfg_j, cfg_t, params_j, params_t, tok, distinct_words(tok, n_words))

    def context(self, n: int = 60):
        return " ".join(self.words[:n]), "what is " + self.words[n] + " ?"

    def torch_pipe(self, headwise=False, decode_kernel=True):
        runner = (kt.Runner.create(self.cfg_t, attn_impl="flash", decode_kernel=False,
                                   headwise_kernel=True, device="cpu") if headwise else
                  kt.Runner.create(self.cfg_t, attn_impl="flash", decode_kernel=decode_kernel,
                                   device="cpu"))
        return kt.KVPressPipeline(runner, self.params_t, self.tok)

    def jax_pipe(self):
        return JaxPipeline(kj.Runner.create(self.cfg_j, attn_impl="xla"), self.params_j,
                           self.tok)

    def run(self, jpress, tpress, n: int = 60, headwise=False, decode_kernel=True,
            max_new_tokens=8, **kw):
        """Both pipelines on the context of ``n`` words. Returns {side:
        (answer, the compressed cache's lengths, its keep-mask (L, B, H,
        S_buf) or None)} for "jax" and "torch"."""
        context, question = self.context(n)
        out = {}
        for side, module, pipe, press in (
                ("jax", jpipeline, self.jax_pipe(), jpress),
                ("torch", tpipeline, self.torch_pipe(headwise, decode_kernel), tpress)):
            seen = {}
            original = module._generate_answer
            at = 2 if side == "jax" else 3

            def probe(*args, **kwargs):
                cache = args[at]
                seen["lengths"] = np.asarray(cache.length).tolist()
                seen["mask"] = None if cache.mask is None else np.array(cache.mask)
                return original(*args, **kwargs)

            module._generate_answer = probe
            try:
                answer = pipe(context, question=question, press=press,
                              max_new_tokens=max_new_tokens, **kw)["answer"]
            finally:
                module._generate_answer = original
            out[side] = (answer, seen["lengths"], seen["mask"])
        return out


def valid_mask(mask, lengths):
    """A compressed cache's keep bits below each layer's length (L, B, H, S)."""
    if mask is None:
        return None
    S = mask.shape[-1]
    return mask & (np.arange(S) < np.asarray(lengths)[:, None, None, None])


def assert_same(out):
    """Equal answers, lengths and keep bits below the lengths."""
    (ja, jl, jm), (ta, tl, tm) = out["jax"], out["torch"]
    assert tl == jl, (tl, jl)
    jv, tv = valid_mask(jm, jl), valid_mask(tm, tl)
    if jv is None or tv is None:
        assert jv is None or jv.all(), "JAX masked slots the port keeps"
        assert tv is None or tv.all(), "the port masked slots JAX keeps"
    else:
        np.testing.assert_array_equal(tv[..., :jv.shape[-1]], jv[..., :tv.shape[-1]])
    assert ta == ja, (ta, ja)
