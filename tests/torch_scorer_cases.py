"""Shared cases of the scorer-press parity tests of kvpress_tpu_torch
(tests/test_torch_scorer_presses.py, test_torch_scorer_prefill.py and
test_torch_bucketing.py): the presses with seeded stand-ins for their trained
artifacts, the tiny models of both packages, and the JAX sketches.

The random sketches (CUR's ``use_random_leverage``, the leverage scores of
LeverageScorePress and Compactor) are drawn by ``jax.random`` in the JAX
package and by a seeded ``torch.Generator`` in the port, so the numbers
differ: ``use_jax_sketches`` hands the port the JAX package's draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import kvpress_tpu as kj
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.presses import compactor as tcompactor
from kvpress_tpu_torch.presses import cur as tcur

TOL = dict(atol=1e-5, rtol=1e-5)
SOLVE_TOL = dict(atol=1e-4, rtol=1e-4)


def as_torch(a):
    return torch.from_numpy(np.array(a))


def jax_sketch(seed, layer_idx, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), layer_idx)
    return np.asarray(jax.random.normal(key, shape, jnp.float32) / jnp.sqrt(shape[-1] * 1.0))


def use_jax_sketches(monkeypatch):
    """Replace the port's sketches by the JAX package's draws."""
    monkeypatch.setattr(tcur.CURPress, "sketch", lambda self, ctx, d, device: as_torch(
        jax_sketch(self.seed, ctx.layer_idx, (d, tcur.SKETCH_RANK))).to(device))
    monkeypatch.setattr(tcompactor.LeverageScorePress, "sketch", lambda self, ctx, shape, device:
                        as_torch(jax_sketch(self.seed, ctx.layer_idx,
                                            (*shape, self.sketch_dimension))).to(device))


def _artifacts(cfg, seed=3):
    """Seeded stand-ins for the trained artifacts: a Q-filter bank, query
    statistics and a KVzap MLP surrogate (and a linear one)."""
    rng = np.random.default_rng(seed)
    L, Hq, Hkv, D, E = (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                        cfg.hidden_size)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    a = f(L, Hq, D, D) * 0.3
    return dict(
        q_filters=f(L, Hkv, D),
        stats={"mu": f(L, Hq, D), "cov": np.einsum("lhij,lhkj->lhik", a, a)},
        mlp={"w1": f(L, E, 32) * 0.2, "b1": f(L, 32) * 0.1, "w2": f(L, 32, Hkv) * 0.2,
             "b2": f(L, Hkv) * 0.1},
        linear={"w": f(L, E, Hkv) * 0.2, "b": f(L, Hkv) * 0.1})


ART = _artifacts(kj.tiny_config())


def _surrogate(m, kind):
    # The JAX press indexes its surrogate by a traced layer: jnp arrays.
    return ART[kind] if m is kt else {k: jnp.asarray(v) for k, v in ART[kind].items()}


# name: press(module), made with the module's names.
PRESSES = {
    "expected_attention": lambda m: m.ExpectedAttentionPress(0.5, n_future_positions=16),
    "expected_attention_no_cov": lambda m: m.ExpectedAttentionPress(
        0.5, use_covariance=False, use_vnorm=False, n_sink=2),
    "expected_attention_eps": lambda m: m.ExpectedAttentionPress(0.5, epsilon=0.01),
    "expected_attention_stats": lambda m: m.ExpectedAttentionStatsPress(
        0.5, n_future_positions=16, stats=ART["stats"]),
    "keydiff": lambda m: m.KeyDiffPress(0.5),
    "lagkv": lambda m: m.LagKVPress(0.5, lag_size=8),
    "lagkv_cross": lambda m: m.LagKVPress(0.5, lag_size=8, cross_scoring=True),
    "lagkv_short": lambda m: m.LagKVPress(0.5, lag_size=64),
    "cur_key": lambda m: m.CURPress(0.5, leverage_type="key", local_window_size=8),
    "cur_value": lambda m: m.CURPress(0.5, leverage_type="value"),
    "cur_kv_avg": lambda m: m.CURPress(0.5, leverage_type="kv_avg", local_window_size=7),
    "cur_kv_product": lambda m: m.CURPress(0.5, use_local_approximation=False),
    "cur_random": lambda m: m.CURPress(0.5, use_random_leverage=True, seed=5),
    "qfilter": lambda m: m.QFilterPress(0.5, q_filters=ART["q_filters"]),
    "cap": lambda m: m.CapPress(0.5, n_future_positions=16),
    "noncausal": lambda m: m.NonCausalAttnPress(0.5, chunk_size=16),
    "noncausal_ragged": lambda m: m.NonCausalAttnPress(0.5, chunk_size=24),
    "leverage": lambda m: m.LeverageScorePress(0.5, sketch_dimension=8),
    "compactor": lambda m: m.CompactorPress(0.5, chunk_size=16, sketch_dimension=8),
    "compactor_blend0": lambda m: m.CompactorPress(0.5, chunk_size=16, sketch_dimension=8,
                                                  blending=0.0),
    "compactor_blend03": lambda m: m.CompactorPress(0.3, chunk_size=32, sketch_dimension=8,
                                                   blending=0.3),
    "compactor_blend1": lambda m: m.CompactorPress(0.5, chunk_size=16, sketch_dimension=8,
                                                  blending=1.0, sink_size_end=0),
    "kvzap_mlp": lambda m: m.KVzapPress(0.5, surrogate=_surrogate(m, "mlp")),
    "kvzap_linear": lambda m: m.KVzapPress(0.5, surrogate=_surrogate(m, "linear")),
}
# Presses with a linear solve or a Cholesky factor between input and score.
SOLVED = ("cap", "leverage", "compactor")


def tol(name):
    return SOLVE_TOL if name.startswith(SOLVED) else TOL


def both(name):
    """(JAX press, port press) of one name."""
    from kvpress_tpu import presses as jp
    return PRESSES[name](jp), PRESSES[name](kt)


def tiny_models(scale_qk: float = 6.0):
    """Tiny-config weights in both packages; wq and wk scaled up so that
    attention is peaked and heads differ (N(0, 0.02) weights at this width
    give near-uniform attention)."""
    cfg_j, cfg_t = kj.tiny_config(), kt.tiny_config()
    params_j = kj.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    layers = dict(params_j["layers"])
    layers["wq"], layers["wk"] = layers["wq"] * scale_qk, layers["wk"] * scale_qk
    params_j = dict(params_j, layers=layers)
    params_t = kt.params_from_jax(jax.tree_util.tree_map(np.asarray, params_j), cfg_t,
                                  device="cpu", dtype=torch.float32)
    return cfg_j, cfg_t, params_j, params_t


def seeded_ids(vocab, n, seed):
    """n distinct token ids (ties of content scores would break apart
    differently)."""
    return np.random.default_rng(seed).permutation(np.arange(3, vocab))[:n][None].astype(np.int32)


def kept_rows(keys, layer, n):
    """The first n key rows of each (batch, head) of one layer as a set:
    float64, sorted by their first channel."""
    k = np.asarray(keys, np.float64)[layer, :, :, :n]
    order = np.argsort(k[..., 0], axis=-1)
    return np.take_along_axis(k, order[..., None], axis=2)


def distinct_words(tok, n):
    """n words that the toy tokenizer maps to distinct ids."""
    seen, words, i = set(), [], 0
    while len(words) < n:
        t = tok.encode(f"word{i}")[0]
        if t not in seen:
            seen.add(t)
            words.append(f"word{i}")
        i += 1
    return words
