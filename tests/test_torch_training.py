"""KVzap training in kvpress_tpu_torch (``training.kvzap``) against the JAX
package on the same weights and inputs (CPU, float32, tiny config): the
repeat prompts, the collector's inputs and targets, the ridge and MLP
trainers, and a trained surrogate through DMS(KVzap)'s prefill.

Tolerances: the collector's X within atol 1e-4 / rtol 1e-3 and y within
1e-3 / 1e-2 (JAX's own limits against the reference); ``train_linear``
within 1e-4 relative; ``fit_mlp`` on JAX's draws within FIT_TOL after 3
epochs (float32 products and autograd's sums in their own order); masks
equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvpress_tpu as kj
from kvpress_tpu.models.llama import quantize_params_int8 as jquant8
from kvpress_tpu.training import kvzap as jtrain
import kvpress_tpu_torch as kt
from kvpress_tpu_torch.training import kvzap as ttrain
from test_chat_template import make_chat_tokenizer
from torch_training_cases import ChatToyTokenizer, documents, jax_mlp_draws

torch.set_num_threads(2)

X_TOL = dict(atol=1e-4, rtol=1e-3)
Y_TOL = dict(atol=1e-3, rtol=1e-2)
FIT_TOL = dict(atol=1e-5, rtol=1e-4)


def numpy_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = kj.tiny_config(), kt.tiny_config()
    params = kj.init_params(cfg_j, jax.random.PRNGKey(0), dtype=jnp.float32)
    return dict(cfg=(cfg_j, cfg_t), params=params,
                runners=(kj.Runner.create(cfg_j, attn_impl="xla"),
                         kt.Runner.create(cfg_t, device="cpu")))


def port_params(tree, cfg_t):
    return kt.params_from_jax(numpy_tree(tree), cfg_t, device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("tokenizer", ["chat_toy", "hf_chars"])
def test_repeat_prompt_tokenization_matches_jax(tokenizer):
    """The same ids and spans from one tokenizer handed to both packages; the
    spans cover the prompt and its repeated copy."""
    tok = ChatToyTokenizer(1024) if tokenizer == "chat_toy" else make_chat_tokenizer()
    prompt = documents(3, 1, 12)[0]
    got = kt.training.repeat_prompt_tokenization(tok, "  " + prompt + "\n")
    want = jtrain.repeat_prompt_tokenization(tok, "  " + prompt + "\n")
    assert got == want
    ids, sp, ep, sr, er = got
    assert 0 < sp < ep < sr < er <= len(ids)
    assert ids[sp:ep] == ids[sr:er]


def _collect(model, ids, spans, params=None, n_tokens=None):
    (_, cfg_t), (jr, tr) = model["cfg"], model["runners"]
    params = params if params is not None else model["params"]
    got = ttrain.collect_scores(tr, port_params(params, cfg_t), ids, spans, n_tokens=n_tokens)
    want = jtrain.collect_scores(jr, params, jnp.asarray(np.asarray(ids)[None]), spans,
                                 n_tokens=n_tokens)
    return [t.numpy() for t in got], [np.asarray(a) for a in want]


@pytest.mark.parametrize("layout", ["chat_template", "hand_spans_subsampled", "int8_weights"])
def test_collector_matches_jax(model, layout):
    """X (L, n, E) and y (L, n, H_kv) equal JAX's ``collect_scores``: a
    chat-template repeat prompt; hand-placed spans over random ids with
    ``n_tokens`` (the same numpy draw picks the same tokens); int8 weights
    (Wo dequantized)."""
    cfg_j, cfg_t = model["cfg"]
    params, n_tokens = model["params"], None
    if layout == "chat_template":
        ids, *spans = kt.training.repeat_prompt_tokenization(
            ChatToyTokenizer(cfg_t.vocab_size), documents(4, 1, 28)[0])
    else:
        ids = np.random.default_rng(5).permutation(cfg_t.vocab_size)[:80]
        spans = (2, 30, 44, 72)
        n_tokens = 17 if layout == "hand_spans_subsampled" else None
        if layout == "int8_weights":
            params = jquant8(params)
    (X, y), (jX, jy) = _collect(model, ids, tuple(spans), params, n_tokens)
    n = n_tokens or spans[1] - spans[0]
    assert X.shape == (cfg_t.num_layers, n, cfg_t.hidden_size)
    assert y.shape == (cfg_t.num_layers, n, cfg_t.num_kv_heads)
    np.testing.assert_allclose(X, jX, **X_TOL)
    np.testing.assert_allclose(y, jy, **Y_TOL)


def test_collector_leaves_the_cache_and_reads_wo_v(model):
    """The collector writes nothing back, and its targets move with the
    ||Wo . v|| factor: a layer whose Wo doubles scores log(2) higher."""
    (_, cfg_t), (_, tr) = model["cfg"], model["runners"]
    p = port_params(model["params"], cfg_t)
    ids = torch.from_numpy(np.random.default_rng(6).permutation(cfg_t.vocab_size)[:40][None])
    spans = (1, 15, 20, 34)
    press = ttrain.KVzipScoreCollector(*spans)
    _, cache, _ = tr.prefill(p, ids, press=press, dtype=torch.float32)
    _, plain, _ = tr.prefill(p, ids, dtype=torch.float32)
    assert torch.equal(cache.keys, plain.keys) and torch.equal(cache.values, plain.values)
    _, y = ttrain.collect_scores(tr, p, ids, spans)
    p.layers[1].wo.data *= 2
    _, y2 = ttrain.collect_scores(tr, p, ids, spans)
    torch.testing.assert_close(y2[1] - y[1], torch.full_like(y[1], float(np.log(2))),
                               atol=1e-5, rtol=0)


def _synthetic(seed=0, N=300, L=2, E=64, H=2):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, L, E)).astype(np.float32)
    w = rng.standard_normal((L, E, H)).astype(np.float32) * 0.2
    y = (np.einsum("nle,leh->nlh", X, w) + np.tanh(X[..., :H]) - 4
         + 0.1 * rng.standard_normal((N, L, H))).astype(np.float32)
    return X, y


def test_train_linear_matches_jax():
    """The batched float32 ridge solve equals JAX's vmapped one within 1e-4
    relative, at alpha 1 and 10."""
    X, y = _synthetic()
    for alpha in (1.0, 10.0):
        got = ttrain.train_linear(torch.from_numpy(X), torch.from_numpy(y), alpha=alpha)
        want = jtrain.train_linear(jnp.asarray(X), jnp.asarray(y), alpha=alpha)
        for k in ("w", "b"):
            scale = np.abs(np.asarray(want[k])).max()
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                       atol=1e-4 * scale)


@pytest.mark.parametrize("batch_size", [32, 100])
def test_fit_mlp_on_jax_draws_matches_train_mlp(batch_size):
    """Given JAX's draws, the port's trainer gives JAX's surrogate after 3
    epochs and JAX's history (AdamW with decay 1e-4, the global-norm clip,
    the cosine rate, exact GELU; batch 100 drops a remainder of 85)."""
    X, y = _synthetic(1)
    N, L, E = X.shape
    H = y.shape[2]
    surrogate, perm, orders, n_val = jax_mlp_draws(N, L, E, H, 32, 3)
    got, gm = ttrain.fit_mlp(torch.from_numpy(X), torch.from_numpy(y),
                             {k: torch.from_numpy(v) for k, v in surrogate.items()},
                             torch.from_numpy(perm), [torch.from_numpy(o) for o in orders],
                             batch_size=batch_size, n_val=n_val)
    want, wm = jtrain.train_mlp(jnp.asarray(X), jnp.asarray(y), hidden_dim=32, max_epochs=3,
                                batch_size=batch_size)
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **FIT_TOL, err_msg=k)
    assert [h["epoch"] for h in gm["history"]] == [0, 1, 2]
    for a, b in zip(gm["history"], wm["history"]):
        np.testing.assert_allclose([a["train_loss"], a["val_loss"]],
                                   [b["train_loss"], b["val_loss"]], rtol=1e-5)
    assert gm["history"][-1]["val_loss"] < gm["history"][0]["val_loss"]
    # The clip acts: the first step's gradient norm is above 1.
    s0 = {k: torch.from_numpy(v).requires_grad_(True) for k, v in surrogate.items()}
    idx = torch.from_numpy(perm[n_val:][orders[0][:batch_size]])
    loss = ttrain._mse(s0, torch.from_numpy(X)[idx], torch.from_numpy(y)[idx])
    assert float(torch.sqrt(sum((g * g).sum() for g in torch.autograd.grad(
        loss, list(s0.values()))))) > 1


def test_init_mlp_surrogate_and_train_mlp_draws():
    """Shapes, zero biases and the uniform bounds of the initial surrogate;
    ``train_mlp`` is ``fit_mlp`` on the seed's draws, so a seed repeats its
    surrogate and the loss falls."""
    g = torch.Generator().manual_seed(0)
    s = ttrain.init_mlp_surrogate(g, 3, 64, 32, 2)
    assert {k: tuple(v.shape) for k, v in s.items()} == {
        "w1": (3, 64, 32), "b1": (3, 32), "w2": (3, 32, 2), "b2": (3, 2)}
    assert float(s["w1"].abs().max()) <= 64 ** -0.5 and float(s["w2"].abs().max()) <= 32 ** -0.5
    assert float(s["w1"].abs().max()) > 0.9 * 64 ** -0.5
    assert not s["b1"].any() and not s["b2"].any()
    X, y = (torch.from_numpy(a) for a in _synthetic(2))
    a, ma = ttrain.train_mlp(X, y, hidden_dim=32, max_epochs=4, batch_size=64, seed=3)
    b, _ = ttrain.train_mlp(X, y, hidden_dim=32, max_epochs=4, batch_size=64, seed=3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert ma["history"][-1]["val_loss"] < ma["history"][0]["val_loss"]


def test_trained_surrogate_masks_jax_slots(model):
    """Targets collected by the port over 3 documents, a linear and an MLP
    surrogate trained by the port, then DMS(KVzap) at the median prediction:
    the port's prefill clears JAX's keep bits, and the linear fit beats the
    mean (R^2 > 0)."""
    (cfg_j, cfg_t), (jr, tr) = model["cfg"], model["runners"]
    p = port_params(model["params"], cfg_t)
    tok = ChatToyTokenizer(cfg_t.vocab_size)
    Xs, ys = [], []
    for doc in documents(7, 3, 30):
        ids, *spans = kt.training.repeat_prompt_tokenization(tok, doc)
        X, y = ttrain.collect_scores(tr, p, ids, tuple(spans))
        Xs.append(X.transpose(0, 1))
        ys.append(y.transpose(0, 1))
    X, y = torch.cat(Xs), torch.cat(ys)
    linear = ttrain.train_linear(X, y)
    pred = torch.einsum("nle,leh->nlh", X, linear["w"]) + linear["b"]
    assert float(((pred - y) ** 2).sum()) < float(((y - y.mean(0)) ** 2).sum())
    mlp, _ = ttrain.train_mlp(X, y, hidden_dim=32, max_epochs=3, batch_size=32)
    ids = np.asarray(tok.encode(documents(8, 1, 64)[0]))[None]
    # Three epochs of two steps leave the MLP short of the targets' offset:
    # each surrogate is thresholded at the median of its own predictions.
    for surrogate, pred in ((linear, pred), (mlp, ttrain.mlp_predict(mlp, X))):
        threshold = float(pred.median())
        s_np = {k: v.numpy() for k, v in surrogate.items()}
        jpress = kj.DMSPress(kj.KVzapPress(surrogate={k: jnp.asarray(v)
                                                      for k, v in s_np.items()}),
                             threshold=threshold, sliding_window_size=16)
        tpress = kt.DMSPress(kt.KVzapPress(surrogate=s_np), threshold=threshold,
                             sliding_window_size=16)
        _, jc, _ = jr.prefill(model["params"], jnp.asarray(ids), press=jpress, dtype=jnp.float32)
        _, tc, _ = tr.prefill(p, torch.from_numpy(ids), press=tpress, dtype=torch.float32)
        np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
        frac = float(kt.masked_fraction(tc))
        assert 0 < frac < 1, frac
