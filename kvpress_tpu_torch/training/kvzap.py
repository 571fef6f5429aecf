"""KVzap training (port of ``kvpress_tpu/training/kvzap.py``; reference
kvzap/data.py and kvzap/train.py).

- Collection: ``KVzipScoreCollector`` is a press run inside one dense
  prefill of a repeat prompt (the context, then the instruction to repeat
  it, then the context again). For each layer it takes the KVzip+ targets:
  attention / ||hidden|| over the query row, times ||Wo_h . v|| over the key
  column, the max over the repeated copy's queries and then over the GQA
  group, logged; and the layer's hidden states over the prompt as inputs.
  Only the (repeat queries) x (prompt keys) block of the product is formed:
  the same arithmetic as JAX's, without its (Hq, S, S) float32
  intermediates.
- Training: a two-layer GELU MLP per layer, all layers in one step
  (``torch.autograd``), with JAX's optax chain written out by hand:
  ``clip_by_global_norm(1.0)``, then ``adamw`` (b1 0.9, b2 0.999, eps 1e-8,
  weight decay 1e-4 on every tensor) under a cosine decay of the rate over
  every step. ``fit_mlp`` is that arithmetic given the initial surrogate,
  the validation permutation and each epoch's order; ``train_mlp`` draws
  them from a ``torch.Generator`` seeded by ``seed`` (not JAX's draws, which
  torch cannot make). ``train_linear`` is the closed-form ridge per layer.

The surrogates are the dicts ``KVzapPress`` and ``save_kvzap_model`` take:
{"w1", "b1", "w2", "b2"} (MLP) or {"w", "b"} (linear), stacked over layers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..models.llama import dequant_weight
from ..presses.base import BasePress, LayerCtx


# --------------------------------------------------------------------------- #
# Data collection
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class KVzipScoreCollector(BasePress):
    """Collector press: the KVzip+ targets of a repeat-prompt prefill
    (reference KVzapDataCollector._forward_hook, kvzap/data.py:173-222).
    [start_prompt, end_prompt) is the context, [start_rep, end_rep) its
    repeated copy. State per layer: {"X": (n, E) float32 hidden states of
    the context, "y": (n, H_kv) float32 log-scores}, n = end_prompt -
    start_prompt (batch 1). It only reads the layer."""

    start_prompt: int = 0
    end_prompt: int = 0
    start_rep: int = 0
    end_rep: int = 0

    needs_attn_probs = True
    writes_cache = False

    def init_state(self, cfg, batch: int, seq_len: int, dtype=None, device=None):
        return [None] * cfg.num_layers

    def layer_compress(self, ctx: LayerCtx, keys, values, length, mask, state=None):
        cfg = ctx.cfg
        B, Hkv, _, D = keys.shape
        Hq = cfg.num_heads
        G = Hq // Hkv
        prompt = slice(self.start_prompt, self.end_prompt)
        rep = slice(self.start_rep, self.end_rep)
        hidden = ctx.hidden.to(torch.float32)
        attn = ctx.attn_probs[:, :, rep, prompt].to(torch.float32)      # (B, Hq, r, n)
        h_norm = torch.linalg.vector_norm(hidden[:, rep], dim=-1)        # (B, r)
        scores = attn / h_norm[:, None, :, None]
        Wo = dequant_weight(ctx.layer_params, "wo", torch.float32).reshape(Hkv, G, D, -1)
        v = values[:, :, prompt].to(torch.float32)                       # (B, Hkv, n, D)
        wov = torch.linalg.vector_norm(torch.einsum("bknd,kgde->bkgne", v, Wo), dim=-1)
        scores = scores * wov.reshape(B, Hq, 1, -1)
        sub = scores.amax(dim=2).reshape(B, Hkv, G, -1).amax(dim=2)      # (B, Hkv, n)
        y = torch.log(sub)[0].T                                          # (n, Hkv)
        X = hidden[0, prompt]
        return keys, values, length, mask, {"X": X, "y": y}


def repeat_prompt_tokenization(tokenizer, prompt: str):
    """Tokenize ``user: prompt + repeat instruction / assistant: prompt`` with
    the tokenizer's chat template and locate the prompt's and the repeated
    prompt's token spans by the offset mapping (reference
    kvzap/data.py:90-141). Returns (ids, start_prompt, end_prompt,
    start_rep, end_rep)."""
    prompt = prompt.strip()
    messages = [
        {"role": "user", "content": prompt + "\n\nRepeat the previous context exactly."},
        {"role": "assistant", "content": prompt},
    ]
    text = tokenizer.apply_chat_template(messages, tokenize=False)
    enc = tokenizer(text, return_offsets_mapping=True)
    starts = [o[0] for o in enc["offset_mapping"]] + [len(text)]
    prefix, repeat, _ = text.split(prompt)

    def first_at_least(x):
        return next(i for i, s in enumerate(starts) if s >= x)

    start_prompt = first_at_least(len(prefix))
    end_prompt = first_at_least(len(prefix) + len(prompt))
    start_rep = first_at_least(len(prefix) + len(prompt) + len(repeat))
    end_rep = first_at_least(len(prefix) + 2 * len(prompt) + len(repeat))
    return enc["input_ids"], start_prompt, end_prompt, start_rep, end_rep


def collect_scores(runner, params, ids, spans, rng=None, n_tokens: Optional[int] = None):
    """One repeat-prompt prefill with the collector (a float32 cache, no
    logits). ``ids``: (1, S) or (S,) token ids; ``spans``: (start_prompt,
    end_prompt, start_rep, end_rep). Returns (X (L, n, E), y (L, n, H_kv))
    float32 on the runner's device; with ``n_tokens``, the tokens of
    ``rng.permutation(n)[:n_tokens]`` (``rng`` a numpy ``Generator``, by
    default ``np.random.default_rng(0)``: the JAX package's draw)."""
    start_prompt, end_prompt, start_rep, end_rep = spans
    press = KVzipScoreCollector(start_prompt=start_prompt, end_prompt=end_prompt,
                                start_rep=start_rep, end_rep=end_rep)
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64, device=runner.device)
    ids = ids.reshape(1, -1) if ids.dim() == 1 else ids
    _, _, states = runner.prefill(params, ids, press=press, dtype=torch.float32,
                                  compute_logits=False)
    X = torch.stack([s["X"] for s in states])
    y = torch.stack([s["y"] for s in states])
    if n_tokens is not None:
        rng = rng or np.random.default_rng(0)
        sel = torch.as_tensor(rng.permutation(X.shape[1])[:n_tokens], device=X.device)
        X, y = X[:, sel], y[:, sel]
    return X, y


# --------------------------------------------------------------------------- #
# Surrogate training
# --------------------------------------------------------------------------- #


def init_mlp_surrogate(generator: torch.Generator, num_layers: int, input_dim: int,
                       hidden_dim: int, output_dim: int) -> dict:
    """w1 ~ U(-1/sqrt(input_dim), +), w2 ~ U(-1/sqrt(hidden_dim), +), zero
    biases, float32 on the generator's device."""
    dev = generator.device

    def uniform(shape, lim):
        u = torch.rand(shape, generator=generator, device=dev, dtype=torch.float32)
        return u * (2 * lim) - lim

    return {
        "w1": uniform((num_layers, input_dim, hidden_dim), (1.0 / input_dim) ** 0.5),
        "b1": torch.zeros((num_layers, hidden_dim), dtype=torch.float32, device=dev),
        "w2": uniform((num_layers, hidden_dim, output_dim), (1.0 / hidden_dim) ** 0.5),
        "b2": torch.zeros((num_layers, output_dim), dtype=torch.float32, device=dev),
    }


def mlp_predict(surrogate: dict, xb: torch.Tensor) -> torch.Tensor:
    """xb (B, L, E) -> (B, L, H_kv), every layer's MLP at once."""
    z = torch.einsum("ble,leh->blh", xb, surrogate["w1"]) + surrogate["b1"]
    z = F.gelu(z, approximate="none")
    return torch.einsum("blh,lho->blo", z, surrogate["w2"]) + surrogate["b2"]


def _mse(surrogate, xb, yb):
    return torch.mean((mlp_predict(surrogate, xb) - yb) ** 2)


def cosine_decay(lr: float, decay_steps: int, count: int) -> float:
    """``optax.cosine_decay_schedule(lr, decay_steps)`` at ``count``."""
    count = min(count, decay_steps)
    return lr * 0.5 * (1 + math.cos(math.pi * count / decay_steps))


# optax.adamw's defaults and the trainer's clip (optax.clip_by_global_norm).
ADAM_B1, ADAM_B2, ADAM_EPS, WEIGHT_DECAY, MAX_NORM = 0.9, 0.999, 1e-8, 1e-4, 1.0


def fit_mlp(X: torch.Tensor, y: torch.Tensor, surrogate: dict, perm: torch.Tensor,
            orders: Sequence[torch.Tensor], lr: float = 1e-3, batch_size: int = 512,
            n_val: int = 1) -> tuple[dict, dict]:
    """``train_mlp``'s arithmetic on given draws: the first ``n_val`` rows of
    ``X[perm]`` validate, the rest train in epochs of ``orders[e]`` (one
    permutation of the training rows an epoch) cut into ``batch_size``
    batches, the remainder dropped. Each step: the mean-squared loss over
    (B, L, H), its gradients clipped to global norm MAX_NORM (``g * MAX_NORM
    / ||g||`` when ``||g|| >= MAX_NORM``), then AdamW with bias-corrected
    moments, decoupled weight decay on every tensor and the rate
    ``cosine_decay(lr, epochs * steps, step)``. Returns (surrogate,
    {"history": [{"epoch", "train_loss", "val_loss"}, ...]})."""
    b1, b2 = ADAM_B1, ADAM_B2
    Xs, ys = X[perm], y[perm]
    X_val, y_val = Xs[:n_val], ys[:n_val]
    X_tr, y_tr = Xs[n_val:], ys[n_val:]
    steps_per_epoch = max(1, len(X_tr) // batch_size)
    total = len(orders) * steps_per_epoch
    params = {k: v.detach().clone().to(torch.float32).requires_grad_(True)
              for k, v in surrogate.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    count = 0
    history = []
    for epoch, order in enumerate(orders):
        epoch_loss = 0.0
        for i in range(steps_per_epoch):
            idx = order[i * batch_size:(i + 1) * batch_size]
            loss = _mse(params, X_tr[idx], y_tr[idx])
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                clip = g_norm < MAX_NORM
                rate = cosine_decay(lr, total, count)
                count += 1
                c1, c2 = 1 - b1 ** count, 1 - b2 ** count
                for (name, p), g in zip(params.items(), grads):
                    g = torch.where(clip, g, (g / g_norm) * MAX_NORM)
                    mu[name] = (1 - b1) * g + b1 * mu[name]
                    nu[name] = (1 - b2) * (g * g) + b2 * nu[name]
                    update = (mu[name] / c1) / (torch.sqrt(nu[name] / c2) + ADAM_EPS)
                    p.add_(-rate * (update + WEIGHT_DECAY * p))
            epoch_loss += float(loss.detach())
        with torch.no_grad():
            val_loss = float(_mse(params, X_val, y_val))
        history.append({"epoch": epoch, "train_loss": epoch_loss / steps_per_epoch,
                        "val_loss": val_loss})
    return {k: v.detach() for k, v in params.items()}, {"history": history}


def train_mlp(X: torch.Tensor, y: torch.Tensor, hidden_dim: int = 512, max_epochs: int = 10,
              lr: float = 1e-3, batch_size: int = 512, seed: int = 0,
              val_fraction: float = 0.05) -> tuple[dict, dict]:
    """Per-layer two-layer GELU MLP surrogates on X (N, L, E) -> y (N, L,
    H_kv) (reference train.py:28-84): the initial surrogate, the validation
    permutation and each epoch's order drawn from a ``torch.Generator`` on
    X's device seeded by ``seed``, then ``fit_mlp``. Returns (surrogate,
    {"history": [...]})."""
    X = torch.as_tensor(X, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=X.device)
    N, L, E = X.shape
    gen = torch.Generator(device=X.device).manual_seed(seed)
    surrogate = init_mlp_surrogate(gen, L, E, hidden_dim, y.shape[2])
    n_val = max(1, int(N * val_fraction))
    perm = torch.randperm(N, generator=gen, device=X.device)
    orders = [torch.randperm(N - n_val, generator=gen, device=X.device)
              for _ in range(max_epochs)]
    return fit_mlp(X, y, surrogate, perm, orders, lr=lr, batch_size=batch_size, n_val=n_val)


def train_linear(X: torch.Tensor, y: torch.Tensor, alpha: float = 1.0) -> dict:
    """Closed-form ridge with intercept per layer (reference
    train.py:87-119), all layers in one batched float32 solve: X (N, L, E),
    y (N, L, H_kv) -> {"w": (L, E, H_kv), "b": (L, H_kv)}."""
    Xf = torch.as_tensor(X, dtype=torch.float32).transpose(0, 1)         # (L, N, E)
    yf = torch.as_tensor(y, dtype=torch.float32, device=Xf.device).transpose(0, 1)
    mx, my = Xf.mean(dim=1), yf.mean(dim=1)                             # (L, E), (L, H)
    Xc, yc = Xf - mx[:, None], yf - my[:, None]
    E = Xf.shape[2]
    G = Xc.transpose(1, 2) @ Xc + alpha * torch.eye(E, device=Xf.device)
    W = torch.linalg.solve(G, Xc.transpose(1, 2) @ yc)                  # (L, E, H)
    b = my - torch.einsum("le,leh->lh", mx, W)
    return {"w": W, "b": b}
