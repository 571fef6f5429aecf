"""Shared cases of the KVzap training parity tests (tests/test_torch_training.py):
a word-level tokenizer with a chat template and offsets, synthetic documents
from a seed, and JAX's draws of ``train_mlp`` made as the JAX trainer makes
them, for the port's ``fit_mlp``."""

import re

import numpy as np

from toy_tokenizer import ToyTokenizer


class ChatToyTokenizer(ToyTokenizer):
    """``ToyTokenizer`` with the two calls ``repeat_prompt_tokenization``
    makes: a chat template (``<|role|> content <|end|>`` per message) and
    ``__call__`` with the character offsets of each whitespace-separated
    token."""

    chat_template = "<|role|> content <|end|>"

    def apply_chat_template(self, messages, tokenize=False, add_generation_prompt=False):
        text = "".join(f"<|{m['role']}|> {m['content']} <|end|> " for m in messages)
        return self.encode(text) if tokenize else text

    def __call__(self, text, return_offsets_mapping=False, add_special_tokens=False):
        spans = [(m.start(), m.end()) for m in re.finditer(r"\S+", text)]
        out = {"input_ids": [self._tok2id(text[a:b]) for a, b in spans]}
        if return_offsets_mapping:
            out["offset_mapping"] = spans
        return out


def documents(seed: int, n: int, words: int, vocab: int = 400) -> list[str]:
    """``n`` documents of ``words`` words drawn from ``vocab`` distinct
    words."""
    rng = np.random.default_rng(seed)
    return [" ".join(f"t{i}" for i in rng.integers(0, vocab, words)) for _ in range(n)]


def jax_mlp_draws(N: int, L: int, E: int, H: int, hidden_dim: int, max_epochs: int,
                  seed: int = 0, val_fraction: float = 0.05):
    """The draws of JAX's ``train_mlp`` (its initial surrogate, validation
    permutation and epoch orders) as numpy arrays, made by its own calls in
    its order."""
    import jax

    from kvpress_tpu.training.kvzap import init_mlp_surrogate

    key = jax.random.PRNGKey(seed)
    key, init_key, perm_key = jax.random.split(key, 3)
    surrogate = {k: np.array(v) for k, v in
                 init_mlp_surrogate(init_key, L, E, hidden_dim, H).items()}
    n_val = max(1, int(N * val_fraction))
    perm = np.array(jax.random.permutation(perm_key, N))
    orders = []
    for _ in range(max_epochs):
        key, ek = jax.random.split(key)
        orders.append(np.array(jax.random.permutation(ek, N - n_val)))
    return surrogate, perm, orders, n_val
