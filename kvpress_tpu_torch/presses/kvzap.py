"""KVzapPress: learned surrogate scoring (reference kvzap_press.py,
arXiv:2601.07891; port of ``kvpress_tpu/presses/kvzap.py``). A per-layer
linear map or two-layer GELU MLP takes the hidden states to per-kv-head
scores. ``training.kvzap`` collects the targets and trains the surrogate.

Under a tensor-parallel mesh a rank scores its own kv heads: the columns of
the output layer (``w2``/``b2``, or ``w``/``b``) from kv head
``shard.rank * H_kv`` on.

The surrogate is a dict of stacked (L, ...) arrays (numpy or tensors) from a
local ``.npz`` file (the reference downloads ``nvidia/KVzap-{mlp,linear}-*``):
{"w1", "b1", "w2", "b2"} for the MLP, {"w", "b"} for the linear map."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .base import LayerCtx, ScorerPress, layer_tensor


def kvzap_apply(surrogate: dict, layer_idx: int, hidden: torch.Tensor,
                heads: Optional[slice] = None) -> torch.Tensor:
    """hidden (B, S, E) -> scores (B, H_kv, S) for one layer; ``heads``
    keeps those kv heads' output columns only."""
    h = hidden.to(torch.float32)
    w = lambda name: layer_tensor(surrogate[name], layer_idx, h.device)
    cols = slice(None) if heads is None else heads
    if "w1" in surrogate:
        z = F.gelu(h @ w("w1") + w("b1"), approximate="none")
        out = z @ w("w2")[:, cols] + w("b2")[cols]
    else:
        out = h @ w("w")[:, cols] + w("b")[cols]
    return out.transpose(1, 2)


def local_heads(shard, n_local: int) -> Optional[slice]:
    """The kv heads of a rank that holds ``n_local`` of them (None without a
    mesh)."""
    return None if shard is None else slice(shard.rank * n_local, (shard.rank + 1) * n_local)


def save_kvzap_model(path: str, surrogate: dict) -> None:
    np.savez(path, **{k: np.asarray(torch.as_tensor(v).cpu()) for k, v in surrogate.items()})


def load_kvzap_model(path: str) -> dict:
    data = np.load(path)
    return {k: data[k] for k in data.files}


def _kvzap_chunk_scores(arg, layer_idx, hidden, keys, values):
    """Per-token chunk scoring: the surrogate scores each token from its own
    hidden state, so a chunk's scores are exact. ``arg``: the surrogate, or
    (surrogate, heads) under a mesh (``chunk_score_arg_local``)."""
    surrogate, heads = arg if isinstance(arg, tuple) else (arg, None)
    return kvzap_apply(surrogate, layer_idx, hidden, heads)


@dataclasses.dataclass(frozen=True)
class KVzapPress(ScorerPress):
    surrogate: Optional[dict] = None

    chunk_score_fn = staticmethod(_kvzap_chunk_scores)

    # The surrogate holds arrays: presses compare and hash by identity.
    __eq__ = object.__eq__
    __hash__ = object.__hash__

    @property
    def chunk_score_arg(self):
        return self.surrogate

    def chunk_score_arg_local(self, shard, n_local: int):
        return self.surrogate, local_heads(shard, n_local)

    def score(self, ctx: LayerCtx, keys, values):
        if self.surrogate is None:
            raise ValueError("KVzap surrogate not loaded; pass surrogate=load_kvzap_model(path)")
        if ctx.hidden.shape[1] != keys.shape[2]:
            raise ValueError(f"KVzapPress scores each slot from its own hidden state: it has "
                             f"{ctx.hidden.shape[1]} for {keys.shape[2]} slots (chunked "
                             f"prefill's compression pass keeps only the last window's)")
        return kvzap_apply(self.surrogate, ctx.layer_idx, ctx.hidden,
                           local_heads(ctx.shard, keys.shape[1]))
