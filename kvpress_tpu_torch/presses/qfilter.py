"""QFilterPress: learned per-(layer, kv-head) filter vectors (reference
qfilter_press.py:53-82; port of ``kvpress_tpu/presses/qfilter.py``).
Score = -<q_filter, k>.

The filters are an (L, H_kv, D) array loaded from a local ``.npz`` /
``.npy`` / ``.safetensors`` file (the reference downloads
``nthngdy/<model>_qfilt``)."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .base import LayerCtx, ScorerPress, layer_tensor


def load_q_filters(path: str) -> np.ndarray:
    """A (num_layers, num_kv_heads, head_dim) filter bank from a local .npz,
    .npy or .safetensors file."""
    if path.endswith(".npz"):
        data = np.load(path)
        return data[list(data.keys())[0]]
    if path.endswith(".npy"):
        return np.load(path)
    from safetensors import safe_open     # only this format needs it

    with safe_open(path, framework="np") as f:
        return f.get_tensor("q_filters")


@dataclasses.dataclass(frozen=True)
class QFilterPress(ScorerPress):
    q_filters: Any = None     # (L, H_kv, D) numpy array or tensor

    # The filters are an array: presses compare and hash by identity.
    __eq__ = object.__eq__
    __hash__ = object.__hash__

    def score(self, ctx: LayerCtx, keys, values):
        if self.q_filters is None:
            raise ValueError("Q-filters not loaded; pass q_filters=load_q_filters(path)")
        filt = layer_tensor(self.q_filters, ctx.layer_idx, keys.device)     # (H_kv, D)
        return -torch.einsum("bhsd,hd->bhs", keys.to(torch.float32), filt)
