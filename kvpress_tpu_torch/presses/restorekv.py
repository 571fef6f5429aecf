"""RestoreKVPress (reference restorekv_press.py, arXiv:2608.01247; port of
``kvpress_tpu/presses/restorekv.py``): KVzip with learned restoration. Before
the eviction, ``n`` restore-token embeddings attend the whole cache in one
LoRA-adapted forward, appending ``n`` slots of context-conditioned restore
cache; the eviction then runs budget-matched (ratio + n / context length).

The artifacts (restore embeddings, the LoRA factors of each adapted
projection stacked over layers, the scaling) cross between the packages as
one ``.npz`` (``save_restore_artifacts`` / ``load_restore_artifacts``, the
JAX package's keys)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .kvzip import KVzipPress

LORA_TARGETS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def apply_lora(params, lora: dict, scaling: float = 2.0):
    """A new ``LlamaModel`` whose adapted projections are ``W + scaling *
    A @ B`` (lora: {name: {"a": (L, in, r), "b": (L, r, out)}}); every other
    tensor is shared with ``params``. Quantized weights are refused: a sum
    with their payload has no meaning."""
    from ..models.llama import LlamaModel

    layers = []
    for l, layer in enumerate(params.layers):
        t = {name: p.data for name, p in layer.named_parameters(recurse=False)}
        for name, ab in lora.items():
            if name + "_scale" in t:
                raise ValueError(f"apply_lora merges into float weights; {name} is quantized "
                                 "(merge the adapter before quantizing)")
            w = t[name]
            a = torch.as_tensor(ab["a"][l], dtype=torch.float32, device=w.device)
            b = torch.as_tensor(ab["b"][l], dtype=torch.float32, device=w.device)
            t[name] = w + ((a @ b) * scaling).to(w.dtype)
        layers.append(t)
    head = params.get("lm_head")
    extra = {n: params.get(n).data for n in ("embed_scale", "lm_head_scale")
             if params.get(n) is not None}
    return LlamaModel(params.embed.data, layers, params.ln_f.data,
                      None if head is None else head.data, extra)


def init_random_lora(generator: torch.Generator, cfg, rank: int = 8,
                     targets=("wq", "wk", "wv", "wo"), device: DeviceLike = "cuda") -> dict:
    """A random adapter as the reference's test fixture installs one
    (tests/default_presses.py:86-99): A ~ N(0, 0.01^2), B = 0, drawn from
    ``generator`` (which must live on ``device``)."""
    device = resolve_device(device)
    E, F = cfg.hidden_size, cfg.intermediate_size
    Hq, Hkv, D, L = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    dims = {"wq": (E, Hq * D), "wk": (E, Hkv * D), "wv": (E, Hkv * D), "wo": (Hq * D, E),
            "wg": (E, F), "wu": (E, F), "wd": (F, E)}
    lora = {}
    for name in targets:
        i_dim, o_dim = dims[name]
        lora[name] = {
            "a": torch.randn((L, i_dim, rank), generator=generator, device=device) * 0.01,
            "b": torch.zeros((L, rank, o_dim), device=device)}
    return lora


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_restore_artifacts(path: str, embeddings, lora: dict, scaling: float = 2.0) -> None:
    flat = {"restore_embeddings": _np(embeddings),
            "lora_scaling": np.asarray(scaling, np.float32)}
    for name, ab in lora.items():
        flat[f"lora_{name}_a"] = _np(ab["a"])
        flat[f"lora_{name}_b"] = _np(ab["b"])
    np.savez(path, **flat)


def load_restore_artifacts(path: str, device: DeviceLike = "cuda"):
    """-> (embeddings, lora, scaling) as tensors on ``device``; the scaling is
    PEFT's lora_alpha / r (2.0 when the file has none)."""
    device = resolve_device(device)
    d = np.load(path)
    on = lambda k: torch.from_numpy(d[k]).to(device)
    scaling = float(d["lora_scaling"]) if "lora_scaling" in d.files else 2.0
    lora = {}
    for k in d.files:
        if k.startswith("lora_") and k.endswith("_a"):
            name = k[len("lora_"):-2]
            lora[name] = {"a": on(k), "b": on(f"lora_{name}_b")}
    return on("restore_embeddings"), lora, scaling


@dataclasses.dataclass(frozen=True)
class RestoreKVPress(KVzipPress):
    restore_embeddings: Optional[torch.Tensor] = None    # (n_restore, E)
    lora: Optional[dict] = None
    lora_scaling: float = 2.0

    # The artifacts are tensors: presses compare and hash by identity.
    __eq__ = object.__eq__
    __hash__ = object.__hash__

    @property
    def num_restore_tokens(self) -> int:
        return 0 if self.restore_embeddings is None else int(self.restore_embeddings.shape[0])

    def max_kept(self, seq_len: int, cfg) -> int:
        # The restore pass appends n slots that are never evicted.
        return seq_len + self.num_restore_tokens
