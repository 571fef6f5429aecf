"""Checkpoints of the port's ``LlamaModel`` (port of
``kvpress_tpu/utils/checkpoint.py``, which writes orbax, JAX's format).

``save_params`` writes the module's tensors with ``torch.save``: each
layer's dict, ``embed``, ``ln_f``, ``lm_head`` and the ``embed_scale`` /
``lm_head_scale`` of int8 embeddings, each in its own dtype (int8 and packed
int4 payloads stay integers). ``load_params`` reads them back with
``weights_only=True`` onto ``device``, so a converted or quantized model is
paid for once and reloads without its source."""

from __future__ import annotations

import os

import torch

from ..device import DeviceLike, resolve_device
from ..models.llama import LlamaModel

EXTRA = ("embed_scale", "lm_head_scale")


def save_params(path: str, params: LlamaModel) -> None:
    """Write ``params`` to the file ``path`` (its directory must exist)."""
    if getattr(params, "shard", None) is not None:
        raise ValueError("save_params takes the whole model, not a rank's shard")
    data = {"layers": [{n: p.data for n, p in layer.named_parameters(recurse=False)}
                       for layer in params.layers],
            "embed": params.embed.data, "ln_f": params.ln_f.data}
    for name in ("lm_head",) + EXTRA:
        t = params.get(name)
        if t is not None:
            data[name] = t.data
    torch.save(data, os.path.abspath(path))


def load_params(path: str, device: DeviceLike = "cuda") -> LlamaModel:
    """The ``LlamaModel`` that ``save_params`` wrote to ``path``, on
    ``device``."""
    device = resolve_device(device)
    data = torch.load(os.path.abspath(path), weights_only=True, map_location=device)
    return LlamaModel(data["embed"], data["layers"], data["ln_f"], data.get("lm_head"),
                      {n: data[n] for n in EXTRA if n in data})
