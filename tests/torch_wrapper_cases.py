"""Shared cases of the wrapper-press parity tests of kvpress_tpu_torch
(tests/test_torch_wrappers.py and test_torch_chunked_wrappers.py): the
wrappers of both packages by the same arguments, a layer's press inputs
captured from the port's prefill, and the same inputs as a JAX ``LayerCtx``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kvpress_tpu.presses.base import LayerCtx as JaxLayerCtx
import kvpress_tpu_torch as kt

SNAP = dict(window_size=8, kernel_size=3)

# name: press(module), made with the module's names. The registry shapes of
# evaluation/registry.py at the tiny config's scale.
WRAPPERS = {
    "critical_knorm": lambda m: m.CriticalKVPress(m.KnormPress(0.5)),
    "critical_snapkv": lambda m: m.CriticalKVPress(m.SnapKVPress(0.5, **SNAP)),
    "critical_expected_attention": lambda m: m.CriticalKVPress(
        m.ExpectedAttentionPress(0.5, n_future_positions=16, use_vnorm=False)),
    "critical_adakv_knorm": lambda m: m.CriticalAdaKVPress(m.KnormPress(0.5)),
    "critical_adakv_snapkv": lambda m: m.CriticalAdaKVPress(m.SnapKVPress(0.5, **SNAP)),
    "critical_adakv_expected_attention": lambda m: m.CriticalAdaKVPress(
        m.ExpectedAttentionPress(0.5, n_future_positions=16, use_vnorm=False)),
    "critical_adakv_snapkv_compact": lambda m: m.CriticalAdaKVPress(
        m.SnapKVPress(0.5, **SNAP), compact=True),
    "key_rerotation": lambda m: m.KeyRerotationPress(m.KnormPress(0.5)),
    "chunk_knorm": lambda m: m.ChunkPress(m.KnormPress(0.5), chunk_length=16),
    "chunk_ragged": lambda m: m.ChunkPress(m.KnormPress(0.3), chunk_length=20),
    "chunkkv": lambda m: m.ChunkKVPress(m.SnapKVPress(0.5, **SNAP), chunk_length=10),
    "chunkkv_short": lambda m: m.ChunkKVPress(m.KnormPress(0.5), chunk_length=128),
    "block_keydiff": lambda m: m.BlockPress(m.KeyDiffPress(0.5), block_size=16),
    "think": lambda m: m.ThinKPress(key_channel_compression_ratio=0.5, window_size=8),
    "snap_think": lambda m: m.ComposedPress(
        (m.SnapKVPress(0.5, **SNAP), m.ThinKPress(0.5, window_size=8))),
    "composed_knorm": lambda m: m.ComposedPress((m.KnormPress(0.25), m.KnormPress(0.5))),
    "per_layer": lambda m: m.PerLayerCompressionPress(
        m.KnormPress(0.5), compression_ratios=(0.25, 0.75)),
}


def both(name):
    """(JAX press, port press) of one name."""
    from kvpress_tpu import presses as jp
    return WRAPPERS[name](jp), WRAPPERS[name](kt)


def capture(runner, params, ids, layer: int):
    """(ctx, keys, values) that a press is given in ``layer`` of the port's
    prefill of ``ids`` (taken from a Knorm prefill)."""
    seen = {}

    class Capture(kt.KnormPress):
        def score(self, ctx, keys, values):
            if ctx.layer_idx == layer:
                seen["args"] = (ctx, keys.clone(), values.clone())
            return super().score(ctx, keys, values)

    runner.prefill(params, torch.from_numpy(ids).long(), press=Capture(0.5))
    return seen["args"]


def jax_ctx(ctx, cfg_j, params_j):
    """The port's ``ctx`` as the JAX package's LayerCtx on the same arrays."""
    arr = lambda t: None if t is None else jnp.asarray(t.numpy())
    layer = jax.tree_util.tree_map(lambda a: a[ctx.layer_idx], params_j["layers"])
    return JaxLayerCtx(
        layer_idx=jnp.asarray(ctx.layer_idx, jnp.int32), hidden=arr(ctx.hidden),
        queries=arr(ctx.queries), queries_prerope=arr(ctx.queries_prerope),
        keys_prerope=arr(ctx.keys_prerope), positions=arr(ctx.positions).astype(jnp.int32),
        attn_probs=arr(ctx.attn_probs), layer_params=layer, inv_freq=arr(ctx.inv_freq),
        cfg=cfg_j, attention_scaling=ctx.attention_scaling,
        kv_len=None if ctx.kv_len is None else jnp.asarray(ctx.kv_len, jnp.int32))


def as_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
