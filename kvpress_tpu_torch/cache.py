"""KV cache as a dataclass of tensors (port of ``kvpress_tpu/cache.py``).

Layout is the JAX package's:

- keys/values stacked over layers, ``(L, B, H_kv, S_max, D)``, with a
  per-layer valid ``length (L,)``; eviction is gather-to-front plus a length
  drop;
- head-wise eviction is a boolean keep-``mask (L, B, H_kv, S_max)``;
- the optional int8 / packed-int4 codec stores payloads with per-(token, head)
  float32 scales ``(L, B, H_kv, S_max, 1)``.

Two differences from the JAX value semantics, both PyTorch idiom:

- ``length``, ``offset`` and ``overflowed`` live on the host (CPU tensors).
  Every slice start in eager PyTorch is a host integer anyway, so keeping them
  there costs no device round trip per layer.
- ``Runner.forward`` writes new K/V into the buffers in place and returns a
  cache with new ``length``/``offset`` tensors. Restoring the old
  ``length``/``offset`` therefore rolls a cache back: slots past ``length``
  are stale and are overwritten by the next append.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import ModelConfig
from .device import DeviceLike, resolve_device


@dataclasses.dataclass
class KVCache:
    keys: torch.Tensor                    # (L, B, H_kv, S_max, D) or int payload
    values: torch.Tensor
    length: torch.Tensor                  # (L,) int32, host
    offset: torch.Tensor                  # () int32, host: logical seq len
    mask: Optional[torch.Tensor] = None   # (L, B, H_kv, S_max) bool keep-bits
    key_scales: Optional[torch.Tensor] = None    # (L, B, H_kv, S_max, 1) f32
    value_scales: Optional[torch.Tensor] = None
    bits: int = 8                         # 8 = int8, 4 = two nibbles per uint8
    overflowed: Optional[torch.Tensor] = None    # () bool, host

    @property
    def is_quantized(self) -> bool:
        return self.key_scales is not None

    @property
    def max_size(self) -> int:
        return self.keys.shape[3]

    @property
    def num_layers(self) -> int:
        return self.keys.shape[0]


def init_cache(
    cfg: ModelConfig,
    batch: int,
    max_size: int,
    dtype: torch.dtype = torch.bfloat16,
    quantized: bool = False,
    bits: int = 8,
    device: DeviceLike = "cuda",
) -> KVCache:
    """An empty cache on ``device``: the card unless the caller passes
    ``device="cpu"`` (no card and no ``device=`` raises)."""
    device = resolve_device(device)
    L, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    if quantized:
        if bits not in (8, 4):
            raise ValueError(f"kv bits must be 8 or 4, got {bits}")
        payload_d = D if bits == 8 else D // 2
        payload_t = torch.int8 if bits == 8 else torch.uint8
        shape = (L, batch, H, max_size, payload_d)
        keys = torch.zeros(shape, dtype=payload_t, device=device)
        values = torch.zeros(shape, dtype=payload_t, device=device)
        ks = torch.ones((L, batch, H, max_size, 1), dtype=torch.float32, device=device)
        vs = torch.ones((L, batch, H, max_size, 1), dtype=torch.float32, device=device)
    else:
        keys = torch.zeros((L, batch, H, max_size, D), dtype=dtype, device=device)
        values = torch.zeros((L, batch, H, max_size, D), dtype=dtype, device=device)
        ks = vs = None
    return KVCache(
        keys=keys,
        values=values,
        length=torch.zeros((L,), dtype=torch.int32),
        offset=torch.zeros((), dtype=torch.int32),
        mask=None,
        key_scales=ks,
        value_scales=vs,
        bits=bits,
        overflowed=torch.zeros((), dtype=torch.bool),
    )


def quantize_kv(x: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric quantization along head_dim.

    bits=8 gives an int8 payload; bits=4 packs two nibbles per uint8
    (payload last dim D//2): channel ``c`` in the low nibble, channel
    ``c + D/2`` in the high nibble, each stored with a +8 offset. The kernels
    depend on this layout. ``torch.round`` rounds half to even like
    ``jnp.round``, so payloads are bit-equal to the JAX codec."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if bits == 8:
        scale = torch.clamp(amax / 127.0, min=1e-8)
        q = torch.clamp(torch.round(xf / scale), -127, 127)
        return q.to(torch.int8), scale
    if bits != 4 or x.shape[-1] % 2:
        raise ValueError(f"unsupported kv bits {bits} for head_dim {x.shape[-1]}")
    d2 = x.shape[-1] // 2
    scale = torch.clamp(amax / 7.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -8, 7).to(torch.int32) + 8
    packed = q[..., :d2] | (q[..., d2:] << 4)
    return packed.to(torch.uint8), scale


def unpack_int4(payload: torch.Tensor, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(low-nibble plane, high-nibble plane) of a packed int4 payload, each
    with the +8 offset removed, as ``dtype``."""
    p = payload.to(torch.int32) & 0xFF
    return ((p & 0xF) - 8).to(dtype), ((p >> 4) - 8).to(dtype)


def dequantize_kv(payload: torch.Tensor, scale: torch.Tensor, bits: int,
                  dtype: torch.dtype) -> torch.Tensor:
    if bits == 8:
        return (payload.to(torch.float32) * scale).to(dtype)
    lo, hi = unpack_int4(payload, torch.float32)
    return (torch.cat([lo, hi], dim=-1) * scale).to(dtype)


def valid_mask(cache: KVCache) -> torch.Tensor:
    """(L, B, H_kv, S_max) bool: attendable slots (length- and mask-aware)."""
    L, B, H, S, _ = cache.keys.shape
    pos = torch.arange(S, device=cache.keys.device)
    m = pos[None, :] < cache.length.to(cache.keys.device)[:, None]
    m = m[:, None, None, :].expand(L, B, H, S)
    if cache.mask is not None:
        m = m & cache.mask
    return m


def masked_fraction(cache: KVCache) -> torch.Tensor:
    """() float32: the share of valid slots masked out head-wise, the measured
    compression ratio of mask-based presses (DMS, Duo, LUKV; reference
    dms_press.py:122-127). 0 without a keep-mask."""
    if cache.mask is None:
        return torch.zeros((), dtype=torch.float32)
    L, B, H, S, _ = cache.keys.shape
    valid = torch.arange(S, device=cache.mask.device) < cache.length.to(
        cache.mask.device)[:, None]
    valid = valid[:, None, None, :].expand(L, B, H, S)
    masked = (valid & ~cache.mask).sum()
    return (masked / torch.clamp(valid.sum(), min=1)).to(torch.float32).cpu()


def compact_masked(cache: KVCache, shard=None) -> KVCache:
    """Move each head's kept (mask-True, valid) entries to the front of its
    buffer, in their order, and drop each layer's length to its longest
    head's kept count; the mask then marks each head's prefix (the
    stacked-cache counterpart of AdaKV's ``compact=True`` for presses that
    evict through mask bits, such as ``DMSPress(compact=True)``). A layer at
    a time, written back into the same tensors: the peak is the one cache
    plus one layer's gather. Follow with ``resize`` to free the memory.

    Slots at or past a layer's length carry mask True by convention; they
    are left out of the kept set. Under a tensor-parallel mesh (``shard``,
    the runner's ``ModelShard``) a layer's length is its longest head's over
    every rank, as on one device."""
    if cache.mask is None:
        return cache
    S = cache.max_size
    pos = torch.arange(S, device=cache.mask.device)
    lengths = cache.length.clone()
    for l in range(cache.num_layers):
        keep = cache.mask[l] & (pos < int(cache.length[l]))          # (B, H, S)
        order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
        for buf in (cache.keys, cache.values, cache.key_scales, cache.value_scales):
            if buf is not None:
                buf[l].copy_(torch.gather(
                    buf[l], 2, order[..., None].expand(*order.shape, buf.shape[-1])))
        counts = keep.sum(dim=-1)                                     # (B, H)
        cache.mask[l].copy_(pos < counts[..., None])
        lengths[l] = int(counts.max()) if shard is None else shard.max(int(counts.max()))
    return dataclasses.replace(cache, length=lengths)


def shrink(cache: KVCache, new_size: int) -> KVCache:
    """Slice the buffers down to ``new_size`` slots (valid entries are always
    front-compacted, so a slice keeps them). The slices are copied so the
    large buffer is freed."""
    def cut(x):
        return None if x is None else x[:, :, :, :new_size].clone()
    return dataclasses.replace(
        cache,
        keys=cut(cache.keys),
        values=cut(cache.values),
        mask=cut(cache.mask),
        key_scales=cut(cache.key_scales),
        value_scales=cut(cache.value_scales),
    )


def grow(cache: KVCache, extra: int) -> KVCache:
    """Pad the sequence axis with ``extra`` empty slots (for decode appends)."""
    def pad(x, fill):
        if x is None:
            return None
        shape = list(x.shape)
        shape[3] = extra
        return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=3)
    return dataclasses.replace(
        cache,
        keys=pad(cache.keys, 0),
        values=pad(cache.values, 0),
        mask=pad(cache.mask, True),
        key_scales=pad(cache.key_scales, 1.0),
        value_scales=pad(cache.value_scales, 1.0),
    )


def resize(cache: KVCache, new_size: int) -> KVCache:
    """Re-bucket to exactly ``new_size`` slots: shrink when the buffer is
    larger, grow when it is smaller."""
    if cache.max_size > new_size:
        return shrink(cache, new_size)
    if cache.max_size < new_size:
        return grow(cache, new_size - cache.max_size)
    return cache


def append_layer_kv(
    cache_layer_keys: torch.Tensor,
    cache_layer_values: torch.Tensor,
    length: int,
    new_keys: torch.Tensor,
    new_values: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Write (B, H, T, D) new K/V at slot ``length`` of one layer's buffers,
    in place. Returns (keys, values, length + T)."""
    T = new_keys.shape[2]
    start = clamp_start(length, T, cache_layer_keys.shape[2])
    cache_layer_keys[:, :, start:start + T] = new_keys.to(cache_layer_keys.dtype)
    cache_layer_values[:, :, start:start + T] = new_values.to(cache_layer_values.dtype)
    return cache_layer_keys, cache_layer_values, length + T


def clamp_start(start: int, n: int, size: int) -> int:
    """``lax.dynamic_update_slice`` semantics: a write that would run past the
    buffer is moved back so it fits (``Runner.forward`` raises the cache's
    ``overflowed`` flag when that happens)."""
    return max(0, min(start, size - n))
