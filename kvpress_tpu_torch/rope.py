"""Rotary position embeddings: default, linear, Llama-3 and YaRN scaling.

Port of ``kvpress_tpu/rope.py``: ``inv_freq`` is computed once per config on
the host in float64 and stored as float32; cos/sin and the rotation run in
float32 whatever the activation dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import ModelConfig


def compute_inv_freq(cfg: ModelConfig) -> tuple[np.ndarray, float]:
    """Return (inv_freq [head_dim//2], attention_scaling) as host constants."""
    dim = cfg.head_dim
    base = cfg.rope_theta
    inv_freq = 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    scaling = cfg.rope_scaling or {}
    rope_type = scaling.get("rope_type", scaling.get("type", "default"))
    attention_scaling = 1.0

    if rope_type in ("default", None):
        pass
    elif rope_type == "linear":
        inv_freq = inv_freq / scaling["factor"]
    elif rope_type == "llama3":
        factor = scaling["factor"]
        low_factor = scaling["low_freq_factor"]
        high_factor = scaling["high_freq_factor"]
        old_len = scaling["original_max_position_embeddings"]
        low_wavelen = old_len / low_factor
        high_wavelen = old_len / high_factor
        wavelen = 2 * math.pi / inv_freq
        inv_freq_llama = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
        smooth = (old_len / wavelen - low_factor) / (high_factor - low_factor)
        smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
        is_medium = (wavelen >= high_wavelen) & (wavelen <= low_wavelen)
        inv_freq = np.where(is_medium, smoothed, inv_freq_llama)
    elif rope_type == "yarn":
        factor = scaling["factor"]
        original_max = scaling.get(
            "original_max_position_embeddings", cfg.max_position_embeddings
        )
        beta_fast = scaling.get("beta_fast", 32)
        beta_slow = scaling.get("beta_slow", 1)
        mscale = scaling.get("mscale", 1.0)

        def find_dim(num_rot):
            return (dim * math.log(original_max / (num_rot * 2 * math.pi))) / (
                2 * math.log(base)
            )

        low = max(math.floor(find_dim(beta_fast)), 0)
        high = min(math.ceil(find_dim(beta_slow)), dim // 2 - 1)
        rng = max(high - low, 1e-3)
        ramp = np.clip((np.arange(dim // 2, dtype=np.float64) - low) / rng, 0, 1)
        inv_freq = inv_freq / factor * ramp + inv_freq * (1 - ramp)
        attention_scaling = scaling.get(
            "attention_factor", 0.1 * mscale * math.log(factor) + 1.0
        )
    else:
        raise ValueError(f"Unsupported rope_type: {rope_type}")
    return inv_freq.astype(np.float32), float(attention_scaling)


def rope_cos_sin(
    inv_freq: torch.Tensor, positions: torch.Tensor, attention_scaling: float = 1.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of shape positions.shape + (head_dim,), float32, in the HF
    "rotate-half" layout (frequencies concatenated twice)."""
    freqs = positions.to(torch.float32)[..., None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb) * attention_scaling, torch.sin(emb) * attention_scaling


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, D); cos/sin broadcastable to it. float32 rotation."""
    xf = x.to(torch.float32)
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)
