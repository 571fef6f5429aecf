"""SigLIP vision tower and Gemma3 multimodal projector (port of
``kvpress_tpu/models/siglip.py``).

HF ``SiglipVisionModel`` semantics (modeling_siglip.py): a non-overlapping
patch convolution (one matmul over the flattened patches) plus learned
position embeddings, a pre-LN encoder (LayerNorm with bias, multi-head
attention with q/k/v/out biases, gelu-tanh MLP) and a post LayerNorm. Then
the Gemma3 projector (modeling_gemma3.py ``Gemma3MultiModalProjector``):
the g x g patch grid average-pooled to sqrt(mm_tokens_per_image) a side, a
Gemma RMSNorm in float32 (``x * (1 + w)``, with the vision tower's eps),
and one (H_vision, E_text) projection.

Weights keep the JAX package's layout: linears as (in, out) matrices, the
patch convolution as a (C * P * P, H) matrix over (channel, row, column).
The tower's attention is a dense product in the JAX package, outside any
Pallas kernel; here it is ``scaled_dot_product_attention``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device

LAYER_NAMES = ("ln1_w", "ln1_b", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
               "ln2_w", "ln2_b", "w1", "b1", "w2", "b2")


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """SigLIP + projector geometry (a copy of the JAX package's)."""

    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    image_size: int
    patch_size: int
    num_channels: int = 3
    layer_norm_eps: float = 1e-6
    mm_tokens_per_image: int = 256

    @classmethod
    def from_hf_config(cls, hf_cfg) -> "VisionConfig":
        """From a whole ``Gemma3Config`` (vision_config + mm_tokens_per_image)."""
        vc = hf_cfg.vision_config
        return cls(
            hidden_size=vc.hidden_size,
            intermediate_size=vc.intermediate_size,
            num_layers=vc.num_hidden_layers,
            num_heads=vc.num_attention_heads,
            image_size=vc.image_size,
            patch_size=vc.patch_size,
            num_channels=vc.num_channels,
            layer_norm_eps=vc.layer_norm_eps,
            mm_tokens_per_image=hf_cfg.mm_tokens_per_image,
        )

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


class _Tensors(nn.Module):
    def __init__(self, tensors: dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, nn.Parameter(t, requires_grad=False))


class VisionTower(nn.Module):
    """The tower and the projector: ``tower(pixel_values)`` maps (B, C, I, I)
    pixels to (B, mm_tokens_per_image, E_text) features for
    ``convert.multimodal_embeds``. ``top`` holds patch_w, patch_b, pos,
    post_ln_w, post_ln_b, mm_norm and mm_proj; ``layers`` each encoder
    layer's ``LAYER_NAMES``."""

    def __init__(self, vcfg: VisionConfig, top: dict[str, torch.Tensor],
                 layers: list[dict[str, torch.Tensor]]):
        super().__init__()
        self.vcfg = vcfg
        self.top = _Tensors(top)
        self.layers = nn.ModuleList(_Tensors(t) for t in layers)

    @property
    def dtype(self) -> torch.dtype:
        return self.top.patch_w.dtype

    @property
    def device(self) -> torch.device:
        return self.top.patch_w.device

    @torch.no_grad()
    def forward(self, pixel_values) -> torch.Tensor:
        return encode_images(self, pixel_values)


def _layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


@torch.no_grad()
def encode_images(tower: VisionTower, pixel_values) -> torch.Tensor:
    """(B, C, I, I) pixels (a tensor or an array) -> (B, mm_tokens_per_image,
    E_text) features, in the tower's dtype."""
    vcfg, top = tower.vcfg, tower.top
    x = torch.as_tensor(pixel_values, device=tower.device)
    B = x.shape[0]
    P, g, H, nh = vcfg.patch_size, vcfg.grid, vcfg.hidden_size, vcfg.num_heads
    d = H // nh

    # The patch convolution (stride == kernel) as one matmul over each patch
    # flattened in the convolution weight's (channel, row, column) order.
    x = x.reshape(B, vcfg.num_channels, g, P, g, P).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(B, g * g, -1).to(tower.dtype)
    x = x @ top.patch_w + top.patch_b + top.pos
    for p in tower.layers:
        h = _layer_norm(x, p.ln1_w, p.ln1_b, vcfg.layer_norm_eps)
        q, k, v = ((h @ w + b).reshape(B, -1, nh, d).transpose(1, 2)
                   for w, b in ((p.wq, p.bq), (p.wk, p.bk), (p.wv, p.bv)))
        o = F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)
        x = x + (o.transpose(1, 2).reshape(B, -1, H) @ p.wo + p.bo)
        h = _layer_norm(x, p.ln2_w, p.ln2_b, vcfg.layer_norm_eps)
        h = F.gelu(h @ p.w1 + p.b1, approximate="tanh")
        x = x + (h @ p.w2 + p.b2)
    x = _layer_norm(x, top.post_ln_w, top.post_ln_b, vcfg.layer_norm_eps)

    # Gemma3 projector: pool the g x g grid to t x t tokens, Gemma RMSNorm in
    # float32 with the vision eps, project.
    t = int(round(vcfg.mm_tokens_per_image ** 0.5))
    kk = g // t
    x = x.reshape(B, t, kk, t, kk, H).mean(dim=(2, 4))
    xf = x.reshape(B, t * t, H).to(torch.float32)
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + vcfg.layer_norm_eps)
    xf = xf * (1.0 + top.mm_norm.to(torch.float32))
    return (xf.to(x.dtype) @ top.mm_proj).to(x.dtype)


def _shapes(vcfg: VisionConfig, text_hidden_size: int):
    H, Fv = vcfg.hidden_size, vcfg.intermediate_size
    C, P = vcfg.num_channels, vcfg.patch_size
    top = {"patch_w": (C * P * P, H), "patch_b": (H,), "pos": (vcfg.grid ** 2, H),
           "post_ln_w": (H,), "post_ln_b": (H,), "mm_norm": (H,),
           "mm_proj": (H, text_hidden_size)}
    layer = {"ln1_w": (H,), "ln1_b": (H,), "wq": (H, H), "bq": (H,), "wk": (H, H), "bk": (H,),
             "wv": (H, H), "bv": (H,), "wo": (H, H), "bo": (H,), "ln2_w": (H,), "ln2_b": (H,),
             "w1": (H, Fv), "b1": (Fv,), "w2": (Fv, H), "b2": (H,)}
    return top, layer


def init_vision_params(vcfg: VisionConfig, generator: torch.Generator,
                       dtype: torch.dtype = torch.bfloat16, device: DeviceLike = "cuda",
                       *, text_hidden_size: int) -> VisionTower:
    """A random tower: N(0, 0.02) matrices and position embeddings, zero
    biases, unit LayerNorm weights and a zero projector norm (``1 + w`` =
    1), drawn from ``generator`` (which must live on ``device``)."""
    device = resolve_device(device)
    top_shapes, layer_shapes = _shapes(vcfg, text_hidden_size)

    def make(name, shape):
        if len(shape) == 2:
            return (torch.randn(shape, generator=generator, device=device,
                                dtype=torch.float32) * 0.02).to(dtype)
        fill = 1.0 if name.endswith("_w") else 0.0     # LayerNorm weights
        return torch.full(shape, fill, dtype=dtype, device=device)

    top = {n: make(n, s) for n, s in top_shapes.items()}
    layers = [{n: make(n, s) for n, s in layer_shapes.items()}
              for _ in range(vcfg.num_layers)]
    return VisionTower(vcfg, top, layers)


def convert_vision_tower(sd: Mapping[str, object], vcfg: VisionConfig,
                         dtype: torch.dtype = torch.float32,
                         device: DeviceLike = "cuda") -> VisionTower:
    """HF ``Gemma3ForConditionalGeneration`` state dict -> ``VisionTower``:
    the ``model.vision_tower.vision_model.*`` and
    ``model.multi_modal_projector.*`` keys; linears transposed to (in, out)."""
    from .convert import _np

    device = resolve_device(device)
    pfx = "model.vision_tower.vision_model."

    def conv(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    def get(name, transpose=False):
        a = _np(sd[pfx + name])
        return conv(a.T if transpose else a)

    enc = "encoder.layers.{i}."
    names = {"ln1_w": ("layer_norm1.weight", False), "ln1_b": ("layer_norm1.bias", False),
             "wq": ("self_attn.q_proj.weight", True), "bq": ("self_attn.q_proj.bias", False),
             "wk": ("self_attn.k_proj.weight", True), "bk": ("self_attn.k_proj.bias", False),
             "wv": ("self_attn.v_proj.weight", True), "bv": ("self_attn.v_proj.bias", False),
             "wo": ("self_attn.out_proj.weight", True), "bo": ("self_attn.out_proj.bias", False),
             "ln2_w": ("layer_norm2.weight", False), "ln2_b": ("layer_norm2.bias", False),
             "w1": ("mlp.fc1.weight", True), "b1": ("mlp.fc1.bias", False),
             "w2": ("mlp.fc2.weight", True), "b2": ("mlp.fc2.bias", False)}
    layers = [{n: get(enc.format(i=i) + key, tr) for n, (key, tr) in names.items()}
              for i in range(vcfg.num_layers)]
    conv_w = _np(sd[pfx + "embeddings.patch_embedding.weight"])       # (H, C, P, P)
    top = {
        "patch_w": conv(conv_w.reshape(conv_w.shape[0], -1).T),       # (C * P * P, H)
        "patch_b": get("embeddings.patch_embedding.bias"),
        "pos": get("embeddings.position_embedding.weight"),
        "post_ln_w": get("post_layernorm.weight"),
        "post_ln_b": get("post_layernorm.bias"),
        "mm_norm": conv(_np(sd["model.multi_modal_projector.mm_soft_emb_norm.weight"])),
        "mm_proj": conv(_np(sd["model.multi_modal_projector.mm_input_projection_weight"])),
    }
    return VisionTower(vcfg, top, layers)


def vision_from_jax(np_vparams: dict, vcfg: VisionConfig, device: DeviceLike = "cuda",
                    dtype: torch.dtype = torch.float32) -> VisionTower:
    """The JAX tower's parameter tree (numpy arrays, encoder layers stacked
    on a leading axis) as a ``VisionTower``."""
    device = resolve_device(device)

    def conv(a):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    stacked = np_vparams["layers"]
    layers = [{n: conv(stacked[n][i]) for n in LAYER_NAMES} for i in range(vcfg.num_layers)]
    top = {n: conv(np_vparams[n]) for n in ("patch_w", "patch_b", "pos", "post_ln_w",
                                            "post_ln_b", "mm_norm", "mm_proj")}
    return VisionTower(vcfg, top, layers)
