"""ViT-B/16 encoder — port of `imagecaptioning_tpu/models/backbones/vit.py`
(`ViTBlock`, `ViTEncoder`).

The reference encoder is torchvision's `vit_b_16` (`AlexCap/
VitbModel.py:156-166`): a 16×16 stride-16 convolution patchifies, a
class token is prepended, learned position embeddings are added, then 12
pre-LN blocks (self-attention scaled by 1/sqrt(head_dim), an MLP with
exact GELU) and a final LayerNorm, all with epsilon 1e-6. The output keeps
all 1 + (H/16)·(W/16) tokens, the class token first (197 at 224²): the
caption decoder attends to every one of them.

The module and parameter names are torchvision's (`conv_proj`,
`class_token`, `encoder.pos_embedding`,
`encoder.layers.encoder_layer_{i}.{ln_1, self_attention.in_proj_weight,
self_attention.in_proj_bias, self_attention.out_proj, ln_2, mlp.0,
mlp.3}`, `encoder.ln`), so its state dict loads into `vit_b_16` and back.

Images are NHWC in normalized space. The products compute in
`compute_dtype` over weights of any dtype, cast each call (fp32 master
weights under bf16 compute, as the ResNet trunk does); each LayerNorm
normalises in fp32 and the residual stream stays in `compute_dtype`, as
flax's LayerNorm over bf16 activations with fp32 parameters does; the
output is fp32. The attention is `F.scaled_dot_product_attention` (the
JAX package computes it with flax, outside any Pallas kernel).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in fp32 (fp64 for fp64 input)."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), norm.eps)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class SelfAttention(nn.Module):
    """torchvision's `nn.MultiheadAttention` parameters (`in_proj_weight`
    (3D, D) as [q; k; v], `in_proj_bias`, `out_proj`), computed as
    scaled-dot-product attention over `heads` heads."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden {hidden} is not a multiple of heads "
                             f"{heads}")
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * hidden))
        self.out_proj = nn.Linear(hidden, hidden)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype),
                       self.in_proj_bias.to(x.dtype))
        q, k, v = (t.reshape(b, s, self.heads, -1).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        out = F.scaled_dot_product_attention(q, k, v)
        return _linear(self.out_proj, out.transpose(1, 2).reshape(b, s, d))


class EncoderBlock(nn.Module):
    """Pre-LN block: x + attn(ln_1(x)), then + mlp(ln_2(x))."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.self_attention = SelfAttention(hidden, heads)
        self.ln_2 = nn.LayerNorm(hidden, eps=LN_EPS)
        # torchvision's MLPBlock numbering: 0 Linear, 1 GELU, 2 Dropout,
        # 3 Linear (its dropout is 0 for vit_b_16)
        self.mlp = nn.Sequential(nn.Linear(hidden, mlp_dim), nn.GELU(),
                                 nn.Identity(), nn.Linear(mlp_dim, hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = x + self.self_attention(_layer_norm(self.ln_1, x).to(dtype))
        h = F.gelu(_linear(self.mlp[0], _layer_norm(self.ln_2, x).to(dtype)))
        return x + _linear(self.mlp[3], h)


class Encoder(nn.Module):
    """torchvision's `vit.encoder`: `pos_embedding`, `layers`, `ln`."""

    def __init__(self, seq_length: int, num_layers: int, heads: int,
                 hidden: int, mlp_dim: int):
        super().__init__()
        self.pos_embedding = nn.Parameter(
            torch.empty(1, seq_length, hidden).normal_(std=0.02))
        self.layers = nn.Sequential(OrderedDict(
            (f"encoder_layer_{i}", EncoderBlock(hidden, heads, mlp_dim))
            for i in range(num_layers)))
        self.ln = nn.LayerNorm(hidden, eps=LN_EPS)


class ViTEncoder(nn.Module):
    """Patchify + class token + position embeddings + blocks + final LN:
    NHWC images (B, S, S, 3) → (B, 1 + (S/P)², hidden) fp32."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 num_layers: int = 12, num_heads: int = 12,
                 hidden_dim: int = 768, mlp_dim: int = 3072,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.patch_size = patch_size
        self.hidden_dim = hidden_dim
        self.compute_dtype = compute_dtype
        self.conv_proj = nn.Conv2d(3, hidden_dim, patch_size, patch_size)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.encoder = Encoder((image_size // patch_size) ** 2 + 1,
                               num_layers, num_heads, hidden_dim, mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or self.conv_proj.weight.dtype
        conv = self.conv_proj
        x = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype),
                     conv.bias.to(dtype), conv.stride)
        x = x.flatten(2).transpose(1, 2)                    # (B, N, D)
        cls = self.class_token.to(dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.encoder.pos_embedding.to(dtype)
        for block in self.encoder.layers:
            x = block(x)
        return _layer_norm(self.encoder.ln, x)
