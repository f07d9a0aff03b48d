"""Vision Transformer backbones: DeiT tiny/small/base and BEiT-base.

Port of point_cloud_reid_tpu/models/vit.py. One module covers the zoo:

  DeiT-distilled: cls + distillation tokens (198 tokens at 224/16);
  'no-pt' DeiT:   plain ViT, no distillation token (197 tokens);
  BEiT:           shared relative-position bias + LayerScale, no absolute
                  position embedding (197 tokens).

The output is every token of the last block, special tokens included, before
any pooling; DeiT presets skip the final LayerNorm (the reference taps
hidden_states[-1]). The softmax attention is a library call
(scaled_dot_product_attention), as the JAX package leaves it to XLA.

Held to the JAX module, so the MLP's gelu is the tanh approximation (flax's
nn.gelu default), LayerNorm eps is 1e-12, and the fused qkv projection's
output is [q | k | v], each head-major. Images come (B, 3, H, W) and the
patch embedding is a Conv2d with an (out, in, p, p) weight. At a bf16
compute dtype the layers cast as flax's do (models/layers.py): the float32
class and position tokens promote the residual stream to float32, as in the
JAX module, and every block's output is float32. Names follow the
JAX tree (cls_token, dist_token, pos_embed, rel_pos_table, patch_embed,
blocks.{i}.{norm1, attn.qkv, attn.proj, gamma_1, norm2, mlp.{0,2}, gamma_2},
norm).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, Dense, LayerNorm, set_compute_dtype

VIT_PRESETS = {
    # dim, depth, heads: facebook/deit-*-distilled-patch16-224 configs.
    # final_norm=False: the last block's output before the model's final
    # LayerNorm
    "deit-tiny": dict(dim=192, depth=12, heads=3, dist_token=True,
                      final_norm=False),
    "deit-small": dict(dim=384, depth=12, heads=6, dist_token=True,
                       final_norm=False),
    "deit-base": dict(dim=768, depth=12, heads=12, dist_token=True,
                      final_norm=False),
    # 'no-pt' variants are a plain ViT built from the config: no
    # distillation token, 197 tokens
    "deit-tiny-no-pt": dict(dim=192, depth=12, heads=3, dist_token=False,
                            final_norm=False),
    "deit-base-no-pt": dict(dim=768, depth=12, heads=12, dist_token=False,
                            final_norm=False),
    # microsoft/beit-base-patch16-224-pt22k; last_hidden_state (post-LN)
    "beit": dict(dim=768, depth=12, heads=12, dist_token=False,
                 rel_pos_bias=True, layer_scale=True, final_norm=True),
}


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor,
                rel_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, C // self.heads)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(dim=2))  # (B,h,N,d)
        if rel_bias is not None and rel_bias.dtype != q.dtype:
            # bf16 scores plus the float32 bias: the softmax and the values'
            # product promote to float32, as in the JAX module
            s = q @ k.transpose(-1, -2) / math.sqrt(C // self.heads)
            out = torch.softmax(s + rel_bias[None], dim=-1) @ v.to(
                rel_bias.dtype)
        else:
            bias = None if rel_bias is None else rel_bias[None]
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0,
                 layer_scale: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-12)
        self.attn = Attention(dim, heads)
        self.norm2 = LayerNorm(dim, eps=1e-12)
        self.mlp = nn.Sequential(Dense(dim, int(dim * mlp_ratio)),
                                 nn.GELU(approximate="tanh"),
                                 Dense(int(dim * mlp_ratio), dim))
        if layer_scale:
            self.gamma_1 = nn.Parameter(torch.full((dim,), 0.1))
            self.gamma_2 = nn.Parameter(torch.full((dim,), 0.1))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x, rel_bias=None):
        y = self.attn(self.norm1(x), rel_bias)
        x = x + (y if self.gamma_1 is None else self.gamma_1 * y)
        y = self.mlp(self.norm2(x))
        return x + (y if self.gamma_2 is None else self.gamma_2 * y)


class ViT(nn.Module):
    """Patch embedding + token transformer: (B, 3, H, W) -> every token,
    (B, N_tok, dim)."""

    def __init__(self, dim: int = 192, depth: int = 12, heads: int = 3,
                 patch: int = 16, image_size: int = 224,
                 dist_token: bool = True, rel_pos_bias: bool = False,
                 layer_scale: bool = False, final_norm: bool = True,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads = dim, heads
        side = image_size // patch
        n_tok = side * side + 1 + int(dist_token)
        self.patch_embed = Conv2d(3, dim, patch, stride=patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.dist_token = (nn.Parameter(torch.zeros(1, 1, dim))
                           if dist_token else None)
        if rel_pos_bias:      # BEiT: one shared relative position bias
            self.pos_embed = None
            self.rel_pos_table = nn.Parameter(
                torch.zeros((2 * side - 1) ** 2 + 3, heads))
            # recomputed, not a weight: it stays out of the state dict
            self.register_buffer("rel_pos_index",
                                 _relative_position_index(side),
                                 persistent=False)
        else:                 # DeiT: learned absolute positions
            self.pos_embed = nn.Parameter(torch.zeros(1, n_tok, dim))
            self.rel_pos_table = None
        self.blocks = nn.ModuleList(
            Block(dim, heads, mlp_ratio, layer_scale) for _ in range(depth))
        self.norm = LayerNorm(dim, eps=1e-12) if final_norm else None
        set_compute_dtype(self, dtype)

    def forward(self, images: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        B = images.shape[0]
        x = self.patch_embed(images).flatten(2).transpose(1, 2)   # (B, P, dim)
        toks = [self.cls_token.expand(B, -1, -1)]
        if self.dist_token is not None:
            toks.append(self.dist_token.expand(B, -1, -1))
        x = torch.cat(toks + [x], dim=1)
        n_tok = x.shape[1]
        rel_bias = None
        if self.pos_embed is not None:
            x = x + self.pos_embed
        else:
            rel_bias = self.rel_pos_table[self.rel_pos_index.reshape(-1)]
            rel_bias = rel_bias.reshape(n_tok, n_tok, self.heads
                                        ).permute(2, 0, 1)
        for block in self.blocks:
            x = block(x, rel_bias)
        return x if self.norm is None else self.norm(x)


def _relative_position_index(side: int) -> torch.Tensor:
    """BEiT's relative-position index over (1 cls + side*side patch) tokens."""
    coords = np.stack(np.meshgrid(np.arange(side), np.arange(side),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]          # (2, P, P)
    rel = rel.transpose(1, 2, 0) + (side - 1)
    idx = rel[..., 0] * (2 * side - 1) + rel[..., 1]
    n = side * side
    full = np.zeros((n + 1, n + 1), dtype=np.int64)
    full[1:, 1:] = idx
    full[0, :] = (2 * side - 1) ** 2       # cls-to-token
    full[:, 0] = (2 * side - 1) ** 2 + 1   # token-to-cls
    full[0, 0] = (2 * side - 1) ** 2 + 2   # cls-to-cls
    return torch.from_numpy(full)


def build_vit(variant: str, image_size: int = 224,
              dtype: torch.dtype = torch.float32) -> ViT:
    return ViT(image_size=image_size, dtype=dtype, **VIT_PRESETS[variant])
