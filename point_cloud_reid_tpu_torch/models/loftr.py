"""LoFTR-style local feature transformer, as an attention stage.

Port of point_cloud_reid_tpu/models/loftr.py (LoFTREncoderLayer,
LocalFeatureTransformer, LoFTRStage; the reference's trackers/deprecated/
loftr.py:7-99). Each layer: bias-free multi-head q / k / v projections ->
attention -> bias-free merge -> LayerNorm -> FFN on [x || message] ->
LayerNorm -> residual; the transformer alternates self and cross layers
over the two feature sets, each layer with its own weights.

The attention is linear_attention for 'linear' and full_attention for any
other string, 'linear-pallas' included, as in the JAX layer (loftr.py:48):
a LoFTR stage never launches the linear-attention kernel.

Names are the reference's: loftr.layers.{i}.{q_proj, k_proj, v_proj,
merge, mlp.0, mlp.2, norm1, norm2} (flax: loftr/layers_{i}/..., mlp_0,
mlp_2).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.attention import full_attention, linear_attention
from .layers import Dense, LayerNorm


class LoFTREncoderLayer(nn.Module):
    """One self- or cross-attention layer: x (B, L, d), source (B, S, d),
    masks (B, L) / (B, S) -> (B, L, d)."""

    def __init__(self, d_model: int, nhead: int, attention: str = "full"):
        super().__init__()
        d = d_model
        self.d_model, self.nhead = d, nhead
        self.attn = linear_attention if attention == "linear" else full_attention
        self.q_proj = Dense(d, d, bias=False)
        self.k_proj = Dense(d, d, bias=False)
        self.v_proj = Dense(d, d, bias=False)
        self.merge = Dense(d, d, bias=False)
        self.mlp = nn.Sequential(Dense(2 * d, 2 * d, bias=False), nn.ReLU(),
                                 Dense(2 * d, d, bias=False))
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.norm2 = LayerNorm(d, eps=1e-5)

    def forward(self, x: torch.Tensor, source: torch.Tensor,
                x_mask: Optional[torch.Tensor] = None,
                source_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, L, _ = x.shape
        dim = self.d_model // self.nhead
        q = self.q_proj(x).reshape(B, L, self.nhead, dim)
        k = self.k_proj(source).reshape(B, -1, self.nhead, dim)
        v = self.v_proj(source).reshape(B, -1, self.nhead, dim)
        msg = self.attn(q, k, v, q_mask=x_mask, kv_mask=source_mask)
        msg = self.norm1(self.merge(msg.reshape(B, L, self.d_model)))
        h = self.norm2(self.mlp(torch.cat([x, msg], dim=-1)))
        return x + h


class LocalFeatureTransformer(nn.Module):
    """Alternating self / cross encoder over two feature sets."""

    def __init__(self, d_model: int, nhead: int = 8,
                 layer_names: Sequence[str] = ("self", "cross") * 4,
                 attention: str = "full"):
        super().__init__()
        for name in layer_names:
            if name not in ("self", "cross"):
                raise KeyError(name)
        self.d_model = d_model
        self.layer_names = tuple(layer_names)
        self.layers = nn.ModuleList(
            LoFTREncoderLayer(d_model, nhead, attention) for _ in layer_names)

    def forward(self, feat0: torch.Tensor, feat1: torch.Tensor,
                mask0: Optional[torch.Tensor] = None,
                mask1: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if feat0.shape[-1] != self.d_model:
            raise ValueError("feature dim != d_model")
        for layer, name in zip(self.layers, self.layer_names):
            if name == "self":
                feat0 = layer(feat0, feat0, mask0, mask0)
                feat1 = layer(feat1, feat1, mask1, mask1)
            else:
                feat0 = layer(feat0, feat1, mask0, mask1)
                feat1 = layer(feat1, feat0, mask1, mask0)
        return feat0, feat1


class LoFTRStage(nn.Module):
    """LocalFeatureTransformer behind the attention-stage interface of the
    match heads: (x, x_xyz, source, source_xyz) -> the updated x (the xyz
    are not read: LoFTR has no positional MLP)."""

    def __init__(self, d_model: int, nhead: int = 8,
                 attention: str = "linear", n_layers: int = 2):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        self.attention = attention
        self.loftr = LocalFeatureTransformer(
            d_model, nhead, ("self", "cross") * n_layers, attention)

    def forward(self, x, x_xyz, source, source_xyz, x_mask=None,
                source_mask=None) -> torch.Tensor:
        return self.loftr(x, source, x_mask, source_mask)[0]
