"""Attention blocks of the ReID models (port of models/attention_blocks.py).

  SelfAttentionBlock   <- Self_Attention        (pointnet2_utils.py:55-114)
  CrossAttentionBlock  <- corss_attention [sic] (attention.py:157-219)
  LocalSelfAttention   <- local_self_attention  (attention.py:221-296)
  CrossLinAttn         <- cross_lin_attn        (attention.py:312-370)
  FPSA                 <- FP_SA                 (pointnet2_utils.py:362-437)

Attribute names are the reference state-dict names (pos_mlp.{0,2},
q_proj, k_proj, v_proj, merge, mlp.{0,2}, norm1, norm2; the local block's
carry the suffix _knn).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..ops.attention import (elu_feature_map, full_attention,
                             linear_attention)
from ..ops.geometry import index_points, knn_feature_space
from .layers import Dense, LayerNorm, pos_mlp


def _attn_fn(kind: str):
    """The attention primitive of a config string: 'linear' is the plain
    composite; 'linear-pallas' (the JAX package's name for its fused kernel,
    kept so one config drives both packages) is the hand-written CUDA kernel
    of kernels/linear_attention.py, which runs the composite when masks are
    given; every other string is softmax attention ('full'), as the JAX
    dispatch's catch-all."""
    if kind == "linear":
        return linear_attention
    if kind == "linear-pallas":
        from ..kernels.linear_attention import fused_linear_attention
        return fused_linear_attention
    return full_attention


def _split_heads(x: torch.Tensor, nhead: int) -> torch.Tensor:
    B, N, C = x.shape
    return x.reshape(B, N, nhead, C // nhead)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, N, H, D = x.shape
    return x.reshape(B, N, H * D)


def _ffn_mlp(d_in: int, d_hidden: int, d_out: int) -> nn.Sequential:
    return nn.Sequential(Dense(d_in, d_hidden, bias=False), nn.ReLU(),
                         Dense(d_hidden, d_out, bias=False))


class SelfAttentionBlock(nn.Module):
    """feat (B,N,C), xyz (B,N,3) -> feat + LN(FFN([feat || LN(merge(
    linattn(q,k,v)))])), with q, k, v all from feat + pos_mlp(xyz)."""

    def __init__(self, d_model: int, nhead: int = 2,
                 attention: str = "linear"):
        super().__init__()
        d = d_model
        self.nhead = nhead
        self.attention = attention
        self.attn = _attn_fn(attention)
        self.pos_mlp = pos_mlp(d)
        self.q_proj = Dense(d, d, bias=False)
        self.k_proj = Dense(d, d, bias=False)
        self.v_proj = Dense(d, d, bias=False)
        self.merge = Dense(d, d, bias=False)
        self.mlp = _ffn_mlp(2 * d, 2 * d, d)
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.norm2 = LayerNorm(d, eps=1e-5)

    def forward(self, feat: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
        feat_pos = feat + self.pos_mlp(xyz)
        q = _split_heads(self.q_proj(feat_pos), self.nhead)
        k = _split_heads(self.k_proj(feat_pos), self.nhead)
        v = _split_heads(self.v_proj(feat_pos), self.nhead)
        msg = self.norm1(self.merge(_merge_heads(self.attn(q, k, v))))
        msg = self.norm2(self.mlp(torch.cat([feat, msg], dim=-1)))
        return feat + msg


class _CrossDecomposable(nn.Module):
    """What the two cross-attention blocks share: the projections, the
    merge / LN / FFN tail, and the pair-grid decomposition of linear
    attention (queries and the finish-from-summary step; only
    template_summary differs, the point block adds the pos-MLP to the
    values)."""

    def __init__(self, d_model: int, nhead: int = 2,
                 attention: str = "linear", with_pos: bool = False):
        super().__init__()
        d = d_model
        self.d_model, self.nhead = d, nhead
        self.attention = attention
        self.attn = _attn_fn(attention)
        if with_pos:     # first, so a seeded init draws in the same order
            self.pos_mlp = pos_mlp(d)
        self.q_proj = Dense(d, d, bias=False)
        self.k_proj = Dense(d, d, bias=False)
        self.v_proj = Dense(d, d, bias=False)
        self.merge = Dense(d, d, bias=False)
        self.mlp = _ffn_mlp(2 * d, 2 * d, d)
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.norm2 = LayerNorm(d, eps=1e-5)

    def _ffn(self, search_feat: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
        msg = self.norm1(self.merge(msg))
        h = self.mlp(torch.cat([search_feat, msg], dim=-1))
        return search_feat + self.norm2(h)

    def query_features(self, search_feat: torch.Tensor) -> torch.Tensor:
        """(B, N, H, D) = elu(q_proj(search)) + 1."""
        return elu_feature_map(_split_heads(self.q_proj(search_feat),
                                            self.nhead))

    def _summary(self, template_feat: torch.Tensor, value_in: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        k = elu_feature_map(_split_heads(self.k_proj(template_feat),
                                         self.nhead))
        v = _split_heads(self.v_proj(value_in), self.nhead)
        s = v.shape[1]
        kv = torch.einsum("nshd,nshv->nhdv", k, v / s)
        return kv, k.sum(dim=1)

    def finish_from_summary(self, search_feat, queries, kv, ksum,
                            v_length: int, eps: float = 1e-6) -> torch.Tensor:
        """search_feat (P, N, C), queries (P, N, H, D), kv (P, H, D, V),
        ksum (P, H, D); v_length is the template's point count."""
        z = 1.0 / (torch.einsum("nlhd,nhd->nlh", queries, ksum) + eps)
        msg = torch.einsum("nlhd,nhdv,nlh->nlhv", queries, kv, z) * v_length
        return self._ffn(search_feat, _merge_heads(msg))


class CrossAttentionBlock(_CrossDecomposable):
    """Cross-attention whose positional encoding enters through the template
    VALUES only (the reference's asymmetry, attention.py:203-209).

    Besides forward, the decomposed pair-grid path of the JAX block:
      query_features     Q' = elu(q_proj(search)) + 1           per object
      template_summary   KV = K'^T (V / S), Ksum = sum_s K'      per object
      finish_from_summary msg = (Q' KV) / (Q' Ksum + eps) * S, then the
                          merge / LN / FFN tail                  per pair
    """

    def __init__(self, d_model: int, nhead: int = 2,
                 attention: str = "linear"):
        super().__init__(d_model, nhead, attention, with_pos=True)

    def forward(self, search_feat, search_xyz, template_feat, template_xyz,
                template_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        """template_pos: optional precomputed pos_mlp(template_xyz)."""
        if template_pos is None:
            template_pos = self.pos_mlp(template_xyz)
        template_pos = template_feat + template_pos
        q = _split_heads(self.q_proj(search_feat), self.nhead)
        k = _split_heads(self.k_proj(template_feat), self.nhead)
        v = _split_heads(self.v_proj(template_pos), self.nhead)
        return self._ffn(search_feat, _merge_heads(self.attn(q, k, v)))

    def template_summary(self, template_feat: torch.Tensor,
                         template_xyz: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """KV (B, H, D, V) with the 1/S value pre-scale, Ksum (B, H, D)."""
        return self._summary(template_feat,
                             template_feat + self.pos_mlp(template_xyz))


class CrossLinAttn(_CrossDecomposable):
    """Cross-attention without positions, for image token sequences (the
    reference builds a pos_mlp here and never uses it; it is left out). The
    same decomposed pair-grid path as CrossAttentionBlock."""

    def forward(self, search_feat, template_feat) -> torch.Tensor:
        q = _split_heads(self.q_proj(search_feat), self.nhead)
        k = _split_heads(self.k_proj(template_feat), self.nhead)
        v = _split_heads(self.v_proj(template_feat), self.nhead)
        return self._ffn(search_feat, _merge_heads(self.attn(q, k, v)))

    def template_summary(self, template_feat: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """KV (B, H, D, V) with the 1/S value pre-scale, Ksum (B, H, D)."""
        return self._summary(template_feat, template_feat)


class LocalSelfAttention(nn.Module):
    """Attention of each point over its knum nearest neighbours in feature
    space (the 'xcorr' match type's local stages): (B, N, d) features and
    xyz -> (B, N, d), as B * N problems of one query and knum keys. The
    neighbours are knn_feature_space's (the lower index first among equal
    distances); the pos-MLP is added to the centre and to each
    neighbour."""

    def __init__(self, d_model: int, nhead: int = 2, knum: int = 32,
                 pos_size: Optional[int] = None, attention: str = "linear"):
        super().__init__()
        if pos_size is not None and pos_size != d_model:
            raise ValueError(
                f"local_self_attention pos_size={pos_size} must equal "
                f"d_model={d_model}: the positional encoding is added to the "
                "features (reference attention.py:62-63)")
        d = d_model
        self.d_model, self.nhead, self.knum = d, nhead, knum
        self.attention = attention
        self.attn = _attn_fn(attention)
        self.pos_mlp_knn = pos_mlp(d)
        self.q_proj_knn = Dense(d, d, bias=False)
        self.k_proj_knn = Dense(d, d, bias=False)
        self.v_proj_knn = Dense(d, d, bias=False)
        self.merge_knn = Dense(d, d, bias=False)
        self.mlp_knn = _ffn_mlp(2 * d, 2 * d, d)
        self.norm1_knn = LayerNorm(d, eps=1e-5)
        self.norm2_knn = LayerNorm(d, eps=1e-5)

    def forward(self, search_feat: torch.Tensor, search_xyz: torch.Tensor
                ) -> torch.Tensor:
        B, N, C = search_feat.shape
        k, d = self.knum, self.d_model
        kidx = knn_feature_space(search_feat.transpose(-1, -2), k)
        fea_knn = index_points(search_feat, kidx)               # (B, N, k, C)
        xyz_knn = index_points(search_xyz, kidx)                # (B, N, k, 3)
        center = search_feat + self.pos_mlp_knn(search_xyz)
        neigh = fea_knn + self.pos_mlp_knn(xyz_knn)
        q = self.q_proj_knn(center).reshape(B * N, 1, self.nhead, -1)
        kk = self.k_proj_knn(neigh).reshape(B * N, k, self.nhead, -1)
        vv = self.v_proj_knn(neigh).reshape(B * N, k, self.nhead, -1)
        msg = self.attn(q, kk, vv).reshape(B * N, 1, d)
        msg = self.norm1_knn(self.merge_knn(msg))
        center_flat = search_feat.reshape(B * N, 1, C)
        msg = self.norm2_knn(self.mlp_knn(torch.cat([center_flat, msg], -1)))
        return (center_flat + msg).reshape(B, N, d)


class FPSA(nn.Module):
    """Attention feature propagation (coarse -> fine): q from fine features,
    k from coarse features, v from coarse features + pos_mlp2(coarse xyz);
    no residual; projected to out_dim."""

    def __init__(self, feat1_dim: int, feat2_dim: int, d_model: int,
                 out_dim: int, nhead: int = 2):
        super().__init__()
        d = d_model
        self.nhead = nhead
        self.pos_mlp2 = pos_mlp(d, feat2_dim)
        self.q_proj = Dense(feat1_dim, d, bias=False)
        self.k_proj = Dense(feat2_dim, d, bias=False)
        self.v_proj = Dense(feat2_dim, d, bias=False)
        self.merge = Dense(d, d, bias=False)
        self.mlp = _ffn_mlp(feat1_dim + d, 2 * d, out_dim)
        self.norm1 = LayerNorm(d, eps=1e-5)
        self.norm2 = LayerNorm(out_dim, eps=1e-5)

    def forward(self, feat1, xyz1, feat2, xyz2) -> torch.Tensor:
        feat2_pos = feat2 + self.pos_mlp2(xyz2)
        q = _split_heads(self.q_proj(feat1), self.nhead)
        k = _split_heads(self.k_proj(feat2), self.nhead)
        v = _split_heads(self.v_proj(feat2_pos), self.nhead)
        msg = self.norm1(self.merge(_merge_heads(linear_attention(q, k, v))))
        return self.norm2(self.mlp(torch.cat([feat1, msg], dim=-1)))
