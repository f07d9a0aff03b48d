"""Attention primitives: linear attention ("Transformers are RNNs",
Katharopoulos et al.) and softmax attention.

Port of point_cloud_reid_tpu/ops/attention.py: elu+1 feature map, the
1/v_length value pre-scale (the reference's fp16 overflow guard, kept because
it changes rounding and so matters for checkpoint parity), the
eps-regularised normaliser, and both functions' optional validity masks.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def elu_feature_map(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x) + 1.0


def _heads(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (B, T) validity mask as a (B, T, 1, 1) factor in like's dtype."""
    return mask[:, :, None, None].to(like.dtype)


def linear_attention(queries: torch.Tensor, keys: torch.Tensor,
                     values: torch.Tensor,
                     q_mask: Optional[torch.Tensor] = None,
                     kv_mask: Optional[torch.Tensor] = None,
                     eps: float = 1e-6) -> torch.Tensor:
    """Multi-head linear attention.

    queries (B, L, H, D), keys (B, S, H, D), values (B, S, H, V), optional
    validity masks q_mask (B, L) and kv_mask (B, S) -> (B, L, H, V). A
    masked query's or key's feature map is zeroed, and so is a masked
    key's value.
    """
    Q = elu_feature_map(queries)
    K = elu_feature_map(keys)
    if q_mask is not None:
        Q = Q * _heads(q_mask, Q)
    if kv_mask is not None:
        K = K * _heads(kv_mask, K)
        values = values * _heads(kv_mask, values)
    v_length = values.shape[1]
    values = values / v_length
    KV = torch.einsum("nshd,nshv->nhdv", K, values)
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", Q, KV, Z) * v_length


def full_attention(queries: torch.Tensor, keys: torch.Tensor,
                   values: torch.Tensor,
                   q_mask: Optional[torch.Tensor] = None,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention with temperature 1/sqrt(D), same shapes and masks
    as linear_attention. Masked scores are -inf, and a row with every score
    masked (a masked query) comes out as zeros (JAX's nan_to_num of the
    softmax)."""
    QK = torch.einsum("nlhd,nshd->nlsh", queries, keys)
    if q_mask is not None or kv_mask is not None:
        mask = torch.ones(QK.shape[:3] + (1,), dtype=torch.bool,
                          device=QK.device)
        if q_mask is not None:
            mask = mask & q_mask[:, :, None, None].bool()
        if kv_mask is not None:
            mask = mask & kv_mask[:, None, :, None].bool()
        QK = QK.masked_fill(~mask, -math.inf)
    temp = 1.0 / math.sqrt(queries.shape[3])
    A = torch.nan_to_num(torch.softmax(temp * QK, dim=2))
    return torch.einsum("nlsh,nshd->nlhd", A, values)
