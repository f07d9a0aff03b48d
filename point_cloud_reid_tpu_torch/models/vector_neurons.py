"""Vector-neuron (VN) layers and the VN-DGCNN point backbone.

Port of point_cloud_reid_tpu/models/vector_neurons.py (the reference's
trackers/deprecated/vn_layers.py:12-198 and vn_dgcnn_cls.py:20-91). Every
scalar channel is a vector in R^3, and every layer commutes with global
rotations. The layout is the JAX package's: the vector axis before the
channel axis, (B, N, 3, C) a point and (B, N, K, 3, C) grouped, so that
channel mixing is a Linear on the last axis; reductions over the vector
axis are over dim -2. EPS placement, the LeakyReLU reflection, BatchNorm on
the vector norms and the std-feature einsum orders are the JAX package's.

Names are the reference's (flax's are the same): map_to_feat, map_to_dir,
batchnorm.bn, vn1 / vn2 / vn_lin, and the backbone's conv1-5, pool1-4 and
std_feature. The VN-DGCNN backbone's kNN runs in the flattened 3C feature
space (ops.geometry.knn_feature_space, the lower index first among equal
distances, as lax.top_k); the JAX model runs no Pallas kernel here.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.geometry import index_points, knn_feature_space
from .layers import BatchNorm, Dense

EPS = 1e-6


def vn_graph_feature(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, 3, C) vector features -> (B, N, k, 3, 2C) edge features
    [neighbour - centre || centre] over the k nearest neighbours in the
    flattened 3C feature space."""
    B, N = x.shape[0], x.shape[1]
    flat = x.reshape(B, N, -1)
    idx = knn_feature_space(flat.transpose(-1, -2), k)
    neigh = index_points(flat, idx).reshape((B, N, k) + tuple(x.shape[2:]))
    center = x[:, :, None].expand_as(neigh)
    return torch.cat([neigh - center, center], dim=-1)


class VNLinear(nn.Module):
    """Channel mixing, which never touches the vector axis."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.map_to_feat = Dense(c_in, features, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.map_to_feat(x)


class VNBatchNorm(nn.Module):
    """BatchNorm of the vector norms alone, directions kept:
    x / (|x| + EPS) * BN(|x| + EPS)."""

    def __init__(self, features: int):
        super().__init__()
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        norm = torch.linalg.vector_norm(x, dim=-2) + EPS        # (..., C)
        norm_bn = self.bn(norm, train)
        return x / norm[..., None, :] * norm_bn[..., None, :]


def _vn_leaky(p: torch.Tensor, d: torch.Tensor,
              negative_slope: float) -> torch.Tensor:
    """The VN LeakyReLU reflection: p where <p, d> >= 0, else p without its
    d component; blended with the slope."""
    dot = torch.sum(p * d, dim=-2, keepdim=True)
    d_norm_sq = torch.sum(d * d, dim=-2, keepdim=True)
    neg = p - (dot / (d_norm_sq + EPS)) * d
    kept = torch.where(dot >= 0, p, neg)
    return negative_slope * p + (1.0 - negative_slope) * kept


class VNLeakyReLU(nn.Module):
    """The directional LeakyReLU with a learned direction per channel (one
    shared with share_nonlinearity)."""

    def __init__(self, c_in: int, share_nonlinearity: bool = False,
                 negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope
        self.map_to_dir = Dense(c_in, 1 if share_nonlinearity else c_in,
                                bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _vn_leaky(x, self.map_to_dir(x), self.negative_slope)


class VNLinearLeakyReLU(nn.Module):
    """Linear -> BatchNorm of the norms -> directional LeakyReLU, whose
    direction comes from the INPUT, not from the normalised features."""

    def __init__(self, c_in: int, features: int,
                 share_nonlinearity: bool = False,
                 negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope
        self.map_to_feat = Dense(c_in, features, bias=False)
        self.batchnorm = VNBatchNorm(features)
        self.map_to_dir = Dense(c_in, 1 if share_nonlinearity else features,
                                bias=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        p = self.batchnorm(self.map_to_feat(x), train)
        return _vn_leaky(p, self.map_to_dir(x), self.negative_slope)


class VNMaxPool(nn.Module):
    """(B, N, K, 3, C) -> (B, N, 3, C): per channel, the sample whose
    vector has the largest dot product with a learned direction (the first
    such sample on ties)."""

    def __init__(self, c_in: int):
        super().__init__()
        self.map_to_dir = Dense(c_in, c_in, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dot = torch.sum(x * self.map_to_dir(x), dim=-2)         # (B, N, K, C)
        idx = torch.argmax(dot, dim=-2)                         # (B, N, C)
        idx = idx[:, :, None, None, :].expand(
            tuple(x.shape[:2]) + (1,) + tuple(x.shape[3:]))
        return torch.gather(x, 2, idx).squeeze(2)


def vn_mean_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over the sample axis: (B, N, K, 3, C) -> (B, N, 3, C)."""
    return x.mean(dim=-3)


class VNStdFeature(nn.Module):
    """Rotation-invariant readout: a 3-frame z0 learned from the features,
    and every vector expressed in it. (B, N, 3, C) -> (invariant (B, N, C,
    3), frame (B, N, 3, 3)); the trailing (C, 3) flattens C-major, as the
    reference's view of a (B, C, 3, N) tensor."""

    def __init__(self, c_in: int, normalize_frame: bool = False,
                 share_nonlinearity: bool = False,
                 negative_slope: float = 0.2):
        super().__init__()
        self.normalize_frame = normalize_frame
        self.vn1 = VNLinearLeakyReLU(c_in, c_in // 2, share_nonlinearity,
                                     negative_slope)
        self.vn2 = VNLinearLeakyReLU(c_in // 2, c_in // 4,
                                     share_nonlinearity, negative_slope)
        self.vn_lin = Dense(c_in // 4, 2 if normalize_frame else 3,
                            bias=False)

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        z0 = self.vn_lin(self.vn2(self.vn1(x, train), train))   # (.., 3, k)
        if self.normalize_frame:
            # Gram-Schmidt of the two learned axes; the third is their cross
            v1 = z0[..., 0]
            u1 = v1 / (torch.linalg.vector_norm(v1, dim=-1, keepdim=True)
                       + EPS)
            v2 = z0[..., 1]
            v2 = v2 - torch.sum(v2 * u1, dim=-1, keepdim=True) * u1
            u2 = v2 / (torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
                       + EPS)
            u3 = torch.linalg.cross(u1, u2, dim=-1)
            z0 = torch.stack([u1, u2, u3], dim=-1)
        return torch.einsum("...ji,...jk->...ik", x, z0), z0


class VNDGCNNBackbone(nn.Module):
    """VN-DGCNN per-point encoder: four VN edge-conv blocks with
    directional (or mean) pooling -> a 341-wide fuse -> the mean over the
    points as context -> the std-feature readout. forward(pts (B, N, 3),
    numpoints unused) -> (pts, (B, N, (1024 // 3) * 2 * 3 = 2046))."""

    def __init__(self, n_knn: int = 20, pooling: str = "max"):
        super().__init__()
        if pooling not in ("max", "mean"):
            raise ValueError(f"VN-DGCNN pooling {pooling}")
        self.n_knn, self.pooling = n_knn, pooling
        widths = (64 // 3, 64 // 3, 128 // 3, 256 // 3)
        c_in = 1
        for i, w in enumerate(widths, 1):
            setattr(self, f"conv{i}", VNLinearLeakyReLU(2 * c_in, w))
            if pooling == "max":
                setattr(self, f"pool{i}", VNMaxPool(w))
            c_in = w
        fuse = 1024 // 3
        self.conv5 = VNLinearLeakyReLU(sum(widths), fuse,
                                       share_nonlinearity=True)
        self.std_feature = VNStdFeature(2 * fuse)
        self.out_channels = 2 * fuse * 3

    def forward(self, pts: torch.Tensor, numpoints: Sequence[int] = (),
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        x = pts[:, :, :, None]                                  # (B, N, 3, 1)
        feats = []
        for i in range(1, 5):
            g = getattr(self, f"conv{i}")(vn_graph_feature(x, self.n_knn),
                                          train)
            x = (getattr(self, f"pool{i}")(g) if self.pooling == "max"
                 else vn_mean_pool(g))
            feats.append(x)
        x = self.conv5(torch.cat(feats, dim=-1), train)
        x = torch.cat([x, x.mean(dim=1, keepdim=True).expand_as(x)], dim=-1)
        x, _ = self.std_feature(x, train)
        B, N = x.shape[0], x.shape[1]
        return pts, x.reshape(B, N, -1)
