"""DGCNN backbone: four EdgeConv blocks -> concat -> pointwise conv to
emb_dims.

Port of point_cloud_reid_tpu/models/dgcnn.py (EdgeConv, DGCNNBackbone).
Channel-last: pts (B, N, 3) -> (pts, per-point features (B, N, emb_dims)).

Names follow the reference state dict (dgcnn_orig.py:89-152): each block's
conv is backbone.conv{i}.0 and its BatchNorm backbone.bn{i}; the reference's
Sequential registers that BatchNorm a second time as conv{i}.1, which the
port does not (an EdgeConv takes its BatchNorm as an argument). conv5.0 and
bn5 are the final conv and its BatchNorm. The convs are Linear layers
without bias ((out, in) weights; the reference's 1x1 Conv2d / Conv1d weights
squeeze to them). LeakyReLU slope 0.2; BatchNorm momentum 0.9 in flax's
convention (0.1 in torch's) and eps 1e-5, as models/layers.BatchNorm.

The kNN runs in feature space on every block's input (ops.geometry.
knn_feature_space: expanded-form distances in the input's dtype, the lower
index first among equal distances). It is plain torch: the JAX model runs
no Pallas kernel here either.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.geometry import edge_features, knn_feature_space
from .layers import BatchNorm, Dense

SLOPE = 0.2


class EdgeConv(nn.Sequential):
    """[neighbour - centre || centre] over the k nearest neighbours in
    feature space -> conv (child 0) -> the block's BatchNorm -> LeakyReLU
    -> max over the neighbours: (B, N, C) -> (B, N, features)."""

    def __init__(self, c_in: int, features: int, k: int):
        super().__init__(Dense(2 * c_in, features, bias=False))
        self.k = k

    def forward(self, x: torch.Tensor, bn: BatchNorm, train: bool = False
                ) -> torch.Tensor:
        idx = knn_feature_space(x.transpose(1, 2), self.k)
        g = bn(self[0](edge_features(x, idx)), train)
        return F.leaky_relu(g, SLOPE).amax(dim=2)


class DGCNNBackbone(nn.Module):
    """forward(pts (B, N, 3), numpoints unused) -> (pts, (B, N, emb_dims))."""

    def __init__(self, emb_dims: int = 1024, k: int = 20):
        super().__init__()
        self.out_channels = emb_dims
        self.bn1 = BatchNorm(64)
        self.bn2 = BatchNorm(64)
        self.bn3 = BatchNorm(128)
        self.bn4 = BatchNorm(256)
        self.bn5 = BatchNorm(emb_dims)
        self.conv1 = EdgeConv(3, 64, k)
        self.conv2 = EdgeConv(64, 64, k)
        self.conv3 = EdgeConv(64, 128, k)
        self.conv4 = EdgeConv(128, 256, k)
        self.conv5 = nn.Sequential(Dense(512, emb_dims, bias=False))

    def forward(self, pts: torch.Tensor, numpoints: Sequence[int] = (),
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        x1 = self.conv1(pts, self.bn1, train)
        x2 = self.conv2(x1, self.bn2, train)
        x3 = self.conv3(x2, self.bn3, train)
        x4 = self.conv4(x3, self.bn4, train)
        x = self.conv5[0](torch.cat([x1, x2, x3, x4], dim=-1))
        return pts, F.leaky_relu(self.bn5(x, train), SLOPE)
