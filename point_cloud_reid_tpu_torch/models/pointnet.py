"""Classic PointNet backbone with input and feature spatial transformers.

Port of point_cloud_reid_tpu/models/pointnet.py (STN, PointNetEncoder,
PointNetBackbone, feature_transform_regularizer). Channel-last: pts
(B, N, C) -> (pts, per-point features (B, N, 1024)).

Names follow the reference state dict: backbone.feat.stn.{conv1..3, fc1..3,
bn1..5}, backbone.feat.{conv1..3, bn1..3}, backbone.feat.fstn.*. The convs
are Linear layers ((out, in) weights; the reference's kernel-1 Conv1d
weights squeeze to them), so models.build.init_weights seeds them as it
seeds every other product.

At a bf16 compute dtype the transforms come out in bf16; `xyz @ trans`
multiplies float32 points by a bf16 transform, which promotes to float32,
as jnp.matmul does, and the feature transform's product is bf16 x bf16.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from .layers import BatchNorm, Dense


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype of the two, as jnp.matmul."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


class STN(nn.Module):
    """Spatial transformer: (B, N, k) -> a (B, k, k) alignment matrix, the
    identity plus a learned residual (reference STN3d / STNkd)."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k
        self.conv1 = Dense(k, 64)
        self.conv2 = Dense(64, 128)
        self.conv3 = Dense(128, 1024)
        self.fc1 = Dense(1024, 512)
        self.fc2 = Dense(512, 256)
        self.fc3 = Dense(256, k * k)
        self.bn1 = BatchNorm(64)
        self.bn2 = BatchNorm(128)
        self.bn3 = BatchNorm(1024)
        self.bn4 = BatchNorm(512)
        self.bn5 = BatchNorm(256)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x), train))
        h = torch.relu(self.bn2(self.conv2(h), train))
        h = torch.relu(self.bn3(self.conv3(h), train))
        h = h.amax(dim=1)
        h = torch.relu(self.bn4(self.fc1(h), train))
        h = torch.relu(self.bn5(self.fc2(h), train))
        h = self.fc3(h)
        eye = torch.eye(self.k, dtype=h.dtype, device=h.device).reshape(1, -1)
        return (h + eye).reshape(-1, self.k, self.k)


class PointNetEncoder(nn.Module):
    """STN -> conv1 (64) -> feature STN -> conv2 (128) -> conv3 (1024) with
    BatchNorm and no ReLU after conv3 (reference pointnet.py:126)."""

    def __init__(self, feature_transform: bool = True, channel: int = 3):
        super().__init__()
        self.stn = STN(3)
        self.conv1 = Dense(channel, 64)
        self.conv2 = Dense(64, 128)
        self.conv3 = Dense(128, 1024)
        self.bn1 = BatchNorm(64)
        self.bn2 = BatchNorm(128)
        self.bn3 = BatchNorm(1024)
        self.fstn = STN(64) if feature_transform else None

    def forward(self, pts: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        trans = self.stn(pts[..., :3], train)
        x = _matmul(pts[..., :3], trans)
        if pts.shape[-1] > 3:
            x = torch.cat([x, pts[..., 3:].to(x.dtype)], dim=-1)
        x = torch.relu(self.bn1(self.conv1(x), train))
        if self.fstn is not None:
            x = _matmul(x, self.fstn(x, train))
        x = torch.relu(self.bn2(self.conv2(x), train))
        return pts, self.bn3(self.conv3(x), train)


class PointNetBackbone(nn.Module):
    """forward(pts (B, N, C), numpoints unused) -> (pts, (B, N, 1024)); the
    ReIDNet backbone interface (reference PointNet.forward)."""

    out_channels = 1024

    def __init__(self, channel: int = 3):
        super().__init__()
        self.feat = PointNetEncoder(feature_transform=True, channel=channel)

    def forward(self, pts: torch.Tensor, numpoints: Sequence[int] = (),
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.feat(pts, train)


def feature_transform_regularizer(trans: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of ||T T^t - I||_F: the orthogonality
    regularizer of a (B, d, d) transform (reference pointnet.py:130-136)."""
    d = trans.shape[1]
    eye = torch.eye(d, dtype=trans.dtype, device=trans.device)[None]
    diff = torch.matmul(trans, trans.transpose(1, 2)) - eye
    return torch.linalg.matrix_norm(diff).mean()
