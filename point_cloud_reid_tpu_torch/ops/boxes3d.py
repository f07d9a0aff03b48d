"""3D box structure with coordinate-origin conversion, the port of
point_cloud_reid_tpu/ops/boxes3d.py (the reference's mmdet3d box classes,
reduced to the geometry the data frontend and tracker use).

Box tensor layout: (N, 7) = [cx, cy, z, dx, dy, dz, yaw]; `origin_z` says
where z sits (0.0 the bottom face, the lidar convention; 0.5 the gravity
centre, the depth convention). The JAX class is also a pytree; a dataclass
of tensors needs no such registration.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .boxes import (box_corners_3d, box_corners_bev, boxes_iou_3d,
                    boxes_iou_bev, nms_bev, points_in_rboxes, rotation_2d)


@dataclasses.dataclass(frozen=True)
class Boxes3D:
    """Immutable batch of 3D boxes."""

    tensor: torch.Tensor             # (N, 7)
    origin_z: float = 0.0            # 0.0 bottom (lidar) | 0.5 centre (depth)

    @classmethod
    def lidar(cls, tensor) -> "Boxes3D":
        return cls(torch.as_tensor(tensor, dtype=torch.float32), origin_z=0.0)

    @classmethod
    def depth(cls, tensor) -> "Boxes3D":
        """Gravity-centred z (DepthInstance3DBoxes, origin (0.5, 0.5, 0.5))."""
        return cls(torch.as_tensor(tensor, dtype=torch.float32), origin_z=0.5)

    def __len__(self) -> int:
        return int(self.tensor.shape[0])

    @property
    def center(self) -> torch.Tensor:
        """(N, 3) gravity centres whatever the stored origin."""
        t = self.tensor
        z = t[:, 2] + (0.5 - self.origin_z) * t[:, 5]
        return torch.stack([t[:, 0], t[:, 1], z], dim=-1)

    @property
    def dims(self) -> torch.Tensor:
        return self.tensor[:, 3:6]

    @property
    def yaw(self) -> torch.Tensor:
        return self.tensor[:, 6]

    @property
    def volume(self) -> torch.Tensor:
        return torch.prod(self.dims, dim=-1)

    def to_origin(self, origin_z: float) -> "Boxes3D":
        """The same boxes with z at another origin (Box3DMode)."""
        t = self.tensor.clone()
        t[:, 2] = t[:, 2] + (origin_z - self.origin_z) * t[:, 5]
        return Boxes3D(t, origin_z=origin_z)

    def bottom(self) -> "Boxes3D":
        return self.to_origin(0.0)

    def gravity(self) -> "Boxes3D":
        return self.to_origin(0.5)

    def corners(self) -> torch.Tensor:
        """(N, 8, 3) corners, the bottom four then the top four."""
        return box_corners_3d(self.bottom().tensor)

    def corners_bev(self) -> torch.Tensor:
        """(N, 4, 2) rotated BEV rectangles."""
        return box_corners_bev(self.tensor)

    def points_in_boxes(self, points: torch.Tensor) -> torch.Tensor:
        """(P, N) membership mask of points (P, >= 3)."""
        return points_in_rboxes(points[:, :3], self.bottom().tensor)

    def rotate(self, angle) -> "Boxes3D":
        """Rotate about the z axis by a scalar angle."""
        t = self.tensor
        angle = torch.as_tensor(angle, dtype=t.dtype, device=t.device)
        xy = t[:, :2] @ rotation_2d(angle).T
        return Boxes3D(torch.cat([xy, t[:, 2:6], t[:, 6:7] + angle], dim=1),
                       origin_z=self.origin_z)

    def translate(self, offset) -> "Boxes3D":
        t = self.tensor.clone()
        t[:, :3] += torch.as_tensor(offset, dtype=t.dtype, device=t.device)
        return Boxes3D(t, origin_z=self.origin_z)

    def scale(self, factor: float) -> "Boxes3D":
        t = self.tensor
        return Boxes3D(torch.cat([t[:, :6] * factor, t[:, 6:]], dim=1),
                       origin_z=self.origin_z)

    def iou_bev(self, other: "Boxes3D") -> torch.Tensor:
        return boxes_iou_bev(self.tensor, other.tensor)

    def iou_3d(self, other: "Boxes3D") -> torch.Tensor:
        return boxes_iou_3d(self.bottom().tensor, other.bottom().tensor)

    def nms(self, scores: torch.Tensor, thresh: float,
            max_out: Optional[int] = None) -> torch.Tensor:
        """Greedy BEV NMS keep indices (max_out,), -1 past the last kept;
        max_out defaults to the number of boxes (the JAX method's default
        call, without max_out, raises: its nms_bev needs one)."""
        return nms_bev(self.tensor, scores, thresh,
                       len(self) if max_out is None else max_out)
