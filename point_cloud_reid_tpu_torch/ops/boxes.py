"""Rotated-box membership test and box corners (port of ops/boxes.py::
points_in_rboxes, rotation_2d, box_corners_bev, box_corners_3d).

Boxes follow the LiDAR convention (x, y, z_bottom, dx, dy, dz, yaw).
"""
from __future__ import annotations

import torch


def points_in_rboxes(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """points (N, 3), boxes (M, 7) -> (N, M) bool membership mask.

    Points are rotated into each box frame and compared with the half
    extents; z is tested against [z_bottom, z_bottom + dz]."""
    rel = points[:, None, :2] - boxes[None, :, :2]                # (N,M,2)
    c, s = torch.cos(-boxes[:, 6]), torch.sin(-boxes[:, 6])
    local_x = rel[..., 0] * c[None] - rel[..., 1] * s[None]
    local_y = rel[..., 0] * s[None] + rel[..., 1] * c[None]
    in_x = torch.abs(local_x) <= boxes[None, :, 3] * 0.5
    in_y = torch.abs(local_y) <= boxes[None, :, 4] * 0.5
    z = points[:, None, 2]
    in_z = (z >= boxes[None, :, 2]) & (z <= boxes[None, :, 2] + boxes[None, :, 5])
    return in_x & in_y & in_z


def rotation_2d(yaw: torch.Tensor) -> torch.Tensor:
    """(...,) yaw -> (..., 2, 2) counter-clockwise rotation matrices."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       dim=-2)


def box_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) boxes -> (..., 4, 2) BEV corners, counter-clockwise."""
    tmpl = torch.tensor([[0.5, 0.5], [-0.5, 0.5], [-0.5, -0.5], [0.5, -0.5]],
                        dtype=boxes.dtype, device=boxes.device)
    local = tmpl * boxes[..., None, 3:5]
    world = torch.einsum("...ij,...kj->...ki", rotation_2d(boxes[..., 6]),
                         local)
    return world + boxes[..., None, :2]


def box_corners_3d(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) boxes -> (..., 8, 3) corners, the bottom four then the top
    four."""
    bev = box_corners_bev(boxes)
    z0 = boxes[..., None, 2:3].expand(bev.shape[:-1] + (1,))
    z1 = (boxes[..., 2:3] + boxes[..., 5:6])[..., None, :].expand(
        bev.shape[:-1] + (1,))
    return torch.cat([torch.cat([bev, z0], -1), torch.cat([bev, z1], -1)],
                     dim=-2)
