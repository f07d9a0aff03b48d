"""Bilinear BEV feature sampling (port of ops/bev_feat.py::
grid_sample_bilinear, interpolate_bev), for the BEV metric supervision.

Feature maps are channel-last (H, W, C). The sampling is a fixed-shape
gather of the four neighbours and a weighted sum, differentiable in the map
and in the positions.
"""
from __future__ import annotations

from typing import Sequence

import torch


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor
                         ) -> torch.Tensor:
    """torch.nn.functional.grid_sample's bilinear, align_corners=False,
    padding 'zeros', on a channel-last map.

    img (H, W, C); grid (..., 2) normalised to [-1, 1], grid[..., 0] along
    W and grid[..., 1] along H. Returns (..., C), zero outside the map."""
    H, W = img.shape[0], img.shape[1]
    x = ((grid[..., 0] + 1.0) * W - 1.0) * 0.5
    y = ((grid[..., 1] + 1.0) * H - 1.0) * 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            w = (1.0 - (x - xi).abs()) * (1.0 - (y - yi).abs())
            inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            xc = torch.clamp(xi, 0, W - 1).long()
            yc = torch.clamp(yi, 0, H - 1).long()
            val = img[yc, xc]                                # (..., C)
            out = out + torch.where(inside[..., None], w[..., None] * val,
                                    torch.zeros((), dtype=val.dtype,
                                                device=val.device))
    return out


def interpolate_bev(bev: torch.Tensor, xy: torch.Tensor,
                    point_cloud_range: Sequence[float]) -> torch.Tensor:
    """Bilinear BEV features at lidar-frame positions.

    bev (H, W, C), lidar x along W and y along H; xy (..., 2);
    point_cloud_range [xmin, ymin, zmin, xmax, ymax, zmax]. Returns
    (..., C), zero outside the range."""
    r = point_cloud_range
    gx = (xy[..., 0] - r[0]) / (r[3] - r[0]) * 2.0 - 1.0
    gy = (xy[..., 1] - r[1]) / (r[4] - r[1]) * 2.0 - 1.0
    return grid_sample_bilinear(bev, torch.stack([gx, gy], dim=-1))
