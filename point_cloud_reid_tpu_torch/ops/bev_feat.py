"""BEV feature sampling, the port of point_cloud_reid_tpu/ops/bev_feat.py:
bilinear sampling at lidar positions and on grids around centres (the
tracker's BEV metric supervision), and LaneGCN's clamped pixel features and
rotated ROI features.

Feature maps are channel-last (H, W, C). The sampling is a fixed-shape
gather of the four neighbours and a weighted sum, differentiable in the map
and in the positions. As in the JAX package, interpolate_bev_grid returns
the unscrambled (N, n, n, C), not the reference's channel-scrambling final
reshape.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

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


def centered_grid(centers: torch.Tensor, spacing: float,
                  num_points: int) -> torch.Tensor:
    """(N, 2) centres -> (N, num_points**2, 2) square grids around them
    (ij-indexed meshgrid order)."""
    lin = torch.linspace(-spacing, spacing, num_points, dtype=centers.dtype,
                         device=centers.device)
    gx, gy = torch.meshgrid(lin, lin, indexing="ij")
    offsets = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
    return centers[:, None, :] + offsets[None]


def interpolate_bev_grid(bev: torch.Tensor, xy: torch.Tensor,
                         point_cloud_range: Sequence[float],
                         spacing: float = 2.0,
                         num_points: int = 5) -> torch.Tensor:
    """BEV features on a num_points x num_points grid around each centre xy
    (N, 2) -> (N, num_points, num_points, C)."""
    feats = interpolate_bev(bev, centered_grid(xy, spacing, num_points),
                            point_cloud_range)
    N, _, C = feats.shape
    return feats.reshape(N, num_points, num_points, C)


def linear_interp(x: torch.Tensor, n_max: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Clamped pixel-centre linear interpolation of x normalised to [0, 1]:
    (left weight, left index, right weight, right index), int64 indices."""
    x = torch.clamp(x * n_max - 0.5, 0.0, n_max - 1.0)
    n = torch.floor(x)
    rw = x - n
    li = n.long()
    return 1.0 - rw, li, rw, torch.clamp(li + 1, max=n_max - 1)


def _pixel_bilinear(fm: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                    ) -> torch.Tensor:
    """Four-tap clamped bilinear gather; fm (H, W, C), x / y in [0, 1]."""
    H, W = fm.shape[0], fm.shape[1]
    xlw, xli, xhw, xhi = linear_interp(x, W)
    ylw, yli, yhw, yhi = linear_interp(y, H)
    return ((xlw * ylw)[..., None] * fm[yli, xli]
            + (xlw * yhw)[..., None] * fm[yhi, xli]
            + (xhw * ylw)[..., None] * fm[yli, xhi]
            + (xhw * yhw)[..., None] * fm[yhi, xhi])


def get_pixel_feat(fm: torch.Tensor, bboxes: torch.Tensor,
                   pts_range: Sequence[float]) -> torch.Tensor:
    """BEV pixel features at box centres: fm (H, W, C), bboxes (N, >= 2)
    with cx, cy leading, pts_range (x_min, x_max, y_min, y_max, ...) in
    LaneGCN's order (not the tracker's point_cloud_range); y is flipped.
    Returns (N, C)."""
    x_min, x_max, y_min, y_max = pts_range[:4]
    x = (bboxes[:, 0] - x_min) / (x_max - x_min)
    y = (y_max - bboxes[:, 1]) / (y_max - y_min)
    return _pixel_bilinear(fm, x, y)


def get_roi_feat(fm: torch.Tensor, bboxes: torch.Tensor,
                 roi_size: Union[int, Sequence[int]],
                 pts_range: Sequence[float]) -> torch.Tensor:
    """Rotated BEV ROI features: an (rh, rw) grid of bin centres inside each
    box (N, 5) = cx, cy, wid, hgt, theta, bilinearly sampled; bins outside
    the open unit square are zero. Returns (N, rh, rw, C)."""
    if isinstance(roi_size, int):
        roi_size = (roi_size, roi_size)
    rh, rw = roi_size
    cx, cy, wid, hgt, theta = (bboxes[:, i] for i in range(5))
    st, ct = torch.sin(theta), torch.cos(theta)
    dev, dt = bboxes.device, bboxes.dtype
    x_bin = (torch.arange(rw, device=dev, dtype=dt) + 0.5) / rw - 0.5
    y_bin = (torch.arange(rh - 1, -1, -1, device=dev, dtype=dt) + 0.5
             ) / rh - 0.5
    ox = x_bin[None, None, :] * wid[:, None, None]
    oy = y_bin[None, :, None] * hgt[:, None, None]
    ox, oy = torch.broadcast_tensors(ox, oy)
    rx = ct[:, None, None] * ox - st[:, None, None] * oy
    ry = st[:, None, None] * ox + ct[:, None, None] * oy
    x = cx[:, None, None] + rx
    y = cy[:, None, None] + ry
    x_min, x_max, y_min, y_max = pts_range[:4]
    x = (x - x_min) / (x_max - x_min)
    y = (y_max - y) / (y_max - y_min)
    mask = (x > 0) & (x < 1) & (y > 0) & (y < 1)
    feat = _pixel_bilinear(fm, x, y)
    return torch.where(mask[..., None], feat, torch.zeros_like(feat))
