"""Voxelization and scatter ops with static output shapes, the port of
point_cloud_reid_tpu/ops/voxel.py (the reference's hard Voxelization,
DynamicScatter and bev_pool extensions) in plain PyTorch.

Dynamic voxel counts become capped static shapes with validity markers, as
in the JAX package: first-come voxel slots, points past
max_points_per_voxel and voxels past max_voxels dropped.
"""
from __future__ import annotations

from typing import Tuple

import torch

_INT32_MAX = 2 ** 31 - 1


def voxelize_hard(points: torch.Tensor,
                  voxel_size: Tuple[float, float, float],
                  pc_range: Tuple[float, float, float, float, float, float],
                  max_points_per_voxel: int, max_voxels: int):
    """Hard voxelization of points (N, C), xyz in the first 3 channels.

    Returns
        voxels      (max_voxels, max_points_per_voxel, C), zero where empty;
        coords      (max_voxels, 3) int32 (z, y, x) grid coordinates, -1 in
                    an empty slot;
        num_points  (max_voxels,) int32 points kept in each voxel;
        num_voxels  () int32.

    Voxels take slots in the order of their linear id (x fastest), points
    in a voxel keep their input order, and the grid size and every
    coordinate are computed in the points' dtype as the JAX function does,
    so both agree index for index.
    """
    dev, dt = points.device, points.dtype
    vs = torch.tensor(voxel_size, dtype=dt, device=dev)
    lo = torch.tensor(pc_range[:3], dtype=dt, device=dev)
    hi = torch.tensor(pc_range[3:], dtype=dt, device=dev)
    grid = torch.floor((hi - lo) / vs).to(torch.int32)

    coord = torch.floor((points[:, :3] - lo) / vs).to(torch.int32)
    in_range = torch.all((coord >= 0) & (coord < grid[None]), dim=1)
    lin = (coord[:, 2].long() * int(grid[1]) + coord[:, 1]) * int(grid[0]) \
        + coord[:, 0]
    lin = torch.where(in_range, lin, _INT32_MAX)

    order = torch.sort(lin, stable=True).indices
    lin_sorted = lin[order]
    valid_sorted = in_range[order]
    new_seg = torch.ones_like(valid_sorted)
    new_seg[1:] = lin_sorted[1:] != lin_sorted[:-1]
    new_seg &= valid_sorted
    voxel_id = torch.cumsum(new_seg.long(), 0) - 1
    voxel_id = torch.where(valid_sorted, voxel_id, max_voxels)
    voxel_id = torch.clamp(voxel_id, max=max_voxels)

    n = points.shape[0]
    idx = torch.arange(n, device=dev)
    seg_start = torch.cummax(torch.where(new_seg, idx, 0), 0).values
    rank = idx - seg_start
    slot_ok = (rank < max_points_per_voxel) & (voxel_id < max_voxels)

    voxels = torch.zeros((max_voxels, max_points_per_voxel, points.shape[1]),
                         dtype=dt, device=dev)
    voxels[voxel_id[slot_ok], rank[slot_ok]] = points[order[slot_ok]]
    num_points = torch.bincount(voxel_id[slot_ok], minlength=max_voxels
                                )[:max_voxels].to(torch.int32)
    first = new_seg & (voxel_id < max_voxels)
    coords = torch.full((max_voxels, 3), -1, dtype=torch.int32, device=dev)
    coords[voxel_id[first]] = coord[order[first]].flip(1)
    num_voxels = first.sum().to(torch.int32)
    return voxels, coords, num_points, num_voxels


def _segment_sum(values: torch.Tensor, ids: torch.Tensor, num: int
                 ) -> torch.Tensor:
    """Sum of the rows of `values` into `num` segments; ids outside
    [0, num) are dropped."""
    keep = (ids >= 0) & (ids < num)
    out = torch.zeros((num,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, ids[keep].long(), values[keep])


def dynamic_scatter_mean(feats: torch.Tensor, voxel_ids: torch.Tensor,
                         num_voxels: int):
    """Mean of the features (N, C) of each voxel (DynamicScatter): voxel_ids
    (N,) in [0, num_voxels), -1 for a dropped point. Returns the means
    (num_voxels, C) and the counts (num_voxels,) in the features' dtype."""
    sums = _segment_sum(feats, voxel_ids, num_voxels)
    counts = _segment_sum(torch.ones_like(feats[:, 0]), voxel_ids,
                          num_voxels)
    return sums / torch.clamp(counts[:, None], min=1.0), counts


def bev_pool(feats: torch.Tensor, ranks: torch.Tensor, num_bins: int
             ) -> torch.Tensor:
    """Sum-pool the features (N, C) into BEV bins by rank id (N,), -1 to
    drop: (num_bins, C)."""
    return _segment_sum(feats, ranks, num_bins)
