"""Point-set ops on the tracker's path.

Port of the parts of point_cloud_reid_tpu/ops/geometry.py the point models
use: squared distances, stable-argsort kNN, RANDOM (first-n) and FPS
(farthest point) centre sampling, the gather, the SA stage's conv1 factors,
and DGCNN's feature-space kNN and edge features. The JAX
package's one-hot-matmul gather is a TPU workaround; here the gather is
torch.gather.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(..., N, C), (..., M, C) -> (..., N, M) squared distances.

    The expanded form ||s||^2 - 2 s.d + ||d||^2, as the JAX package and the
    reference compute it: kNN ties (duplicate points) and their order depend
    on these exact roundings, so torch.cdist is not a substitute.
    """
    inner = torch.matmul(src, dst.transpose(-1, -2))
    s2 = torch.sum(src * src, dim=-1, keepdim=True)
    d2 = torch.sum(dst * dst, dim=-1, keepdim=True)
    return s2 - 2.0 * inner + d2.transpose(-1, -2)


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along the point axis: (B, N, C), (B, ...) -> (B, ..., C).

    Out-of-range indices are clamped to the last point, as in the JAX
    package."""
    B, N, C = points.shape
    flat = idx.reshape(B, -1).long().clamp(0, N - 1)
    out = torch.gather(points, 1, flat[:, :, None].expand(-1, -1, C))
    return out.reshape(tuple(idx.shape) + (C,))


def knn_indices(nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
                method: str = "argsort") -> torch.Tensor:
    """(B, S, nsample) int64 indices of each query's nearest points.

    method: 'argsort' is a stable argsort, which keeps first-occurrence
    order among equal distances (the duplicate points of
    resample-with-replacement rely on it); 'topk' is torch.topk, which may
    order ties differently; 'pallas' (the JAX package's name for its fused
    kernel, kept so one config drives both packages) is the hand-written
    CUDA kernel of kernels/knn.py, with the tie order of 'argsort'."""
    if method == "pallas":
        from ..kernels.knn import knn
        return knn(new_xyz, xyz, nsample)
    d = square_distance(new_xyz, xyz)
    if method == "argsort":
        return torch.argsort(d, dim=-1, stable=True)[..., :nsample]
    if method == "topk":
        return torch.topk(-d, nsample, dim=-1).indices
    raise ValueError(f"unknown knn method: {method}")


def knn_feature_space(x: torch.Tensor, k: int) -> torch.Tensor:
    """kNN in feature space on channel-first input: x (B, C, N) -> (B, N, k)
    int64 indices, nearest first, each point its own first neighbour.

    Distances are square_distance's expanded form in x's dtype, as JAX's;
    the order is lax.top_k's (the lower index first among equal
    distances), which a stable ascending sort gives and torch.topk does not
    promise. Resampled crops repeat points, so exact ties are the normal
    case."""
    xt = x.transpose(-1, -2)
    d = square_distance(xt, xt)
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def edge_features(xt: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """DGCNN's EdgeConv input on channel-last features: xt (B, N, C), idx
    (B, N, k) -> (B, N, k, 2C) = [neighbour - centre || centre]."""
    feature = index_points(xt, idx)
    center = xt[:, :, None, :].expand_as(feature)
    return torch.cat([feature - center, center], dim=-1)


def get_graph_feature(x: torch.Tensor, k: int,
                      idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DGCNN's edge-feature builder on channel-first input x (B, C, N):
    (B, 2C, N, k) = [neighbour - centre || centre] over the k nearest
    neighbours in feature space (knn_feature_space, unless idx (B, N, k) is
    given). The JAX function's edge=False (plain gathered neighbours) has
    no caller in either package and is not carried."""
    if idx is None:
        idx = knn_feature_space(x, k)
    return edge_features(x.transpose(-1, -2), idx).permute(0, 3, 1, 2)


def random_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """'RANDOM' sampling as the reference defines it: the first npoint
    indices of every cloud (the randomness is the upstream resample)."""
    B = xyz.shape[0]
    return torch.arange(npoint, device=xyz.device).expand(B, npoint)


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """Iterative farthest point sampling: xyz (B, N, 3) -> (B, npoint) int64
    indices, the first of which is the start point.

    start: (B,) start indices in [0, N); else, with a generator (on xyz's
    device), a uniform draw per cloud, as the reference's randint start;
    else every cloud starts at point 0. On CUDA tensors the loop is the
    hand-written kernel of kernels/fps.py, on CPU tensors its plain version;
    both take the first of equally far points."""
    from ..kernels.fps import fps
    B, N, _ = xyz.shape
    if start is None:
        if generator is None:
            start = torch.zeros((B,), dtype=torch.int64, device=xyz.device)
        else:
            start = torch.randint(0, N, (B,), generator=generator,
                                  device=xyz.device)
    return fps(xyz, npoint, start)


def sample_centers(xyz: torch.Tensor, numpoints: int, sampling: str,
                   fps_start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, numpoints) centre indices: 'RANDOM' (the first numpoints) or
    'FPS' (from fps_start, or from point 0)."""
    if sampling == "FPS":
        return farthest_point_sample(xyz, numpoints, start=fps_start)
    if sampling == "RANDOM":
        return random_point_sample(xyz, numpoints)
    raise ValueError(f"unknown sampling {sampling}")


def conv1_edge_factors(kernel: torch.Tensor, bias: Optional[torch.Tensor],
                       xyz: torch.Tensor, points: Optional[torch.Tensor],
                       center_xyz: torch.Tensor,
                       center_points: Optional[torch.Tensor],
                       dtype: Optional[torch.dtype] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point / per-centre factors of the SA stage's first conv over the
    edge features [dxyz || centre_feat || grouped_feat - centre_feat].

    kernel is (3 [+ 2D], C1) in (in, out) layout. conv1 is linear, so

        conv1(edge)[b, s, k] = A[b, idx[b, s, k]] + Ct[b, s]
        A  = xyz @ W_d + points @ W_g                    (B, N, C1)
        Ct = -centre_xyz @ W_d + centre_points @ (W_c - W_g) + bias
                                                         (B, S, C1)

    With `dtype` (a model's compute dtype, bf16) every operand is cast to it
    and the factors come out in it, as in the JAX function; W_c - W_g is
    taken before the cast.
    """
    def c(t):
        return t if dtype is None else t.to(dtype)

    w_d = c(kernel[:3])
    A = c(xyz) @ w_d
    Ct = -(c(center_xyz) @ w_d)
    if points is not None:
        D = points.shape[-1]
        w_c = kernel[3:3 + D]
        w_g = kernel[3 + D:]
        A = A + c(points) @ c(w_g)
        Ct = Ct + c(center_points) @ c(w_c - w_g)
    if bias is not None:
        Ct = Ct + c(bias)
    return A, Ct


def sample_and_group_edge(nsample: int, xyz: torch.Tensor,
                          points: Optional[torch.Tensor], numpoints: int,
                          sampling: str = "RANDOM", use_knn: bool = True,
                          knn_method: str = "argsort",
                          fps_start: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample centres, group kNN neighbourhoods and build the edge features
    [grouped_xyz - centre_xyz || centre_feat || grouped_feat - centre_feat].

    xyz (B, N, 3); points (B, N, D) or None -> new_xyz (B, S, 3),
    new_points (B, S, K, 3 [+ 2D]). sampling is 'RANDOM' (first-n) or 'FPS'
    (from fps_start (B,), or from point 0, as the JAX function without a
    key); the ball query waits for the rest of the ops (M7).
    """
    if not use_knn:
        raise NotImplementedError("ball query is not ported yet (M7)")
    fps_idx = sample_centers(xyz, numpoints, sampling, fps_start)
    new_xyz = index_points(xyz, fps_idx)
    idx = knn_indices(nsample, xyz, new_xyz, method=knn_method)
    grouped_xyz_norm = index_points(xyz, idx) - new_xyz[:, :, None, :]
    if points is None:
        return new_xyz, grouped_xyz_norm
    center = index_points(points, fps_idx)
    grouped = index_points(points, idx)
    new_points = torch.cat(
        [grouped_xyz_norm, center[:, :, None, :].expand_as(grouped),
         grouped - center[:, :, None, :]], dim=-1)
    return new_xyz, new_points
