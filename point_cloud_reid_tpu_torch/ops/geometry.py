"""Point-set ops, the port of point_cloud_reid_tpu/ops/geometry.py.

Squared distances, stable-argsort kNN, RANDOM (first-n) and FPS (farthest
point) centre sampling, the gather, the SA stage's conv1 factors, DGCNN's
feature-space kNN and edge features, and the rest of the reference's point
utilities in plain PyTorch: FPS over a distance matrix, the ball query and
grouping, three-NN inverse-distance interpolation, the single global group,
the device-side resample and the chamfer distance. The JAX package's
one-hot-matmul gather is a TPU workaround; here the gather is torch.gather.
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
    case. One route for every caller (DGCNN, VN-DGCNN, the local stages):
    kernels/knn.knn with the distances in x's dtype, on the card its
    kernel (no (B, N, N) tensor; tier C past 3 channels or at bf16), on the
    CPU its plain version, this sort."""
    from ..kernels.knn import knn
    xt = x.transpose(-1, -2)
    return knn(xt, xt, k, keep_dtype=True)


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
    """Iterative farthest point sampling: xyz (B, N, C) -> (B, npoint) int64
    indices, the first of which is the start point; the distance is over
    all C channels (xyz, or points with features, as fps_pallas takes).

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
                          fps_start: Optional[torch.Tensor] = None,
                          radius: float = 0.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample centres, group kNN (or ball-query) neighbourhoods and build
    the edge features
    [grouped_xyz - centre_xyz || centre_feat || grouped_feat - centre_feat].

    xyz (B, N, 3); points (B, N, D) or None -> new_xyz (B, S, 3),
    new_points (B, S, K, 3 [+ 2D]). sampling is 'RANDOM' (first-n) or 'FPS'
    (from fps_start (B,), or from point 0, as the JAX function without a
    key); use_knn=False groups by query_ball_point(radius).
    """
    fps_idx = sample_centers(xyz, numpoints, sampling, fps_start)
    new_xyz = index_points(xyz, fps_idx)
    if use_knn:
        idx = knn_indices(nsample, xyz, new_xyz, method=knn_method)
    else:
        idx = query_ball_point(radius, nsample, xyz, new_xyz)
    grouped_xyz_norm = index_points(xyz, idx) - new_xyz[:, :, None, :]
    if points is None:
        return new_xyz, grouped_xyz_norm
    center = index_points(points, fps_idx)
    grouped = index_points(points, idx)
    new_points = torch.cat(
        [grouped_xyz_norm, center[:, :, None, :].expand_as(grouped),
         grouped - center[:, :, None, :]], dim=-1)
    return new_xyz, new_points


def farthest_point_sample_with_dist(dist: torch.Tensor, npoint: int,
                                    start: Optional[torch.Tensor] = None
                                    ) -> torch.Tensor:
    """FPS over a precomputed (B, N, N) distance matrix -> (B, npoint) int64
    indices (the reference's FurthestPointSamplingWithDist): from `start`
    (B,) or point 0, each step takes the first of the points farthest from
    the chosen set."""
    B, N, _ = dist.shape
    farthest = (torch.zeros((B,), dtype=torch.int64, device=dist.device)
                if start is None else start.long())
    running = torch.full((B, N), 1e10, dtype=dist.dtype, device=dist.device)
    centroids = torch.empty((B, npoint), dtype=torch.int64,
                            device=dist.device)
    rows = torch.arange(B, device=dist.device)
    for i in range(npoint):
        centroids[:, i] = farthest
        running = torch.minimum(running, dist[rows, farthest])
        farthest = torch.argmax(running, dim=-1)
    return centroids


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """Fixed-radius neighbours with first-k fill: (B, S, nsample) int64
    indices of the in-radius points of each query in index order; the slots
    past the in-radius count repeat the first one, and a query with no
    point in radius gets N (the JAX function's sentinel, which index_points
    clamps to the last point)."""
    N = xyz.shape[1]
    d = square_distance(new_xyz, xyz)
    arange = torch.arange(N, device=xyz.device).expand_as(d)
    group_idx = torch.where(d > radius * radius, N, arange)
    group_idx = torch.sort(group_idx, dim=-1).values[..., :nsample]
    first = group_idx[..., :1].expand_as(group_idx)
    return torch.where(group_idx == N, first, group_idx)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbour features: (B, N, C), (B, S, K) -> (B, S, K, C)."""
    return index_points(points, idx)


def three_nn(unknown: torch.Tensor, known: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3 nearest `known` points (B, M, 3) of each `unknown` query
    (B, N, 3): (dist (B, N, 3) euclidean, idx (B, N, 3) int64), nearest
    first, the lower index first among equal distances (lax.top_k's
    order)."""
    d = square_distance(unknown, known)
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return torch.sqrt(torch.clamp(vals[..., :3], min=0.0)), idx[..., :3]


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted sum of three neighbours' features: features (B, M, C), idx
    and weight (B, N, 3) -> (B, N, C)."""
    return torch.sum(index_points(features, idx) * weight[..., None], dim=2)


def interpolate_idw(unknown: torch.Tensor, known: torch.Tensor,
                    features: torch.Tensor, eps: float = 1e-8
                    ) -> torch.Tensor:
    """3-NN inverse-squared-distance interpolation of `features` (B, M, C)
    at the `unknown` points (B, N, 3) -> (B, N, C)."""
    dist, idx = three_nn(unknown, known)
    inv = 1.0 / (dist * dist + eps)
    weight = inv / torch.sum(inv, dim=-1, keepdim=True)
    return three_interpolate(features, idx, weight)


def sample_and_group_all(xyz: torch.Tensor, points: Optional[torch.Tensor]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One global group: new_xyz (B, 1, C) zeros, new_points (B, 1, N,
    C [+ D]) = [xyz || points]."""
    B, _, C = xyz.shape
    new_xyz = torch.zeros((B, 1, C), dtype=xyz.dtype, device=xyz.device)
    grouped_xyz = xyz[:, None]
    if points is None:
        return new_xyz, grouped_xyz
    return new_xyz, torch.cat([grouped_xyz, points[:, None]], dim=-1)


def subsample_pc(generator: Optional[torch.Generator], pc: torch.Tensor,
                 num_valid, subsample_number: int) -> torch.Tensor:
    """Resample-with-replacement on the device: `subsample_number` rows
    drawn uniformly from the first num_valid rows of the padded cloud pc
    (N_max, 3); a cloud of fewer than 3 valid points becomes zeros. The
    draw is torch's (generator on pc's device), not jax.random's stream."""
    n = max(int(num_valid), 1)
    idx = torch.randint(0, n, (subsample_number,), generator=generator,
                        device=pc.device)
    out = pc[idx]
    return out if int(num_valid) >= 3 else torch.zeros_like(out)


def chamfer_distance(x: torch.Tensor, y: torch.Tensor,
                     x_mask: Optional[torch.Tensor] = None,
                     y_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric squared chamfer distance, mean over the batch: x (B, N, 3),
    y (B, M, 3), optional boolean masks (B, N) / (B, M) of the points that
    count (pytorch3d's chamfer_distance, as the reference's shape loss)."""
    d = square_distance(x, y)
    big = torch.tensor(1e10, dtype=d.dtype, device=d.device)
    if y_mask is not None:
        d = torch.where(y_mask[:, None, :], d, big)
    d_t = d if x_mask is None else torch.where(x_mask[:, :, None], d, big)
    min_xy = d.amin(dim=-1)
    min_yx = d_t.amin(dim=-2)

    def mean(v, mask):
        if mask is None:
            return v.mean(dim=-1)
        m = mask.to(v.dtype)
        return (v * m).sum(-1) / torch.clamp(m.sum(-1), min=1)

    return torch.mean(mean(min_xy, x_mask) + mean(min_yx, y_mask))
