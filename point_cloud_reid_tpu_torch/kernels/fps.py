"""Farthest point sampling from given start indices.

Port of point_cloud_reid_tpu/ops/pallas/fps.py. `fps` launches the CUDA
kernel of csrc/fps.cu on CUDA tensors and runs its plain PyTorch version,
`fps_reference`, on CPU tensors; any other device raises. Both compute the
squared distance as dx*dx + dy*dy + dz*dz, left to right, and both take the
first of equally far points, so their indices are equal. Indices carry no
gradient.
"""
from __future__ import annotations

import torch

from . import _lib

MAX_POINTS = 1024      # the kernel keeps one point a thread


def _check(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> None:
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps: want (B, N, 3) points, got {tuple(xyz.shape)}")
    B, N, _ = xyz.shape
    if not 0 < npoint <= N:
        raise ValueError(f"fps: npoint={npoint} not in (0, N={N}]")
    if tuple(start.shape) != (B,) or start.dtype not in (torch.int32,
                                                         torch.int64):
        raise ValueError(f"fps: want ({B},) integer start indices, got "
                         f"{tuple(start.shape)} {start.dtype}")
    if start.device != xyz.device:
        raise ValueError("fps: points and start indices on one device")


def fps_reference(xyz: torch.Tensor, npoint: int, start: torch.Tensor
                  ) -> torch.Tensor:
    """Plain version: xyz (B, N, 3), start (B,) -> (B, npoint) int64. The
    start indices must lie in [0, N)."""
    _check(xyz, npoint, start)
    B, N, _ = xyz.shape
    rows = torch.arange(B, device=xyz.device)
    out = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    distance = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    farthest = start.long()
    for i in range(npoint):
        out[:, i] = farthest
        d = xyz - xyz[rows, farthest][:, None, :]
        dist = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        distance = torch.minimum(distance, dist)
        farthest = distance.argmax(dim=-1)       # first of equal maxima
    return out


@torch.no_grad()
def fps(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> torch.Tensor:
    """xyz (B, N, 3) float32, start (B,) indices in [0, N) -> (B, npoint)
    int64 sample indices, out[:, 0] == start (the kernel writes int32;
    torch indexes with int64). On the card N <= 1024; more raises."""
    if xyz.device.type == "cpu":
        return fps_reference(xyz, npoint, start)
    if xyz.device.type != "cuda":
        raise RuntimeError(f"fps: no kernel for {xyz.device}")
    _check(xyz, npoint, start)
    B, N, _ = xyz.shape
    if xyz.dtype != torch.float32:
        raise ValueError(f"fps: want float32 points, got {xyz.dtype}")
    if N > MAX_POINTS:
        raise ValueError(f"fps: the kernel takes N <= {MAX_POINTS} points a "
                         f"cloud, got {N}")
    pts = xyz.contiguous()
    first = start.to(torch.int32).contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    lib = _lib.LIBRARY.get()
    err = lib.pcr_fps(pts.data_ptr(), first.data_ptr(), out.data_ptr(), B, N,
                      npoint, _lib.stream_ptr(xyz.device))
    _lib.check(err, "pcr_fps")
    fps.launches += 1
    return out.long()


fps.launches = 0
