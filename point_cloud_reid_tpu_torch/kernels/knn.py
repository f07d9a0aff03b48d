"""k nearest neighbours in stable-argsort order.

Port of point_cloud_reid_tpu/ops/pallas/knn.py. `knn` launches the CUDA
kernel of csrc/knn.cu on CUDA tensors and runs its plain PyTorch version,
`knn_reference`, on CPU tensors; any other device raises. Both order equal
distances lower index first, which the duplicated points of crops resampled
with replacement rely on. Indices carry no gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.geometry import knn_indices, square_distance  # noqa: F401
from . import _lib


def knn_reference(new_xyz: torch.Tensor, xyz: torch.Tensor, k: int
                  ) -> torch.Tensor:
    """Plain version: the first k of a stable argsort of the distances
    (square_distance is re-exported for those who check near-ties)."""
    return knn_indices(k, xyz, new_xyz, method="argsort")


@torch.no_grad()
def knn(new_xyz: torch.Tensor, xyz: torch.Tensor, k: int) -> torch.Tensor:
    """new_xyz (B, S, 3) queries, xyz (B, N, 3) database, both float32 ->
    (B, S, k) int64 indices into N, which the kernel writes itself. The
    kernel is built for the crops of the SA stages, N <= 128; a larger N on
    the card raises."""
    if k > xyz.shape[1]:
        raise ValueError(f"knn: k={k} > N={xyz.shape[1]}")
    if new_xyz.device.type == "cpu":
        return knn_reference(new_xyz, xyz, k)
    if new_xyz.device.type != "cuda":
        raise RuntimeError(f"knn: no kernel for {new_xyz.device}")
    out = launch(new_xyz, xyz, k)
    knn.launches += 1
    return out


knn.launches = 0


def launch(new_xyz: torch.Tensor, xyz: torch.Tensor, k: int,
           library: Optional[_lib.Library] = None) -> torch.Tensor:
    """Check CUDA inputs as knn takes them and launch the kernel. `library`
    is another build of csrc/knn.cu's entry point, as
    tools/ab_train_kernels.py times versions of the kernel."""
    B, S, C = new_xyz.shape
    N = xyz.shape[1]
    if C != 3 or tuple(xyz.shape) != (B, N, 3) or N > 128:
        raise ValueError(f"knn: want (B, S, 3) and (B, N <= 128, 3), got "
                         f"{tuple(new_xyz.shape)} and {tuple(xyz.shape)}")
    for t in (new_xyz, xyz):
        if t.dtype != torch.float32 or t.device != new_xyz.device:
            raise ValueError("knn: want float32 tensors on one device")
    q, db = new_xyz.contiguous(), xyz.contiguous()
    out = torch.empty((B, S, k), dtype=torch.int64, device=q.device)
    lib = (library or _lib.LIBRARY).get()
    err = lib.pcr_knn_i64(q.data_ptr(), db.data_ptr(), out.data_ptr(), B, S,
                          N, k, _lib.stream_ptr(q.device))
    _lib.check(err, "pcr_knn_i64")
    return out
