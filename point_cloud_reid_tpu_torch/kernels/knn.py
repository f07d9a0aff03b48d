"""k nearest neighbours in stable-argsort order.

Port of point_cloud_reid_tpu/ops/pallas/knn.py. `knn` launches the CUDA
kernel of csrc/knn.cu on CUDA tensors and runs its plain PyTorch version,
`knn_reference`, on CPU tensors; any other device raises. Both order equal
distances lower index first, which the duplicated points of crops resampled
with replacement rely on. Indices carry no gradient.

`plan(N, k)` picks the kernel's launch for clouds of N points (any N >= k):
one of the tiers below, points a lane, warps (query rows) a block and
dynamic shared bytes. csrc/knn.cu describes the tiers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.geometry import knn_indices, square_distance  # noqa: F401
from . import _lib


# tiers, as csrc/knn.cu numbers them
REG, SHARED, GLOBAL = range(3)
TIER_NAMES = ("registers", "shared", "global")

MAX_SMEM = 232448       # 227 KB: a block's most dynamic shared memory, sm_90
POINT_BYTES = 16        # a point staged as (x, y, z, |p|^2)
REG_WARPS = 8           # query rows a block in tier R
SCAN_WARPS = 16         # query rows a block in tiers S and G
REG_MAX_N = 128         # tier R holds 2 or 4 points a lane


class Plan(NamedTuple):
    tier: int           # REG, SHARED or GLOBAL
    points: int         # points a lane (tier R; 0 otherwise)
    warps: int          # query rows a block
    smem: int           # dynamic shared bytes a block


def plan(N: int, k: int, tier: Optional[int] = None) -> Plan:
    """The launch for k of N points: by default tier R up to 128 points,
    tier S while the crop's points fit in shared memory, tier G beyond.
    `tier` forces another tier that takes N, as the CUDA tests hold every
    tier against the plain version."""
    if not 1 <= k <= N:
        raise ValueError(f"knn: k={k} not in [1, N={N}]")
    if tier is None:
        tier = (REG if N <= REG_MAX_N
                else SHARED if POINT_BYTES * N <= MAX_SMEM else GLOBAL)
    if tier == REG:
        if N > REG_MAX_N:
            raise ValueError(f"knn: no register plan for N={N}")
        return Plan(REG, 2 if N <= 64 else 4, REG_WARPS, POINT_BYTES * N)
    if tier == SHARED:
        if POINT_BYTES * N > MAX_SMEM:
            raise ValueError(f"knn: no shared plan for N={N}")
        return Plan(SHARED, 0, SCAN_WARPS, POINT_BYTES * N)
    if tier == GLOBAL:
        return Plan(GLOBAL, 0, SCAN_WARPS, 0)
    raise ValueError(f"knn: no tier {tier}")


def knn_reference(new_xyz: torch.Tensor, xyz: torch.Tensor, k: int
                  ) -> torch.Tensor:
    """Plain version: the first k of a stable argsort of the distances
    (square_distance is re-exported for those who check near-ties)."""
    return knn_indices(k, xyz, new_xyz, method="argsort")


@torch.no_grad()
def knn(new_xyz: torch.Tensor, xyz: torch.Tensor, k: int) -> torch.Tensor:
    """new_xyz (B, S, 3) queries, xyz (B, N, 3) database ->
    (B, S, k) int64 indices into N, which the kernel writes itself. Any
    N >= k; on the card one launch of plan(N, k). bf16 or float16 points
    are cast to float32 first, as knn_pallas casts them (serving passes
    float32 xyz at every compute dtype)."""
    if k > xyz.shape[1]:
        raise ValueError(f"knn: k={k} > N={xyz.shape[1]}")
    if new_xyz.dtype in (torch.bfloat16, torch.float16):
        new_xyz, xyz = new_xyz.float(), xyz.float()
    if new_xyz.device.type == "cpu":
        return knn_reference(new_xyz, xyz, k)
    if new_xyz.device.type != "cuda":
        raise RuntimeError(f"knn: no kernel for {new_xyz.device}")
    how = plan(xyz.shape[1], k)
    out = launch(new_xyz, xyz, k, how)
    knn.launches += 1
    knn.tier_launches[TIER_NAMES[how.tier]] += 1
    return out


knn.launches = 0
# launches by tier, beside the total
knn.tier_launches = dict.fromkeys(TIER_NAMES, 0)


def launch(new_xyz: torch.Tensor, xyz: torch.Tensor, k: int,
           how: Optional[Plan] = None,
           library: Optional[_lib.Library] = None) -> torch.Tensor:
    """Check CUDA inputs as knn takes them and launch the kernel with `how`
    (plan(N, k) by default). `library` is another build of csrc/knn.cu's
    entry points, as tools/ab_train_kernels.py times versions of the
    kernel; one without `pcr_knn_plan` (before the tiers) is launched
    through `pcr_knn_i64`, N <= 128."""
    B, S, C = new_xyz.shape
    N = xyz.shape[1]
    if C != 3 or tuple(xyz.shape) != (B, N, 3):
        raise ValueError(f"knn: want (B, S, 3) and (B, N, 3), got "
                         f"{tuple(new_xyz.shape)} and {tuple(xyz.shape)}")
    how = how or plan(N, k)
    for t in (new_xyz, xyz):
        if t.dtype != torch.float32 or t.device != new_xyz.device:
            raise ValueError("knn: want float32 tensors on one device")
    q, db = new_xyz.contiguous(), xyz.contiguous()
    out = torch.empty((B, S, k), dtype=torch.int64, device=q.device)
    lib = (library or _lib.LIBRARY).get()
    if hasattr(lib, "pcr_knn_plan"):
        err = lib.pcr_knn_plan(q.data_ptr(), db.data_ptr(), out.data_ptr(),
                               B, S, N, k, *how, _lib.stream_ptr(q.device))
        _lib.check(err, "pcr_knn_plan")
    else:
        err = lib.pcr_knn_i64(q.data_ptr(), db.data_ptr(), out.data_ptr(), B,
                              S, N, k, _lib.stream_ptr(q.device))
        _lib.check(err, "pcr_knn_i64")
    return out
