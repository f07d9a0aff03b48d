"""k nearest neighbours in stable-argsort order.

Port of point_cloud_reid_tpu/ops/pallas/knn.py. `knn` launches the CUDA
kernel of csrc/knn.cu (C = 3) or csrc/knn_channels.cu (any other C) on CUDA
tensors and runs its plain PyTorch version, `knn_reference`, on CPU
tensors; any other device raises. Both order equal distances lower index
first, which the duplicated points of crops resampled with replacement rely
on. Indices carry no gradient.

`plan(N, k, C=3)` picks the kernel's launch for clouds of N points of C
channels (any N >= k): one of the tiers below, points a lane (tier R) or
channels a stage (tier C), warps (query rows) a block and dynamic shared
bytes. csrc/knn.cu describes tiers R, S and G, csrc/knn_channels.cu tier C.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.geometry import knn_indices, square_distance  # noqa: F401
from . import _lib


# tiers, as csrc/knn.cu numbers them, then csrc/knn_channels.cu's
REG, SHARED, GLOBAL, CHANNELS = range(4)
TIER_NAMES = ("registers", "shared", "global", "channels")

MAX_SMEM = 232448       # 227 KB: a block's most dynamic shared memory, sm_90
POINT_BYTES = 16        # a point staged as (x, y, z, |p|^2)
REG_WARPS = 8           # query rows a block in tier R
SCAN_WARPS = 16         # query rows a block in tiers S and G
REG_MAX_N = 128         # tier R holds 2 or 4 points a lane
# tier C (csrc/knn_channels.cu): 64 queries a block on 8 warps against
# tiles of 64 points, a key row of 72 words, a pending buffer of CH_PENDING
# candidates a query, k <= 64 (two list entries a lane); a width whose
# stage would not leave shared memory for two blocks an SM streams CH_STAGE
# channels a stage
CH_ROWS, CH_WARPS, CH_KEY_STRIDE, CH_MAX_K = 64, 8, 72, 64
CH_PENDING = 32
CH_TWO_BLOCKS = 113664  # a block's dynamic shared bytes, two an SM
CH_STAGE = 64


class Plan(NamedTuple):
    tier: int           # REG, SHARED, GLOBAL or CHANNELS
    points: int         # points a lane (tier R), channels a stage (tier C)
    warps: int          # query rows a block (tier C: 64 rows on 8 warps)
    smem: int           # dynamic shared bytes a block


def channel_stride(width: int, bf16: bool = False) -> int:
    """Elements of a staged row in tier C: the width padded to the
    tensor-core k-step (8 float32, 16 bf16), then to an odd number of
    16-byte groups (bf16: of 16-byte pairs), so no fragment read conflicts."""
    if bf16:
        return 8 * ((-(-width // 16) * 16 // 8) | 1)
    return 4 * ((-(-width // 8) * 8 // 4) | 1)


def channel_smem(C: int, width: int, bf16: bool = False) -> int:
    """Tier C's dynamic shared bytes: the key rows, two norm rows, the
    queries' pending buffers and their counts, and the staged rows (queries
    resident and two point buffers at one stage a tile; two buffers of
    points and queries when `width` < C)."""
    tiles = 4 if width < C else 3
    return (CH_ROWS * CH_KEY_STRIDE * 4 + 2 * CH_ROWS * 4
            + CH_ROWS * (CH_PENDING * 8 + 4)
            + tiles * CH_ROWS * channel_stride(width, bf16)
            * (2 if bf16 else 4))


def plan(N: int, k: int, tier: Optional[int] = None, C: int = 3,
         bf16: bool = False, width: Optional[int] = None) -> Plan:
    """The launch for k of N points of C channels: at C = 3 in float32, by
    default tier R up to 128 points, tier S while the crop's points fit in
    shared memory, tier G beyond; at any other C, or at bf16 (the
    distances rounded as knn_feature_space's bf16 ones), tier C, one stage
    a tile while that leaves two blocks an SM, else CH_STAGE channels a
    stage. `tier` (and for tier C `width`, C or a multiple of 16 below it)
    forces another launch that takes the shape, as the CUDA tests hold
    every tier against the plain version."""
    if not 1 <= k <= N:
        raise ValueError(f"knn: k={k} not in [1, N={N}]")
    if C < 1:
        raise ValueError(f"knn: C={C} channels")
    if tier is None:
        tier = (CHANNELS if C != 3 or bf16
                else REG if N <= REG_MAX_N
                else SHARED if POINT_BYTES * N <= MAX_SMEM else GLOBAL)
    if tier == CHANNELS:
        if k > CH_MAX_K:
            raise ValueError(f"knn: k={k} > {CH_MAX_K} (tier C's lists) at "
                             f"C={C}: past the port's bounds, ROADMAP.md K7")
        if width is None:
            width = (C if channel_smem(C, C, bf16) <= CH_TWO_BLOCKS
                     else CH_STAGE)
        if not (width == C or (0 < width < C and width % 16 == 0)):
            raise ValueError(f"knn: no stage of {width} of C={C} channels")
        smem = channel_smem(C, width, bf16)
        if smem > MAX_SMEM:
            raise ValueError(f"knn: a stage of {width} channels takes {smem} "
                             "shared bytes")
        return Plan(CHANNELS, width, CH_WARPS, smem)
    if C != 3 or bf16:
        raise ValueError(f"knn: tier {tier} takes float32 points of 3 "
                         f"channels, not C={C}{' bf16' * bf16}")
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
def knn(new_xyz: torch.Tensor, xyz: torch.Tensor, k: int,
        keep_dtype: bool = False) -> torch.Tensor:
    """new_xyz (B, S, C) queries, xyz (B, N, C) database ->
    (B, S, k) int64 indices into N, which the kernel writes itself. Any
    N >= k and any C; on the card one launch of plan(N, k, C=C). bf16 or
    float16 points are cast to float32 first, as knn_pallas casts them
    (serving passes float32 xyz at every compute dtype), unless
    `keep_dtype`: then the distances are computed in the inputs' dtype, as
    ops.geometry.knn_feature_space computes them (on the card bf16 in tier
    C; float16 has no kernel)."""
    if k > xyz.shape[1]:
        raise ValueError(f"knn: k={k} > N={xyz.shape[1]}")
    if not keep_dtype and new_xyz.dtype in (torch.bfloat16, torch.float16):
        new_xyz, xyz = new_xyz.float(), xyz.float()
    if new_xyz.device.type == "cpu":
        return knn_reference(new_xyz, xyz, k)
    if new_xyz.device.type != "cuda":
        raise RuntimeError(f"knn: no kernel for {new_xyz.device}")
    how = plan(xyz.shape[1], k, C=new_xyz.shape[-1],
               bf16=new_xyz.dtype == torch.bfloat16)
    out = launch(new_xyz, xyz, k, how)
    knn.launches += 1
    knn.tier_launches[TIER_NAMES[how.tier]] += 1
    by_dtype = (knn.bf16_launches if new_xyz.dtype == torch.bfloat16
                else knn.f32_launches)
    by_dtype[TIER_NAMES[how.tier]] += 1
    return out


knn.launches = 0
# launches by tier, beside the total, and by tier apart for float32 and
# bf16 inputs (bf16 only in tier C)
knn.tier_launches = dict.fromkeys(TIER_NAMES, 0)
knn.f32_launches = dict.fromkeys(TIER_NAMES, 0)
knn.bf16_launches = dict.fromkeys(TIER_NAMES, 0)


def launch(new_xyz: torch.Tensor, xyz: torch.Tensor, k: int,
           how: Optional[Plan] = None,
           library: Optional[_lib.Library] = None) -> torch.Tensor:
    """Check CUDA inputs as knn takes them and launch the kernel with `how`
    (plan(N, k) by default). `library` is another build of csrc/knn.cu's
    entry points, as tools/ab_train_kernels.py times versions of the
    kernel; one without `pcr_knn_plan` (before the tiers) is launched
    through `pcr_knn_i64`, N <= 128. Tier C takes float32 or bf16 inputs,
    the others float32 of 3 channels."""
    B, S, C = new_xyz.shape
    N = xyz.shape[1]
    if tuple(xyz.shape) != (B, N, C):
        raise ValueError(f"knn: want (B, S, C) and (B, N, C), got "
                         f"{tuple(new_xyz.shape)} and {tuple(xyz.shape)}")
    bf16 = new_xyz.dtype == torch.bfloat16
    how = how or plan(N, k, C=C, bf16=bf16)
    dtypes = ((torch.float32, torch.bfloat16) if how.tier == CHANNELS
              else (torch.float32,))
    for t in (new_xyz, xyz):
        if (t.dtype not in dtypes or t.dtype != new_xyz.dtype
                or t.device != new_xyz.device):
            raise ValueError(f"knn: tier {TIER_NAMES[how.tier]} wants "
                             f"{' or '.join(map(str, dtypes))} tensors of "
                             "one dtype on one device")
    q, db = new_xyz.contiguous(), xyz.contiguous()
    out = torch.empty((B, S, k), dtype=torch.int64, device=q.device)
    lib = (library or _lib.LIBRARY).get()
    if how.tier == CHANNELS:
        err = lib.pcr_knn_channels(q.data_ptr(), db.data_ptr(),
                                   out.data_ptr(), B, S, N, C, k, how.points,
                                   how.smem, int(bf16),
                                   _lib.stream_ptr(q.device))
        _lib.check(err, "pcr_knn_channels")
    elif hasattr(lib, "pcr_knn_plan"):
        err = lib.pcr_knn_plan(q.data_ptr(), db.data_ptr(), out.data_ptr(),
                               B, S, N, k, *how, _lib.stream_ptr(q.device))
        _lib.check(err, "pcr_knn_plan")
    else:
        err = lib.pcr_knn_i64(q.data_ptr(), db.data_ptr(), out.data_ptr(), B,
                              S, N, k, _lib.stream_ptr(q.device))
        _lib.check(err, "pcr_knn_i64")
    return out
