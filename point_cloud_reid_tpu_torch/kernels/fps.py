"""Farthest point sampling from given start indices.

Port of point_cloud_reid_tpu/ops/pallas/fps.py. `fps` launches the CUDA
kernel of csrc/fps.cu on CUDA tensors and runs its plain PyTorch version,
`fps_reference`, on CPU tensors; any other device raises. Both compute the
squared distance as dx*dx + dy*dy + dz*dz, left to right, and both take the
first of equally far points, so their indices are equal. Indices carry no
gradient.

`plan(N)` picks the kernel's launch for clouds of N points (any N >= 1):
one of the tiers below, points a lane or thread, threads and clouds a
block, and dynamic shared bytes. csrc/fps.cu describes the tiers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import _lib

# tiers, as csrc/fps.cu numbers them
WARP, BLOCK, L2, SCRATCH = range(4)
TIER_NAMES = ("warp", "block", "l2", "scratch")

MAX_THREADS = 1024      # a block's most threads
MAX_SMEM = 232448       # 227 KB: a block's most dynamic shared memory, sm_90
SLOT_BYTES = 512        # the block tiers' warp winners: 2 buffers x 32 x 8 B
# points a lane instantiated in tier W; 32 (N <= 1024) only for a forced
# plan, as tools/ab_fps.py --sweep times tier W against tier BLOCK
WARP_POINTS = (1, 2, 4, 8, 16, 32)
# tier W by default up to here: on the H100 it beat tier BLOCK at N = 256
# and 512, and at N = 1024 lost at 128 clouds and won at 512 (PERF.md)
WARP_MAX_N = 512
WARP_CLOUDS = 4         # clouds (one warp each) a block in tier W
# tier BLOCK holds 8 points a thread (x, y, z, distance: 32 registers), so
# that 1024 threads keep within 64 registers a thread: N <= 8192
BLOCK_P = 8


class Plan(NamedTuple):
    tier: int           # WARP, BLOCK, L2 or SCRATCH
    points: int         # points a lane (WARP) or a thread (the block tiers)
    threads: int        # threads a block
    clouds: int         # clouds a block
    smem: int           # dynamic shared bytes a block


def plan(N: int, tier: Optional[int] = None) -> Plan:
    """The launch for clouds of N points: by default tier W up to
    WARP_MAX_N, tier BLOCK up to BLOCK_P * 1024, then L2 (the distances in
    shared memory) while they fit in 227 KB, and SCRATCH (the distances in
    a global scratch) beyond. `tier` forces another tier, as
    tools/ab_fps.py times them against each other."""
    if N < 1:
        raise ValueError(f"fps: N={N} points")
    if tier is None:
        tier = (WARP if N <= WARP_MAX_N
                else BLOCK if N <= BLOCK_P * MAX_THREADS
                else L2 if SLOT_BYTES + 4 * N <= MAX_SMEM else SCRATCH)
    if tier == WARP:
        points = next((p for p in WARP_POINTS if 32 * p >= N), None)
        if points is None:
            raise ValueError(f"fps: no warp plan for N={N}")
        return Plan(WARP, points, 32 * WARP_CLOUDS, WARP_CLOUDS, 0)
    if tier == BLOCK:
        threads = 32 * -(-N // (32 * BLOCK_P))
        smem = SLOT_BYTES + 12 * N
        if threads > MAX_THREADS or smem > MAX_SMEM:
            raise ValueError(f"fps: no block plan for N={N}")
        return Plan(BLOCK, BLOCK_P, threads, 1, smem)
    smem = SLOT_BYTES + (4 * N if tier == L2 else 0)
    if smem > MAX_SMEM:
        raise ValueError(f"fps: no {TIER_NAMES[tier]} plan for N={N}")
    threads = min(MAX_THREADS, 32 * -(-N // 32))
    return Plan(tier, -(-N // threads), threads, 1, smem)


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
    """xyz (B, N, 3) float32, start (B,) int32 or int64 indices in [0, N) ->
    (B, npoint) int64 sample indices, out[:, 0] == start. Any N; on the
    card one launch, which reads the start indices as given and writes the
    int64 indices itself."""
    if xyz.device.type == "cpu":
        return fps_reference(xyz, npoint, start)
    if xyz.device.type != "cuda":
        raise RuntimeError(f"fps: no kernel for {xyz.device}")
    out = launch(xyz, npoint, start)
    fps.launches += 1
    return out


fps.launches = 0


def launch(xyz: torch.Tensor, npoint: int, start: torch.Tensor,
           how: Optional[Plan] = None,
           library: Optional[_lib.Library] = None) -> torch.Tensor:
    """Check inputs as fps takes them and launch the kernel with `how`
    (plan(N) by default). `library` is another build of csrc/fps.cu's entry
    point, as tools/ab_fps.py times versions of the kernel."""
    _check(xyz, npoint, start)
    if xyz.dtype != torch.float32:
        raise ValueError(f"fps: want float32 points, got {xyz.dtype}")
    B, N, _ = xyz.shape
    how = how or plan(N)
    pts, first = xyz.contiguous(), start.contiguous()
    out = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    scratch = (torch.empty((B, N), dtype=torch.float32, device=xyz.device)
               if how.tier == SCRATCH else None)
    lib = (library or _lib.LIBRARY).get()
    err = lib.pcr_fps_plan(
        pts.data_ptr(), first.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, N, npoint,
        int(first.dtype == torch.int64), *how, _lib.stream_ptr(xyz.device))
    _lib.check(err, "pcr_fps_plan")
    return out
