"""Farthest point sampling from given start indices.

Port of point_cloud_reid_tpu/ops/pallas/fps.py. `fps` launches the CUDA
kernel of csrc/fps.cu on CUDA tensors and runs its plain PyTorch version,
`fps_reference`, on CPU tensors; any other device raises. Points have any
number C >= 1 of channels, as fps_pallas takes them; both compute the
squared distance as the sum of the channels' squared differences, left to
right (dx*dx + dy*dy + dz*dz for xyz), and both take the first of equally
far points, so their indices are equal. Indices carry no gradient.

`plan(N, C)` picks the kernel's launch for clouds of N points of C
channels (any N, C >= 1): one of the tiers below, points a lane or thread,
threads and clouds a block, and dynamic shared bytes. csrc/fps.cu
describes the tiers; C = 3 has its own kernels (entry point pcr_fps_plan),
any other C those of pcr_fps_channels, whose tiers stage 4 N C bytes of
coordinates in shared memory where they fit.
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


def plan(N: int, tier: Optional[int] = None, C: int = 3) -> Plan:
    """The launch for clouds of N points of C channels: by default tier W
    up to WARP_MAX_N, tier BLOCK up to BLOCK_P * 1024, then L2 (the
    distances in shared memory) while they fit in 227 KB, and SCRATCH (the
    distances in a global scratch) beyond. `tier` forces another tier, as
    tools/ab_fps.py times them against each other. Another C than 3:
    plan_channels."""
    if N < 1:
        raise ValueError(f"fps: N={N} points")
    if C != 3:
        return plan_channels(N, C, tier)
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


def plan_channels(N: int, C: int, tier: Optional[int] = None) -> Plan:
    """The launch of pcr_fps_channels for clouds of N points of C channels:
    tier W up to WARP_MAX_N points while a cloud's 4 N C bytes of
    coordinates fit in shared memory (up to WARP_CLOUDS clouds a block, as
    many as fit), else BLOCK (a block a cloud, the coordinates and the
    distances in shared memory) while they fit, then L2 and SCRATCH as at
    C = 3 (the coordinates read from the input). `tier` forces one."""
    if N < 1 or C < 1:
        raise ValueError(f"fps: N={N} points of C={C} channels")
    cloud = 4 * N * C
    if tier is None:
        tier = (WARP if N <= WARP_MAX_N and cloud <= MAX_SMEM
                else BLOCK if SLOT_BYTES + 4 * N + cloud <= MAX_SMEM
                else L2 if SLOT_BYTES + 4 * N <= MAX_SMEM else SCRATCH)
    if tier == WARP:
        points = next((p for p in WARP_POINTS[:-1] if 32 * p >= N), None)
        clouds = min(WARP_CLOUDS, MAX_SMEM // cloud)
        if points is None or clouds < 1:
            raise ValueError(f"fps: no warp plan for N={N}, C={C}")
        return Plan(WARP, points, 32 * clouds, clouds, clouds * cloud)
    smem = SLOT_BYTES + {BLOCK: 4 * N + cloud, L2: 4 * N}.get(tier, 0)
    if smem > MAX_SMEM:
        raise ValueError(f"fps: no {TIER_NAMES[tier]} plan for N={N}, C={C}")
    threads = min(MAX_THREADS, 32 * -(-N // 32))
    return Plan(tier, -(-N // threads), threads, 1, smem)


def _check(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> None:
    if xyz.dim() != 3 or xyz.shape[-1] < 1:
        raise ValueError(f"fps: want (B, N, C) points, got {tuple(xyz.shape)}")
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
    """Plain version: xyz (B, N, C), start (B,) -> (B, npoint) int64. The
    start indices must lie in [0, N)."""
    _check(xyz, npoint, start)
    B, N, C = xyz.shape
    rows = torch.arange(B, device=xyz.device)
    out = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    distance = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    farthest = start.long()
    for i in range(npoint):
        out[:, i] = farthest
        d = xyz - xyz[rows, farthest][:, None, :]
        dist = d[..., 0] * d[..., 0]
        for c in range(1, C):
            dist = dist + d[..., c] * d[..., c]
        distance = torch.minimum(distance, dist)
        farthest = distance.argmax(dim=-1)       # first of equal maxima
    return out


@torch.no_grad()
def fps(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> torch.Tensor:
    """xyz (B, N, C) float32, start (B,) int32 or int64 indices in [0, N) ->
    (B, npoint) int64 sample indices, out[:, 0] == start. Any N; on the
    card one launch, which reads the start indices as given and writes the
    int64 indices itself."""
    if xyz.device.type == "cpu":
        return fps_reference(xyz, npoint, start)
    if xyz.device.type != "cuda":
        raise RuntimeError(f"fps: no kernel for {xyz.device}")
    out = launch(xyz, npoint, start)
    fps.launches += 1
    if xyz.shape[-1] != 3:
        fps.shape_launches["channels"] += 1
    return out


fps.launches = 0
# of those, the launches of the channel kernels (points of C != 3 channels)
fps.shape_launches = {"channels": 0}


def launch(xyz: torch.Tensor, npoint: int, start: torch.Tensor,
           how: Optional[Plan] = None,
           library: Optional[_lib.Library] = None) -> torch.Tensor:
    """Check inputs as fps takes them and launch the kernel with `how`
    (plan(N, C=C) by default): pcr_fps_plan at C = 3, else
    pcr_fps_channels. `library` is another build of csrc/fps.cu's entry
    point, as tools/ab_fps.py times versions of the kernel."""
    _check(xyz, npoint, start)
    if xyz.dtype != torch.float32:
        raise ValueError(f"fps: want float32 points, got {xyz.dtype}")
    B, N, C = xyz.shape
    how = how or plan(N, C=C)
    pts, first = xyz.contiguous(), start.contiguous()
    out = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    scratch = (torch.empty((B, N), dtype=torch.float32, device=xyz.device)
               if how.tier == SCRATCH else None)
    lib = (library or _lib.LIBRARY).get()
    ptrs = (pts.data_ptr(), first.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr())
    entry = "pcr_fps_plan" if C == 3 else "pcr_fps_channels"
    shape = (B, N, npoint) if C == 3 else (B, N, C, npoint)
    err = getattr(lib, entry)(*ptrs, *shape, int(first.dtype == torch.int64),
                              *how, _lib.stream_ptr(xyz.device))
    _lib.check(err, entry)
    return out
