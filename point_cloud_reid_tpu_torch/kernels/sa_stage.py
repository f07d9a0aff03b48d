"""Eval-mode SA stage: gather + edge-MLP + max over neighbours.

Port of point_cloud_reid_tpu/ops/pallas/sa_stage.py. `fused_sa_convmax`
launches the CUDA kernel of csrc/sa_stage.cu (its two products on the tensor
cores in three TF32 passes) on CUDA tensors and runs its
plain PyTorch version, `sa_convmax_reference`, on CPU tensors; any other
device raises. `sa_stage_inference` folds BatchNorm into per-channel affines
exactly as the JAX wrapper does (conv1's bias enters Ct through
conv1_edge_factors; conv2/conv3's biases enter t2/t3) and calls it.

Widths. The kernels take C a multiple of 32 from 32 to MAX_C = 8192 (the
float32 kernel's layout for each, `plan_f32`: two row buffers below
F32_WIDE_FROM = 928 channels, where they shrink to one 16-row m-tile, the
wide layout from it, about 2x faster there on the H100). Any other C up to
8192 runs at kernel_width(C), the next multiple of 32 (at least 32), in the
padded layout of `pad_args`: zeros in lanes C .. W - 1 of A, Ct, w2, w3
(rows and columns) and the six affines, the output sliced back to C. Zeros
are exact there: a padded lane is relu(0 * s + 0) = 0 through all three
convs, it adds exact zeros to every real lane's sums, and the max of zeros
is 0, so no lane needs a mask (tests/test_torch_wide_widths.py holds the
padded plain version equal to the unpadded one bit for bit). The wide
layout runs a width at the next multiple of 64 (run_width: the wrapper pads
once, to it). Past 8192 channels (the backbone's mul 64) the wrapper
raises naming ROADMAP_SA_WIDTHS.

Under a bf16 model (the JAX kernel with A and Ct in the model dtype) A, Ct
and the output are bf16 and the weights and affines float32; each product
multiplies bf16-rounded operands with float32 accumulation. On CUDA that is
csrc/sa_stage_bf16.cu, whose tier `plan_bf16(W, K, R)` names: "wgmma" (W =
32, 64, 128, 256, 512, 1024: a persistent grid, weights through a
shared-memory ring, every product on wgmma), "mma_sync" (the first
version's row tiles, for the other multiples of 32 up to 1024) or "wide"
(past 1024, where the wgmma tier's h2, C / 4 registers a thread over a
64-row m-tile, does not fit). The wide layout at both dtypes is
csrc/sa_wide_wg.cuh: a persistent grid whose weight stages each serve two
warpgroups' 64-row m-tiles, h1 and h2 in a device scratch the wrapper
allocates (`wide_scratch_bytes` a block), weights in the stage copy of
`wide_stage_weights`. The wrapper converts w2 and w3 once per
weight tensor (utils/cache.py): into the wgmma tier's stage layout
(stage_weights), (out, in) bf16 for the mma_sync tier, or the wide
layout's stage copy. bf16 launches count in
`fused_sa_convmax.bf16_launches` and by tier in
`fused_sa_convmax.bf16_tiers`, the float32 kernel's in
`fused_sa_convmax.launches` and by layout in `fused_sa_convmax.f32_layouts`;
launches in the padded layout also in `fused_sa_convmax.padded_launches`
("float32", "bf16").
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.geometry import conv1_edge_factors
from ..utils.cache import derived
from . import _lib

BF16 = torch.bfloat16
# where the SA kernels' missing widths are queued
ROADMAP_SA_WIDTHS = "ROADMAP.md K7"
MAX_C = 8192            # widest SA stage the kernels take
MAX_SMEM = 232448       # dynamic shared memory a block may take


def kernel_width(C: int) -> int:
    """The kernels' width for a stage of C channels: C where it is a
    multiple of 32 from 32 to MAX_C, else the next one (the padded
    layout); the wide layout runs it at wide_width of it (run_width).
    Raises ValueError past MAX_C."""
    if not 1 <= C <= MAX_C:
        raise ValueError(f"fused_sa_convmax: C={C}; the kernels take 1 to "
                         f"{MAX_C} channels ({ROADMAP_SA_WIDTHS})")
    return max(32, -(-C // 32) * 32)


def run_width(C: int, bf16: bool) -> int:
    """The width a stage of C channels runs at: kernel_width(C), or where
    the plan of the dtype gives the wide layout the next multiple of 64
    (wide_width); fused_sa_convmax pads to it once."""
    W = kernel_width(C)
    return wide_width(W) if _takes_wide(W, bf16) else W


def _lanes(x: torch.Tensor, W: int) -> torch.Tensor:
    return F.pad(x, (0, W - x.shape[-1]))


def _weight(w: torch.Tensor, W: int, contiguous: bool) -> torch.Tensor:
    """w (C, C) (in, out) float32 as the kernels take it at width W: zero
    rows and columns past C, contiguous where the float32 kernel needs it
    or padded; made once per weight tensor. The bf16 kernel's own copy
    (launch) takes any strides."""
    if W == w.shape[0] and (w.is_contiguous() or not contiguous):
        return w
    return derived((w,), ("sa_stage_w", W),
                   lambda: F.pad(w, (0, W - w.shape[1], 0, W - w.shape[0]))
                   .contiguous())


def pad_args(A, Ct, idx, w2, w3, s1, t1, s2, t2, s3, t3, W: int) -> tuple:
    """fused_sa_convmax's arguments of width C in the padded layout of
    width W >= C: zeros in lanes C .. W - 1 of A, Ct and the affines, and
    in w2's and w3's rows and columns past C (the weights padded once per
    weight tensor, contiguous)."""
    C = A.shape[-1]
    vecs = (s1, t1, s2, t2, s3, t3)
    if W != C:
        A, Ct = _lanes(A, W), _lanes(Ct, W)
        vecs = tuple(_lanes(v, W) for v in vecs)
    contiguous = A.dtype != BF16
    return (A, Ct, idx, _weight(w2, W, contiguous),
            _weight(w3, W, contiguous)) + vecs


# ---- the wide layout (csrc/sa_wide_wg.cuh), both dtypes ----

WIDE = "wide"
WIDE_ROWS = 128         # rows a weight stage serves: two warpgroups' m-tiles
WIDE_WARPGROUPS = 2     # consumer warpgroups (and a producer warpgroup)
WIDE_RING = 14          # ring slots of 16 KB
WIDE_A_STAGE = 8192     # bytes of an A stage: 64 rows x one 128-byte k-panel
WIDE_SMEM = 1024 + WIDE_RING * 16384 + 8 * (2 * WIDE_RING + 1)


def wide_width(W: int) -> int:
    """The width the wide layout runs W at: the next multiple of 64."""
    return -(-W // 64) * 64


def _takes_wide(W: int, bf16: bool) -> bool:
    """Whether the plan gives kernel width W the wide layout: past 1024
    channels at bf16 (plan_bf16), from F32_WIDE_FROM at float32
    (plan_f32)."""
    return W > 1024 if bf16 else W >= F32_WIDE_FROM


def wide_scratch_bytes(W: int, bf16: bool) -> int:
    """Device scratch a block of the wide layout at width W (run at
    wide_width(W)): each consumer warpgroup's h1 and h2 (W / PK A stages
    each, PK = 64 bf16 / 32 float32 k a stage) and its 4 centres' running
    maxima (4 x W floats)."""
    Wd = wide_width(W)
    return WIDE_WARPGROUPS * (2 * (Wd // (64 if bf16 else 32)) * WIDE_A_STAGE
                              + 16 * Wd)


def wide_stage_weights(w2: torch.Tensor, w3: torch.Tensor,
                       bf16: bool) -> tuple:
    """w2, w3 ((in, out) float32, width W a multiple of 64) as the wide
    layout streams them, made once per weight tensor: for each 128-column
    output chunk j (64 at the end of a width 64 past a multiple of 128),
    each k-panel p (PK input columns), the chunk's 64-row blocks b: the B
    stage of output rows 64 (2 j + b) .. and input columns p PK .. in
    kernels/match_grid.b_stages' layout (K natural; bf16 8 KB, TF32 hi then
    lo, 16 KB). At bf16 a chunk's two blocks of a panel are one 128-row
    operand."""
    from .match_grid import b_stages      # match_grid imports this module
    W = w2.shape[0]
    pk = 64 if bf16 else 32
    blocks = tuple((64 * (2 * j + b), p * pk) for j in range(-(-W // 128))
                   for p in range(W // pk)
                   for b in range(min(2, W // 64 - 2 * j)))
    return tuple(derived((w,), ("sa_wide_stages", bf16),
                         lambda w=w: b_stages(w.t().float(), blocks, bf16,
                                              natural=True))
                 for w in (w2, w3))


def wide_blocks(centres: int, device) -> int:
    """Blocks of a wide launch: one an SM (its 230,632 shared bytes), at
    most one a pair of 4-centre groups."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    groups = -(-centres // 4)
    return max(1, min(-(-groups // 2), sms))


# ---- the float32 kernel's layout (csrc/sa_stage.cu, pcr_sa_f32_layout) ----

F32_WARPS = 8           # warps a block; 16 where there are 16 column chunks
TWO_BUFFERS = "two_buffers"
F32_LAYOUTS = (TWO_BUFFERS, WIDE)
F32_WIDE_FROM = 928     # the narrowest width on the wide layout


class SaF32Plan(NamedTuple):
    layout: str          # TWO_BUFFERS or WIDE
    warps: int           # warps a block
    nt: int              # n-tiles (8 columns) a warp's column chunk
    tile_rows: int       # rows a weight read serves
    smem: int            # shared bytes a block
    whole_centres: bool  # every centre's K rows lie in one block (or warp)
    ring: int = 0        # ring slots (wide)
    scratch: int = 0     # device scratch bytes a block (wide)


@functools.lru_cache(maxsize=None)
def plan_f32(W: int, K: int) -> SaF32Plan:
    """The float32 kernel's launch for width W (a multiple of 32, 32 to
    MAX_C) and K neighbours, as csrc/sa_stage.cu's pcr_sa_f32_layout: below
    F32_WIDE_FROM the row tiles, NT the largest of 1, 2, 4 leaving 8 column
    chunks, 16 warps where there are 16 chunks, M = groups x MT x 16 rows
    with MT the most m-tiles (8 / 4 / 3 for NT 1 / 2 / 4) whose two row
    buffers of M x (W + 4) floats fit a block's shared memory; from it the
    wide layout (12 warps: two consumer warpgroups and the producer's, a
    128-column chunk a warpgroup, 128 rows a weight stage), at
    wide_width(W)."""
    if W % 32 or not 32 <= W <= MAX_C or K < 1:
        raise ValueError(f"plan_f32: W={W}, K={K}; want W a multiple of 32 "
                         f"from 32 to {MAX_C} and K >= 1")
    if _takes_wide(W, False):
        return SaF32Plan(WIDE, 4 * (WIDE_WARPGROUPS + 1), 16, WIDE_ROWS,
                         WIDE_SMEM, True, WIDE_RING,
                         wide_scratch_bytes(W, False))
    ntiles = W // 8
    nt = 1
    for d in (2, 4):
        if ntiles % d == 0 and ntiles // d >= F32_WARPS:
            nt = d
    chunks = ntiles // nt
    warps = 2 * F32_WARPS if chunks >= 2 * F32_WARPS else F32_WARPS
    groups = warps // chunks if chunks < warps else 1
    mt = {1: 8, 2: 4}.get(nt, 3)
    while mt > 1 and 2 * groups * mt * 16 * (W + 4) * 4 > MAX_SMEM:
        mt -= 1
    M = groups * mt * 16
    return SaF32Plan(TWO_BUFFERS, warps, nt, M, 2 * M * (W + 4) * 4,
                     M % K == 0)


# ---- the bf16 kernel's launch plan (csrc/sa_stage_bf16.cu, make_plan) ----

WGMMA, MMA_SYNC = "wgmma", "mma_sync"
BF16_TIERS = (WGMMA, MMA_SYNC, WIDE)
WGMMA_WIDTHS = (32, 64, 128, 256, 512, 1024)


class SaPlan(NamedTuple):
    tier: str            # WGMMA, MMA_SYNC or WIDE
    tile_rows: int       # rows a weight tile serves at once (a block's tile)
    warpgroups: int      # consumer warpgroups a block (0: mma_sync)
    cluster: int         # blocks a cluster
    ring: int            # weight stages in shared memory (0: mma_sync)
    smem: int            # shared bytes a block
    whole_centres: bool  # every centre's K rows lie in one tile
    scratch: int = 0     # device scratch bytes a block (wide)


def _wgmma_tiles(C: int) -> Tuple[int, int, int, int]:
    """csrc/sa_stage_bf16.cu Cfg<C>: consumer warpgroups (3 at C <= 128, 2
    above), conv2's and conv3's output columns a stage (NC2, NC3) and
    conv3's 64-column k-panels a stage (conv2's: 1)."""
    return (3 if C <= 128 else 2, min(C, 128), 64 if C == 512 else min(C, 128),
            2 if C == 512 else 1)


@functools.lru_cache(maxsize=None)
def _wgmma_plan(C: int) -> SaPlan:
    """csrc/sa_stage_bf16.cu Cfg<C>: warpgroups of 64 rows each (at C =
    1024 two share one m-tile); stages of NC output rows x 64 or 128 input
    columns (4-16 KB); each m-tile's h1 (64 rows x 64-column panels) and
    running maxima (4 x C floats) beside as many stages as fit (all of w2
    and w3 where they fit: resident). tile_rows: the rows a stage serves."""
    nwg, nc2, nc3, kp3 = _wgmma_tiles(C)
    split = C == 1024           # the two warpgroups share one m-tile
    bufs = 1 if split else nwg
    panels = (C + 63) // 64
    sb = nc2 * 128
    stages = (C // nc2) * panels + (C // nc3) * (panels // kp3)
    per_buf = 64 * panels * 128 + 16 * C
    fit = (MAX_SMEM - 1024 - bufs * per_buf - 256) // sb
    ring = stages if fit >= stages else fit
    smem = 1024 + ring * sb + bufs * per_buf + 16 * ring
    return SaPlan(WGMMA, 64 * bufs, nwg, 1, ring, smem, True)


@functools.lru_cache(maxsize=None)
def _mma_sync_plan(C: int, K: int) -> SaPlan:
    """The mma_sync tier's row tiles (mma_sync_tier::tiles): M rows a block,
    two bf16 buffers of M x (C + 8), within a block's shared memory at every
    width the tier takes (C <= 992)."""
    ntiles = C // 8
    nt = 1
    for d in (2, 4):
        if ntiles % d == 0 and ntiles // d >= 8:
            nt = d
    chunks = ntiles // nt
    warps = 16 if chunks >= 16 else 8
    groups = warps // chunks if chunks < warps else 1
    M = groups * {1: 8, 2: 4}.get(nt, 3) * 16
    return SaPlan(MMA_SYNC, M, 0, 1, 0, 2 * M * (C + 8) * 2, M % K == 0)


def plan_bf16(C: int, K: int, R: int = 0) -> SaPlan:
    """The bf16 kernel's launch plan for width C, K neighbours and R = B S K
    rows, as csrc/sa_stage_bf16.cu's make_plan: the wgmma tier at C in
    WGMMA_WIDTHS, the mma_sync tier at the other multiples of 32 up to
    1024, the wide tier past 1024 (the wgmma tier's h2, C / 4 registers a
    thread over a 64-row m-tile, does not fit), at wide_width(C). C is the
    kernel's width (kernel_width of the model's). Raises
    NotImplementedError on a width no tier takes and ValueError on K < 1
    or R >= 2^31."""
    if C % 32 or not 32 <= C <= MAX_C:
        raise NotImplementedError(
            f"fused_sa_convmax at bf16: C={C}; the bf16 kernel takes C "
            f"a multiple of 32 from 32 to {MAX_C} (other widths run padded "
            f"to kernel_width; past it {ROADMAP_SA_WIDTHS})")
    if K < 1 or R >= 2 ** 31:
        raise ValueError(f"fused_sa_convmax at bf16: K={K}, R={R}; want "
                         "K >= 1 and B * S * K below 2^31")
    if C in WGMMA_WIDTHS:
        return _wgmma_plan(C)
    if _takes_wide(C, True):
        return SaPlan(WIDE, WIDE_ROWS, WIDE_WARPGROUPS, 1, WIDE_RING,
                      WIDE_SMEM, True, wide_scratch_bytes(C, True))
    return _mma_sync_plan(C, K)


def stage_layout(w: torch.Tensor, nr: int, kp: int) -> torch.Tensor:
    """The wgmma tier's weight stages of one product, in the order the
    kernel takes them and as each lies in shared memory: w (C, C) bf16 in
    (out, in) layout cut into NR output rows x KP 64-column k-panels (in
    input columns past C, zeros), chunk-major; within a stage panel, row,
    then the row's eight 16-byte units, unit u of row r at u ^ (r % 8) (the
    128-byte swizzle of csrc/bf16_mma.cuh). Returns a flat bf16 tensor of
    C / NR * ceil(C / 64 / KP) stages of NR * KP * 64 values."""
    C = w.shape[0]
    panels = -(-C // 64)
    stages = -(-panels // kp)
    wp = w.new_zeros((C, stages * kp * 64))
    wp[:, :C] = w
    t = wp.view(C // nr, nr, stages, kp, 8, 8)
    r = torch.arange(nr, device=w.device)
    unit = torch.arange(8, device=w.device)[None, :] ^ (r[:, None] & 7)
    t = torch.gather(t, 4, unit.view(1, nr, 1, 1, 8, 1).expand(t.shape))
    return t.permute(0, 2, 3, 1, 4, 5).reshape(-1).contiguous()


def stage_weights(w2: torch.Tensor, w3: torch.Tensor) -> tuple:
    """w2, w3 as fused_sa_convmax takes them ((in, out) float32) in the
    wgmma tier's stage layout, made once per weight tensor: conv2's stages
    of NC2 rows x 1 panel, conv3's of NC3 rows x KP3 panels."""
    C = w2.shape[0]
    _, nc2, nc3, kp3 = _wgmma_tiles(C)
    return tuple(derived((w,), ("sa_stages_bf16", nr, kp),
                         lambda w=w, nr=nr, kp=kp: stage_layout(
                             w.t().to(BF16), nr, kp))
                 for w, nr, kp in ((w2, nc2, 1), (w3, nc3, kp3)))


def kernel_plan_bf16(C: int, K: int, lib) -> Optional[SaPlan]:
    """The plan csrc/sa_stage_bf16.cu's pcr_sa_bf16_layout reports for
    (C, K) in library `lib`, or None where it refuses the shape."""
    vals = (ctypes.c_longlong * 8)()
    if lib.pcr_sa_bf16_layout(C, K, vals):
        return None
    tier, rows, wgs, cluster, ring, smem, whole, scratch = vals
    return SaPlan(BF16_TIERS[tier], rows, wgs, cluster, ring, smem,
                  bool(whole), scratch)


def kernel_plan_f32(C: int, K: int, lib) -> Optional[SaF32Plan]:
    """The plan csrc/sa_stage.cu's pcr_sa_f32_layout reports for (C, K) in
    library `lib`, or None where it refuses the shape."""
    vals = (ctypes.c_longlong * 8)()
    if lib.pcr_sa_f32_layout(C, K, vals):
        return None
    layout, warps, nt, rows, smem, whole, ring, scratch = vals
    return SaF32Plan(F32_LAYOUTS[layout], warps, nt, rows, smem, bool(whole),
                     ring, scratch)


_CHECKED_PLANS = set()


def _check_kernel_plan(how, C: int, K: int, lib, bf16: bool) -> None:
    """Raise where the build's own plan (its layout, shared and scratch
    bytes) differs from plan_bf16's or plan_f32's (once per library, dtype
    and shape)."""
    key = (id(lib), how, C, K, bf16)
    if key in _CHECKED_PLANS:
        return
    got = (kernel_plan_bf16 if bf16 else kernel_plan_f32)(C, K, lib)
    if got != how:
        raise ValueError(f"fused_sa_convmax at {'bf16' if bf16 else 'float32'}"
                         f", C={C}, K={K}: the kernel's plan {got} differs "
                         f"from the wrapper's {how}")
    _CHECKED_PLANS.add(key)


def rounded_mm(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a @ b as a product of `dtype` (bf16) operands with a float32 result,
    JAX's preferred_element_type=f32: each product of two bf16 values is
    exact in float32, so only the summation order differs from the
    kernel's (TF32 must be off on the card)."""
    return a.to(dtype).float() @ b.to(dtype).float()


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version's two C x C products: the products the kernel runs
    on the tensor cores, in one place."""
    return a @ b


def sa_convmax_reference(A: torch.Tensor, Ct: torch.Tensor, idx: torch.Tensor,
                         w2: torch.Tensor, w3: torch.Tensor,
                         s1, t1, s2, t2, s3, t3) -> torch.Tensor:
    """Plain version: (B, S, C) = max_k relu(relu(relu((A[idx] + Ct) s1 + t1)
    @ w2 s2 + t2) @ w3 s3 + t3), in A's dtype; at bf16 the chain runs in
    float32 with bf16 operands to each product, as the JAX kernel does."""
    B, S, K = idx.shape
    C = A.shape[-1]
    dt = A.dtype
    wide = torch.promote_types(dt, torch.float32)
    g = torch.gather(A, 1, idx.reshape(B, S * K, 1).long().expand(-1, -1, C))
    h = g.reshape(B, S, K, C).to(wide) + Ct.to(wide)[:, :, None, :]
    mm = _mm if dt != BF16 else functools.partial(rounded_mm, dtype=dt)
    h = torch.relu(h * s1 + t1)
    h = torch.relu(mm(h, w2) * s2 + t2)
    h = torch.relu(mm(h, w3) * s3 + t3)
    return h.amax(dim=2).to(dt)


def fused_sa_convmax(A: torch.Tensor, Ct: torch.Tensor, idx: torch.Tensor,
                     w2: torch.Tensor, w3: torch.Tensor,
                     s1, t1, s2, t2, s3, t3) -> torch.Tensor:
    """Batched gather + conv MLP + max over K.

    A (B, N, C) per-point conv1 factor; Ct (B, S, C) per-centre term;
    idx (B, S, K) neighbour indices into N; w2/w3 (C, C) in (in, out)
    layout (any strides); s*/t* (C,) folded BN affines. Returns (B, S, C)
    in A's dtype: float32, or bf16 (A and Ct bf16, the rest float32). On
    CUDA any C up to MAX_C (a width off the kernels' own in the padded
    layout, pad_args at run_width); past it ValueError.
    """
    if A.device.type == "cpu":
        return sa_convmax_reference(A, Ct, idx, w2, w3, s1, t1, s2, t2, s3, t3)
    if A.device.type != "cuda":
        raise RuntimeError(f"fused_sa_convmax: no kernel for {A.device}")
    C = A.shape[-1]
    bf16 = A.dtype == BF16
    W = run_width(C, bf16)
    out = launch(*pad_args(A, Ct, idx, w2, w3, s1, t1, s2, t2, s3, t3, W))
    if bf16:
        fused_sa_convmax.bf16_launches += 1
        fused_sa_convmax.bf16_tiers[plan_bf16(W, idx.shape[2]).tier] += 1
    else:
        fused_sa_convmax.launches += 1
        fused_sa_convmax.f32_layouts[plan_f32(W, idx.shape[2]).layout] += 1
    if W != C:
        fused_sa_convmax.padded_launches["bf16" if bf16 else "float32"] += 1
        out = out[..., :C].contiguous()
    return out


def _checked(A, Ct, idx, w2, w3, vecs) -> bool:
    """Check the kernels' CUDA inputs (shapes, dtypes, devices, R below
    2^31); whether they are bf16."""
    B, N, C = A.shape
    S, K = idx.shape[1], idx.shape[2]
    bf16 = A.dtype == BF16
    dt = BF16 if bf16 else torch.float32
    _expect(A, (B, N, C), dt, "A")
    _expect(Ct, (B, S, C), dt, "Ct")
    _expect(idx, (B, S, K), torch.int32, "idx")
    for w, name in ((w2, "w2"), (w3, "w3")):
        _expect(w, (C, C), torch.float32, name, contiguous=not bf16)
    for i, v in enumerate(vecs):
        _expect(v, (C,), torch.float32, f"affine {i}")
    for t in (Ct, idx, w2, w3) + vecs:
        if t.device != A.device:
            raise ValueError("fused_sa_convmax: inputs on different devices")
    if B * S * K >= 2 ** 31:
        raise ValueError("fused_sa_convmax: B * S * K must be below 2^31")
    return bf16


def launch(A, Ct, idx, w2, w3, s1, t1, s2, t2, s3, t3,
           library: Optional[_lib.Library] = None) -> torch.Tensor:
    """Check CUDA inputs at a width the kernels run (run_width: pad_args
    lays out any other) and launch the kernel of their dtype and plan,
    which must be the build's own plan (its layout, shared and scratch
    bytes): csrc/sa_stage.cu (float32; w2, w3 contiguous), or
    csrc/sa_stage_bf16.cu (A and Ct bf16; w2, w3 float32 in any strides,
    handed to the kernel converted once); on the wide layout launch_wide.
    `library` is another build of the entry points, as tools/ab_sa.py
    times versions of the kernel."""
    B, N, C = A.shape
    S, K = idx.shape[1], idx.shape[2]
    vecs = (s1, t1, s2, t2, s3, t3)
    bf16 = _checked(A, Ct, idx, w2, w3, vecs)
    if run_width(C, bf16) != C:
        raise ValueError(f"fused_sa_convmax: C={C}; the kernels run C a "
                         f"multiple of 32 from 32 to {MAX_C}, on the wide "
                         "layout of 64 (pad_args at run_width lays out any "
                         "other width)")
    how = plan_bf16(C, K, B * S * K) if bf16 else plan_f32(C, K)
    lib = (library or _lib.LIBRARY).get()
    _check_kernel_plan(how, C, K, lib, bf16)
    if (how.tier if bf16 else how.layout) == WIDE:
        return _launch_wide(lib, A, Ct, idx, w2, w3, vecs, bf16)
    if bf16 and C in WGMMA_WIDTHS:
        w2, w3 = stage_weights(w2, w3)
    elif bf16:
        w2, w3 = (derived((w,), "sa_stage_bf16",
                          lambda w=w: w.t().to(BF16).contiguous())
                  for w in (w2, w3))
    _aligned(A, Ct, w2, w3, *vecs)
    out = torch.empty((B, S, C), dtype=A.dtype, device=A.device)
    entry = "pcr_sa_convmax_bf16" if bf16 else "pcr_sa_convmax"
    err = getattr(lib, entry)(
        *[t.data_ptr() for t in (A, Ct, idx, w2, w3) + vecs + (out,)],
        B, N, S, K, C, _lib.stream_ptr(A.device))
    _lib.check(err, entry)
    return out


def launch_wide(A, Ct, idx, w2, w3, s1, t1, s2, t2, s3, t3,
                library: Optional[_lib.Library] = None) -> torch.Tensor:
    """The wide layout (csrc/sa_wide_wg.cuh) at C a multiple of 64, whatever
    layout the plan gives C, as tools/ab_sa.py --layout wide times it below
    the plan's widths: the inputs checked as launch checks them, the
    scratch by the kernel (it refuses one smaller than its wide plan's)."""
    C = A.shape[-1]
    bf16 = _checked(A, Ct, idx, w2, w3, (s1, t1, s2, t2, s3, t3))
    if C % 64 or not 64 <= C <= MAX_C:
        raise ValueError(f"launch_wide: C={C}; the wide layout takes C a "
                         f"multiple of 64 up to {MAX_C}")
    lib = (library or _lib.LIBRARY).get()
    return _launch_wide(lib, A, Ct, idx, w2, w3, (s1, t1, s2, t2, s3, t3),
                        bf16)


def _aligned(*tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("fused_sa_convmax: float inputs must be 16-byte "
                         "aligned (the kernel reads them in float4 / float2)")


def _launch_wide(lib, A, Ct, idx, w2, w3, vecs, bf16: bool) -> torch.Tensor:
    """The wide layout at C (a multiple of 64): the stage copies of w2 and
    w3, a scratch of wide_scratch_bytes a block for wide_blocks blocks."""
    B, N, C = A.shape
    S, K = idx.shape[1], idx.shape[2]
    w2, w3 = wide_stage_weights(w2, w3, bf16)
    _aligned(A, Ct, w2, w3, *vecs)
    blocks = wide_blocks(B * S, A.device)
    stride = wide_scratch_bytes(C, bf16)
    scratch = torch.empty((blocks, stride), dtype=torch.uint8, device=A.device)
    out = torch.empty((B, S, C), dtype=A.dtype, device=A.device)
    entry = "pcr_sa_convmax_wide_bf16" if bf16 else "pcr_sa_convmax_wide"
    err = getattr(lib, entry)(
        *[t.data_ptr() for t in (A, Ct, idx, w2, w3, *vecs, out, scratch)],
        B, N, S, K, C, blocks, stride, _lib.stream_ptr(A.device))
    _lib.check(err, entry)
    return out


fused_sa_convmax.launches = 0
fused_sa_convmax.bf16_launches = 0
fused_sa_convmax.bf16_tiers = dict.fromkeys(BF16_TIERS, 0)
# of those, the launches in the padded layout, by dtype
fused_sa_convmax.padded_launches = {"float32": 0, "bf16": 0}
# the float32 kernel's launches by layout (plan_f32)
fused_sa_convmax.f32_layouts = dict.fromkeys(F32_LAYOUTS, 0)


def _expect(t: torch.Tensor, shape, dtype, name: str,
            contiguous: bool = True) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: want {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def bn_affine(bn: Tuple[torch.Tensor, ...], eps: float,
              conv_bias: Optional[torch.Tensor] = None):
    """Eval BatchNorm (gamma, beta, mean, var) -> (scale, shift), with an
    optional preceding conv bias folded into the shift."""
    gamma, beta, mean, var = bn
    s = gamma / torch.sqrt(var + eps)
    t = beta - mean * s
    if conv_bias is not None:
        t = t + conv_bias * s
    return s.contiguous(), t.contiguous()


def sa_stage_args(xyz: torch.Tensor, points: Optional[torch.Tensor],
                  idx: torch.Tensor,
                  convs: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
                  bns: Sequence[Tuple[torch.Tensor, ...]],
                  eps: float = 1e-5, dtype: Optional[torch.dtype] = None
                  ) -> tuple:
    """The arguments of fused_sa_convmax for one eval-mode SA stage.

    xyz (B, N, 3); points (B, N, D) or None; idx (B, S, K) kNN indices with
    centres = the first S points (clamped when S > N); convs: three
    (weight (out, in), bias) pairs; bns: three (gamma, beta, mean, var).
    dtype: the model's compute dtype (bf16: A and Ct in it). w2, w3 are
    transposed views of the weights, which the wrappers copy into the
    kernels' layout once per weight tensor.
    """
    B, S, K = idx.shape
    N = xyz.shape[1]
    cidx = torch.arange(S, device=xyz.device).clamp(max=N - 1)
    (w1, b1), (w2, b2), (w3, b3) = convs
    A, Ct = conv1_edge_factors(
        w1.t(), b1, xyz, points, xyz[:, cidx],
        None if points is None else points[:, cidx], dtype)
    s1, t1 = bn_affine(bns[0], eps)
    s2, t2 = bn_affine(bns[1], eps, b2)
    s3, t3 = bn_affine(bns[2], eps, b3)
    return (A.contiguous(), Ct.contiguous(), idx.to(torch.int32).contiguous(),
            w2.t(), w3.t(), s1, t1, s2, t2, s3, t3)


def sa_stage_inference(xyz, points, idx, convs, bns, eps: float = 1e-5,
                       dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Full eval-mode SA conv chain (arguments as sa_stage_args): (B, S, C)
    features after the max over neighbours, the input of the stage's
    self-attention block."""
    return fused_sa_convmax(*sa_stage_args(xyz, points, idx, convs, bns, eps,
                                           dtype))


def sa_stage_reference(xyz, points, idx, convs, bns, eps: float = 1e-5,
                       dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """sa_stage_inference through the plain version on any device: what
    the card's eval is held against."""
    return sa_convmax_reference(*sa_stage_args(xyz, points, idx, convs, bns,
                                               eps, dtype))
