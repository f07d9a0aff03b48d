"""Eval-mode SA stage: gather + edge-MLP + max over neighbours.

Port of point_cloud_reid_tpu/ops/pallas/sa_stage.py. `fused_sa_convmax`
launches the CUDA kernel of csrc/sa_stage.cu (its two products on the tensor
cores in three TF32 passes) on CUDA tensors and runs its
plain PyTorch version, `sa_convmax_reference`, on CPU tensors; any other
device raises. `sa_stage_inference` folds BatchNorm into per-channel affines
exactly as the JAX wrapper does (conv1's bias enters Ct through
conv1_edge_factors; conv2/conv3's biases enter t2/t3) and calls it.

Widths. The kernels take C a multiple of 32 from 32 to MAX_C = 2048 (the
float32 kernel's layout for each, `plan_f32`: two row buffers up to 1,792
channels, the h1-from-gather layout past them). Any other C up to 2048 runs
at kernel_width(C), the next multiple of 32 (at least 32), in the padded
layout of `pad_args`: zeros in lanes C .. W - 1 of A, Ct, w2, w3 (rows and
columns) and the six affines, the output sliced back to C. Zeros are exact
there: a padded lane is relu(0 * s + 0) = 0 through all three convs, it
adds exact zeros to every real lane's sums, and the max of zeros is 0, so
no lane needs a mask (tests/test_torch_wide_widths.py holds the padded
plain version equal to the unpadded one bit for bit). Past 2048 channels
the wrapper raises naming ROADMAP_SA_WIDTHS.

Under a bf16 model (the JAX kernel with A and Ct in the model dtype) A, Ct
and the output are bf16 and the weights and affines float32; each product
multiplies bf16-rounded operands with float32 accumulation. On CUDA that is
csrc/sa_stage_bf16.cu, whose tier `plan_bf16(W, K, R)` names: "wgmma" (W =
32, 64, 128, 256, 512, 1024: a persistent grid, weights through a
shared-memory ring, every product on wgmma) or "mma_sync" (the first
version's row tiles, for the other multiples of 32 up to 2048: the wgmma
tier keeps h2 in registers over 64-row m-tiles and so stops at 1024, while
the row tiles' two bf16 buffers of 16 x (W + 8) take 131,584 bytes at W =
2048). The wrapper converts w2 and w3 to bf16 once per
weight tensor (utils/cache.py): into the wgmma tier's stage layout
(stage_weights), or (out, in) for the mma_sync tier. bf16 launches count in
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
MAX_C = 2048            # widest SA stage the kernels take
MAX_SMEM = 232448       # dynamic shared memory a block may take


def kernel_width(C: int) -> int:
    """The width the SA kernels run a stage of C channels at: C where it is
    a multiple of 32 from 32 to MAX_C, else the next one (the padded
    layout). Raises ValueError past MAX_C."""
    if not 1 <= C <= MAX_C:
        raise ValueError(f"fused_sa_convmax: C={C}; the kernels take 1 to "
                         f"{MAX_C} channels ({ROADMAP_SA_WIDTHS})")
    return max(32, -(-C // 32) * 32)


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


# ---- the float32 kernel's layout (csrc/sa_stage.cu, pcr_sa_convmax) ----

F32_WARPS = 8           # warps a block; 16 where there are 16 column chunks
TWO_BUFFERS, GATHER_H1 = "two_buffers", "gather_h1"


class SaF32Plan(NamedTuple):
    layout: str          # TWO_BUFFERS or GATHER_H1
    warps: int           # warps a block
    nt: int              # n-tiles (8 columns) a warp's column chunk
    tile_rows: int       # rows M a block
    smem: int            # shared bytes a block
    whole_centres: bool  # every centre's K rows lie in one block


@functools.lru_cache(maxsize=None)
def plan_f32(W: int, K: int) -> SaF32Plan:
    """The float32 kernel's launch for width W (a multiple of 32, 32 to
    MAX_C) and K neighbours, as csrc/sa_stage.cu's pcr_sa_convmax: NT the
    largest of 1, 2, 4 leaving 8 column chunks, 16 warps where there are
    16 chunks, M = groups x MT x 16 rows with MT the most m-tiles (8 / 4 /
    3 for NT 1 / 2 / 4) whose two row buffers of M x (W + 4) floats fit a
    block's shared memory. Where even one m-tile's two buffers do not fit
    (W > 1,792), the h1-from-gather layout: M = 16, conv2's A fragments
    formed from the gather, one buffer (h2) and a 16 x 32 strip a warp for
    conv3's columns before the max."""
    if W % 32 or not 32 <= W <= MAX_C or K < 1:
        raise ValueError(f"plan_f32: W={W}, K={K}; want W a multiple of 32 "
                         f"from 32 to {MAX_C} and K >= 1")
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
    if 2 * M * (W + 4) * 4 <= MAX_SMEM:
        return SaF32Plan(TWO_BUFFERS, warps, nt, M, 2 * M * (W + 4) * 4,
                         M % K == 0)
    return SaF32Plan(GATHER_H1, warps, nt, 16,
                     16 * (W + 4) * 4 + warps * 16 * 32 * 4, 16 % K == 0)


# ---- the bf16 kernel's launch plan (csrc/sa_stage_bf16.cu, make_plan) ----

WGMMA, MMA_SYNC = "wgmma", "mma_sync"
BF16_TIERS = (WGMMA, MMA_SYNC)
WGMMA_WIDTHS = (32, 64, 128, 256, 512, 1024)


class SaPlan(NamedTuple):
    tier: str            # WGMMA or MMA_SYNC
    tile_rows: int       # rows a weight tile serves at once (a block's tile)
    warpgroups: int      # consumer warpgroups a block (0: mma_sync)
    cluster: int         # blocks a cluster
    ring: int            # weight stages in shared memory (0: mma_sync)
    smem: int            # shared bytes a block
    whole_centres: bool  # every centre's K rows lie in one tile


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
    """The mma_sync tier's row tiles (mma_sync_tier::tiles): M rows a block, two bf16
    buffers of M x (C + 8)."""
    ntiles = C // 8
    nt = 1
    for d in (2, 4):
        if ntiles % d == 0 and ntiles // d >= 8:
            nt = d
    chunks = ntiles // nt
    warps = 16 if chunks >= 16 else 8
    groups = warps // chunks if chunks < warps else 1
    mt = {1: 8, 2: 4}.get(nt, 3)

    def smem(m):
        return 2 * groups * m * 16 * (C + 8) * 2
    while mt > 1 and smem(mt) > MAX_SMEM:
        mt -= 1
    M = groups * mt * 16
    return SaPlan(MMA_SYNC, M, 0, 1, 0, smem(mt), M % K == 0)


def plan_bf16(C: int, K: int, R: int = 0) -> SaPlan:
    """The bf16 kernel's launch plan for width C, K neighbours and R = B S K
    rows, as csrc/sa_stage_bf16.cu's make_plan: the wgmma tier at C in
    WGMMA_WIDTHS, the mma_sync tier at the other multiples of 32 up to
    MAX_C (past 1024 the wgmma tier's h2, C / 4 registers a thread over a
    64-row m-tile, does not fit; the row tiles' two buffers do, at one
    m-tile of 16 rows from 1,088 channels on). C is the kernel's width
    (kernel_width of the model's). Raises NotImplementedError on a width
    neither tier takes and ValueError on K < 1 or R >= 2^31."""
    if C % 32 or not 32 <= C <= MAX_C:
        raise NotImplementedError(
            f"fused_sa_convmax at bf16: C={C}; the bf16 kernel takes C "
            f"a multiple of 32 from 32 to {MAX_C} (other widths run padded "
            f"to kernel_width; past it {ROADMAP_SA_WIDTHS})")
    if K < 1 or R >= 2 ** 31:
        raise ValueError(f"fused_sa_convmax at bf16: K={K}, R={R}; want "
                         "K >= 1 and B * S * K below 2^31")
    return _wgmma_plan(C) if C in WGMMA_WIDTHS else _mma_sync_plan(C, K)


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
    vals = (ctypes.c_longlong * 7)()
    if lib.pcr_sa_bf16_layout(C, K, vals):
        return None
    tier, rows, wgs, cluster, ring, smem, whole = vals
    return SaPlan(BF16_TIERS[tier], rows, wgs, cluster, ring, smem,
                  bool(whole))


_CHECKED_PLANS = set()


def _check_kernel_plan(how: SaPlan, C: int, K: int, lib) -> None:
    """Raise where the build's own plan differs from plan_bf16's (once per
    library and shape)."""
    key = (id(lib), C, K)
    if key in _CHECKED_PLANS:
        return
    got = kernel_plan_bf16(C, K, lib)
    if got != how:
        raise ValueError(f"fused_sa_convmax at bf16, C={C}, K={K}: the "
                         f"kernel's plan {got} differs from plan_bf16's {how}")
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
    CUDA any C up to MAX_C (a width off the kernels' multiples of 32 in the
    padded layout, pad_args); past it ValueError.
    """
    if A.device.type == "cpu":
        return sa_convmax_reference(A, Ct, idx, w2, w3, s1, t1, s2, t2, s3, t3)
    if A.device.type != "cuda":
        raise RuntimeError(f"fused_sa_convmax: no kernel for {A.device}")
    C = A.shape[-1]
    W = kernel_width(C)
    out = launch(*pad_args(A, Ct, idx, w2, w3, s1, t1, s2, t2, s3, t3, W))
    bf16 = A.dtype == BF16
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


def launch(A, Ct, idx, w2, w3, s1, t1, s2, t2, s3, t3,
           library: Optional[_lib.Library] = None) -> torch.Tensor:
    """Check CUDA inputs at a width the kernels take (a multiple of 32, 32
    to MAX_C: pad_args lays out any other) and launch the kernel of their
    dtype: csrc/sa_stage.cu (float32; w2, w3 contiguous), or
    csrc/sa_stage_bf16.cu (A and Ct bf16; w2, w3 float32 in any strides,
    handed to the kernel converted once, bf16 in (out, in) layout; the tier
    plan_bf16 names, which must be the build's own plan).
    `library` is another build of the entry points, as tools/ab_sa.py times
    versions of the kernel (an earlier one without pcr_sa_bf16_layout is
    launched unchecked, with (out, in) weights)."""
    B, N, C = A.shape
    S, K = idx.shape[1], idx.shape[2]
    vecs = (s1, t1, s2, t2, s3, t3)
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
    if kernel_width(C) != C:
        raise ValueError(f"fused_sa_convmax: C={C}; the kernels take C a "
                         f"multiple of 32 from 32 to {MAX_C} (pad_args lays "
                         "out any other width)")
    how = plan_bf16(C, K, B * S * K) if bf16 else None
    if B * S * K >= 2 ** 31:
        raise ValueError("fused_sa_convmax: B * S * K must be below 2^31")
    lib = (library or _lib.LIBRARY).get()
    # a build with the plan entry takes the wgmma tier's weights in its
    # stage layout; the mma_sync tier (and an earlier build) in (out, in)
    staged = bf16 and how.tier == WGMMA and hasattr(lib, "pcr_sa_bf16_layout")
    if staged:
        w2, w3 = stage_weights(w2, w3)
    elif bf16:
        w2, w3 = (derived((w,), "sa_stage_bf16",
                          lambda w=w: w.t().to(BF16).contiguous())
                  for w in (w2, w3))
    if any(t.data_ptr() % 16 for t in (A, Ct, w2, w3) + vecs):
        raise ValueError("fused_sa_convmax: float inputs must be 16-byte "
                         "aligned (the kernel reads them in float4 / float2)")
    out = torch.empty((B, S, C), dtype=dt, device=A.device)
    entry = "pcr_sa_convmax_bf16" if bf16 else "pcr_sa_convmax"
    if bf16 and (library is None or hasattr(lib, "pcr_sa_bf16_layout")):
        _check_kernel_plan(how, C, K, lib)
    err = getattr(lib, entry)(
        *[t.data_ptr() for t in (A, Ct, idx, w2, w3) + vecs + (out,)],
        B, N, S, K, C, _lib.stream_ptr(A.device))
    _lib.check(err, entry)
    return out


fused_sa_convmax.launches = 0
fused_sa_convmax.bf16_launches = 0
fused_sa_convmax.bf16_tiers = dict.fromkeys(BF16_TIERS, 0)
# of those, the launches in the padded layout, by dtype
fused_sa_convmax.padded_launches = {"float32": 0, "bf16": 0}
# the float32 kernel's launches by layout (plan_f32)
fused_sa_convmax.f32_layouts = dict.fromkeys((TWO_BUFFERS, GATHER_H1), 0)


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
