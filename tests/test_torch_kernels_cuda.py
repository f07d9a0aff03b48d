"""The port's CUDA kernels against their plain versions on the card.

These need an NVIDIA GPU and nvcc (the kernels are built from csrc/ at first
use); without a card each test skips. The card's machine has no jax, which
tests/conftest.py imports, so run them there without it:
`python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

# float32 on both sides, only the summation order differs
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    err = (got - want).abs().max().item()
    assert err <= TOL * max(1.0, want.abs().max().item()), err


def _sa_args(cuda, B, N, S, K, C):
    g = torch.Generator(device=cuda).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    idx = torch.randint(0, N, (B, S, K), generator=g, device=cuda,
                        dtype=torch.int32)
    return (r(B, N, C), r(B, S, C), idx, r(C, C) / C ** 0.5,
            r(C, C) / C ** 0.5) + tuple(r(C) for _ in range(6))


# The kernel's row tile M is 128 rows at C = 32 (x 2 row groups), 64, 96,
# 128; 96 at C = 256, 48 at C = 512, 16 at C = 1024. Where K does not divide
# M, centres straddle blocks and their maxima meet by atomicMax.
@pytest.mark.parametrize("B,N,S,K,C", [
    (3, 40, 20, 12, 64),            # K = 12 does not divide M = 128
    (1, 30, 7, 16, 128),
    (2, 64, 32, 48, 512),
    (4, 128, 128, 32, 128),         # the flagship's SA1, SA2, SA3 at B = 4
    (4, 128, 64, 48, 256),
    (4, 64, 32, 48, 512),
    (2, 64, 32, 48, 1024),          # mul = 8's SA3: M = 16 < K, atomicMax
    (3, 50, 25, 20, 96),            # odd S, K = 20 does not divide M; 12
                                    # column chunks over 8 warps
    (2, 16, 9, 7, 32),              # two row groups of 4 warps
    (4, 2048, 128, 32, 128),        # SA1 of a 2048-point ablation's crops
    (4, 128, 128, 32, 256),         # the 7M model's (mul = 8) SA1, SA2, SA3
    (4, 128, 64, 48, 512),
    (4, 64, 32, 48, 1024),
    (3, 64, 25, 20, 1024),          # a ragged last group, slots past K
    (128, 64, 32, 48, 1024),        # the 7M SA3 at B = 128: many rounds
])
def test_sa_convmax_kernel_matches_plain(cuda, B, N, S, K, C):
    from point_cloud_reid_tpu_torch.kernels import sa_stage as sa
    args = _sa_args(cuda, B, N, S, K, C)
    before = sa.fused_sa_convmax.launches
    got = sa.fused_sa_convmax(*args)
    assert sa.fused_sa_convmax.launches == before + 1
    _close(got, sa.sa_convmax_reference(*args))


def test_sa_convmax_kernel_refuses_other_widths(cuda):
    """The kernels take any C up to 8192 (the wrapper pads a width off the
    multiples of 32); past 8192 (ROADMAP.md K7) the wrapper raises before
    any launch, and kernels/sa_stage.launch refuses an unpadded width."""
    from point_cloud_reid_tpu_torch.kernels import sa_stage as sa
    before = sa.fused_sa_convmax.launches
    for C in (8224, 8256):
        with pytest.raises(ValueError, match="K7"):
            sa.fused_sa_convmax(*_sa_args(cuda, 1, 8, 4, 4, C))
    with pytest.raises(ValueError, match="multiple of 32"):
        sa.launch(*_sa_args(cuda, 1, 8, 4, 4, 48))
    assert sa.fused_sa_convmax.launches == before


def test_match_kernels_match_plain(cuda):
    from point_cloud_reid_tpu_torch.configs import point_transformer_point_cat
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.models import build_model
    model = build_model(point_transformer_point_cat(
        conv_out=16, mul=1, nsample=(8, 8, 8), backbone_list=(16, 8, 4)),
        device=cuda)
    rs = np.random.RandomState(0)
    with torch.no_grad():
        xt, ht = model.embed(torch.from_numpy(
            rs.randn(5, 40, 3).astype(np.float32)).to(cuda))
        xd, hd = model.embed(torch.from_numpy(
            rs.randn(7, 40, 3).astype(np.float32)).to(cuda))
        t, d, w1, w2, nhead = mg.match_factors(model, ht, xt, hd, xd)
    ti = torch.arange(5, device=cuda).repeat_interleave(7)
    di = torch.arange(7, device=cuda).repeat(5)
    grid = mg.fused_match_grid(t, d, w1, w2, nhead)
    _close(grid, mg.match_pooled_reference(t, d, w1, w2, nhead, ti, di
                                           ).reshape(5, 7, -1))
    t_idx = torch.tensor([4, 0, 2, 2], dtype=torch.int32, device=cuda)
    d_idx = torch.tensor([6, 1, 0, 3], dtype=torch.int32, device=cuda)
    pairs = mg.fused_match_pairs(t, d, w1, w2, nhead, t_idx, d_idx)
    # one per-pair code in both index modes: the same bits
    assert torch.equal(pairs, grid[t_idx.long(), d_idx.long()])
    # out-of-range pairs raise before the launch, as the plain version does
    before = mg.fused_match_pairs.launches
    with pytest.raises(IndexError, match="out of range"):
        mg.fused_match_pairs(t, d, w1, w2, nhead, t_idx, d_idx + 4)
    assert mg.fused_match_pairs.launches == before


def test_match_kernels_at_the_flagship_width(cuda):
    """The point kernel at the flagship's width: N=128 points, C=64, 2
    heads, two seeded CrossAttentionBlock stages."""
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.tools.ab_match import inputs
    nt, nd = 3, 5
    t, d, w1, w2, nhead = inputs("point", nt, nd, 128, device=cuda)
    ti = torch.arange(nt, device=cuda).repeat_interleave(nd)
    di = torch.arange(nd, device=cuda).repeat(nt)
    before = mg.fused_match_grid.launches
    grid = mg.fused_match_grid(t, d, w1, w2, nhead)
    assert mg.fused_match_grid.launches == before + 1
    _close(grid, mg.match_pooled_reference(t, d, w1, w2, nhead, ti, di
                                           ).reshape(nt, nd, -1))
    t_idx = torch.tensor([2, 0, 1, 1, 2], dtype=torch.int32, device=cuda)
    d_idx = torch.tensor([4, 1, 0, 3, 4], dtype=torch.int32, device=cuda)
    pairs = mg.fused_match_pairs(t, d, w1, w2, nhead, t_idx, d_idx)
    assert torch.equal(pairs, grid[t_idx.long(), d_idx.long()])


def _rows_case(cuda, N, C, nhead, dtype):
    """The point head's rows tier (the wgmma tier at C = 64 / 128, where the
    plan gives the cluster tier driven through launch(tier=ROWS); the first
    rows kernel at C = 16) on a 3 x 4 grid and a pair list with repeated
    and out-of-order pairs: each against the plain version (TOL; bf16:
    BF16_TOL), pairs equal to their grid cells bit for bit, one launch of
    the tier counted a call."""
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.tools.ab_match import inputs
    bf16 = dtype == torch.bfloat16
    nt, nd = 3, 4
    t, d, w1, w2, _ = inputs("point", nt, nd, N, C, nhead, device=cuda,
                             dtype=dtype)
    how = mg.plan(N, C, nhead, dtype=dtype)
    tier = mg.ROWS if C in mg.ROWS_WIDTHS else mg.ROWS_MMA
    key = mg.tier_key(tier, bf16)
    ti = torch.arange(nt, device=cuda).repeat_interleave(nd)
    di = torch.arange(nd, device=cuda).repeat(nt)
    t_idx = torch.tensor([2, 0, 1, 1, 2], dtype=torch.int32, device=cuda)
    d_idx = torch.tensor([3, 1, 0, 3, 3], dtype=torch.int32, device=cuda)
    close = _close_bf16 if bf16 else _close
    if how.tier == tier:
        fn = mg.fused_match_grid
        before = (fn.launches, fn.bf16_launches, dict(fn.tier_launches))
        grid = fn(t, d, w1, w2, nhead)
        assert (fn.launches, fn.bf16_launches) == (before[0] + (not bf16),
                                                   before[1] + bf16)
        assert fn.tier_launches == dict(before[2], **{key: before[2][key]
                                                      + 1})
        before = mg.fused_match_pairs.tier_launches[key]
        pairs = mg.fused_match_pairs(t, d, w1, w2, nhead, t_idx, d_idx)
        assert mg.fused_match_pairs.tier_launches[key] == before + 1
        with pytest.raises(IndexError, match="out of range"):
            mg.fused_match_pairs(t, d, w1, w2, nhead, t_idx, d_idx + 4)
    else:
        assert how.tier == mg.CLUSTER and tier == mg.ROWS
        grid = mg.launch(None, 5, t, d, w1, w2, nhead, None, None,
                         tier=mg.ROWS).reshape(nt, nd, -1)
        pairs = mg.launch(None, 5, t, d, w1, w2, nhead, t_idx, d_idx,
                          tier=mg.ROWS)
    close(grid, mg.match_pooled_reference(t, d, w1, w2, nhead, ti, di
                                          ).reshape(nt, nd, -1))
    # one per-pair code in both modes, whatever block scores a pair
    assert torch.equal(pairs, grid[t_idx.long(), d_idx.long()])


# the rows tier's edges: C = 128 (the 1.5M and 7M models) from one row
# through a 16-row slab, a 64-row m-tile and a ragged second and third
# m-tile; C = 64 past the cluster tier's 224 rows (the ablations served at
# their crop size, 2048) and, driven past the plan, from one row; 1, 2 and 8
# heads (1 head at C = 128: 128-channel heads, the KV band of 128 columns);
# C = 16 past its cluster layout on the first rows kernel
@pytest.mark.parametrize("N,C,nhead", [
    (1, 128, 2), (15, 128, 2), (16, 128, 2), (17, 128, 2), (64, 128, 2),
    (127, 128, 2), (128, 128, 2), (129, 128, 2), (225, 128, 2),
    (128, 128, 8), (128, 128, 1), (17, 128, 1), (1, 128, 8),
    (225, 64, 2), (2048, 64, 2), (1, 64, 2), (15, 64, 8), (64, 64, 1),
    (129, 64, 2), (2600, 16, 2)])
def test_match_rows_tier_matches_plain(cuda, N, C, nhead):
    _rows_case(cuda, N, C, nhead, torch.float32)


@pytest.mark.parametrize("N,C,dtype", [(240, 64, torch.float32),
                                       (130, 128, torch.float32),
                                       (240, 64, torch.bfloat16),
                                       (130, 128, torch.bfloat16),
                                       (130, 256, torch.float32),
                                       (130, 256, torch.bfloat16),
                                       (70, 200, torch.bfloat16)])
def test_match_rows_tier_walks_more_pairs_than_blocks(cuda, N, C, dtype):
    """More pairs than the card's blocks at once: each block scores pairs
    in turn in its own slot of the scratch, and a pair list in reverse
    order meets its grid cells bit for bit."""
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.tools.ab_match import inputs
    nt = nd = 40
    t, d, w1, w2, nhead = inputs("point", nt, nd, N, C, device=cuda,
                                 dtype=dtype)
    how = mg.plan(N, C, nhead, dtype=dtype)
    assert how.tier == mg.ROWS and mg.rows_blocks(nt * nd, how.smem,
                                                  cuda) < nt * nd
    grid = mg.fused_match_grid(t, d, w1, w2, nhead)
    t_idx = torch.arange(nt, device=cuda, dtype=torch.int32).flip(0)
    d_idx = torch.arange(nd, device=cuda, dtype=torch.int32)
    pairs = mg.fused_match_pairs(t, d, w1, w2, nhead, t_idx, d_idx)
    assert torch.equal(pairs, grid[t_idx.long(), d_idx.long()])
    sel = torch.tensor([0, 617, 1599], device=cuda)
    ti, di = sel // nd, sel % nd
    (_close_bf16 if dtype == torch.bfloat16 else _close)(
        grid.reshape(nt * nd, -1)[sel],
        mg.match_pooled_reference(t, d, w1, w2, nhead, ti, di))


def _image_factors(cuda, nt, nd, S, C=16, nhead=2, seed=0):
    """Image-head factors and weights from seeded random token features and
    two seeded CrossLinAttn stages."""
    from point_cloud_reid_tpu_torch.tools.ab_match import inputs
    return inputs("image", nt, nd, S, C, nhead, seed, device=cuda)


# S below one 16-row slab, one row past two slabs, ragged slabs past the
# 8 warps' first round, and the released token counts (more than one
# 128-row summary chunk), at the smallest and the released C
@pytest.mark.parametrize("C", [16, 64])
@pytest.mark.parametrize("S", [6, 33, 70, 197, 198])
def test_image_match_kernels_match_plain(cuda, S, C):
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    nt, nd = 3, 5
    t, d, w1, w2, nhead = _image_factors(cuda, nt, nd, S, C)
    ti = torch.arange(nt, device=cuda).repeat_interleave(nd)
    di = torch.arange(nd, device=cuda).repeat(nt)
    before = mg.fused_image_match_grid.launches, mg.fused_match_grid.launches
    grid = mg.fused_image_match_grid(t, d, w1, w2, nhead)
    assert (mg.fused_image_match_grid.launches,
            mg.fused_match_grid.launches) == (before[0] + 1, before[1])
    _close(grid, mg.match_pooled_reference(t, d, w1, w2, nhead, ti, di
                                           ).reshape(nt, nd, -1))
    t_idx = torch.tensor([2, 0, 1, 1], dtype=torch.int32, device=cuda)
    d_idx = torch.tensor([4, 1, 0, 3], dtype=torch.int32, device=cuda)
    before = mg.fused_image_match_pairs.launches
    pairs = mg.fused_image_match_pairs(t, d, w1, w2, nhead, t_idx, d_idx)
    assert mg.fused_image_match_pairs.launches == before + 1
    assert torch.equal(pairs, grid[t_idx.long(), d_idx.long()])
    with pytest.raises(IndexError, match="out of range"):
        mg.fused_image_match_pairs(t, d, w1, w2, nhead, t_idx, d_idx + 4)
    assert mg.fused_image_match_pairs.launches == before + 1


def test_match_kernels_refuse_a_shape_that_does_not_fit(cuda):
    """260 tokens x 64 channels need 242,688 bytes of shared memory a block
    in the cluster tier (weights 8 C^2 + 272 padded rows of O at C + 4 + the
    peer's [KV | Z] 2 C^2 + pooling 1,216 floats), more than the 232,448 a
    block may take. Both heads score such shapes in the rows tier, whose
    layout does not grow with N (the image head through its padded entry
    point, without the position term); the cluster tier's C entry point
    refuses the shape when it is called past the wrapper's plan. The plan's
    bytes are the layout checks' own."""
    import ctypes

    from point_cloud_reid_tpu_torch.kernels import _lib
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    lib = _lib.LIBRARY.get()
    need, limit = ctypes.c_longlong(), ctypes.c_longlong()
    for (N, C), (status, want) in {(128, 64): (0, 203520),
                                   (198, 64): (0, 225280),
                                   (224, 64): (0, 229632),
                                   (225, 64): (2, 233984),
                                   (260, 64): (2, 242688)}.items():
        assert lib.pcr_match_pooled_layout(
            N, C, 2, ctypes.byref(need), ctypes.byref(limit)) == status
        assert (need.value, limit.value) == (want, 232448)
        assert mg.cluster_bytes(N, C) == want
    _rows_layouts_equal_the_plan(lib, torch.float32)
    assert mg.plan(225, 64, 2) == mg.Plan(mg.ROWS, mg.rows_bytes(64))
    t, d, w1, w2, nhead = _image_factors(cuda, 2, 2, 260, 64)
    before = dict(mg.fused_image_match_grid.padded_launches)
    grid = mg.fused_image_match_grid(t, d, w1, w2, nhead)
    assert mg.fused_image_match_grid.padded_launches["rows"] == \
        before["rows"] + 1
    ti, di = torch.tensor([0, 0, 1, 1]), torch.tensor([0, 1, 0, 1])
    _close(grid, mg.match_pooled_reference(t, d, w1, w2, nhead, ti.to(cuda),
                                           di.to(cuda)).reshape(2, 2, -1))
    weights = [{"w1": w1, "w2": w2}[g][k] for g, k in mg._WEIGHT_ORDER]
    out = torch.empty((2, 2, 128), device=cuda)
    err = _lib.LIBRARY.get().pcr_match_pooled_image(
        *[x.data_ptr() for x in t], *[x.data_ptr() for x in d],
        *[x.data_ptr() for x in weights], None, None, out.data_ptr(),
        2, 2, 4, 260, 64, nhead, _lib.stream_ptr(cuda))
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _lib.check(err, "pcr_match_pooled_image")


def test_match_kernels_refuse_channels_the_tiles_cannot_take(cuda):
    """C=12 is not a multiple of the tensor-core tiles' 8 columns: it runs
    in the padded layout of the cluster tier's C = 16 and meets the plain
    version; past 1024 channels (ROADMAP.md K7) the wrapper raises before
    any launch."""
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    t, d, w1, w2, nhead = _image_factors(cuda, 2, 2, 10, 12)
    before = mg.fused_image_match_grid.padded_launches["cluster"]
    grid = mg.fused_image_match_grid(t, d, w1, w2, nhead)
    assert mg.fused_image_match_grid.padded_launches["cluster"] == before + 1
    ti = torch.tensor([0, 0, 1, 1], device=cuda)
    di = torch.tensor([0, 1, 0, 1], device=cuda)
    _close(grid, mg.match_pooled_reference(t, d, w1, w2, nhead, ti, di
                                           ).reshape(2, 2, -1))
    t, d, w1, w2, nhead = _image_factors(cuda, 2, 2, 10, 1032)
    before = mg.fused_image_match_grid.launches
    with pytest.raises(ValueError, match="K7"):
        mg.fused_image_match_grid(t, d, w1, w2, nhead)
    assert mg.fused_image_match_grid.launches == before


# every head width up to 128 channels and 8 heads (ROADMAP.md K6) at the
# shapes chip_smoke.py's phase 16 holds, and the tiers' edges: C = 32 / 48
# on the cluster tier's C = 64, C = 96 / 120 / 100 on the rows tier's C =
# 128 (heads of 48, 32, 15 and 20 channels, 3 and 5 heads in 4- and 8-slot
# widths), N past an m-tile and at the ablation's 2048 rows, the image head
# on the rows tier (C = 96, and C = 64 past the cluster tier's rows), a
# ragged C = 12, and C = 16 on the padded rows tier (driven past the plan,
# which keeps the first rows kernel there)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head,C,H,N", [
    ("point", 32, 2, 128), ("point", 48, 4, 128), ("point", 96, 2, 128),
    ("point", 96, 3, 128), ("point", 96, 2, 2048), ("point", 120, 8, 128),
    ("point", 100, 5, 65), ("point", 12, 3, 40), ("point", 40, 5, 300),
    ("image", 96, 2, 197), ("image", 64, 2, 256), ("image", 32, 2, 198),
    ("image", 120, 8, 33)])
def test_match_widths_match_plain(cuda, head, C, H, N, dtype):
    """The padded layout on the card: grid and pair list against the plain
    version at the true width (TOL; bf16: BF16_TOL), pairs equal to their
    grid cells bit for bit, one padded launch of the plan's tier a call."""
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.tools.ab_match import inputs
    bf16 = dtype == torch.bfloat16
    nt, nd = 3, 4
    if N >= 2048:
        nt, nd = 2, 2
    t, d, w1, w2, H = inputs(head, nt, nd, N, C, H, device=cuda, dtype=dtype)
    point = head == "point"
    grid_fn = mg.fused_match_grid if point else mg.fused_image_match_grid
    pair_fn = mg.fused_match_pairs if point else mg.fused_image_match_pairs
    how = mg.plan(N, C, H, pos=point, dtype=dtype)
    key = mg.tier_key(how.tier, bf16)
    before = grid_fn.padded_launches[key]
    grid = grid_fn(t, d, w1, w2, H)
    assert grid.shape == (nt, nd, 2 * C)
    assert grid_fn.padded_launches[key] == before + 1
    t_idx = torch.tensor([2, 0, 1, 1, 0], dtype=torch.int32,
                         device=cuda) % nt
    d_idx = torch.tensor([3, 1, 0, 3, 3], dtype=torch.int32,
                         device=cuda) % nd
    pairs = pair_fn(t, d, w1, w2, H, t_idx, d_idx)
    ti = torch.arange(nt, device=cuda).repeat_interleave(nd)
    di = torch.arange(nd, device=cuda).repeat(nt)
    (_close_bf16 if bf16 else _close)(
        grid, mg.match_pooled_reference(t, d, w1, w2, H, ti, di
                                        ).reshape(nt, nd, -1))
    assert torch.equal(pairs, grid[t_idx.long(), d_idx.long()])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_match_c16_on_the_padded_rows_tier(cuda, dtype):
    """C = 16 past both cluster layouts (2,900 rows) driven onto the padded
    wgmma rows tier (C = 64) beside the first rows kernel the plan picks
    there: both meet the plain version."""
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.tools.ab_match import inputs
    bf16 = dtype == torch.bfloat16
    t, d, w1, w2, H = inputs("point", 2, 2, 2900, 16, 2, device=cuda,
                             dtype=dtype)
    assert mg.plan(2900, 16, H, dtype=dtype).tier == mg.ROWS_MMA
    ti = torch.tensor([0, 0, 1, 1], device=cuda)
    di = torch.tensor([0, 1, 0, 1], device=cuda)
    want = mg.match_pooled_reference(t, d, w1, w2, H, ti, di).reshape(2, 2, -1)
    for tier in (mg.ROWS, None):
        got = mg.launch(None, 5, t, d, w1, w2, H, None, None, tier=tier)
        (_close_bf16 if bf16 else _close)(got.reshape(2, 2, -1), want)


def _knn_inputs(kind, B, S, N, seed=0):
    rs = np.random.RandomState(seed)
    if kind == "exact":
        # multiples of 1/64 in [-2, 2): every product and sum is exact in
        # float32, so both sides compute identical distances, full of ties
        xyz = rs.randint(-128, 128, (B, N, 3)).astype(np.float32) / 64.0
    elif kind == "duplicates":
        base = rs.randn(B, max(N // 4, 1), 3).astype(np.float32)
        xyz = base[:, rs.randint(0, base.shape[1], N)]
    else:
        xyz = (rs.randn(B, N, 3) * 0.6).astype(np.float32)
    return torch.from_numpy(xyz)


# the SA stages' shapes, N not a multiple of 32 (33, 100, 127), k == N at
# both instantiations (64, 128) and N = 1
@pytest.mark.parametrize("kind", ["exact", "duplicates", "random"])
@pytest.mark.parametrize("B,S,N,k", [(16, 128, 128, 32), (16, 64, 128, 48),
                                     (16, 32, 64, 48), (3, 5, 33, 33),
                                     (2, 7, 100, 40), (2, 9, 127, 50),
                                     (2, 64, 64, 64), (2, 128, 128, 128),
                                     (3, 1, 1, 1)])
def test_knn_kernel_matches_plain(cuda, kind, B, S, N, k):
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    xyz = _knn_inputs(kind, B, S, N).to(cuda)
    q = xyz[:, :S].contiguous()
    before = kk.knn.launches
    got = kk.knn(q, xyz, k)
    # one launch: the kernel writes the int64 indices itself
    assert kk.knn.launches == before + 1
    want = kk.knn_reference(q, xyz, k)
    assert got.dtype == torch.int64 and got.shape == (B, S, k)
    assert got.is_contiguous()
    if kind == "exact":
        assert torch.equal(got, want)
        return
    # same neighbours in the same order, except where two distances differ
    # in the last bits (the matmul's rounding is not the kernel's)
    d = kk.square_distance(q, xyz)
    dg, dw = d.gather(-1, got), d.gather(-1, want)
    bad = got != want
    assert ((dg - dw).abs()[bad] <= 1e-6 * dw.abs()[bad].clamp(min=1.0)).all()
    if kind == "duplicates" and k > 1:
        # the same point twice is an exact tie on both sides: lower index
        # first (one neighbour, N = 1, has no pair to order)
        pts = xyz[torch.arange(B, device=cuda)[:, None, None], got]
        same = (pts[:, :, 1:] == pts[:, :, :-1]).all(-1)
        assert same.any()
        assert (got[..., 1:][same] > got[..., :-1][same]).all()


@pytest.mark.parametrize("N,k", [(7, 7), (64, 48), (128, 128)])
def test_knn_kernel_all_points_identical(cuda, N, k):
    """An all-way tie: every query's neighbours are 0 .. k-1 in order."""
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    xyz = torch.full((3, N, 3), 0.37, device=cuda)
    q = torch.randn((3, 5, 3), generator=torch.Generator(device=cuda
                                                         ).manual_seed(0),
                    device=cuda)
    want = torch.arange(k, device=cuda).expand(3, 5, k)
    assert torch.equal(kk.knn(q, xyz, k), want)
    assert torch.equal(kk.knn(xyz[:, :4], xyz, k), want[:, :4])


def _knn_tier_edges():
    """(N, k) on both sides of each tier edge that kernels/knn.plan sets."""
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    top = kk.MAX_SMEM // kk.POINT_BYTES
    return [(kk.REG_MAX_N, 32), (kk.REG_MAX_N + 1, 32), (top, 32),
            (top + 1, 32)]


# past the register tier: the ablations' crop sizes, k = 32 and 48 (the SA
# stages'), k = N, a cloud past the shared tier, and the tier edges
@pytest.mark.parametrize("kind", ["exact", "duplicates", "random"])
@pytest.mark.parametrize("B,N,k", [(4, 129, 32), (4, 160, 48), (4, 256, 32),
                                   (4, 256, 256), (8, 2048, 32),
                                   (8, 2048, 48), (2, 2048, 2048),
                                   (2, 20000, 32), (3, 1000, 1)]
                         + [(2, n, k) for n, k in _knn_tier_edges()])
def test_knn_kernel_matches_plain_at_any_cloud_size(cuda, kind, B, N, k):
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    from point_cloud_reid_tpu_torch.tools.scenes import knn_cloud
    xyz = torch.from_numpy(knn_cloud(kind, B, N, N + k)).to(cuda)
    q = xyz[:, :min(N, 128)].contiguous()
    before = kk.knn.launches, dict(kk.knn.tier_launches)
    got = kk.knn(q, xyz, k)
    tier = kk.TIER_NAMES[kk.plan(N, k).tier]
    assert kk.knn.launches == before[0] + 1
    assert kk.knn.tier_launches[tier] == before[1][tier] + 1
    want = kk.knn_reference(q, xyz, k)
    assert got.dtype == torch.int64 and got.shape == want.shape
    if kind != "random":
        assert torch.equal(got, want)
        return
    d = kk.square_distance(q, xyz)
    dg, dw = d.gather(-1, got), d.gather(-1, want)
    bad = got != want
    assert ((dg - dw).abs()[bad] <= 1e-6 * dw.abs()[bad].clamp(min=1.0)).all()


@pytest.mark.parametrize("kind", ["exact", "duplicates"])
@pytest.mark.parametrize("tier", [0, 1, 2])
def test_knn_every_tier_equal_plain(cuda, kind, tier):
    """Each tier forced at a cloud that every tier takes gives the plain
    version's indices."""
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    from point_cloud_reid_tpu_torch.tools.scenes import knn_cloud
    xyz = torch.from_numpy(knn_cloud(kind, 3, 100, tier)).to(cuda)
    q = xyz[:, :37].contiguous()
    got = kk.launch(q, xyz, 40, kk.plan(100, 40, tier))
    assert torch.equal(got, kk.knn_reference(q, xyz, 40))


@pytest.fixture
def bf16_full_sums(cuda):
    """cuBLAS's bf16 products summed in float32 alone, as tier C and JAX
    sum them (restored after the test). PyTorch's default lets cuBLAS
    reduce bf16 products at reduced precision, which tier C does not
    reproduce: the indices equal those of the float32-summed bf16 path."""
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    yield cuda
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag


def _channel_cloud(cuda, kind, B, N, C, seed, dtype=torch.float32):
    from point_cloud_reid_tpu_torch.tools.scenes import knn_cloud
    return torch.from_numpy(knn_cloud(kind, B, N, seed, C)).to(cuda, dtype)


def _knn_near_ties(kk, q, xyz, got, want, tol):
    """Every index that differs from the plain version's is a near-tie: the
    plain distances of the two picks within tol of max(1, |d|)."""
    d = kk.square_distance(q, xyz).float()
    dg, dw = d.gather(-1, got), d.gather(-1, want)
    bad = got != want
    assert ((dg - dw).abs()[bad] <= tol * dw.abs()[bad].clamp(min=1.0)).all()


# tier C (csrc/knn_channels.cu): DGCNN's feature-space shapes (C = 64, 128,
# every point a query), channel counts off the 4-element groups (1, 5, 6),
# one stage a tile and 64-channel stages (256), k past 32 and k = N, S and
# N off the 64-row tiles, a cloud past shared memory (20,000 x 16 floats),
# k = 1, 32 (one list entry a lane, full) and 33 (two), at one stage a
# tile (C = 64) and in 64-channel stages (C = 128 float32); xyz (C = 3) at
# bf16 in test_knn_feature_space_bf16_route
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["exact", "duplicates", "random"])
@pytest.mark.parametrize("B,S,N,C,k", [
    (4, 256, 256, 64, 20), (2, 2048, 2048, 64, 20), (2, 2048, 2048, 128, 20),
    (2, 100, 300, 5, 7), (3, 64, 97, 6, 40), (1, 5, 64, 1, 64),
    (2, 33, 1000, 256, 48), (2, 9, 20000, 16, 32), (2, 300, 700, 64, 1),
    (2, 257, 700, 64, 32), (2, 130, 333, 128, 33), (2, 200, 500, 128, 1)])
def test_knn_channels_match_plain(bf16_full_sums, dtype, kind, B, S, N, C,
                                  k):
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    cuda, dt = bf16_full_sums, getattr(torch, dtype)
    xyz = _channel_cloud(cuda, kind, B, N, C, N + C + k, dt)
    q = xyz[:, :S].contiguous()
    # counted in all, by tier, and by tier for its dtype alone
    by_dtype = (kk.knn.bf16_launches if dtype == "bfloat16"
                else kk.knn.f32_launches)
    other = (kk.knn.f32_launches if dtype == "bfloat16"
             else kk.knn.bf16_launches)

    def counts():
        return (kk.knn.launches, kk.knn.tier_launches["channels"],
                by_dtype["channels"], other["channels"])
    before = counts()
    got = kk.knn(q, xyz, k, keep_dtype=True)
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1,
                        before[3])
    want = kk.knn_reference(q, xyz, k)
    assert got.dtype == torch.int64 and got.shape == (B, S, k)
    if kind != "random":
        assert torch.equal(got, want)
        return
    # float32: the matmul's rounding is not the kernel's; bf16: a float32
    # sum taken in another order may round to the neighbouring bf16 value,
    # in the inner product and in the distance (two ulps a pick)
    _knn_near_ties(kk, q, xyz, got, want, 1e-6 if dtype == "float32"
                   else 2 ** -5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,width", [(64, 16), (64, 48), (40, 16),
                                     (130, 64), (129, 32)])
def test_knn_channel_stages_equal_plain(bf16_full_sums, dtype, C, width):
    """Stages narrower than C, forced (the last stage ragged at 40, 130
    and 129 channels; 129 and 130 element by element): exact and
    duplicated inputs give the plain version's indices."""
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    cuda = bf16_full_sums
    dt = getattr(torch, dtype)
    for kind in ("exact", "duplicates"):
        xyz = _channel_cloud(cuda, kind, 3, 150, C, C, dt)
        q = xyz[:, :70].contiguous()
        how = kk.plan(150, 24, C=C, bf16=dtype == "bfloat16", width=width)
        assert how.tier == kk.CHANNELS and how.points == width
        got = kk.launch(q, xyz, 24, how)
        assert torch.equal(got, kk.knn_reference(q, xyz, 24)), kind


@pytest.mark.parametrize("C,dtype", [(64, "float32"), (128, "float32"),
                                     (6, "float32"), (64, "bfloat16")])
def test_knn_channels_one_kernel_a_call(cuda, C, dtype):
    """Tier C writes the int64 indices itself: one device kernel a call,
    no cast, no copy."""
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    from point_cloud_reid_tpu_torch.tools.timing import device_kernels
    xyz = _channel_cloud(cuda, "random", 2, 300, C, 0, getattr(torch, dtype))
    names = device_kernels(lambda: kk.knn(xyz, xyz, 20, keep_dtype=True))
    assert len(names) == 1 and "knn_channels" in names[0], names


@pytest.mark.parametrize("C", [3, 64, 128])
def test_knn_feature_space_bf16_route(bf16_full_sums, C):
    """knn_feature_space at bf16 on the card: tier C with the plain bf16
    path's roundings (indices equal to the bf16 sort on exact and
    duplicated features, C = 3 included), while knn() without keep_dtype
    casts bf16 to float32 as knn_pallas does; float32 features of 64 and
    128 channels take tier C, of 3 the xyz tiers."""
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    from point_cloud_reid_tpu_torch.ops.geometry import (knn_feature_space,
                                                         square_distance)
    cuda = bf16_full_sums
    for kind in ("exact", "duplicates"):
        x = _channel_cloud(cuda, kind, 4, 500, C, C, torch.bfloat16)
        d = square_distance(x, x)
        assert d.dtype == torch.bfloat16
        want = torch.sort(d, dim=-1, stable=True).indices[..., :20]
        before = dict(kk.knn.tier_launches)
        got = knn_feature_space(x.transpose(1, 2), 20)
        assert torch.equal(got, want), kind
        assert kk.knn.tier_launches["channels"] == before["channels"] + 1
        cast = kk.knn(x, x, 20)
        assert torch.equal(cast, kk.knn_reference(x.float(), x.float(), 20))
        f32 = x.float()
        before = dict(kk.knn.tier_launches)
        got = knn_feature_space(f32.transpose(1, 2), 20)
        assert torch.equal(got, kk.knn_reference(f32, f32, 20))
        tier = "channels" if C != 3 else "shared"
        assert kk.knn.tier_launches[tier] == before[tier] + 1


def test_knn_channels_all_points_identical(cuda):
    """An all-way tie over 64 channels: every query's neighbours are
    0 .. k-1 in order, in both dtypes."""
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    for dt in (torch.float32, torch.bfloat16):
        xyz = torch.full((3, 200, 64), 0.37, device=cuda, dtype=dt)
        want = torch.arange(48, device=cuda).expand(3, 7, 48)
        assert torch.equal(kk.knn(xyz[:, :7], xyz, 48, keep_dtype=True), want)


def _f32(x):
    """The float32 nearest the exact rational x, ties to even."""
    from fractions import Fraction
    best = np.float32(float(x))
    for y in (np.nextafter(best, np.float32(-np.inf)),
              np.nextafter(best, np.float32(np.inf))):
        dy, db = abs(Fraction(float(y)) - x), abs(Fraction(float(best)) - x)
        if dy < db or (dy == db and int(y.view(np.int32)) % 2 == 0):
            best = y
    return best


def _kernel_distances(q, xyz):
    """The kernel's distances, rounding for rounding: |q|^2 - 2 q.p + |p|^2
    with the products and sums rounded one at a time and q.p as the FMA
    chain fma(qz, pz, fma(qy, py, qx px)), each FMA rounded once."""
    from fractions import Fraction

    def fma(a, b, c):
        return _f32(Fraction(float(a)) * Fraction(float(b))
                    + Fraction(float(c)))

    def norm(p):
        return (p[0] * p[0] + p[1] * p[1]) + p[2] * p[2]
    out = np.empty((q.shape[0], xyz.shape[0]), np.float32)
    for s, a in enumerate(q):
        for n, p in enumerate(xyz):
            inner = fma(a[2], p[2], fma(a[1], p[1], a[0] * p[0]))
            out[s, n] = (norm(a) - np.float32(2) * inner) + norm(p)
    return out


def test_knn_kernel_orders_negative_distances_as_floats(cuda):
    """Queries that are points of a crop far from the origin: |q|^2 ~ 3e6
    swamps the distances of close points, rounding makes some slightly
    negative (and some -0), and the kernel's keys must order them as the
    floats order, ties by index."""
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    rs = np.random.RandomState(3)
    xyz = (1000.0 + rs.randn(1, 128, 3) * 0.05).astype(np.float32)
    xyz[0, 100:] = xyz[0, 3]                  # duplicates of a query
    q = xyz[:, [3, 17, 60, 101]]
    d = _kernel_distances(q[0], xyz[0])
    assert (d < 0).any() and (d > 0).any()
    want = np.argsort(d, axis=-1, kind="stable")
    got = kk.knn(torch.from_numpy(q).to(cuda), torch.from_numpy(xyz).to(cuda),
                 128)
    assert np.array_equal(got[0].cpu().numpy(), want)


def _fps_boundaries():
    """(B, N, npoint) at the largest N of each tier that kernels/fps.plan
    sets and at that N + 1."""
    from point_cloud_reid_tpu_torch.kernels import fps as kf
    tops = (kf.WARP_MAX_N, kf.BLOCK_P * kf.MAX_THREADS,
            (kf.MAX_SMEM - kf.SLOT_BYTES) // 4)
    return [(2, n, 48) for top in tops for n in (top, top + 1)]


@pytest.mark.parametrize("start_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("kind", ["exact", "duplicates", "random"])
@pytest.mark.parametrize("B,N,npoint", [
    (128, 128, 128), (128, 128, 64), (128, 64, 32), (3, 33, 33),
    (2, 1000, 40), (5, 7, 1), (2, 1025, 64), (512, 2048, 512),
    (4, 16384, 256), (2, 20000, 128)] + _fps_boundaries())
def test_fps_kernel_indices_equal_plain(cuda, kind, B, N, npoint,
                                        start_dtype):
    from point_cloud_reid_tpu_torch.kernels import fps as kf
    xyz = _knn_inputs(kind, B, N, N).to(cuda)
    start = torch.from_numpy(np.random.RandomState(1).randint(0, N, B)
                             ).to(cuda, start_dtype)
    before = kf.fps.launches
    got = kf.fps(xyz, npoint, start)
    assert kf.fps.launches == before + 1
    assert got.dtype == torch.int64 and got.shape == (B, npoint)
    assert torch.equal(got, kf.fps_reference(xyz, npoint, start))
    assert torch.equal(got[:, 0], start.long())


@pytest.mark.parametrize("tier", range(4))
@pytest.mark.parametrize("kind", ["exact", "duplicates", "random"])
def test_fps_every_tier_equal_plain(cuda, kind, tier):
    """Every tier, forced, at one N that all of them reach (tier W with its
    32 points a lane, as tools/ab_fps.py --sweep forces it)."""
    from point_cloud_reid_tpu_torch.kernels import fps as kf
    B, N, npoint = 6, 1000, 300
    xyz = _knn_inputs(kind, B, N, N).to(cuda)
    start = torch.from_numpy(np.random.RandomState(2).randint(0, N, B)
                             ).to(cuda)
    got = kf.launch(xyz, npoint, start, kf.plan(N, tier))
    assert torch.equal(got, kf.fps_reference(xyz, npoint, start))


@pytest.mark.parametrize("N", [128, 2048, 20000, 60000])
def test_fps_call_is_one_device_kernel(cuda, N):
    """The kernel reads int64 starts and writes int64 indices itself: no
    cast, no copy, one kernel a call, whatever the tier."""
    from point_cloud_reid_tpu_torch.kernels import fps as kf
    from point_cloud_reid_tpu_torch.tools.timing import device_kernels
    xyz = _knn_inputs("random", 2, N, N).to(cuda)
    start = torch.tensor([0, N - 1], device=cuda)
    names = device_kernels(lambda: kf.fps(xyz, 16, start))
    assert len(names) == 1 and "fps" in names[0], names


# points of C channels (fps_pallas's (B, N, C)) through every tier of the
# channel kernels, C = 1 to 64, indices equal to the plain loop's
@pytest.mark.parametrize("kind", ["exact", "random"])
@pytest.mark.parametrize("C", [1, 2, 6, 64])
@pytest.mark.parametrize("tier", [None, 0, 1, 2, 3])
def test_fps_over_channels_equal_plain(cuda, C, tier, kind):
    from point_cloud_reid_tpu_torch.kernels import fps as kf
    g = torch.Generator(device=cuda).manual_seed(C)
    for B, N, npoint in ((5, 37, 20), (3, 600, 64), (2, 1500, 100)):
        if kind == "exact":
            x = torch.randint(-2, 3, (B, N, C), generator=g, device=cuda
                              ).float()
        else:
            x = torch.randn((B, N, C), generator=g, device=cuda)
        start = torch.randint(0, N, (B,), generator=g, device=cuda)
        try:
            how = kf.plan(N, tier, C=C)
        except ValueError:
            continue                # e.g. tier W past 512 points
        got = kf.launch(x, npoint, start, how)
        assert torch.equal(got, kf.fps_reference(x, npoint, start))


def test_fps_wrapper_raises_on_bad_input(cuda):
    from point_cloud_reid_tpu_torch.kernels import fps as kf
    x = torch.zeros((2, 8, 3), device=cuda)
    start = torch.zeros(2, dtype=torch.long, device=cuda)
    before = kf.fps.launches
    with pytest.raises(ValueError, match="npoint"):
        kf.fps(x, 9, start)
    with pytest.raises(ValueError, match="float32"):
        kf.fps(x.double(), 4, start)
    with pytest.raises(ValueError, match="one device"):
        kf.fps(x, 4, start.cpu())
    for bad in (x[..., 0], x[..., :0]):
        with pytest.raises(ValueError, match=r"\(B, N, C\)"):
            kf.fps(bad, 4, start)
    with pytest.raises(ValueError, match="start"):
        kf.fps(x, 4, start.float())
    with pytest.raises(ValueError, match="start"):
        kf.fps(x, 4, start[:1])
    assert kf.fps.launches == before
    # a plan the kernel cannot run (tier BLOCK without its shared memory)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kf.launch(x, 4, start, kf.Plan(kf.BLOCK, kf.BLOCK_P, 32, 1, 0))


# the cross stages' shape; D = V = 128 (chunks of 32 rows, four tiles a
# thread); S = 1; L and S past a 64-row chunk; one and four heads; D and V
# not multiples of 4 (4-byte copies)
@pytest.mark.parametrize("B,L,S,H,D,V", [(256, 128, 128, 2, 32, 32),
                                         (3, 50, 37, 2, 8, 12),
                                         (2, 200, 64, 4, 64, 16),
                                         (2, 40, 33, 2, 128, 128),
                                         (3, 17, 1, 2, 32, 32),
                                         (2, 129, 65, 2, 32, 32),
                                         (3, 50, 37, 1, 32, 32),
                                         (2, 64, 48, 4, 32, 32),
                                         (2, 30, 20, 3, 5, 7)])
def test_linear_attention_kernel_matches_plain(cuda, B, L, S, H, D, V):
    from point_cloud_reid_tpu_torch.kernels import linear_attention as la
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, L, H, D), generator=g, device=cuda, requires_grad=True)
    # non-contiguous views, as a fused qkv projection would hand them over
    kv = torch.randn((B, S, H, D + V), generator=g, device=cuda)
    k = kv[..., :D].detach().requires_grad_(True)
    v = kv[..., D:].detach().requires_grad_(True)
    before = la.linear_attention_forward.launches
    got = la.fused_linear_attention(q, k, v)
    assert la.linear_attention_forward.launches == before + 1
    want = la.linear_attention_reference(q, k, v)
    _close(got.detach(), want.detach())
    go = torch.randn(got.shape, generator=g, device=cuda)
    grads = torch.autograd.grad(got, (q, k, v), go.transpose(1, 2).contiguous(
        ).transpose(1, 2))                       # a non-contiguous cotangent
    assert la.linear_attention_forward.launches == before + 1
    for a, b in zip(grads, torch.autograd.grad(want, (q, k, v), go)):
        _close(a, b)


@pytest.mark.parametrize("rows", [256 * 128, 3 * 50])
def test_linear_attention_kernel_at_the_local_stages_shape(cuda, rows):
    """LocalSelfAttention's shape: one query and 32 keys a row (a point and
    its feature-space neighbours), two heads of 32, for 256 pairs of
    128-point crops and a small batch; forward and gradients, and the
    launch counted at one query."""
    from point_cloud_reid_tpu_torch.kernels import linear_attention as la
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn((rows, n, 2, 32), generator=g, device=cuda,
                           requires_grad=True) for n in (1, 32, 32))
    before = la.linear_attention_forward.launches
    one = la.linear_attention_forward.shape_launches["one_query"]
    got = la.fused_linear_attention(q, k, v)
    assert la.linear_attention_forward.launches == before + 1
    assert la.linear_attention_forward.shape_launches["one_query"] == one + 1
    want = la.linear_attention_reference(q, k, v)
    _close(got.detach(), want.detach())
    go = torch.randn(got.shape, generator=g, device=cuda)
    for a, b in zip(torch.autograd.grad(got, (q, k, v), go),
                    torch.autograd.grad(want, (q, k, v), go)):
        _close(a, b)


def test_kernel_wrappers_raise_on_bad_input(cuda):
    from point_cloud_reid_tpu_torch.kernels import knn as kk
    from point_cloud_reid_tpu_torch.kernels import linear_attention as la
    x = torch.zeros((2, 8, 3), device=cuda)
    with pytest.raises(ValueError):
        kk.knn(x, x, 9)
    with pytest.raises(ValueError):
        kk.knn(x.double(), x.double(), 4)
    with pytest.raises(ValueError):
        kk.knn(x[..., :2], x, 4)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kk.launch(x, x, 4, kk.Plan(kk.REG, 3, 8, 8 * 16))
    q = torch.zeros((2, 8, 2, 4), device=cuda)
    with pytest.raises(ValueError):
        la.linear_attention_forward(q, q[:, :, :1], q)
    with pytest.raises(ValueError):
        la.linear_attention_forward(q.half(), q.half(), q.half())


# ---- the bf16 kernels (csrc/sa_stage_bf16.cu, csrc/match_grid_bf16.cu) ----
#
# Against their bf16 plain versions: the same bf16-rounded operands and
# float32 accumulation on both sides, so only the summation order differs;
# where a float32 value lies next to a bf16 rounding boundary, an operand or
# an output may round one ulp apart. Relative to max(1, |plain|): one bf16
# ulp is at most 2^-7 = 7.8e-3 of it (chip_smoke.py's BF16_TOL, measured).
BF16_TOL = 1e-2


def _close_bf16(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BF16_TOL * max(1.0, want.float().abs().max().item()), err


def _sa_args_bf16(cuda, B, N, S, K, C):
    A, Ct, *rest = _sa_args(cuda, B, N, S, K, C)
    return (A.to(torch.bfloat16), Ct.to(torch.bfloat16), *rest)


# Every branch of plan_bf16: the wgmma tier (C = 32, 64, ..., 1024) groups 4
# centres and takes a centre's K rows in ceil(K / 16) 64-row m-tiles,
# repeating neighbour K - 1 in the slots past K; weights resident at
# C <= 128, through the ring above; at C = 1024 two warpgroups split each
# m-tile's columns. The mma_sync tier (the other multiples of 32) keeps
# the first version's row tiles of M rows, with CAS maxima where M is not a
# multiple of K.
@pytest.mark.parametrize("B,N,S,K,C", [
    (3, 40, 20, 12, 64),            # K = 12: slots past K, whole centres
    (4, 128, 128, 32, 128),         # the flagship's SA1, SA2, SA3 at B = 4:
    (4, 128, 64, 48, 256),          # K = 32 and 48 fill their m-tiles
    (4, 64, 32, 48, 512),
    (2, 64, 32, 48, 1024),          # two warpgroups an m-tile
    (2, 64, 32, 32, 1024),
    (3, 50, 25, 20, 96),            # mma_sync tier, K does not divide M:
    (2, 40, 16, 32, 992),           # CAS maxima; M = 48 at C = 992
    (2, 16, 9, 7, 32),              # C = 32 in half a swizzle row
    (3, 50, 25, 20, 128),           # 75 centres: a ragged last group
    (1, 30, 7, 16, 256),            # fewer centres than one block's groups
    (2, 256, 6, 200, 128),          # K = 200: a centre past a block's rows
    (1, 96, 5, 70, 512),            # K = 70 through the ring
    (4, 128, 128, 32, 256),         # the 7M model's (mul = 8) SA1, SA2, SA3
    (4, 128, 64, 48, 512),
    (4, 64, 32, 48, 1024),
    (3, 64, 25, 20, 1024),          # a ragged last group, slots past K
    (128, 64, 32, 48, 1024),        # the 7M SA3 at B = 128: many rounds
    (256, 128, 128, 32, 128),       # more groups than resident blocks
    (128, 64, 32, 48, 512),         # the ring over several rounds a block
])
def test_sa_convmax_bf16_kernel_matches_plain(cuda, B, N, S, K, C):
    from point_cloud_reid_tpu_torch.kernels import sa_stage as sa
    args = _sa_args_bf16(cuda, B, N, S, K, C)
    tier = sa.plan_bf16(C, K, B * S * K).tier
    assert tier == (sa.WGMMA if C in sa.WGMMA_WIDTHS else sa.MMA_SYNC)
    fn = sa.fused_sa_convmax
    before = fn.launches, fn.bf16_launches, dict(fn.bf16_tiers)
    got = fn(*args)
    assert (fn.launches, fn.bf16_launches) == (before[0], before[1] + 1)
    assert fn.bf16_tiers == dict(before[2], **{tier: before[2][tier] + 1})
    _close_bf16(got, sa.sa_convmax_reference(*args))


def test_sa_bf16_layout_equals_the_plan(cuda):
    """pcr_sa_bf16_layout gives the plan that plan_bf16 reckons at every
    width either tier takes, and refuses what neither takes."""
    from point_cloud_reid_tpu_torch.kernels import _lib
    from point_cloud_reid_tpu_torch.kernels import sa_stage as sa
    lib = _lib.LIBRARY.get()
    for C in range(32, 8193, 32):
        for K in (1, 7, 16, 32, 48, 200):
            want = sa.plan_bf16(C, K)
            assert sa.kernel_plan_bf16(C, K, lib) == want, (C, K)
            assert want.smem <= sa.MAX_SMEM
    assert sa.plan_bf16(128, 32) == sa.SaPlan(sa.WGMMA, 192, 3, 1, 4,
                                              121920, True)
    for C, K in ((16, 8), (48, 8), (8224, 8), (128, 0)):
        assert sa.kernel_plan_bf16(C, K, lib) is None


def test_sa_convmax_bf16_kernel_refuses_other_widths(cuda):
    """At bf16 as at float32: past 8192 channels (ROADMAP.md K7) the
    wrapper raises before any launch."""
    from point_cloud_reid_tpu_torch.kernels import sa_stage as sa
    before = sa.fused_sa_convmax.bf16_launches
    for C in (8224, 8256):
        with pytest.raises(ValueError, match="K7"):
            sa.fused_sa_convmax(*_sa_args_bf16(cuda, 1, 8, 4, 4, C))
    assert sa.fused_sa_convmax.bf16_launches == before


# the serving shapes (the flagship's N = 128 at C = 64, DeiT's 197 / 198
# tokens), the tiny models' C = 16, rows short of one slab, ragged slabs and
# 64-row tiles (65, 129), and the most rows the bf16 cluster layout takes at
# C = 64 (208)
@pytest.mark.parametrize("head,N,C", [
    ("point", 128, 64), ("point", 40, 16), ("point", 33, 64),
    ("point", 208, 64), ("point", 65, 64), ("point", 129, 16),
    ("image", 197, 64), ("image", 198, 64), ("image", 129, 64),
    ("image", 6, 16), ("image", 70, 16)])
def test_match_bf16_kernels_match_plain(cuda, head, N, C):
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.tools.ab_match import inputs
    nt, nd = 3, 5
    t, d, w1, w2, nhead = inputs(head, nt, nd, N, C, device=cuda,
                                 dtype=torch.bfloat16)
    assert mg.plan(N, C, nhead, pos=head == "point",
                   dtype=torch.bfloat16).tier == mg.CLUSTER
    grid_fn, pairs_fn = ((mg.fused_match_grid, mg.fused_match_pairs)
                         if head == "point" else
                         (mg.fused_image_match_grid,
                          mg.fused_image_match_pairs))
    ti = torch.arange(nt, device=cuda).repeat_interleave(nd)
    di = torch.arange(nd, device=cuda).repeat(nt)
    before = (grid_fn.launches, grid_fn.bf16_launches,
              grid_fn.tier_launches["cluster_bf16"])
    grid = grid_fn(t, d, w1, w2, nhead)
    assert (grid_fn.launches, grid_fn.bf16_launches,
            grid_fn.tier_launches["cluster_bf16"]) == (
                before[0], before[1] + 1, before[2] + 1)
    _close_bf16(grid, mg.match_pooled_reference(t, d, w1, w2, nhead, ti, di
                                                ).reshape(nt, nd, -1))
    t_idx = torch.tensor([2, 0, 1, 1, 2], dtype=torch.int32, device=cuda)
    d_idx = torch.tensor([4, 1, 0, 3, 4], dtype=torch.int32, device=cuda)
    before = pairs_fn.bf16_launches
    pairs = pairs_fn(t, d, w1, w2, nhead, t_idx, d_idx)
    assert pairs_fn.bf16_launches == before + 1
    # one per-pair code in both index modes: the same bits
    assert torch.equal(pairs, grid[t_idx.long(), d_idx.long()])
    with pytest.raises(IndexError, match="out of range"):
        pairs_fn(t, d, w1, w2, nhead, t_idx, d_idx + 5)


def test_match_bf16_cluster_walks_more_pairs_than_clusters(cuda):
    """More pairs than the card holds clusters at once: each cluster scores
    pairs in turn with its resident weights; the pairs are their grid
    cells whatever cluster and turn score them."""
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.tools.ab_match import inputs
    nt = nd = 24
    t, d, w1, w2, nhead = inputs("point", nt, nd, 128, 64, device=cuda,
                                 dtype=torch.bfloat16)
    grid = mg.fused_match_grid(t, d, w1, w2, nhead)
    t_idx = torch.arange(nt, device=cuda, dtype=torch.int32).flip(0)
    d_idx = torch.arange(nd, device=cuda, dtype=torch.int32)
    pairs = mg.fused_match_pairs(t, d, w1, w2, nhead, t_idx, d_idx)
    assert torch.equal(pairs, grid[t_idx.long(), d_idx.long()])
    sel = torch.tensor([0, 301, 575], device=cuda)
    ti, di = sel // nd, sel % nd
    _close_bf16(grid.reshape(nt * nd, -1)[sel],
                mg.match_pooled_reference(t, d, w1, w2, nhead, ti, di))


# the bf16 rows tier at the float32 tier's edges; C = 64 past the bf16
# cluster layout's 208 rows and, driven past the plan, below it; C = 16 past
# its cluster layout on the first rows kernel
@pytest.mark.parametrize("N,C,nhead", [
    (1, 128, 2), (15, 128, 2), (16, 128, 2), (17, 128, 2), (64, 128, 2),
    (127, 128, 2), (128, 128, 2), (129, 128, 2), (225, 128, 2),
    (128, 128, 8), (128, 128, 1), (17, 128, 1), (1, 128, 8),
    (209, 64, 2), (1024, 64, 2), (2048, 64, 2), (1, 64, 2), (15, 64, 8),
    (64, 64, 1), (129, 64, 2), (2849, 16, 2)])
def test_match_rows_bf16_matches_plain(cuda, N, C, nhead):
    _rows_case(cuda, N, C, nhead, torch.bfloat16)


def _rows_layouts_equal_the_plan(lib, dtype):
    """The rows tiers' layout entry points at `dtype` give the status and
    the bytes plan reckons: the wgmma tier at C = 64 / 128 (1 to 16 heads,
    any N) and its wide kernel at the multiples of 128 from 256 to 1024 (1
    to 32 heads), the first rows kernel at C = 16 (up to 8 heads); what
    neither takes is 1."""
    import ctypes

    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    need, limit = ctypes.c_longlong(), ctypes.c_longlong()
    for (N, C, H), (wg, mma) in {
            (225, 64, 2): (0, 1), (1, 64, 1): (0, 1), (2048, 64, 8): (0, 1),
            (1, 128, 2): (0, 1), (128, 128, 8): (0, 1), (129, 128, 1): (0, 1),
            (2849, 16, 2): (1, 0), (128, 128, 16): (0, 1),
            (128, 128, 32): (1, 1), (1, 256, 1): (0, 1), (300, 256, 16): (0, 1),
            (128, 256, 32): (0, 1), (128, 384, 3): (0, 1), (65, 512, 32): (0, 1),
            (197, 768, 2): (0, 1), (2048, 1024, 8): (0, 1), (128, 256, 64): (1, 1),
            (128, 1152, 2): (1, 1), (128, 320, 2): (1, 1),
            (128, 32, 2): (1, 1), (128, 128, 3): (1, 1),
            (0, 64, 2): (1, 1)}.items():
        assert getattr(lib, f"pcr_match_rows_wg{sfx}_layout")(
            N, C, H, ctypes.byref(need), ctypes.byref(limit)) == wg
        assert limit.value == mg.MAX_SMEM
        if wg == 0:
            assert need.value == mg.rows_layout(C, H, dtype).smem
            assert mg.plan(max(N, 225), C, H, dtype=dtype) == mg.Plan(
                mg.ROWS, need.value)
        assert getattr(lib, f"pcr_match_rows{sfx}_layout")(
            N, C, H, ctypes.byref(need), ctypes.byref(limit)) == mma
        if mma == 0:
            want = (mg.rows_mma_bytes_bf16 if sfx else mg.rows_mma_bytes)(C)
            assert need.value == want
            assert mg.plan(N, C, H, dtype=dtype) == mg.Plan(mg.ROWS_MMA,
                                                            want)


def test_match_rows_layouts_equal_the_plan(cuda):
    """The float32 twin of test_match_bf16_layouts_equal_the_plan's rows
    part: csrc/match_rows.cu's two layout checks against plan."""
    from point_cloud_reid_tpu_torch.kernels import _lib
    _rows_layouts_equal_the_plan(_lib.LIBRARY.get(), torch.float32)


def test_match_bf16_layouts_equal_the_plan(cuda):
    """The bf16 tiers' layout entry points give the status and the bytes
    that plan(..., dtype=torch.bfloat16) reckons: the cluster tier up to its
    edge (208 rows at C = 64), the rows tier past it and at C = 128, and
    what neither takes."""
    import ctypes

    from point_cloud_reid_tpu_torch.kernels import _lib
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    lib = _lib.LIBRARY.get()
    need, limit = ctypes.c_longlong(), ctypes.c_longlong()
    for (N, C), (status, want) in {(128, 64): (0, 210688),
                                   (197, 64): (0, 231168),
                                   (208, 64): (0, 231168),
                                   (209, 64): (2, 235264),
                                   (40, 16): (0, 52416),
                                   (2848, 16): (0, 231616),
                                   (2849, 16): (2, 232640),
                                   (128, 128): (1, 0)}.items():
        assert lib.pcr_match_pooled_bf16_layout(
            N, C, 2, ctypes.byref(need), ctypes.byref(limit)) == status
        assert (need.value, limit.value) == (want, 232448)
        if status != 1:
            assert mg.cluster_bytes_bf16(N, C) == want
        if status == 0:
            assert mg.plan(N, C, 2, dtype=torch.bfloat16) == mg.Plan(
                mg.CLUSTER, want)
    _rows_layouts_equal_the_plan(lib, torch.bfloat16)


@pytest.mark.parametrize("M,C", [(3000, 64), (65_536, 128)])
def test_global_batch_norm_on_the_card_matches_the_cpu(cuda, M, C):
    """The data-parallel BatchNorm (models/layers._GlobalBatchNorm) in one
    process, float64: its card path (SyncBatchNorm's backward kernels)
    against its CPU path, outputs and the gradients of x, gamma, beta."""
    from point_cloud_reid_tpu_torch.models.layers import _GlobalBatchNorm
    g = torch.Generator().manual_seed(0)
    x, dy = (torch.randn(M, C, generator=g, dtype=torch.float64) * 2 + 1
             for _ in range(2))
    w, b = (torch.randn(C, generator=g, dtype=torch.float64)
            for _ in range(2))
    out = []
    for dev in ("cpu", cuda):
        args = [t.to(dev).requires_grad_() for t in (x, w, b)]
        y = _GlobalBatchNorm.apply(*args, 1e-5)[0]
        grads = torch.autograd.grad(y, args, dy.to(dev))
        out.append([t.detach().cpu() for t in (y,) + grads])
    for got, want in zip(out[1], out[0]):
        err = (got - want).abs().max().item()
        assert err <= 1e-9 * max(1.0, want.abs().max().item()), err


# ---- ROADMAP.md K5 and K6b: the SA stage at any width up to 2048 and the
# match chain past 128 channels and 8 heads

# C = 16 and 48 in the padded layout (32, 64), 1,056, 1,824, 2,000 (padded
# to 2,016) and 2048 on the float32 kernel's wide layout (the mul16 model's
# SA3; run at the next multiple of 64), with
# K dividing 16 (K = 16, 48), not dividing it (5, 20) and a ragged last
# group; the bf16 kernel's wide tier past 1024
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,S,K,C", [
    (3, 40, 20, 12, 16), (2, 50, 25, 20, 48), (2, 64, 32, 48, 1056),
    (2, 64, 32, 48, 1824), (2, 64, 32, 5, 2000), (4, 64, 32, 48, 2048),
    (3, 64, 25, 20, 2048), (2, 40, 7, 16, 2048), (16, 64, 32, 48, 2048),
    # ROADMAP.md K7: past 2048 channels, the mul24 model's SA3 (3,072), a
    # width padded to 4,032, and the widest, 8192
    (2, 64, 32, 48, 2080), (4, 64, 32, 48, 3072), (2, 64, 9, 20, 4000),
    (1, 64, 32, 48, 4096), (1, 40, 5, 48, 8192)])
def test_sa_wide_and_padded_widths_match_plain(cuda, B, N, S, K, C, dtype):
    """fused_sa_convmax at widths past the first kernels' (ROADMAP.md K5):
    one launch of the dtype's kernel (in the padded layout where C is off
    the multiples of 32), against the plain version at the true width."""
    from point_cloud_reid_tpu_torch.kernels import sa_stage as sa
    bf16 = dtype == torch.bfloat16
    args = (_sa_args_bf16 if bf16 else _sa_args)(cuda, B, N, S, K, C)
    fn = sa.fused_sa_convmax
    W = sa.run_width(C, bf16)
    key = "bf16" if bf16 else "float32"
    before = (fn.bf16_launches if bf16 else fn.launches,
              fn.padded_launches[key])
    got = fn(*args)
    assert got.shape == (B, S, C) and got.dtype == dtype
    assert (fn.bf16_launches if bf16 else fn.launches) == before[0] + 1
    assert fn.padded_launches[key] == before[1] + (W != C)
    if bf16:
        assert sa.plan_bf16(W, K).tier == (
            sa.WGMMA if W in sa.WGMMA_WIDTHS else sa.WIDE if W > 1024
            else sa.MMA_SYNC)
        _close_bf16(got, sa.sa_convmax_reference(*args))
    else:
        assert sa.plan_f32(W, K).layout == (
            sa.WIDE if W >= sa.F32_WIDE_FROM else sa.TWO_BUFFERS)
        _close(got, sa.sa_convmax_reference(*args))


# The wide layout (csrc/sa_wide_wg.cuh) at both dtypes, through the wrapper's
# plan where it gives the layout and forced (launch_wide) below it:
# C = 1,056 (a 64-column last chunk at 1,088), 1,536 and 2048; K = 1, 5, 48
# and 64 (one to four m-tiles a group, slots past K repeated); B S not a
# multiple of a group's 4 centres or of a pair of groups; more pairs of
# groups than resident blocks (B = 128: 512 pairs on 132 blocks).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,S,K,C", [
    (2, 64, 7, 1, 1056), (3, 64, 25, 5, 1536), (2, 64, 32, 48, 2048),
    (2, 96, 9, 64, 1056), (3, 50, 25, 20, 1536), (1, 80, 13, 64, 2048),
    (128, 64, 32, 48, 1056), (4, 64, 32, 48, 1024)])
def test_sa_wide_layout_matches_plain(cuda, B, N, S, K, C, dtype):
    from point_cloud_reid_tpu_torch.kernels import sa_stage as sa
    bf16 = dtype == torch.bfloat16
    args = (_sa_args_bf16 if bf16 else _sa_args)(cuda, B, N, S, K, C)
    want = sa.sa_convmax_reference(*args)
    fn = sa.fused_sa_convmax
    how = sa.plan_bf16(C, K) if bf16 else sa.plan_f32(C, K)
    if (how.tier if bf16 else how.layout) == sa.WIDE:
        counts = fn.bf16_tiers if bf16 else fn.f32_layouts
        before = counts[sa.WIDE]
        got = fn(*args)
        assert counts[sa.WIDE] == before + 1
    else:
        got = sa.launch_wide(*args)
    assert got.shape == (B, S, C) and got.dtype == dtype
    (_close_bf16 if bf16 else _close)(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sa_wide_layout_is_deterministic(cuda, dtype):
    """Two launches on the same inputs (each with its own scratch from the
    allocator, the second most likely the first's bytes) give bit-equal
    outputs: no atomics, every centre's max in one warp in one order."""
    from point_cloud_reid_tpu_torch.kernels import sa_stage as sa
    bf16 = dtype == torch.bfloat16
    args = (_sa_args_bf16 if bf16 else _sa_args)(cuda, 16, 64, 32, 48, 2048)
    first = sa.fused_sa_convmax(*args)
    again = sa.fused_sa_convmax(*args)
    assert torch.equal(first, again)


def test_sa_f32_layout_equals_the_plan_and_checks_the_scratch(cuda):
    """pcr_sa_f32_layout gives the plan that plan_f32 reckons at every width
    (its layout, shared and scratch bytes), and refuses what neither layout
    takes; a wrapper plan that differs from the build's raises before any
    launch, and the wide entry points refuse a scratch smaller than the
    plan's."""
    from point_cloud_reid_tpu_torch.kernels import _lib
    from point_cloud_reid_tpu_torch.kernels import sa_stage as sa
    lib = _lib.LIBRARY.get()
    for C in range(32, 8193, 32):
        for K in (1, 7, 16, 48, 200):
            want = sa.plan_f32(C, K)
            assert sa.kernel_plan_f32(C, K, lib) == want, (C, K)
            assert want.smem <= sa.MAX_SMEM
    for C, K in ((16, 8), (48, 8), (8224, 8), (128, 0)):
        assert sa.kernel_plan_f32(C, K, lib) is None
    for bf16 in (False, True):
        how = sa.plan_bf16(2048, 48) if bf16 else sa.plan_f32(2048, 48)
        with pytest.raises(ValueError, match="differs"):
            sa._check_kernel_plan(how._replace(scratch=how.scratch - 16),
                                  2048, 48, lib, bf16)
    args = _sa_args(cuda, 1, 16, 4, 16, 2048)
    w2, w3 = sa.wide_stage_weights(args[3], args[4], False)
    need = sa.wide_scratch_bytes(2048, False)
    scratch = torch.empty(need, dtype=torch.uint8, device=cuda)
    out = torch.empty((1, 4, 2048), device=cuda)
    ptrs = [t.data_ptr() for t in (args[0], args[1], args[2], w2, w3,
                                   *args[5:], out, scratch)]
    stream = _lib.stream_ptr(cuda)
    assert lib.pcr_sa_convmax_wide(*ptrs, 1, 16, 4, 16, 2048, 1, need - 16,
                                   stream) != 0
    assert lib.pcr_sa_convmax_wide(*ptrs, 1, 16, 4, 16, 2048, 1, need,
                                   stream) == 0
    torch.cuda.synchronize()
    _close(out, sa.sa_convmax_reference(*args))
    # the row tiles' entry refuses the wide layout's widths
    for C in (sa.F32_WIDE_FROM, 1792, 2048):
        assert lib.pcr_sa_convmax(*ptrs[:12], 1, 16, 4, 16, C, stream) != 0
    with pytest.raises(ValueError, match="multiple of 64"):
        sa.launch_wide(*_sa_args(cuda, 1, 16, 4, 16, 992))




# C = 256 in 2 heads of 128 (conv_out256), in 16 of 16 and in one, at one
# m-tile, a ragged second one and past two; 129 .. 255 channels padded to
# 256 (heads crossing the halves); C = 128 in 16 heads of 8 (heads16) on the
# exact instantiation; C = 64 in 16 heads of 4 and C = 96 in 12 heads of 8
# on the padded one; the image head at 256 channels and at 197 / 198 tokens
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head,C,H,N", [
    ("point", 256, 2, 128), ("point", 256, 2, 65), ("point", 256, 16, 40),
    ("point", 256, 1, 17), ("point", 200, 2, 70), ("point", 136, 8, 33),
    ("point", 128, 16, 128), ("point", 128, 16, 1), ("point", 64, 16, 300),
    ("point", 96, 12, 130), ("image", 256, 2, 197), ("image", 192, 3, 198),
    ("image", 128, 16, 197),
    # ROADMAP.md K7: the wide kernel past 256 channels (C = 320 padded to
    # 384, 512, 1000 in two heads of 500 padded to 1024, 1024 at two
    # m-tiles) and past 16 heads (256 in 32 heads of 8), the image head at
    # 768 in two heads of 384
    ("point", 320, 5, 70), ("point", 512, 2, 128), ("point", 1000, 2, 20),
    ("point", 1024, 8, 65), ("point", 256, 32, 40), ("image", 768, 2, 197)])
def test_match_wide_and_many_heads_match_plain(cuda, head, C, H, N, dtype):
    """The rows tier past 128 channels (the wide kernel) and past 8 heads:
    grid and pair list against the plain version at the true width (TOL;
    bf16: BF16_TOL), pairs equal to their grid cells bit for bit, one
    launch of the rows tier a call, in the padded layout as rows_padded
    says."""
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    from point_cloud_reid_tpu_torch.tools.ab_match import inputs
    bf16 = dtype == torch.bfloat16
    nt, nd = 3, 4
    t, d, w1, w2, H = inputs(head, nt, nd, N, C, H, device=cuda, dtype=dtype)
    point = head == "point"
    grid_fn = mg.fused_match_grid if point else mg.fused_image_match_grid
    pair_fn = mg.fused_match_pairs if point else mg.fused_image_match_pairs
    how = mg.plan(N, C, H, pos=point, dtype=dtype)
    assert how.tier == mg.ROWS
    key = mg.tier_key(mg.ROWS, bf16)
    before = (grid_fn.tier_launches[key], grid_fn.padded_launches[key])
    grid = grid_fn(t, d, w1, w2, H)
    assert grid.shape == (nt, nd, 2 * C)
    assert (grid_fn.tier_launches[key], grid_fn.padded_launches[key]) == (
        before[0] + 1, before[1] + mg.rows_padded(C, H, 5 if point else 4))
    t_idx = torch.tensor([2, 0, 1, 1, 0], dtype=torch.int32, device=cuda)
    d_idx = torch.tensor([3, 1, 0, 3, 3], dtype=torch.int32, device=cuda)
    pairs = pair_fn(t, d, w1, w2, H, t_idx, d_idx)
    ti = torch.arange(nt, device=cuda).repeat_interleave(nd)
    di = torch.arange(nd, device=cuda).repeat(nt)
    (_close_bf16 if bf16 else _close)(
        grid, mg.match_pooled_reference(t, d, w1, w2, H, ti, di
                                        ).reshape(nt, nd, -1))
    assert torch.equal(pairs, grid[t_idx.long(), d_idx.long()])
