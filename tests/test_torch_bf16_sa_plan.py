"""kernels/sa_stage.plan_bf16 on the CPU: the bf16 SA kernel's launch plan
at every width a registered leaf serves, which csrc/sa_stage_bf16.cu's
pcr_sa_bf16_layout must report the same (tests/test_torch_kernels_cuda.py
holds the two equal on the card)."""
import pytest

torch = pytest.importorskip("torch")

from point_cloud_reid_tpu_torch.configs.experiments import (  # noqa: E402
    EXPERIMENTS, get_experiment)
from point_cloud_reid_tpu_torch.kernels import sa_stage as sa  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

FLAGSHIP = "pts_point-transformer_point-cat_nus_det_4x256_500e"
LEAVES = {
    "flagship": FLAGSHIP,
    "1.5M": "pts_point-transformer-1.5M_point-cat_nus_det_4x256_500e",
    "7M": "pts_point-transformer-7M_point-cat_nus_det_4x256_500e",
    "2048pts": "pts_point-transformer_point-cat_waymo_det_4x256_400e_2048pts",
}
BATCH = 128                     # crops a serving frame embeds


def _stages(name: str):
    """(C, K, R) of each SA stage of a leaf at BATCH crops."""
    m = get_experiment(name)["model"]
    mul, ks = m["backbone"]["mul"], m["backbone"]["nsample"]
    return [(w * mul, k, BATCH * s * k)
            for w, k, s in zip((32, 64, 128), ks, m["backbone_list"])]


def test_the_leaves_are_registered():
    assert set(LEAVES.values()) <= set(EXPERIMENTS)


@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_plan_at_every_stage_of_the_leaf(leaf):
    """Every stage of the flagship, the 1.5M and 7M leaves and the
    2048-point ablation takes the wgmma tier, within a block's shared
    memory, every centre whole in a warp; each weight stage serves two or
    three warpgroups' m-tiles (128 or 192 rows), or at C = 1024 (the 7M
    SA3) one m-tile that two warpgroups split by columns."""
    for C, K, R in _stages(LEAVES[leaf]):
        how = sa.plan_bf16(C, K, R)
        assert how.tier == sa.WGMMA
        assert how.smem <= sa.MAX_SMEM
        assert how.cluster == 1 and how.whole_centres and how.ring >= 2
        if C == 1024:
            assert (how.tile_rows, how.warpgroups) == (64, 2)
        else:
            assert how.tile_rows == 64 * how.warpgroups >= 128


@pytest.mark.parametrize("C,want", [
    (128, sa.SaPlan(sa.WGMMA, 192, 3, 1, 4, 121920, True)),     # resident
    (256, sa.SaPlan(sa.WGMMA, 128, 2, 1, 9, 222352, True)),     # the ring
    (512, sa.SaPlan(sa.WGMMA, 128, 2, 1, 5, 230480, True)),
    (1024, sa.SaPlan(sa.WGMMA, 64, 2, 1, 5, 230480, True)),
    (992, sa.SaPlan(sa.MMA_SYNC, 48, 0, 1, 0, 192000, True)),
    (1056, sa.SaPlan(sa.WIDE, 128, 2, 1, 14, 230632, True, 591872)),
    (1536, sa.SaPlan(sa.WIDE, 128, 2, 1, 14, 230632, True, 835584)),
    (2048, sa.SaPlan(sa.WIDE, 128, 2, 1, 14, 230632, True, 1114112)),
])
def test_plan_at_the_served_widths(C, want):
    """The flagship's and the 7M model's widths at K = 48: both weights
    resident at C = 128 (every row a block takes shares them), a ring of
    16 KB stages serving two warpgroups' 128 rows at C = 256 and 512, and
    at C = 1024 one 64-row m-tile whose h1 (128 KB) two warpgroups share;
    a width off the wgmma tier's (992) on the mma_sync tier's row tiles;
    past 1024 (mul16's SA3 at 2048) the wide tier: 14 slots of 16 KB whose
    weight stages serve two warpgroups' m-tiles (128 rows), h1, h2 and the
    running maxima in a scratch of 2 x (2 W / 64 x 8 KB + 16 W) bytes a
    block at W the next multiple of 64 (1,088 for 1,056)."""
    assert sa.plan_bf16(C, 48, BATCH * 32 * 48) == want


def test_plan_takes_any_k_and_refuses_what_no_tier_takes():
    """The wgmma and wide tiers' plans do not depend on K (a centre's rows
    fill ceil(K / 16) m-tiles of one warp); the mma_sync tier's centres are
    whole where K divides its M rows; past 1024 channels the wide tier
    takes every multiple of 32 to 2048. Kernel widths off the multiples of
    32 (the wrapper pads them to kernel_width) or past 2048, K < 1 and
    B S K >= 2^31 raise."""
    for K in (1, 7, 16, 33, 200):
        assert sa.plan_bf16(256, K) == sa.plan_bf16(256, 48)
        assert sa.plan_bf16(1056, K) == sa.plan_bf16(1056, 48)
    assert sa.plan_bf16(96, 16).whole_centres
    assert not sa.plan_bf16(96, 20).whole_centres
    assert {sa.plan_bf16(C, 32).tier for C in range(32, 1025, 32)} == {
        sa.WGMMA, sa.MMA_SYNC}
    assert {sa.plan_bf16(C, 32).tier for C in range(1056, 8193, 32)} == {
        sa.WIDE}
    for C in (16, 48, 8224):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sa.plan_bf16(C, 8)
    with pytest.raises(ValueError, match="K=0"):
        sa.plan_bf16(128, 0)
    with pytest.raises(ValueError, match="2\\^31"):
        sa.plan_bf16(128, 32, 2 ** 31)


def test_cpu_launches_count_no_tier():
    """On the CPU the wrapper runs the plain version: no launch is counted,
    in all or by tier."""
    before = (sa.fused_sa_convmax.bf16_launches,
              dict(sa.fused_sa_convmax.bf16_tiers))
    g = torch.Generator().manual_seed(0)
    C = 32
    args = (torch.randn(1, 8, C, generator=g).to(torch.bfloat16),
            torch.randn(1, 4, C, generator=g).to(torch.bfloat16),
            torch.randint(0, 8, (1, 4, 3), generator=g, dtype=torch.int32),
            torch.randn(C, C, generator=g), torch.randn(C, C, generator=g),
            *(torch.randn(C, generator=g) for _ in range(6)))
    out = sa.fused_sa_convmax(*args)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 4, C)
    assert (sa.fused_sa_convmax.bf16_launches,
            sa.fused_sa_convmax.bf16_tiers) == before
    assert set(before[1]) == set(sa.BF16_TIERS)


def _sw128(r: int, k: int, rows: int) -> int:
    """Byte offset of element (r, k) of a K-major operand of `rows` rows in
    the 128-byte-swizzle layout (csrc/bf16_mma.cuh sw128)."""
    unit = ((k & 63) >> 3) ^ (r & 7)
    return (k >> 6) * rows * 128 + r * 128 + (unit << 4) + (k & 7) * 2


@pytest.mark.parametrize("C", sa.WGMMA_WIDTHS)
def test_stage_weights_lie_as_the_kernel_reads_them(C):
    """stage_weights: stage s of conv2 (then conv3) holds output rows
    n0 .. n0 + NR of chunk s // stages-a-chunk and k-panels from
    (s % stages-a-chunk) KP, each element (n, k) at the byte sw128 gives
    for NR rows; input columns past C are zero (C = 32: half a row)."""
    g = torch.Generator().manual_seed(C)
    w2, w3 = (torch.randn(C, C, generator=g) for _ in range(2))
    _, nc2, nc3, kp3 = sa._wgmma_tiles(C)
    panels = -(-C // 64)
    for w, flat, nr, kp in zip((w2, w3), sa.stage_weights(w2, w3),
                               (nc2, nc3), (1, kp3)):
        ref = w.t().to(torch.bfloat16)            # (out, in)
        per = -(-panels // kp)                    # stages a chunk
        stage_elems = nr * kp * 64
        assert flat.dtype == torch.bfloat16
        assert flat.numel() == (C // nr) * per * stage_elems
        for s in range(0, (C // nr) * per, max(1, (C // nr) * per // 5)):
            stage = flat[s * stage_elems:(s + 1) * stage_elems]
            n0, k0 = (s // per) * nr, (s % per) * kp * 64
            for n in range(0, nr, 7):
                for k in range(0, kp * 64, 5):
                    got = stage[_sw128(n, k, nr) // 2]
                    want = ref[n0 + n, k0 + k] if k0 + k < C else 0.0
                    assert got == want, (s, n, k)
