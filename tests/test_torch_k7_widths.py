"""The shape gaps past the wide layouts' first bounds on the CPU
(ROADMAP.md K7): the SA stage to 8192 channels, and the match chain to 1024
channels and 32 heads (16 up to 128 channels).

Here:
  - part A, row 1: both SA kernels' plans at every width from 2,080 to
    8192 (the wide layout, its scratch sized from the width) and their
    refusal past 8192 naming K7; a model of the wide layout's walk
    (tests/test_torch_wide_widths.py::_sa_wide_model) at C = 2,112 against
    the plain version; one SA stage at 2,080 (padded to 2,112) and 2,112
    channels against JAX's stage, run as JAX's own tests run it;
  - part B, rows 2-4: kernels/match_grid.plan at every width from 257 to
    1024, head, dtype and head count, and its refusals past the new bounds;
    the wide kernel's one layout (a ring of 12 TF32 / 24 bf16 stages at
    every width), its scratch and the blocks a scratch budget allows; its
    stage copies at 384 and 512 channels read back byte for byte; a model
    of its walk with sum k and the pooling through a warpgroup's staging
    (_wide_model) at 384 and 512 channels against the plain chain; the
    tiny flagship at conv_out 512 and the tiny image model at 768 against
    JAX's model.apply, scorer and pair logits;
  - part C, heads: the plan and the walk at 256 channels in 32 heads of 8,
    and the tiny flagship at 32 heads against JAX.
The card holds the kernels themselves to the plain version at these shapes
(tests/test_torch_kernels_cuda.py, chip_smoke.py phase 18)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.ops.pallas import sa_stage as jsa  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import match_grid as mg  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import sa_stage as sa  # noqa: E402
from point_cloud_reid_tpu_torch.tools.ab_match import inputs  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401
from tests.test_torch_kernels_plain import _stage_weights  # noqa: E402
from tests.test_torch_match_rows_plan import read_stage  # noqa: E402
from tests.test_torch_wide_widths import (  # noqa: E402
    WALK_TOL, _a_stages, _sa_args, _sa_wide_model, _wide_model,
    image_width_against_jax, point_width_against_jax)

BF16 = torch.bfloat16


# ---- part A: the SA stage to 8192 channels ------------------------------------

def test_sa_plans_to_8192_channels():
    """Both kernels put every width from 2,080 to 8192 on the wide layout:
    12 warps, 128 rows a weight stage, 14 slots in 230,632 shared bytes at
    any width, a scratch a block of 2 x (2 W / PK x 8,192 + 16 W) bytes at
    the next multiple of 64 (4,325,376 / 2,228,224 at 4096 float32 / bf16,
    8,650,752 / 4,456,448 at 8192); a width off the multiples of 64 runs at
    the next one. Past 8192 both raise naming ROADMAP.md's K7 (the bound
    was 2048)."""
    for W in range(2080, 8193, 32):
        Wd = -(-W // 64) * 64
        for bf16, pk in ((False, 32), (True, 64)):
            scratch = 2 * (2 * Wd // pk * 8192 + 16 * Wd)
            assert sa.wide_scratch_bytes(W, bf16) == scratch
        assert sa.plan_f32(W, 48) == sa.SaF32Plan(
            sa.WIDE, 12, 16, 128, 230632, True, 14,
            sa.wide_scratch_bytes(W, False))
        assert sa.plan_bf16(W, 48, 128 * 32 * 48) == sa.SaPlan(
            sa.WIDE, 128, 2, 1, 14, 230632, True,
            sa.wide_scratch_bytes(W, True))
    assert [sa.wide_scratch_bytes(W, bf16) for W in (4096, 8192)
            for bf16 in (False, True)] == [4325376, 2228224, 8650752,
                                           4456448]
    assert [sa.run_width(C, bf16) for C in (2049, 2080, 3072, 4000, 8192)
            for bf16 in (False, True)] == [2112] * 4 + [3072] * 2 + [
                4032] * 2 + [8192] * 2
    for C in (8193, 8224, 16384):
        with pytest.raises(ValueError, match="K7"):
            sa.kernel_width(C)
    with pytest.raises(NotImplementedError, match="K7"):
        sa.plan_bf16(8224, 48)
    with pytest.raises(ValueError, match="8192"):
        sa.plan_f32(8224, 48)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_sa_wide_walk_model_at_2112_channels(dtype):
    """The wide layout's walk past 2048 channels (C = 2,112: 16 chunks of
    128 columns and one of 64, 66 / 33 k-panels a product at float32 /
    bf16; slots past K = 13 repeated, a group part empty at 5 centres)
    meets the plain version (WALK_TOL)."""
    args = _sa_args(1, 24, 5, 13, 2112, seed=2112, dtype=dtype)
    want = sa.sa_convmax_reference(*args).double()
    got = _sa_wide_model(*args, blocks=1)
    assert (got - want).abs().max() <= WALK_TOL[dtype] * max(
        1.0, want.abs().max())


@pytest.mark.parametrize("C", [2080, 2112])
def test_sa_stage_past_2048_channels_matches_jax(C):
    """One eval SA stage at 2,080 channels (the wrapper's padded layout at
    2,112, through the plain version as the card's kernel runs it) and at
    2,112 against JAX's sa_stage_inference in interpret mode, as the JAX
    suite runs the Pallas kernel on the CPU; float32, 2e-5."""
    rs = np.random.RandomState(C)
    B, N, S, K, D = 1, 16, 6, 5, 4
    xyz = rs.randn(B, N, 3).astype(np.float32)
    pts = rs.randn(B, N, D).astype(np.float32)
    convs, bns, params, stats = _stage_weights(rs, 3 + 2 * D, C)
    idx = rs.randint(0, N, (B, S, K)).astype(np.int32)
    want = jsa.sa_stage_inference(jnp.asarray(xyz), jnp.asarray(pts),
                                  jnp.asarray(idx), params, stats,
                                  interpret=True)
    args = sa.sa_stage_args(torch.from_numpy(xyz), torch.from_numpy(pts),
                            torch.from_numpy(idx), convs, bns)
    W = sa.run_width(C, False)
    assert W == 2112
    got = sa.sa_convmax_reference(*sa.pad_args(*args, W))[..., :C]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# ---- parts B and C: the match chain to 1024 channels and 32 heads ------------

@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_plan_takes_every_width_to_1024_channels_and_32_heads(dtype):
    """The rows tier's wide kernel for every C from 257 to 1024, point and
    image head, in up to 32 heads dividing it (C = 256 too: 17 to 32
    heads), at the next multiple of 128 in the padded layout and the one
    wide layout's bytes; its layout check is given 32 heads. Past 1024
    channels, past 32 heads, or past 16 where the rows tier takes C <= 128,
    ValueError naming ROADMAP.md's K7 (the bounds were 256 channels and 16
    heads)."""
    wide = mg.rows_layout(1024, 32, dtype).smem
    for C in range(256, 1025):
        W = mg.kernel_width(C, mg.ROWS)
        assert W == -(-C // 128) * 128 and W in mg.ROWS_WIDTHS
        for H in (h for h in (1, 2, 3, 4, 5, 8, 16, 17, 24, 32)
                  if C % h == 0 and (C > 256 or h > 16)):
            for pos in (True, False):
                for N in (1, 197, 2048):
                    assert mg.plan(N, C, H, pos=pos, dtype=dtype) == \
                        mg.Plan(mg.ROWS, wide)
                assert mg.rows_padded(C, H, 5 if pos else 4)
                assert mg.layout_heads(C, H, 5 if pos else 4) == 32
    assert mg.max_heads(128) == 16 and mg.max_heads(129) == 32
    for args in ((128, 1025, 1), (128, 1152, 2), (128, 2048, 8),
                 (128, 256, 64), (197, 264, 33), (128, 128, 32),
                 (2048, 96, 24)):
        for pos in (True, False):
            with pytest.raises(ValueError, match="K7"):
                mg.plan(*args, pos=pos, dtype=dtype)


def test_wide_layout_is_one_at_every_width(monkeypatch):
    """The wide kernel's layout is sized for 1024 channels and 32 heads: a
    ring of 12 TF32 / 24 bf16 stages in 230,600 / 230,792 shared bytes at
    every width (the staging of a 128-column group, sum k of each side and
    the normalisers, 32 KB, in place of 8 warps' partials, 64 KB at 1024
    channels); its scratch grows with C and N (WideScratch: 28.8 MB a
    block at C = 1024, N = 128 float32, 139 MB at N = 2048), and a launch
    takes no more blocks than ROWS_SCRATCH_BUDGET holds."""
    for dtype, ring, smem, pk, sb in ((torch.float32, 12, 230600, 32, 16384),
                                      (BF16, 24, 230792, 64, 8192)):
        fixed = 4 * (2 * 4 * 128 * 2 + 2 * 1024 + 2 * 64 * 32)
        assert smem == 1024 + ring * sb + fixed + 8 * (2 * ring + 1)
        for C in range(256, 1025, 128):
            for H in (1, 2, 32):
                lay = mg.rows_layout(C, H, dtype)
                assert (lay.ring, lay.smem, lay.kvn) == (ring, smem, C)
                assert lay.kv_stages == C // 64 * C // pk
            for N in (1, 128, 197, 2048):
                ntiles = -(-N // 64)
                side = (sb * (C // pk) * (3 * ntiles + 4)
                        + 4 * (ntiles * 64 * C + 64 * (C - 128) + 2 * C))
                assert mg.rows_scratch_bytes(N, C, 1, dtype) == (
                    2 * (C // 64) * (C // pk) * sb + 2 * side)
    assert mg.rows_scratch_bytes(128, 1024, 1) == 28786688
    assert mg.rows_scratch_bytes(2048, 1024, 1) == 138887168

    class Props:
        multi_processor_count = 132
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    one = mg.rows_scratch_bytes(2048, 1024, 1)
    assert mg.rows_blocks(5000, 230600, "cuda", one) == \
        mg.ROWS_SCRATCH_BUDGET // one == 30
    assert mg.rows_blocks(5000, 230600, "cuda",
                          mg.rows_scratch_bytes(128, 1024, 1)) == 132
    assert mg.rows_blocks(7, 230600, "cuda", one) == 7


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("C", [384, 512])
def test_wide_stage_copies_past_256_channels(C, dtype):
    """The stage copies at 384 (three 128-column groups) and 512 channels,
    read back as the kernel reads them, K natural: every weight stage of
    weight_blocks' order (every product in 128-column groups, 10 x 3 x PPC
    x 2 stages a stage-1 tile at 384) and every message stage (one band of
    all C columns), byte for byte; the A stages of a scratch buffer hold
    their rows a k-panel."""
    bf16 = dtype == BF16
    pk = 64 if bf16 else 32
    ppc, nh = C // pk, C // 128
    lay = mg.rows_layout(C, 2, dtype)
    t, d, w1, w2, _ = inputs("point", 1, 1, 3, C, device="cpu")
    stages = mg.rows_stage_weights(w1, w2, bf16).reshape(-1, 4096)
    seq = mg.weight_blocks(C, pk)
    s1w, ssw, _ = lay.weight_stages
    assert stages.shape[0] == len(seq) == sum(lay.weight_stages)
    assert s1w == 10 * nh * ppc and ssw == 4 * nh * ppc
    assert sorted(seq) == sorted(set(seq))
    assert seq[2 * ppc] == ("merge1", 128, 0)
    assert seq[s1w - 1] == ("fc2_1", C - 64, 2 * C - pk)
    mats = mg._weight_matrices(w1, w2)
    for i, (name, r0, k0) in enumerate(seq):
        want = mats[name][r0:r0 + 64, k0:k0 + pk]
        want = want.to(BF16).double() if bf16 else want.double()
        assert torch.equal(read_stage(stages[i], bf16, natural=True),
                           want), (i, name)
    ms, ks = mg.message_stages(t[2], 1, bf16)
    kvt = t[2][0, :, :C].t().double()
    blocks = mg.message_blocks(C, 2, pk)
    assert len(blocks) == lay.kv_stages
    for i, (r0, k0) in enumerate(blocks):
        got = read_stage(ms[0, i * 4096:(i + 1) * 4096], bf16, natural=True)
        assert torch.equal(got, kvt[r0:r0 + 64, k0:k0 + pk].float().to(
            dtype).double()), i
    assert torch.equal(ks[0], torch.diagonal(t[2][0, :, C:]).float())
    rows = torch.randn(64, C, generator=torch.Generator().manual_seed(C))
    got = _a_stages(rows, bf16)
    for p in range(ppc):
        assert torch.equal(read_stage(got[p], bf16, natural=True),
                           rows[:, p * pk:(p + 1) * pk].to(dtype).double())


@pytest.mark.parametrize("head,C,H,N", [("point", 384, 3, 70),
                                        ("point", 320, 5, 20),
                                        ("point", 512, 2, 20),
                                        ("image", 512, 4, 30),
                                        ("point", 256, 32, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_a_model_of_the_wide_walk_past_256_channels_and_16_heads(
        head, C, H, N, dtype):
    """The wide kernel's walk at its new widths and heads (384 in heads of
    128 over a ragged second m-tile; 320 in heads of 64 padded to 384; 512
    in two heads of 256, point and image; 256 in 32 heads of 8), sum k and
    the pooling through a warpgroup's staging, gives the plain version's
    pooled features at the true width (WALK_TOL)."""
    bf16 = dtype == BF16
    t, d, w1, w2, _ = inputs(head, 2, 2, N, C, H, device="cpu", dtype=dtype)
    Wd = mg.kernel_width(C, mg.ROWS)
    assert Wd == -(-C // 128) * 128
    pw1, pw2 = mg.pad_weights(w1, w2, Wd)
    got = mg.unpad_pooled(_wide_model(
        mg.pad_side(t, Wd), mg.pad_side(d, Wd), pw1, pw2, H, 1, 0, bf16, C),
        C)
    want = mg.match_pooled_reference(t, d, w1, w2, H, torch.tensor([1]),
                                     torch.tensor([0]))[0].double()
    assert (got - want).abs().max() <= WALK_TOL[dtype] * max(
        1.0, want.abs().max())


@pytest.mark.parametrize("name,kw", [
    ("conv_out512", dict(conv_out=512)),
    ("heads32", dict(conv_out=256, heads=32))])
def test_k7_point_width_matches_jax(name, kw):
    """Embeddings, the scorer's grid and a pair list of the tiny flagship
    at conv_out 512 (two 256-channel heads) and at conv_out 256 in 32
    heads of 8 (configs/widths.py's conv_out512 and heads32), the port
    against JAX's model.apply, scorer and xla_pair_logits."""
    point_width_against_jax(name, kw)


def test_k7_image_width_matches_jax():
    """The tiny image model at downsample_dim 768 (two 384-channel heads,
    image768): tokens, grid and pairs against JAX."""
    image_width_against_jax(768)
