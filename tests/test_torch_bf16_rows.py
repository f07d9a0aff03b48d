"""The bf16 match chain's tiers on the CPU: the plan that sends a bf16 model's
shapes to the cluster tier (csrc/match_grid_bf16.cu) or the rows tier
(csrc/match_rows_bf16.cu), and the bf16 plain chain at the rows tier's
C = 128 against the JAX package's fused_match_grid / fused_match_pairs at
bf16, run as the JAX suite runs them on the CPU (interpret=True)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.ops.pallas import match_grid as jmg  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import match_grid as tmg  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

BF16 = torch.bfloat16
JBF16 = jnp.bfloat16
# bf16 operands and float32 sums on both sides: only the summation order
# differs, and a value next to a bf16 rounding boundary may round one ulp
# apart (tests/test_torch_bf16_kernels_plain.py's bar), relative to
# max(1, |want|)
TOL = 1e-2


def _side(rs, n: int, N: int, C: int, nhead: int) -> tuple:
    """Seeded per-object factors (h, q, kvz, a1, pv) shaped as grid_factors
    makes them (q elu+1-positive, [KV | Z] block-diagonal per head), in
    bf16."""
    heads = np.arange(C) // (C // nhead)
    mask = (heads[:, None] == heads[None, :]).astype(np.float32)
    q = np.exp(np.minimum(rs.randn(n, N, C), 0))
    k = np.exp(np.minimum(rs.randn(n, N, C), 0))
    v = rs.randn(n, N, C)
    kvz = np.concatenate([np.einsum("bnc,bnd->bcd", k, v) * mask / N,
                          k.sum(1)[:, :, None] * mask[None] / N], -1)
    side = (rs.randn(n, N, C), q, kvz, rs.randn(n, N, 2 * C) / np.sqrt(C),
            0.1 * rs.randn(n, N, C))
    return tuple(torch.from_numpy(x.astype(np.float32)).to(BF16)
                 for x in side)


def _weights(rs, C: int) -> tuple:
    def mat(a, b):
        return torch.from_numpy((rs.randn(a, b) / np.sqrt(a)
                                 ).astype(np.float32))

    def vec(base):
        return torch.from_numpy((base + 0.1 * rs.randn(C)).astype(np.float32))

    def tail():
        return dict(merge=mat(C, C), fc1=mat(2 * C, 2 * C), fc2=mat(2 * C, C),
                    ln1_scale=vec(1.0), ln1_bias=vec(0.0),
                    ln2_scale=vec(1.0), ln2_bias=vec(0.0))
    w1, w2 = tail(), tail()
    w2.update(q=mat(C, C), kv=mat(C, 2 * C))
    return w1, w2


def _j(t: torch.Tensor):
    """A port tensor as a jnp array of the same dtype and bits."""
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy(), JBF16)
    return jnp.asarray(t.numpy())


def _close(got: torch.Tensor, want):
    assert got.dtype == BF16 and want.dtype == JBF16
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), err


# the bf16 cluster layout's edge at C = 64 (csrc/match_grid_bf16.cu)
CLUSTER_EDGE = 208


def test_bf16_plan_picks_the_tier():
    """At bf16: the cluster tier at the serving shapes (the flagship's 128
    rows, DeiT's 197 / 198 tokens, the tiny models' C = 16) up to its edge;
    the rows tier at C = 128 and past the edge, for the image head too
    (its padded entry point). The float32 plan at the same shapes is its
    own (PR 4's and PR 11's layouts)."""
    for N, C in ((128, 64), (197, 64), (198, 64), (CLUSTER_EDGE, 64),
                 (40, 16)):
        for pos in (True, False):
            how = tmg.plan(N, C, 2, pos=pos, dtype=BF16)
            assert how == tmg.Plan(tmg.CLUSTER, tmg.cluster_bytes_bf16(N, C))
            assert how.smem <= tmg.MAX_SMEM
    assert tmg.cluster_bytes_bf16(CLUSTER_EDGE + 1, 64) > tmg.MAX_SMEM
    for N, C in ((128, 128), (CLUSTER_EDGE + 1, 64), (2048, 64), (1, 128)):
        assert tmg.plan(N, C, 2, dtype=BF16) == tmg.Plan(
            tmg.ROWS, tmg.rows_bytes_bf16(C))
    assert tmg.rows_bytes_bf16(128) <= tmg.MAX_SMEM
    assert tmg.plan(128, 128, 8, dtype=BF16).tier == tmg.ROWS
    assert tmg.plan(CLUSTER_EDGE + 1, 64, 2, pos=False, dtype=BF16) == \
        tmg.Plan(tmg.ROWS, tmg.rows_bytes_bf16(64, tmg.ROWS_MAX_HEADS))
    with pytest.raises(ValueError, match="at most 16 heads"):
        tmg.plan(128, 128, 32, dtype=BF16)
    # float32: the cluster tier holds up to 224 rows at C = 64, C = 128 is
    # the rows tier's
    for N, C, tier in ((128, 64, tmg.CLUSTER), (197, 64, tmg.CLUSTER),
                       (198, 64, tmg.CLUSTER), (CLUSTER_EDGE + 1, 64,
                                                tmg.CLUSTER),
                       (40, 16, tmg.CLUSTER), (128, 128, tmg.ROWS),
                       (2048, 64, tmg.ROWS)):
        want = (tmg.cluster_bytes(N, C) if tier == tmg.CLUSTER
                else tmg.rows_bytes(C))
        assert tmg.plan(N, C, 2) == tmg.Plan(tier, want)


def test_bf16_launch_counts_by_tier():
    """Each wrapper counts its launches by tier and dtype; the CPU plain
    version counts none."""
    for fn in (tmg.fused_match_grid, tmg.fused_match_pairs,
               tmg.fused_image_match_grid, tmg.fused_image_match_pairs):
        assert set(fn.tier_launches) == {"cluster", "rows", "rows_mma",
                                         "cluster_bf16", "rows_bf16",
                                         "rows_mma_bf16"}
    assert [tmg.tier_key(t, b) for b in (False, True)
            for t in (tmg.CLUSTER, tmg.ROWS, tmg.ROWS_MMA)] == [
                "cluster", "rows", "rows_mma", "cluster_bf16", "rows_bf16",
                "rows_mma_bf16"]


def test_match_chain_bf16_plain_matches_pallas_at_c128():
    """The bf16 plain chain at C = 128 (the 1.5M / 7M models' width, the
    rows tier's on the card) on a 2 x 3 grid and a 4-pair list, against
    JAX's fused_match_grid / fused_match_pairs at bf16 from the same bf16
    factors and float32 weights; the port's pairs are its grid cells bit
    for bit."""
    nt, nd, N, C, nhead = 2, 3, 16, 128, 2
    rs = np.random.RandomState(13)
    t, d = _side(rs, nt, N, C, nhead), _side(rs, nd, N, C, nhead)
    w1, w2 = _weights(rs, C)
    assert tmg.plan(N, C, nhead, dtype=BF16).tier == tmg.ROWS
    grid = tmg.fused_match_grid(t, d, w1, w2, nhead)
    assert grid.shape == (nt, nd, 2 * C) and grid.dtype == BF16
    jw1 = {k: _j(v) for k, v in w1.items()}
    jw2 = {k: _j(v) for k, v in w2.items()}
    want = jmg.fused_match_grid(*map(_j, t), *map(_j, d), jw1, jw2, nhead,
                                det_block=nd, interpret=True)
    _close(grid, want)
    t_idx = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    d_idx = torch.tensor([nd - 1, 1, 0, 0], dtype=torch.int32)
    pairs = tmg.fused_match_pairs(t, d, w1, w2, nhead, t_idx, d_idx)
    assert torch.equal(pairs, grid[t_idx.long(), d_idx.long()])
    ti, di = t_idx.numpy(), d_idx.numpy()
    jpairs = jmg.fused_match_pairs(
        *(_j(x)[ti] for x in t), *(_j(x)[di] for x in d), jw1, jw2, nhead,
        pair_block=4, interpret=True)
    _close(pairs, jpairs)
