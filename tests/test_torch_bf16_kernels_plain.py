"""The plain versions of the port's bf16 kernels against the JAX package's
Pallas kernels at bf16, run as the JAX suite runs them on the CPU
(interpret=True): the SA chain (fused_sa_convmax, sa_stage_inference), the
match chain's per-object factors, grid and pairs (fused_match_grid /
fused_match_pairs, pallas_grid_logits, pallas_pair_logits) and the image
head's grid (pallas_image_grid_logits). Same numpy-seeded inputs, same
float32 weights; the port's pairs equal its grid cells bit for bit."""
import copy
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.ops.pallas import match_grid as jmg  # noqa: E402
from point_cloud_reid_tpu.ops.pallas import sa_stage as jsa  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import match_grid as tmg  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import sa_stage as tsa  # noqa: E402
from tests._torch_port import TINY, crops, to_jax_tree  # noqa: E402
from tests.test_torch_kernels_plain import _stage_weights  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

BF16 = torch.bfloat16
JBF16 = jnp.bfloat16
# bf16 on both sides with the same rounding points: only the float32
# summation order differs, and a value next to a bf16 rounding boundary may
# round one ulp apart (the CUDA tests' BF16_TOL), relative to max(1, |want|)
TOL = 1e-2
# logits through the match head, whose bf16 layers round too (the serving
# tests' bar)
LOGIT_TOL = 6e-2


def _close(got: torch.Tensor, want, tol: float = TOL):
    assert got.dtype == BF16 and want.dtype == JBF16
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _j(t: torch.Tensor):
    """A port tensor as a jnp array of the same dtype and bits."""
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy(), JBF16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("with_points", [False, True])
def test_sa_stage_bf16_plain_matches_pallas(with_points):
    """sa_stage_inference at bf16: A and Ct in bf16 (conv1_edge_factors),
    the chain's products on bf16 operands, the output bf16."""
    rs = np.random.RandomState(0)
    B, N, S, K, D, C = 2, 24, 12, 6, 8, 16
    xyz = rs.randn(B, N, 3).astype(np.float32)
    pts = rs.randn(B, N, D).astype(np.float32) if with_points else None
    c_in = 3 + (2 * D if with_points else 0)
    convs, bns, params, stats = _stage_weights(rs, c_in, C)
    idx = rs.randint(0, N, (B, S, K)).astype(np.int32)
    want = jsa.sa_stage_inference(
        jnp.asarray(xyz), None if pts is None else jnp.asarray(pts),
        jnp.asarray(idx), params, stats, dtype=JBF16, interpret=True)
    got = tsa.sa_stage_inference(
        torch.from_numpy(xyz), None if pts is None else torch.from_numpy(pts),
        torch.from_numpy(idx), convs, bns, dtype=BF16)
    _close(got, want)


@pytest.mark.parametrize("C", [32, 128, 512, 1024])
@pytest.mark.parametrize("K", [8, 48])
def test_sa_convmax_bf16_plain_matches_pallas(C, K):
    """The kernel's own inputs: bf16 A and Ct, float32 weights and
    affines, at the widths of both bf16 tiers (C = 32 ... 512 wgmma, 1024
    mma_sync) and K in and past one 16-row slot group."""
    rs = np.random.RandomState(1)
    B, N, S = (3, 32, 16) if C == 32 else (2, 48, 4)
    A = torch.from_numpy(rs.randn(B, N, C).astype(np.float32)).to(BF16)
    Ct = torch.from_numpy(rs.randn(B, S, C).astype(np.float32)).to(BF16)
    idx = torch.from_numpy(rs.randint(0, N, (B, S, K)).astype(np.int32))
    w2, w3 = (torch.from_numpy((rs.randn(C, C) / np.sqrt(C)).astype(
        np.float32)) for _ in range(2))
    vecs = [torch.from_numpy((1 + 0.1 * rs.randn(C)).astype(np.float32))
            for _ in range(6)]
    got = tsa.fused_sa_convmax(A, Ct, idx, w2, w3, *vecs)
    idx_km = jnp.asarray(idx.numpy().transpose(0, 2, 1).reshape(B, K * S, 1))
    want = jsa.fused_sa_convmax(_j(A), _j(Ct), idx_km, _j(w2), _j(w3),
                                *(_j(v) for v in vecs), interpret=True)
    _close(got, want)


@functools.lru_cache(maxsize=1)
def _point_models():
    from point_cloud_reid_tpu.configs.models import (
        point_transformer_point_cat as jax_cfg)
    from point_cloud_reid_tpu.models import build_model as jax_build
    from point_cloud_reid_tpu_torch.configs import point_transformer_point_cat
    from point_cloud_reid_tpu_torch.models import build_model
    t16 = build_model(point_transformer_point_cat(**TINY),
                      generator=torch.Generator().manual_seed(0),
                      dtype=BF16)
    jvars = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(t16))
    return jax_build(jax_cfg(**TINY), dtype=JBF16), jvars, t16


def _embeddings(nt, nd):
    jmodel, jvars, tmodel = _point_models()
    with torch.no_grad():
        xt, ht = tmodel.embed(torch.from_numpy(crops(10, nt)))
        xd, hd = tmodel.embed(torch.from_numpy(crops(11, nd)))
    assert ht.dtype == BF16 and xt.dtype == torch.float32
    return jmodel, jvars, tmodel, (ht, xt, hd, xd)


def test_grid_factors_bf16_match_jax():
    """The per-object factors: float32 products of the bf16 embeddings,
    cast to bf16, as JAX's grid_factors; the kernel's weights stay
    float32."""
    _, jvars, tmodel, (ht, xt, _, _) = _embeddings(3, 1)
    want = jmg.grid_factors(jvars["params"], _j(ht), _j(xt), 2)
    got = tmg.grid_factors(tmodel.cross_stage1, tmodel.cross_stage2, ht, xt, 2)
    assert torch.equal(got[0], ht)
    for g, w in zip(got[1:], want):
        _close(g, w)
    for w in tmg.stage_weights(tmodel.cross_stage1, tmodel.cross_stage2):
        assert all(x.dtype == torch.float32 for x in w.values())


def test_match_chain_bf16_plain_matches_pallas():
    """Pooled features of the grid and of a pair list: the port's plain
    chain against JAX's fused_match_grid / fused_match_pairs at bf16, each
    from its own package's factors of the same embeddings. The port's pairs
    are its grid cells bit for bit."""
    _, jvars, tmodel, (ht, xt, hd, xd) = _embeddings(4, 8)
    params = jvars["params"]
    t, d, w1, w2, nhead = tmg.match_factors(tmodel, ht, xt, hd, xd)
    grid = tmg.fused_match_grid(t, d, w1, w2, nhead)
    jt = jmg.grid_factors(params, _j(ht), _j(xt), nhead)
    jd = jmg.grid_factors(params, _j(hd), _j(xd), nhead)
    jw1, jw2 = jmg.stage_weights(params)
    want = jmg.fused_match_grid(_j(ht), *jt, _j(hd), *jd, jw1, jw2, nhead,
                                det_block=4, interpret=True)
    assert grid.shape == (4, 8, 32) and grid.dtype == BF16
    _close(grid, want)
    rs = np.random.RandomState(0)
    t_idx = torch.from_numpy(rs.randint(0, 4, 8).astype(np.int32))
    d_idx = torch.from_numpy(rs.randint(0, 8, 8).astype(np.int32))
    pairs = tmg.fused_match_pairs(t, d, w1, w2, nhead, t_idx, d_idx)
    assert torch.equal(pairs, grid[t_idx.long(), d_idx.long()])
    ti, di = jnp.asarray(t_idx.numpy()), jnp.asarray(d_idx.numpy())
    jpairs = jmg.fused_match_pairs(
        _j(ht)[ti], *(x[ti] for x in jt), _j(hd)[di], *(x[di] for x in jd),
        jw1, jw2, nhead, pair_block=4, interpret=True)
    _close(pairs, jpairs)


def test_grid_and_pair_logits_bf16_plain_match_pallas():
    jmodel, jvars, tmodel, (ht, xt, hd, xd) = _embeddings(4, 8)
    j = [_j(x) for x in (ht, xt, hd, xd)]
    want = jmg.pallas_grid_logits(jmodel, jvars, *j, det_block=4,
                                  interpret=True)
    rs = np.random.RandomState(1)
    t_idx = rs.randint(0, 4, 8).astype(np.int32)
    d_idx = rs.randint(0, 8, 8).astype(np.int32)
    want_pairs = jmg.pallas_pair_logits(
        jmodel, jvars, *j, jnp.asarray(t_idx), jnp.asarray(d_idx),
        pair_block=4, interpret=True)
    with torch.no_grad():
        got = tmg.grid_logits(tmodel, ht, xt, hd, xd)
        pairs = tmg.pair_logits(tmodel, ht, xt, hd, xd,
                                torch.from_numpy(t_idx),
                                torch.from_numpy(d_idx))
    assert want.dtype == JBF16
    _close(got, want, LOGIT_TOL)
    _close(pairs, want_pairs, LOGIT_TOL)
    assert torch.equal(pairs, got[t_idx, d_idx])


def test_image_grid_logits_bf16_plain_match_pallas():
    """The image head (no position term, 5 tokens) at bf16 against
    pallas_image_grid_logits in interpret mode, and pooled features against
    the image kernel on JAX's factors; pairs equal grid cells."""
    from point_cloud_reid_tpu.models import build_model as jax_build
    from point_cloud_reid_tpu_torch.models import build_model
    from tests._torch_image import (images, jax_variables_of,
                                    tiny_image_cfg)
    cfg = tiny_image_cfg("deit-test-no-pt", aux=False)
    t16 = build_model(copy.deepcopy(cfg),
                      generator=torch.Generator().manual_seed(0), dtype=BF16)
    jmodel = jax_build(copy.deepcopy(cfg), dtype=JBF16)
    jvars = jax_variables_of(t16, "deit-test-no-pt")
    with torch.no_grad():
        h = t16.downsample_tokens(t16.embed(torch.from_numpy(images(3, 7))))
    assert h.dtype == BF16
    ht, hd = h[:3], h[3:]
    want = jmg.pallas_image_grid_logits(jmodel, jvars, _j(ht), _j(hd),
                                        det_block=4, interpret=True)
    with torch.no_grad():
        got = tmg.image_grid_logits(t16, ht, hd)
        t, d, w1, w2, nhead = tmg.image_match_factors(t16, ht, hd)
        grid = tmg.fused_image_match_grid(t, d, w1, w2, nhead)
        t_idx = torch.tensor([2, 0, 1], dtype=torch.int32)
        d_idx = torch.tensor([3, 1, 0], dtype=torch.int32)
        pairs = tmg.fused_image_match_pairs(t, d, w1, w2, nhead, t_idx, d_idx)
    assert want.dtype == JBF16
    _close(got, want, LOGIT_TOL)
    assert torch.equal(pairs, grid[t_idx.long(), d_idx.long()])
