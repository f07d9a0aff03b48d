"""Plain versions of the port's kernels against the JAX package's Pallas
kernels, run as the JAX suite runs them on the CPU (interpret=True)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.ops.pallas import match_grid as jmg  # noqa: E402
from point_cloud_reid_tpu.ops.pallas import sa_stage as jsa  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import match_grid as tmg  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import sa_stage as tsa  # noqa: E402
from tests._torch_port import crops, tiny_models  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

# the bar of tests/test_pair_grid.py for the grid and pair kernels
GRID_RTOL, GRID_ATOL = 2e-4, 2e-5


def _stage_weights(rs, c_in, C):
    convs, bns, params, stats = [], [], {}, {}
    for i, cin in enumerate((c_in, C, C)):
        w = (rs.randn(C, cin) / np.sqrt(cin)).astype(np.float32)   # (out, in)
        b = (0.1 * rs.randn(C)).astype(np.float32)
        g = (1 + 0.1 * rs.randn(C)).astype(np.float32)
        be = (0.1 * rs.randn(C)).astype(np.float32)
        m = (0.1 * rs.randn(C)).astype(np.float32)
        v = rs.uniform(0.5, 1.5, C).astype(np.float32)
        convs.append((torch.from_numpy(w), torch.from_numpy(b)))
        bns.append(tuple(torch.from_numpy(x) for x in (g, be, m, v)))
        params[f"mlp_{i}"] = dict(conv=dict(kernel=jnp.asarray(w.T),
                                            bias=jnp.asarray(b)),
                                  bn=dict(scale=jnp.asarray(g),
                                          bias=jnp.asarray(be)))
        stats[f"mlp_{i}"] = dict(bn=dict(mean=jnp.asarray(m),
                                         var=jnp.asarray(v)))
    return convs, bns, params, stats


@pytest.mark.parametrize("with_points", [False, True])
def test_sa_stage_plain_matches_pallas(with_points):
    """Port plain sa_stage_inference == JAX sa_stage_inference(interpret)
    with and without input features; f32, tolerance 2e-5."""
    rs = np.random.RandomState(0)
    B, N, S, K, D, C = 2, 24, 12, 6, 8, 16
    xyz = rs.randn(B, N, 3).astype(np.float32)
    pts = rs.randn(B, N, D).astype(np.float32) if with_points else None
    c_in = 3 + (2 * D if with_points else 0)
    convs, bns, params, stats = _stage_weights(rs, c_in, C)
    idx = rs.randint(0, N, (B, S, K)).astype(np.int32)
    want = jsa.sa_stage_inference(
        jnp.asarray(xyz), None if pts is None else jnp.asarray(pts),
        jnp.asarray(idx), params, stats, interpret=True)
    got = tsa.sa_stage_inference(
        torch.from_numpy(xyz), None if pts is None else torch.from_numpy(pts),
        torch.from_numpy(idx), convs, bns)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_sa_convmax_oversampled_centres():
    """S > N clamps the centres to the last point, as in JAX."""
    rs = np.random.RandomState(1)
    B, N, S, K, C = 1, 6, 9, 4, 8
    xyz = rs.randn(B, N, 3).astype(np.float32)
    convs, bns, params, stats = _stage_weights(rs, 3, C)
    idx = rs.randint(0, N, (B, S, K)).astype(np.int32)
    want = jsa.sa_stage_inference(jnp.asarray(xyz), None, jnp.asarray(idx),
                                  params, stats, interpret=True)
    got = tsa.sa_stage_inference(torch.from_numpy(xyz), None,
                                 torch.from_numpy(idx), convs, bns)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def _embeddings(nt, nd):
    jmodel, jvars, tmodel = tiny_models()
    with torch.no_grad():
        xt, ht = tmodel.embed(torch.from_numpy(crops(10, nt)))
        xd, hd = tmodel.embed(torch.from_numpy(crops(11, nd)))
    return jmodel, jvars, tmodel, (ht, xt, hd, xd)


def test_grid_factors_and_stage_weights():
    """Per-object factors and the kernel's weight dicts == JAX's (f32,
    2e-4 / 2e-5)."""
    jmodel, jvars, tmodel, (ht, xt, _, _) = _embeddings(3, 1)
    params = jvars["params"]
    want = jmg.grid_factors(params, jnp.asarray(ht.numpy()),
                            jnp.asarray(xt.numpy()), 2)
    got = tmg.grid_factors(tmodel.cross_stage1, tmodel.cross_stage2, ht, xt, 2)
    for g, w in zip(got[1:], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=GRID_RTOL, atol=GRID_ATOL)
    jw1, jw2 = jmg.stage_weights(params)
    tw1, tw2 = tmg.stage_weights(tmodel.cross_stage1, tmodel.cross_stage2)
    for tw, jw in ((tw1, jw1), (tw2, jw2)):
        assert set(tw) == set(jw)
        for k in jw:
            np.testing.assert_array_equal(tw[k].numpy(), np.asarray(jw[k]))


def test_grid_logits_plain_matches_pallas():
    jmodel, jvars, tmodel, (ht, xt, hd, xd) = _embeddings(4, 8)
    want = jmg.pallas_grid_logits(
        jmodel, jvars, *(jnp.asarray(x.numpy()) for x in (ht, xt, hd, xd)),
        det_block=4, interpret=True)
    with torch.no_grad():
        got = tmg.grid_logits(tmodel, ht, xt, hd, xd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=GRID_RTOL, atol=GRID_ATOL)


def test_pair_logits_plain_matches_pallas():
    jmodel, jvars, tmodel, (ht, xt, hd, xd) = _embeddings(4, 8)
    rs = np.random.RandomState(0)
    t_idx = rs.randint(0, 4, 8).astype(np.int32)
    d_idx = rs.randint(0, 8, 8).astype(np.int32)
    want = jmg.pallas_pair_logits(
        jmodel, jvars, *(jnp.asarray(x.numpy()) for x in (ht, xt, hd, xd)),
        jnp.asarray(t_idx), jnp.asarray(d_idx), pair_block=4, interpret=True)
    with torch.no_grad():
        got = tmg.pair_logits(tmodel, ht, xt, hd, xd,
                              torch.from_numpy(t_idx), torch.from_numpy(d_idx))
        grid = tmg.grid_logits(tmodel, ht, xt, hd, xd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=GRID_RTOL, atol=GRID_ATOL)
    np.testing.assert_allclose(got.numpy(), grid.numpy()[t_idx, d_idx],
                               rtol=GRID_RTOL, atol=GRID_ATOL)


def test_wrappers_refuse_devices_without_a_kernel():
    """A tensor that is neither on the CPU nor on CUDA raises: no silent
    fallback to the plain version."""
    meta = torch.device("meta")
    A = torch.empty((1, 4, 8), device=meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        tsa.fused_sa_convmax(A, torch.empty((1, 2, 8), device=meta),
                             torch.empty((1, 2, 3), dtype=torch.int32,
                                         device=meta),
                             *[torch.empty(s, device=meta)
                               for s in ((8, 8), (8, 8)) + ((8,),) * 6])
    side = tuple(torch.empty(s, device=meta) for s in
                 ((1, 4, 8), (1, 4, 8), (1, 8, 16), (1, 4, 16), (1, 4, 8)))
    with pytest.raises(RuntimeError, match="no kernel"):
        tmg.fused_match_grid(side, side, {}, {}, 2)
    with pytest.raises(RuntimeError, match="no kernel"):
        tmg.fused_match_pairs(side, side, {}, {}, 2,
                              torch.zeros(1, dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("t_idx,d_idx", [([0, -1], [0, 1]),
                                         ([0, 4], [0, 1]),
                                         ([0, 1], [8, 0])])
def test_pair_indices_out_of_range_raise(t_idx, d_idx):
    """Pair indices outside [0, nt) x [0, nd) raise instead of wrapping (the
    CUDA wrapper makes the same check before its launch)."""
    _, _, tmodel, (ht, xt, hd, xd) = _embeddings(4, 8)
    with torch.no_grad(), pytest.raises(IndexError, match="out of range"):
        tmg.pair_logits(tmodel, ht, xt, hd, xd,
                        torch.tensor(t_idx, dtype=torch.int32),
                        torch.tensor(d_idx, dtype=torch.int32))
