"""The rest of the port's op library against the JAX package's functions on
the same seeded numpy inputs: ball query and grouping, three-NN
interpolation, FPS over a distance matrix, the global group, chamfer, the
BEV samplers and voxelization (the sparse-conv ops and Boxes3D are in
tests/test_torch_ops_sparse.py). Indices equal exactly, floats within 1e-5
of max(1, |JAX|); the overflow cases (more voxels than max_voxels, more
points than max_points_per_voxel) included."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu import ops as jops  # noqa: E402
from point_cloud_reid_tpu.ops import bev_feat as jbev  # noqa: E402
from point_cloud_reid_tpu.ops import geometry as jgeo  # noqa: E402
from point_cloud_reid_tpu.ops import voxel as jvox  # noqa: E402
from point_cloud_reid_tpu_torch import ops as tops  # noqa: E402
from point_cloud_reid_tpu_torch.ops import bev_feat as tbev  # noqa: E402
from point_cloud_reid_tpu_torch.ops import geometry as tgeo  # noqa: E402
from point_cloud_reid_tpu_torch.ops import voxel as tvox  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

TOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def same_index(got, want):
    np.testing.assert_array_equal(np.asarray(got.cpu()), np.asarray(want))


def close(got, want):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got.cpu(), np.float64) - want)
    assert got.shape == want.shape
    assert np.all(err <= TOL * np.maximum(1.0, np.abs(want))), err.max()


def test_ops_all_is_the_jax_packages():
    assert sorted(tops.__all__) == sorted(jops.__all__)
    for name in tops.__all__:
        assert hasattr(tops, name), name


# ---- geometry ---------------------------------------------------------------

def _cloud(seed, B=2, N=40, dup=True):
    rs = np.random.RandomState(seed)
    base = rs.randn(B, N, 3).astype(np.float32)
    if dup:                       # resampled crops repeat points: ties
        base = base[:, rs.randint(0, N, N)]
    return base


@pytest.mark.parametrize("radius", [0.05, 0.6, 1.2, 10.0])
def test_query_ball_point_and_group_points(radius):
    xyz = _cloud(0)
    new_xyz = np.concatenate([xyz[:, :10], xyz[:, :2] + 50.0], 1)  # empties
    want = jgeo.query_ball_point(radius, 8, jnp.asarray(xyz),
                                 jnp.asarray(new_xyz))
    got = tgeo.query_ball_point(radius, 8, t(xyz), t(new_xyz))
    same_index(got, want)
    feats = np.random.RandomState(1).randn(2, 40, 5).astype(np.float32)
    close(tgeo.group_points(t(feats), got),
          jgeo.group_points(jnp.asarray(feats), want))


def test_sample_and_group_edge_ball_query_computes_as_jax():
    xyz = _cloud(2)
    pts = np.random.RandomState(3).randn(2, 40, 4).astype(np.float32)
    for points in (None, pts):
        jx, jp = jgeo.sample_and_group_edge(
            6, jnp.asarray(xyz), None if points is None else
            jnp.asarray(points), 12, radius=0.8, use_knn=False)
        tx, tp = tgeo.sample_and_group_edge(
            6, t(xyz), None if points is None else t(points), 12,
            radius=0.8, use_knn=False)
        close(tx, jx)
        close(tp, jp)


def test_three_nn_interpolate_idw():
    known = _cloud(4, N=24)
    unknown = _cloud(5, N=30, dup=False)
    unknown[:, :6] = known[:, :6]                 # zero distances
    feats = np.random.RandomState(6).randn(2, 24, 7).astype(np.float32)
    jd, ji = jgeo.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    td, ti = tgeo.three_nn(t(unknown), t(known))
    same_index(ti, ji)
    close(td, jd)
    w = np.random.RandomState(7).rand(2, 30, 3).astype(np.float32)
    close(tgeo.three_interpolate(t(feats), ti, t(w)),
          jgeo.three_interpolate(jnp.asarray(feats), ji, jnp.asarray(w)))
    close(tgeo.interpolate_idw(t(unknown), t(known), t(feats)),
          jgeo.interpolate_idw(jnp.asarray(unknown), jnp.asarray(known),
                               jnp.asarray(feats)))


def test_fps_with_dist_and_group_all():
    xyz = _cloud(8, N=33)
    d = np.asarray(jgeo.square_distance(jnp.asarray(xyz), jnp.asarray(xyz)))
    start = np.array([0, 5], np.int32)
    for s in (None, start):
        want = jgeo.farthest_point_sample_with_dist(
            jnp.asarray(d), 12, None if s is None else jnp.asarray(s))
        got = tgeo.farthest_point_sample_with_dist(
            t(d), 12, None if s is None else t(s))
        same_index(got, want)
    pts = np.random.RandomState(9).randn(2, 33, 4).astype(np.float32)
    for points in (None, pts):
        jx, jp = jgeo.sample_and_group_all(
            jnp.asarray(xyz), None if points is None else jnp.asarray(points))
        tx, tp = tgeo.sample_and_group_all(
            t(xyz), None if points is None else t(points))
        close(tx, jx)
        close(tp, jp)


def test_chamfer_distance_with_and_without_masks():
    rs = np.random.RandomState(10)
    x = rs.randn(3, 20, 3).astype(np.float32)
    y = rs.randn(3, 28, 3).astype(np.float32)
    xm = rs.rand(3, 20) > 0.3
    ym = rs.rand(3, 28) > 0.3
    xm[2] = False                                 # a sample with no x
    for a, b in ((None, None), (xm, None), (None, ym), (xm, ym)):
        want = jgeo.chamfer_distance(
            jnp.asarray(x), jnp.asarray(y),
            None if a is None else jnp.asarray(a),
            None if b is None else jnp.asarray(b))
        got = tgeo.chamfer_distance(t(x), t(y), None if a is None else t(a),
                                    None if b is None else t(b))
        close(got, want)


def test_subsample_pc_contract():
    """The draw is torch's stream, not jax.random's: both give rows of the
    valid prefix, and zeros below 3 valid points."""
    pc = np.random.RandomState(11).randn(50, 3).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    for nv in (1, 2, 3, 17, 50):
        out = tgeo.subsample_pc(g, t(pc), nv, 64).numpy()
        assert out.shape == (64, 3)
        if nv < 3:
            assert not out.any()
        else:
            rows = {r.tobytes() for r in pc[:nv]}
            assert all(r.tobytes() in rows for r in out)


# ---- BEV features -----------------------------------------------------------

def test_bev_grids_pixel_and_roi_features():
    rs = np.random.RandomState(12)
    bev = rs.randn(20, 24, 6).astype(np.float32)
    pcr = [-12.0, -10.0, -3.0, 12.0, 10.0, 1.0]
    xy = (rs.rand(5, 2) * 22 - 11).astype(np.float32)
    close(tbev.centered_grid(t(xy), 1.5, 4),
          jbev.centered_grid(jnp.asarray(xy), 1.5, 4))
    close(tbev.interpolate_bev_grid(t(bev), t(xy), pcr, 1.5, 4),
          jbev.interpolate_bev_grid(jnp.asarray(bev), jnp.asarray(xy), pcr,
                                    1.5, 4))
    x = rs.rand(17).astype(np.float32) * 1.2 - 0.1
    for got, want in zip(tbev.linear_interp(t(x), 9),
                         jbev.linear_interp(jnp.asarray(x), 9)):
        if got.dtype.is_floating_point:
            close(got, want)
        else:
            same_index(got, want)
    lrange = [-12.0, 12.0, -10.0, 10.0]
    boxes = np.concatenate([xy * 1.1, rs.rand(5, 2).astype(np.float32) * 4 + 1,
                            rs.randn(5, 1).astype(np.float32)], 1)
    close(tbev.get_pixel_feat(t(bev), t(boxes), lrange),
          jbev.get_pixel_feat(jnp.asarray(bev), jnp.asarray(boxes), lrange))
    for roi in (3, (2, 5)):
        close(tbev.get_roi_feat(t(bev), t(boxes), roi, lrange),
              jbev.get_roi_feat(jnp.asarray(bev), jnp.asarray(boxes), roi,
                                lrange))


# ---- voxels -----------------------------------------------------------------

@pytest.mark.parametrize("max_ppv,max_voxels", [(10, 400), (3, 400), (4, 25),
                                                (1, 1)])
def test_voxelize_hard_with_overflow(max_ppv, max_voxels):
    rs = np.random.RandomState(13)
    pts = np.concatenate([rs.rand(300, 3) * [8, 8, 3] - [4, 4, 1],
                          rs.rand(300, 1)], 1).astype(np.float32)
    pts[:40, :3] = pts[0, :3] + rs.rand(40, 3) * 0.05   # one crowded voxel
    pts[-5:, 0] = 9.0                                  # out of range
    args = ((0.5, 0.5, 0.4), (-4.0, -4.0, -1.0, 4.0, 4.0, 2.0), max_ppv,
            max_voxels)
    want = jvox.voxelize_hard(jnp.asarray(pts), *args)
    got = tvox.voxelize_hard(t(pts), *args)
    close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.int32
        same_index(g, w)


def test_dynamic_scatter_mean_and_bev_pool():
    rs = np.random.RandomState(14)
    feats = rs.randn(200, 5).astype(np.float32)
    ids = rs.randint(-1, 12, 200).astype(np.int32)
    ids[:3] = [12, 13, -7]                       # past the end / invalid
    jm, jc = jvox.dynamic_scatter_mean(jnp.asarray(feats), jnp.asarray(ids),
                                       12)
    tm, tc = tvox.dynamic_scatter_mean(t(feats), t(ids), 12)
    close(tm, jm)
    close(tc, jc)
    close(tvox.bev_pool(t(feats), t(ids), 12),
          jvox.bev_pool(jnp.asarray(feats), jnp.asarray(ids), 12))
