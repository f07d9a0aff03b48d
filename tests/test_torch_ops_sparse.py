"""The port's sparse-conv rulebook and ops and Boxes3D against the JAX
package's on the same seeded numpy inputs (the rest of the op library is
in tests/test_torch_ops_library.py): indices equal exactly, floats within
1e-5, with hash collisions in small tables, probe runs past the budget and
more output sites than capacity."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.ops import sparse as jsp  # noqa: E402
from point_cloud_reid_tpu.ops.boxes3d import Boxes3D as JBoxes3D  # noqa: E402
from point_cloud_reid_tpu_torch.ops import sparse as tsp  # noqa: E402
from point_cloud_reid_tpu_torch.ops.boxes3d import Boxes3D  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401
from tests.test_torch_ops_library import close, same_index, t  # noqa: E402


# ---- sparse conv ------------------------------------------------------------

@pytest.mark.parametrize("aggregate", ["sum", "avg", "max"])
def test_assign_score_withk(aggregate):
    rs = np.random.RandomState(15)
    B, N, Np, K, M, O = 2, 6, 9, 4, 3, 5
    scores = rs.rand(B, N, K, M).astype(np.float32)
    points = rs.randn(B, Np, M, O).astype(np.float32)
    centers = rs.randn(B, N, M, O).astype(np.float32)
    idx = rs.randint(0, Np, (B, N, K)).astype(np.int32)
    close(tsp.assign_score_withk(t(scores), t(points), t(centers), t(idx),
                                 aggregate),
          jsp.assign_score_withk(jnp.asarray(scores), jnp.asarray(points),
                                 jnp.asarray(centers), jnp.asarray(idx),
                                 aggregate))


def test_coord_hash_matches_jax_on_negative_and_large_coordinates():
    rs = np.random.RandomState(16)
    c = rs.randint(-2 ** 31, 2 ** 31 - 1, (200, 3)).astype(np.int32)
    c[:20] = rs.randint(-3, 3, (20, 3))
    for size in (16, 97, 4096):
        same_index(tsp._coord_hash(t(c), size),
                   jsp._coord_hash(jnp.asarray(c), size))


def _brute_force_insert(h, size):
    full = np.zeros(size, bool)
    ok = np.zeros(len(h), bool)
    for i, s in enumerate(h):
        for j in range(tsp._PROBES):
            if not full[(s + j) % size]:
                full[(s + j) % size] = ok[i] = True
                break
    return ok


@pytest.mark.parametrize("n,size,spread", [(50, 16, 16), (60, 200, 40),
                                           (150, 160, 160), (300, 250, 250),
                                           (400, 4000, 4000)])
def test_insert_ok_is_the_sequential_probe(n, size, spread):
    """Which inserts the probe budget drops, against the one-by-one
    insert: small tables, clustered hashes (runs past 64 slots), a table
    filled past its size, and a sparse one."""
    h = np.random.RandomState(n + size).randint(0, spread, n)
    got = tsp._insert_ok(t(h.astype(np.int64)), size).numpy()
    np.testing.assert_array_equal(got, _brute_force_insert(h, size))


def _voxels(seed, V=36, extent=5, pad=4):
    rs = np.random.RandomState(seed)
    coords = rs.randint(0, extent, (V, 3)).astype(np.int32)
    coords[3] = coords[1]                        # a duplicate site
    coords = np.concatenate([coords, np.zeros((pad, 3), np.int32)])
    valid = np.concatenate([np.ones(V, bool), np.zeros(pad, bool)])
    valid[7] = False
    feats = rs.randn(V + pad, 4).astype(np.float32) * valid[:, None]
    return coords, valid, feats


@pytest.mark.parametrize("hash_size", [None, 16, 40, 70])
def test_build_indice_pairs_and_submanifold_conv(hash_size, monkeypatch):
    coords, valid, feats = _voxels(17)
    offs = tsp._centered_offsets(3, "cpu").numpy()
    want = jsp.build_indice_pairs(jnp.asarray(coords), jnp.asarray(valid),
                                  jnp.asarray(offs), hash_size)
    got = tsp.build_indice_pairs(t(coords), t(valid), t(offs), hash_size)
    same_index(got, want)
    if hash_size is None:
        w = np.random.RandomState(18).randn(27, 4, 6).astype(np.float32)
        b = np.random.RandomState(19).randn(6).astype(np.float32)
        close(tsp.submanifold_conv3d(t(feats), t(coords), t(valid), t(w),
                                     t(b)),
              jsp.submanifold_conv3d(jnp.asarray(feats), jnp.asarray(coords),
                                     jnp.asarray(valid), jnp.asarray(w),
                                     jnp.asarray(b)))


@pytest.mark.parametrize("capacity,spatial", [(None, None), (None, (5, 5, 5)),
                                              (9, None)])
def test_strided_conv_inverse_and_maxpool(capacity, spatial):
    coords, valid, feats = _voxels(20, V=20, extent=6)
    rs = np.random.RandomState(21)
    w = rs.randn(27, 4, 3).astype(np.float32)
    b = rs.randn(3).astype(np.float32)
    want = jsp.sparse_conv3d(jnp.asarray(feats), jnp.asarray(coords),
                             jnp.asarray(valid), jnp.asarray(w), 2, 1,
                             jnp.asarray(b), capacity, spatial)
    got = tsp.sparse_conv3d(t(feats), t(coords), t(valid), t(w), 2, 1, t(b),
                            capacity, spatial)
    close(got[0], want[0])
    for g, wnt in zip(got[1:], want[1:]):
        same_index(g, wnt)
    wi = rs.randn(27, 3, 4).astype(np.float32)
    close(tsp.sparse_inverse_conv3d(got[0], got[3], t(wi), len(coords),
                                    t(b[:1].repeat(4))),
          jsp.sparse_inverse_conv3d(want[0], want[3], jnp.asarray(wi),
                                    len(coords),
                                    jnp.asarray(b[:1].repeat(4))))
    jm = jsp.sparse_maxpool3d(jnp.asarray(feats), jnp.asarray(coords),
                              jnp.asarray(valid), 2, None, 0, capacity,
                              spatial)
    tm = tsp.sparse_maxpool3d(t(feats), t(coords), t(valid), 2, None, 0,
                              capacity, spatial)
    close(tm[0], jm[0])
    same_index(tm[1], jm[1])
    same_index(tm[2], jm[2])
    shape = (3, 3, 3)
    close(tsp.to_dense(tm[0], tm[1], tm[2], shape),
          jsp.to_dense(jm[0], jm[1], jm[2], shape))


def test_strided_output_sites_past_a_small_table():
    """capacity 3: the output table has 16 slots (max(4 * 3, 16)), the
    sites take them in first-occurrence order and the rest are dropped."""
    coords, valid, _ = _voxels(22, V=12, extent=8)
    want = jsp.build_strided_output(jnp.asarray(coords), jnp.asarray(valid),
                                    3, 2, 1, 3)
    got = tsp.build_strided_output(t(coords), t(valid), 3, 2, 1, 3)
    for g, w in zip(got, want):
        same_index(g, w)


# ---- Boxes3D ----------------------------------------------------------------

def test_boxes3d_against_jax():
    rs = np.random.RandomState(23)
    arr = np.concatenate([rs.randn(12, 3) * 4, rs.rand(12, 3) * 3 + 0.5,
                          rs.randn(12, 1)], 1).astype(np.float32)
    arr[5] = arr[4] + [0.2, 0.1, 0, 0, 0, 0, 0.05]    # overlapping pair
    pts = (rs.randn(60, 4) * 3).astype(np.float32)
    scores = rs.rand(12).astype(np.float32)
    for ctor in ("lidar", "depth"):
        jb, tb = getattr(JBoxes3D, ctor)(arr), getattr(Boxes3D, ctor)(arr)
        assert len(tb) == len(jb) == 12 and tb.origin_z == jb.origin_z
        for name in ("center", "dims", "yaw", "volume"):
            close(getattr(tb, name), getattr(jb, name))
        for name in ("corners", "corners_bev"):
            close(getattr(tb, name)(), getattr(jb, name)())
        same_index(tb.points_in_boxes(t(pts)),
                   jb.points_in_boxes(jnp.asarray(pts)))
        for tv, jv in ((tb.gravity(), jb.gravity()), (tb.bottom(),
                                                      jb.bottom()),
                       (tb.rotate(0.7), jb.rotate(0.7)),
                       (tb.translate([1.0, -2.0, 0.5]),
                        jb.translate(jnp.asarray([1.0, -2.0, 0.5]))),
                       (tb.scale(1.5), jb.scale(1.5))):
            close(tv.tensor, jv.tensor)
            assert tv.origin_z == jv.origin_z
        other_j, other_t = jb.rotate(0.3), tb.rotate(0.3)
        close(tb.iou_bev(other_t), jb.iou_bev(other_j))
        close(tb.iou_3d(other_t), jb.iou_3d(other_j))
        for thresh, max_out in ((0.1, 12), (0.5, 4)):
            same_index(tb.nms(t(scores), thresh, max_out),
                       jb.nms(jnp.asarray(scores), thresh, max_out))
    assert tb.nms(t(scores), 0.1).shape == (12,)


def test_indice_pairs_at_coordinates_far_apart():
    """Coordinates across the int32 range (the rulebook's keys then come
    from a sort of the rows, not a linear id): the same pairs as JAX's."""
    coords, valid, _ = _voxels(24, V=16, extent=3)
    coords[:4] += np.array([2 ** 30, -2 ** 30, 7], np.int32)
    coords[4:6] = coords[0] + np.array([[1, 0, 0], [0, 0, -1]], np.int32)
    offs = tsp._centered_offsets(3, "cpu").numpy()
    same_index(tsp.build_indice_pairs(t(coords), t(valid), t(offs)),
               jsp.build_indice_pairs(jnp.asarray(coords),
                                      jnp.asarray(valid), jnp.asarray(offs)))
