"""The port's rotated-box geometry and BEV NMS against the JAX package's
ops/boxes.py, and the reference's NMS call in TrackingManager."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.ops import boxes as jb  # noqa: E402
from point_cloud_reid_tpu_torch.ops import boxes as tb  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

# float32 polygon clipping on both sides; only the rounding differs
TOL = 1e-5


def _cases() -> np.ndarray:
    """Rotated boxes (x, y, z, dx, dy, dz, yaw): a disjoint pair, a nested
    pair, an identical pair, an edge-touching pair, partly overlapping
    rotated ones, and seeded random boxes."""
    rs = np.random.RandomState(0)
    named = np.array([
        [0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0],
        [10.0, 10.0, 0.0, 2.0, 1.0, 1.5, 0.7],       # disjoint from all
        [0.1, -0.1, 0.2, 0.8, 0.6, 1.0, 0.4],        # nested in box 0
        [0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0],         # identical to box 0
        [2.0, 0.0, 0.5, 2.0, 2.0, 2.0, 0.0],         # touches box 0's edge
        [0.9, 0.8, -0.3, 2.5, 1.2, 1.0, 0.6],        # partial, rotated
        [-0.7, 0.5, 0.1, 3.0, 0.9, 2.5, -1.1],       # partial, rotated
    ], np.float32)
    rand = np.concatenate([rs.rand(9, 2) * 5, rs.rand(9, 1) - 0.5,
                           rs.rand(9, 3) * 2 + 0.5, rs.rand(9, 1) * 6 - 3],
                          axis=1).astype(np.float32)
    return np.concatenate([named, rand])


@pytest.mark.parametrize("fn", ["boxes_overlap_bev", "boxes_iou_bev",
                                "boxes_iou_3d"])
def test_overlaps_and_ious_match_jax(fn):
    b = _cases()
    a = b[:11]
    want = np.asarray(getattr(jb, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tb, fn)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (11, len(b))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if fn != "boxes_overlap_bev":
        assert abs(got[0, 1]) <= TOL                     # disjoint
        assert abs(got[0, 3] - 1.0) <= TOL               # identical
        assert abs(got[0, 4]) <= TOL                     # edge-touching
    if fn == "boxes_iou_bev":                            # nested: area ratio
        assert abs(got[0, 2] - 0.8 * 0.6 / 4.0) <= TOL
    assert tb.boxes_iou_bev(torch.zeros((0, 7)),
                            torch.from_numpy(b)).shape == (0, len(b))


def test_points_to_box_frame_matches_jax():
    rs = np.random.RandomState(1)
    pts = (rs.randn(50, 3) * 3).astype(np.float32)
    for box in _cases()[:7]:
        want = np.asarray(jb.points_to_box_frame(jnp.asarray(pts),
                                                 jnp.asarray(box)))
        got = tb.points_to_box_frame(torch.from_numpy(pts),
                                     torch.from_numpy(box)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("thresh", [0.05, 0.3, 0.6])
def test_nms_bev_keep_lists_match_jax(thresh):
    """Keep lists equal to JAX nms_bev(..., max_out=n), tied scores (index
    order wins) included, and with a max_out that cuts the list. No IoU of
    the boxes lies within 1e-4 of a threshold, so float rounding cannot
    flip a suppression."""
    b = _cases()
    iou = np.asarray(jb.boxes_iou_bev(jnp.asarray(b), jnp.asarray(b)))
    assert np.abs(iou - thresh).min() > 1e-4
    scores = np.random.RandomState(2).rand(len(b)).astype(np.float32)
    scores[[0, 3, 5, 9]] = 0.5                           # ties
    for max_out in (len(b), 3):
        want = np.asarray(jb.nms_bev(jnp.asarray(b), jnp.asarray(scores),
                                     thresh, max_out))
        got = tb.nms_bev(torch.from_numpy(b), torch.from_numpy(scores),
                         thresh, max_out)
        assert got.dtype == torch.int64 and got.shape == (max_out,)
        np.testing.assert_array_equal(got.numpy(), want)
    kept = got.numpy()
    assert (kept >= 0).sum() == 3 and kept[0] == np.argmax(scores)


def _frame():
    boxes = np.array([[0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0],
                      [0.3, 0.2, 0.0, 2.0, 2.0, 2.0, 0.1],   # duplicate
                      [6.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0]], np.float32)
    return boxes, np.array([0.9, 0.6, 0.8], np.float32)


def test_reference_manager_nms_call_lacks_max_out():
    """The JAX TrackingManager calls nms_bev(boxes, scores, thresh) without
    the max_out that nms_bev requires, so any frame of 2+ detections with
    nms_threshold set raises; the port's manager passes max_out = D and
    keeps what nms_bev(..., max_out=D) keeps."""
    from point_cloud_reid_tpu_torch.inference import PairScorer
    from point_cloud_reid_tpu_torch.tracking import TrackingManager
    from tests._torch_port import tiny_torch_model

    jmgr_mod = importlib.import_module("point_cloud_reid_tpu.tracking.manager")

    class _NoScorer:
        image_mode = False

    boxes, scores = _frame()
    jmgr = jmgr_mod.TrackingManager(_NoScorer(), nms_threshold=0.5)
    with pytest.raises(TypeError, match="max_out"):
        jmgr.step(np.zeros((10, 3), np.float32), boxes, scores,
                  np.zeros(3, np.int64))

    tmgr = TrackingManager(PairScorer(tiny_torch_model()),
                           subsample_number=32, nms_threshold=0.5)
    keep = tmgr._nms(boxes, scores)
    want = np.asarray(jb.nms_bev(jnp.asarray(boxes), jnp.asarray(scores),
                                 0.5, 3))
    np.testing.assert_array_equal(keep, want[want >= 0])
    np.testing.assert_array_equal(keep, [0, 2])
    pts = (np.repeat(boxes[[0, 2], :3], 40, axis=0)
           + np.random.RandomState(0).randn(80, 3).astype(np.float32) * 0.4)
    tracks = tmgr.step(pts, boxes, scores, np.zeros(3, np.int64))
    assert sorted(tuple(t.box[:2]) for t in tracks) == [(0.0, 0.0),
                                                         (6.0, 0.0)]
