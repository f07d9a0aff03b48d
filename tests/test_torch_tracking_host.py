"""The port's host-cache tracking path against the JAX package: FeatureCache,
PairScorer.make_frame_fn / score_frame, TrackingManager(device_cache=False)
with NMS, gt ids and an eval recorder, the image branch's crop_fn and
camera-crop host paths, and the port's device and host caches against each
other. JAX's crop draws are injected into the port (tests/_torch_port)."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.evaluation import (  # noqa: E402
    TrackingEvalAccumulator as JaxRecorder)
from point_cloud_reid_tpu.inference import FeatureCache as JaxCache  # noqa: E402
from point_cloud_reid_tpu.inference import PairScorer as JaxScorer  # noqa: E402
from point_cloud_reid_tpu.ops import boxes_iou_bev as jax_iou_bev  # noqa: E402
from point_cloud_reid_tpu.ops import nms_bev as jax_nms_bev  # noqa: E402
from point_cloud_reid_tpu.tracking import image_crops as jcrops  # noqa: E402
from point_cloud_reid_tpu_torch.evaluation import (  # noqa: E402
    TrackingEvalAccumulator)
from point_cloud_reid_tpu_torch.inference import FeatureCache, PairScorer  # noqa: E402
from point_cloud_reid_tpu_torch.tracking import TrackingManager  # noqa: E402
from point_cloud_reid_tpu_torch.tracking import image_crops as tcrops  # noqa: E402
from tests._torch_port import (N_PTS, crops, jax_uniform_crops,  # noqa: E402
                               tiny_models)
from tests._torch_threads import few_threads  # noqa: E402,F401

# the full model's bar (tests/test_convert_full_model.py)
TOL = 1e-3
NMS_THRESH = 0.5
jax_manager = importlib.import_module("point_cloud_reid_tpu.tracking.manager")


def jax_manager_with_nms_max_out(monkeypatch):
    """The JAX manager's nms_bev call with max_out = D, the argument it
    lacks (tests/test_torch_boxes.py shows the TypeError)."""
    monkeypatch.setattr(
        jax_manager, "nms_bev",
        lambda b, s, t: jax_nms_bev(b, s, t, max_out=b.shape[0]))


def port_split_stream(port_cls):
    """A JAX manager subclass whose split-chain crop key is PRNGKey(k) for
    the k the port seeds its second crop stream with."""
    class Manager(jax_manager.TrackingManager):
        def __init__(self, *a, seed=0, **k):
            super().__init__(*a, seed=seed, **k)
            self._port_rng_seed = seed * 1_000_003 + port_cls._RNG_OFFSET

        def _next_rng(self):
            self._port_rng_seed += 1
            return jax.random.PRNGKey(self._port_rng_seed)
    return Manager


def test_feature_cache_matches_jax():
    rs = np.random.RandomState(0)
    h = rs.randn(4, 6, 5).astype(np.float32)
    xyz = rs.randn(4, 6, 3).astype(np.float32)
    caches = (JaxCache(), FeatureCache())
    for c in caches:
        c.update([3, 7, 1], h[:3], xyz[:3])
        c.update([7], h[3:], xyz[3:])
        c.drop([1, 99])
    got, want = caches[1].gather([7, 3]), caches[0].gather([7, 3])
    assert len(caches[1]) == len(caches[0]) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # tensors are fetched as they are; no xyz stored -> None
    t = FeatureCache()
    t.update([5], torch.from_numpy(h[:1]))
    hg, xg = t.gather([5])
    np.testing.assert_array_equal(hg, h[:1])
    assert xg is None


def _sweep(seed: int, n_obj: int = 5, per_obj: int = 40, n_pad: int = 2048):
    rs = np.random.RandomState(seed)
    centers = (rs.rand(n_obj, 3) * 16 - 8).astype(np.float32)
    centers[:, 2] = 0.0
    boxes = np.full((8, 7), 1e6, np.float32)
    boxes[:n_obj] = np.concatenate(
        [centers, np.full((n_obj, 3), 2.0, np.float32),
         (rs.rand(n_obj, 1) * 3).astype(np.float32)], axis=1)
    pts = np.full((n_pad, 3), 1e6, np.float32)
    pts[:n_obj * per_obj] = (np.repeat(centers, per_obj, axis=0)
                             + rs.randn(n_obj * per_obj, 3) * 0.5)
    return pts, boxes


@pytest.mark.parametrize("mode", ["crop_points", "crops"])
def test_make_frame_fn_matches_jax(monkeypatch, mode):
    """One host-cache frame for an (8, 8) bucket: logits, det features and
    det xyz within the full-model bar; on-device crops from a named seed or
    a pre-cut crop batch."""
    jax_uniform_crops(monkeypatch)
    jmodel, jvars, tmodel = tiny_models()
    with torch.no_grad():
        xyz_t, h_t = tmodel.embed(torch.from_numpy(crops(40, 8)))
    pts, boxes = _sweep(1)
    if mode == "crop_points":
        jdets = (np.int32(11), jnp.asarray(pts), jnp.asarray(boxes))
        tdets = (11, torch.from_numpy(pts), torch.from_numpy(boxes))
        kw = dict(crop_points=N_PTS)
    else:
        c = crops(41, 8)
        jdets, tdets, kw = jnp.asarray(c), torch.from_numpy(c), {}
    jfn = JaxScorer(jmodel, jvars).make_frame_fn(8, 8, **kw)
    tscorer = PairScorer(tmodel)
    tfn = tscorer.make_frame_fn(8, 8, **kw)
    jout = jfn(jnp.asarray(h_t.numpy()), jnp.asarray(xyz_t.numpy()), jdets)
    tout = tfn(h_t, xyz_t, tdets)
    for name, t, j in zip(("logits", "h_d", "xyz_d"), tout, jout):
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL, err_msg=name)
    assert tscorer.last_frame["logits"] is tout[0]
    with pytest.raises(ValueError, match="bucket"):
        tfn(h_t[:4], xyz_t[:4], tdets)


def test_score_frame_matches_jax():
    """Against a FeatureCache, with class gating; a frame without tracks
    gives a (0, n_dets) matrix."""
    jmodel, jvars, tmodel = tiny_models()
    with torch.no_grad():
        xyz_t, h_t = tmodel.embed(torch.from_numpy(crops(42, 3)))
    det = crops(43, 5)
    jc, tc = JaxCache(), FeatureCache()
    jc.update([4, 8, 9], h_t.numpy(), xyz_t.numpy())
    tc.update([4, 8, 9], h_t, xyz_t)
    cls_t, cls_d = np.array([0, 1, 0]), np.array([0, 0, 1, 1, 0])
    jscorer, tscorer = JaxScorer(jmodel, jvars), PairScorer(tmodel)
    want = jscorer.score_frame(jc, [9, 4, 8], jnp.asarray(det), cls_t, cls_d)
    got = tscorer.score_frame(tc, [9, 4, 8], torch.from_numpy(det), cls_t,
                              cls_d)
    w, g = np.asarray(want[0]), got[0].numpy()
    assert g.shape == (3, 5)
    np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
    fin = np.isfinite(w)
    np.testing.assert_allclose(g[fin], w[fin], rtol=TOL, atol=TOL)
    for t, j in zip(got[1:], want[1:]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL)
    empty = tscorer.score_frame(tc, [], torch.from_numpy(det))[0]
    assert empty.shape == (0, 5)


def _scene():
    """Five well-separated objects of two classes over six frames, with gt
    ids: frame 0 and 1 carry one near-duplicate box each (lower score, gt
    -1) that NMS removes, frame 2 has no detection, frame 3 a single one (so
    NMS is skipped, and the other tracks age out), frame 5 a detector
    false positive. The scene ends with live tracks. No duplicate's BEV IoU
    lies within 1e-4 of NMS_THRESH."""
    rs = np.random.RandomState(5)
    centers = np.array([[-8, -4, 0], [-2, 5, 0], [4, -6, 0], [9, 3, 0],
                        [0, -1, 0]], np.float32)
    labels = np.array([0, 1, 0, 1, 0], np.int64)
    frames = []
    for t in range(6):
        centers[:, :2] += rs.randn(5, 2).astype(np.float32) * 0.2
        boxes = np.concatenate(
            [centers, np.full((5, 3), 2.0, np.float32),
             (rs.rand(5, 1) * 0.3).astype(np.float32)], axis=1)
        scores = (0.6 + 0.3 * rs.rand(5)).astype(np.float32)
        gt, lab = np.arange(5, dtype=np.int64), labels.copy()
        if t in (0, 1):
            dup = boxes[2 * t] + np.array([0.3, 0.2, 0, 0, 0, 0, 0.05],
                                          np.float32)
            boxes = np.concatenate([boxes, dup[None]])
            scores = np.append(scores, 0.3).astype(np.float32)
            gt, lab = np.append(gt, -1), np.append(lab, lab[2 * t])
        keep = {2: [], 3: [3]}.get(t, slice(None))
        if t == 5:
            boxes = np.concatenate([boxes, [[20, 20, 0, 2, 2, 2, 0]]]
                                   ).astype(np.float32)
            scores = np.append(scores, 0.5).astype(np.float32)
            gt, lab = np.append(gt, -1), np.append(lab, 1)
        pts = (np.repeat(centers, 40, axis=0)
               + rs.randn(200, 3).astype(np.float32) * 0.4)
        frames.append((pts, boxes[keep], scores[keep], lab[keep], gt[keep]))
    return frames


def _recorded(jax_cls, port_cls, j_logits, t_logits):
    class JaxRec(jax_cls):
        def _full_frame_fn(self, t_pad, d_pad):
            fn = super()._full_frame_fn(t_pad, d_pad)

            def call(*a):
                out = fn(*a)
                j_logits.append(np.asarray(out[0], np.float64))
                return out
            return call

    class TorchRec(port_cls):
        def _step_host_cache(self, *a):
            out = super()._step_host_cache(*a)
            t_logits.append(out[0].copy())
            return out
    return JaxRec, TorchRec


def _check_logits(t_logits, j_logits, rtol=TOL, atol=TOL):
    assert len(t_logits) == len(j_logits) > 0
    for t, j in zip(t_logits, j_logits):
        j = j[:t.shape[0], :t.shape[1]]
        np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)


def test_host_cache_manager_matches_jax(monkeypatch):
    """device_cache=False with NMS, gt ids and an eval recorder: the same
    tracks (ids and boxes) every frame, the logits within the full-model
    bar, the same NMS survivors and an equal tracking-eval summary after
    end_scene."""
    jax_uniform_crops(monkeypatch)
    jax_manager_with_nms_max_out(monkeypatch)
    jmodel, jvars, tmodel = tiny_models()
    frames = _scene()
    for _, boxes, _, _, _ in frames[:2]:
        iou = np.asarray(jax_iou_bev(jnp.asarray(boxes), jnp.asarray(boxes)))
        assert np.abs(iou - NMS_THRESH).min() > 1e-4
    j_logits, t_logits = [], []
    JaxRec, TorchRec = _recorded(port_split_stream(TrackingManager),
                                 TrackingManager, j_logits, t_logits)
    kw = dict(subsample_number=N_PTS, seed=2, match_threshold=1.0,
              max_age=1, nms_threshold=NMS_THRESH, device_cache=False)
    jrec, trec = JaxRecorder(), TrackingEvalAccumulator()
    jmgr = JaxRec(JaxScorer(jmodel, jvars), eval_recorder=jrec, **kw)
    tmgr = TorchRec(PairScorer(tmodel), eval_recorder=trec, **kw)
    n_tracks = []
    for frame in frames:
        jt = jmgr.step(*frame[:4], det_gt_ids=frame[4])
        tt = tmgr.step(*frame[:4], det_gt_ids=frame[4])
        assert [t.track_id for t in tt] == [t.track_id for t in jt]
        for a, b in zip(tt, jt):
            np.testing.assert_array_equal(a.box, b.box)
        assert sorted(tmgr.cache._h) == sorted(jmgr.cache._h)
        n_tracks.append(len(tmgr.store))
    assert tmgr._dc.h_buf is None and len(tmgr.cache) == 6
    assert n_tracks == [5, 5, 5, 1, 5, 6]        # duplicates never tracked
    _check_logits(t_logits, j_logits)
    jmgr.end_scene()
    tmgr.end_scene()
    got, want = trec.summary(), jrec.summary()
    assert got == want
    assert got["association"]["fp_matches"] == 0 and got["scenes"] == 1
    assert sum(got["track_stats"]["length_frequency"].values()) == 10


def test_device_and_host_caches_track_alike():
    """The port's device-cache and host-cache managers give the same track
    ids on a well-separated scene (the JAX package's
    test_device_cache_matches_host_cache_tracking): the crop streams
    differ, the gate makes association unambiguous."""
    _, _, tmodel = tiny_models()

    def run(device_cache):
        mgr = TrackingManager(PairScorer(tmodel), subsample_number=N_PTS,
                              match_threshold=1.0, max_distance=5.0, seed=3,
                              device_cache=device_cache)
        rng = np.random.RandomState(11)
        ids = []
        for t in range(5):
            centers = [np.array([0.4 * t, 0, 0]), np.array([30.0, 1.0, 0]),
                       np.array([-25.0 + 0.3 * t, -3.0, 0])]
            boxes = np.stack([np.array([*c, 2, 2, 2, 0.0]) for c in centers]
                             ).astype(np.float32)
            pts = np.concatenate([c + rng.randn(40, 3) * 0.3
                                  for c in centers]).astype(np.float32)
            tracks = mgr.step(pts, boxes, np.ones(3, np.float32),
                              np.zeros(3, np.int64))
            ids.append(sorted(tr.track_id for tr in tracks))
        return ids, mgr

    dev, dmgr = run(True)
    host, hmgr = run(False)
    assert dev == host == [[0, 1, 2]] * 5
    assert dmgr._dc.h_buf is not None and len(dmgr.cache) == 0
    assert hmgr._dc.h_buf is None and len(hmgr.cache) == 3


# ---- image branch -------------------------------------------------------------

W, H = 160, 90


def _image_scene(n_frames: int = 4, n_obj: int = 4):
    """Objects ahead of and behind two cameras, drifting; small float32
    frames (tests/test_torch_image_tracking.py's geometry)."""
    l2c1 = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                     [0, 0, 0, 1]], np.float32)
    l2cs = np.stack([l2c1, l2c1 @ np.diag([-1, -1, 1, 1]).astype(np.float32)])
    K = np.array([[50, 0, 80], [0, 50, 45], [0, 0, 1]], np.float32)
    Ks = np.stack([K, K])
    rs = np.random.RandomState(4)
    images = rs.rand(2, 3, H, W).astype(np.float32)
    side = np.where(np.arange(n_obj) % 2 == 0, 1.0, -1.0)
    centers = np.stack([side * (8.0 + rs.rand(n_obj) * 6.0),
                        rs.rand(n_obj) * 8.0 - 4.0, np.zeros(n_obj)],
                       axis=1).astype(np.float32)
    for _ in range(n_frames):
        centers[:, :2] += rs.randn(n_obj, 2).astype(np.float32) * 0.2
        boxes = np.concatenate(
            [centers, np.full((n_obj, 3), 2.0, np.float32),
             np.zeros((n_obj, 1), np.float32)], axis=1)
        yield ((images, l2cs, Ks), boxes, np.ones(n_obj, np.float32),
               np.zeros(n_obj, np.int64))


@pytest.mark.parametrize("path", ["crop_fn", "camera_crops"])
def test_image_host_cache_manager_matches_jax(path):
    """The image branch on the host cache, at tiny ViT widths: through a
    crop_fn (a closure over each package's crops_per_frame) or through the
    manager's own camera crops (device_cache=False). The same tracks every
    frame; logits rtol 1e-4, atol 1e-5 (the image tracker's bar,
    tests/test_torch_image_tracking.py)."""
    from tests._torch_image import IMAGE_SIZE, tiny_image_models
    jmodel, jvars, tmodel = tiny_image_models()
    j_logits, t_logits = [], []

    class JaxScorerRec(JaxScorer):
        def cost_matrix(self, *a, **k):
            out = super().cost_matrix(*a, **k)
            j_logits.append(np.asarray(out, np.float64))
            return out

    class TorchRec(TrackingManager):
        def _step_host_cache(self, *a):
            out = super()._step_host_cache(*a)
            t_logits.append(out[0].copy())
            return out

    jkw, tkw = {}, {}
    if path == "crop_fn":
        def jcrop(frame, boxes_p):
            im, l2c, K = frame
            return jcrops.crops_per_frame(
                jnp.asarray(im), jnp.asarray(l2c), jnp.asarray(K),
                jnp.asarray(boxes_p), image_size=(W, H),
                output_size=(IMAGE_SIZE, IMAGE_SIZE))[0]

        def tcrop(frame, boxes_p):
            im, l2c, K = frame
            return tcrops.crops_per_frame(
                torch.from_numpy(im), torch.from_numpy(l2c),
                torch.from_numpy(K), torch.from_numpy(boxes_p),
                image_size=(W, H), output_size=(IMAGE_SIZE, IMAGE_SIZE))[0]
        jkw, tkw = dict(crop_fn=jcrop), dict(crop_fn=tcrop)
    else:
        jkw = tkw = dict(device_cache=False)
    kw = dict(seed=1, max_distance=3.0, match_threshold=1.0)
    jmgr = jax_manager.TrackingManager(
        JaxScorerRec(jmodel, jvars, image_mode=True), **kw, **jkw)
    tmgr = TorchRec(PairScorer(tmodel, image_mode=True), **kw, **tkw)
    for frame in _image_scene():
        jt = jmgr.step(*frame)
        tt = tmgr.step(*frame)
        assert [t.track_id for t in tt] == [t.track_id for t in jt]
        for a, b in zip(tt, jt):
            np.testing.assert_array_equal(a.box, b.box)
    assert len(tt) == 4 and tmgr._dc.h_buf is None
    assert tmgr.cache.gather([0])[1] is None          # no xyz kept
    _check_logits(t_logits, j_logits, rtol=1e-4, atol=1e-5)
