"""The port's image tracking slice against the JAX package on the CPU: camera
crops (float32 and uint8 frames, an invisible and a padded box), the cached
image frame functions, and TrackingManager over an image PairScorer."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.inference import PairScorer as JaxScorer  # noqa: E402
from point_cloud_reid_tpu.tracking import TrackingManager as JaxManager  # noqa: E402
from point_cloud_reid_tpu.tracking import image_crops as jcrops  # noqa: E402
from point_cloud_reid_tpu_torch.inference import PairScorer  # noqa: E402
from point_cloud_reid_tpu_torch.tracking import TrackingManager  # noqa: E402
from point_cloud_reid_tpu_torch.tracking import image_crops as tcrops  # noqa: E402
from tests._torch_image import IMAGE_SIZE, tiny_image_models  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

W, H = 160, 90


def _cameras():
    """Two cameras at the origin, one looking down +x, one down -x."""
    l2c1 = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                     [0, 0, 0, 1]], np.float32)
    l2c2 = l2c1 @ np.diag([-1, -1, 1, 1]).astype(np.float32)
    K = np.array([[50, 0, 80], [0, 50, 45], [0, 0, 1]], np.float32)
    return np.stack([l2c1, l2c2]), np.stack([K, K])


def _boxes():
    """Ahead, behind, off-axis, one no camera sees (straight above), and a
    padded slot as TrackingManager fills it (all seven entries 1e6: a huge
    box that the first camera does see)."""
    return np.array([[10.0, 0, 0, 2, 2, 2, 0.3],
                     [-8.0, 1, 0, 1, 2, 1.5, 0.0],
                     [12.0, -2, 0.5, 2, 1, 1, 1.0],
                     [0.0, 0.0, 30.0, 2, 2, 2, 0.0],
                     [1e6] * 7], np.float32)


def test_project_boxes_matches_jax():
    l2cs, Ks = _cameras()
    boxes = _boxes()
    uv, vis = tcrops.project_boxes(torch.from_numpy(boxes),
                                   torch.from_numpy(l2cs),
                                   torch.from_numpy(Ks), (W, H))
    assert uv.shape == (2, 5, 8, 2) and vis.shape == (2, 5)
    for c in range(2):
        juv, jvis = jcrops.project_boxes(jnp.asarray(boxes),
                                         jnp.asarray(l2cs[c]),
                                         jnp.asarray(Ks[c]), (W, H))
        np.testing.assert_array_equal(vis[c].numpy(), np.asarray(jvis))
        live = np.asarray(jvis)
        np.testing.assert_allclose(uv[c].numpy()[live], np.asarray(juv)[live],
                                   rtol=1e-5, atol=1e-3)
        # one camera alone gives the same as the stack
        uv1, vis1 = tcrops.project_boxes(torch.from_numpy(boxes),
                                         torch.from_numpy(l2cs[c]),
                                         torch.from_numpy(Ks[c]), (W, H))
        assert torch.equal(vis1, vis[c])
        assert torch.equal(uv1[vis1], uv[c][vis1])
    assert vis.numpy().tolist() == [[True, False, True, False, True],
                                    [False, True, False, False, False]]


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_crops_per_frame_matches_jax(dtype):
    """atol 1e-5, the JAX suite's bar (tests/test_image_crops.py); the
    camera choice and the valid mask are equal."""
    l2cs, Ks = _cameras()
    boxes = _boxes()
    imgs = np.random.RandomState(3).randint(0, 256, (2, 3, H, W)).astype(
        np.uint8)
    if dtype == "float32":
        imgs = imgs.astype(np.float32) / 255.0
    want, jvalid = jcrops.crops_per_frame(
        jnp.asarray(imgs), jnp.asarray(l2cs), jnp.asarray(Ks),
        jnp.asarray(boxes), image_size=(W, H), output_size=(16, 16))
    got, valid = tcrops.crops_per_frame(
        torch.from_numpy(imgs), torch.from_numpy(l2cs), torch.from_numpy(Ks),
        torch.from_numpy(boxes), image_size=(W, H), output_size=(16, 16))
    assert got.shape == (5, 3, 16, 16) and got.dtype == torch.float32
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.numpy().tolist() == [True, True, True, False, True]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert float(got[3].abs().sum()) == 0.0 and bool(torch.isfinite(got).all())
    # the band gather is extract_crops on the chosen camera's image
    if dtype == "float32":
        uv, vis = tcrops.project_boxes(torch.from_numpy(boxes[:1]),
                                       torch.from_numpy(l2cs[0]),
                                       torch.from_numpy(Ks[0]), (W, H))
        one = tcrops.extract_crops(torch.from_numpy(imgs[0]),
                                   tcrops.boxes_2d(uv, (W, H)), (16, 16))
        np.testing.assert_allclose(one[0].numpy(), got[0].numpy(), rtol=0,
                                   atol=1e-6)


def _scene(n_frames: int = 4, n_obj: int = 6):
    """Objects ahead of and behind the two cameras, drifting; one missed
    detection; two classes. Small float32 frames."""
    l2cs, Ks = _cameras()
    rs = np.random.RandomState(4)
    images = rs.rand(2, 3, H, W).astype(np.float32)
    side = np.where(np.arange(n_obj) % 2 == 0, 1.0, -1.0)
    centers = np.stack([side * (8.0 + rs.rand(n_obj) * 6.0),
                        rs.rand(n_obj) * 8.0 - 4.0, np.zeros(n_obj)],
                       axis=1).astype(np.float32)
    labels = np.array([0, 1] * (n_obj // 2), np.int64)
    for t in range(n_frames):
        centers[:, :2] += rs.randn(n_obj, 2).astype(np.float32) * 0.2
        keep = np.ones(n_obj, bool)
        if t == 2:
            keep[1] = False
        boxes = np.concatenate(
            [centers, np.full((n_obj, 3), 2.0, np.float32),
             np.zeros((n_obj, 1), np.float32)], axis=1)[keep]
        yield ((images, l2cs, Ks), boxes, np.ones(keep.sum(), np.float32),
               labels[keep])


@pytest.mark.parametrize("sparse", ["never", "always"])
def test_image_tracking_manager_steps_match_jax(sparse):
    """Same scene on both managers: the same track ids and boxes every frame
    and the same logits (rtol 1e-4, atol 1e-5), dense and gated sparse."""
    jmodel, jvars, tmodel = tiny_image_models()
    j_logits, t_logits = [], []

    class JaxRec(JaxManager):
        def _step_device_cached_image(self, *a, **k):
            out = super()._step_device_cached_image(*a, **k)
            j_logits.append(out[0])
            return out

    class TorchRec(TrackingManager):
        def _step_device_cached_image(self, *a, **k):
            out = super()._step_device_cached_image(*a, **k)
            t_logits.append(out)
            return out

    kw = dict(seed=1, sparse_scoring=sparse, max_distance=3.0)
    jmgr = JaxRec(JaxScorer(jmodel, jvars, image_mode=True), **kw)
    tscorer = PairScorer(tmodel, image_mode=True)
    tmgr = TorchRec(tscorer, **kw)
    for frame in _scene():
        jt = jmgr.step(*frame)
        tt = tmgr.step(*frame)
        assert [t.track_id for t in tt] == [t.track_id for t in jt]
        for a, b in zip(tt, jt):
            np.testing.assert_array_equal(a.box, b.box)
    assert tmgr._image_sizes == ((W, H), (IMAGE_SIZE, IMAGE_SIZE))
    assert tmgr._dc.xyz_buf is None and tmgr._dc.h_buf.shape[1:] == (6, 16)
    assert len(t_logits) == len(j_logits) == 4
    scored = 0
    for t, j in zip(t_logits, j_logits):
        assert (t is None) == (j is None)
        if t is not None:
            np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
            fin = np.isfinite(j)
            scored += fin.sum()
            np.testing.assert_allclose(t[fin], j[fin], rtol=1e-4, atol=1e-5)
    assert scored > 0
    last = tscorer.last_frame
    assert last["xyz_t"] is None and (last["pairs"] is None) == (
        sparse == "never")


def test_uint8_frames_track_like_float32_frames():
    """uint8 frames go up as they are and give the float32 frames' logits."""
    _, _, tmodel = tiny_image_models()
    logits = {}
    for dtype in ("float32", "uint8"):
        scorer = PairScorer(tmodel, image_mode=True)
        mgr = TrackingManager(scorer, sparse_scoring="never",
                              max_distance=3.0)
        for (images, l2cs, Ks), *dets in _scene(2):
            u8 = np.round(images * 255).astype(np.uint8)
            frame = u8 if dtype == "uint8" else u8.astype(np.float32) / 255.0
            mgr.step((frame, l2cs, Ks), *dets)
        logits[dtype] = scorer.last_frame["logits"].numpy()
    np.testing.assert_allclose(logits["uint8"], logits["float32"],
                               rtol=1e-4, atol=1e-5)
