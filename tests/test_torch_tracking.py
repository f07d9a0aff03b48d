"""The port's tracking slice against the JAX package: box crops, the cached
PairScorer frames and TrackingManager.step, with JAX's crop draws injected
into the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.inference import PairScorer as JaxScorer  # noqa: E402
from point_cloud_reid_tpu.tracking import TrackingManager as JaxManager  # noqa: E402
from point_cloud_reid_tpu.tracking.crops import (  # noqa: E402
    extract_box_crops as jax_crops)
from point_cloud_reid_tpu_torch.inference import PairScorer  # noqa: E402
from point_cloud_reid_tpu_torch.tracking import TrackingManager  # noqa: E402
from point_cloud_reid_tpu_torch.tracking.crops import (  # noqa: E402
    extract_box_crops)
from tests._torch_port import (N_PTS, crops, jax_uniform_crops,  # noqa: E402
                               tiny_models)
from tests._torch_threads import few_threads  # noqa: E402,F401

# the full model's bar (tests/test_convert_full_model.py)
TOL = 1e-3


def _sweep(seed: int, n_obj: int = 6, per_obj: int = 40, n_pad: int = 2048):
    rs = np.random.RandomState(seed)
    centers = (rs.rand(n_obj, 3) * 16 - 8).astype(np.float32)
    centers[:, 2] = 0.0
    boxes = np.concatenate(
        [centers, np.full((n_obj, 3), 2.0, np.float32),
         (rs.rand(n_obj, 1) * 3).astype(np.float32)], axis=1)
    pts = np.full((n_pad, 3), 1e6, np.float32)
    pts[:n_obj * per_obj] = (np.repeat(centers, per_obj, axis=0)
                             + rs.randn(n_obj * per_obj, 3) * 0.5)
    boxes_p = np.full((8, 7), 1e6, np.float32)
    boxes_p[:n_obj] = boxes
    boxes_p[n_obj] = [30.0, 30.0, 0.0, 2.0, 2.0, 2.0, 0.0]   # an empty box
    return pts, boxes_p


def test_extract_box_crops_matches_jax(monkeypatch):
    """With JAX's uniform draws injected the selection is identical: counts
    exactly, crops to 1e-6 (the same points through the same rotation)."""
    jax_uniform_crops(monkeypatch)
    pts, boxes = _sweep(0)
    want, wcounts = jax_crops(jax.random.PRNGKey(123), jnp.asarray(pts),
                              jnp.asarray(boxes), N_PTS)
    got, counts = extract_box_crops(torch.Generator().manual_seed(123),
                                    torch.from_numpy(pts),
                                    torch.from_numpy(boxes), N_PTS)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(wcounts))
    assert (counts.numpy()[:6] > 0).all() and counts.numpy()[6] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def _frame_inputs():
    jmodel, jvars, tmodel = tiny_models()
    cap, d_prev = 8, 8
    with torch.no_grad():
        xyz_buf, h_buf = tmodel.embed(torch.from_numpy(crops(20, cap + 1)))
        prev_xyz, prev_h = tmodel.embed(torch.from_numpy(crops(21, d_prev)))
    upd_src = np.array([0, 1, 2, 0, 0, 0, 0, 0], np.int64)
    upd_dst = np.array([5, 2, 7, cap, cap, cap, cap, cap], np.int64)
    slot_idx = np.array([2, 5, 0, 7, 1, cap, cap, cap], np.int64)
    pts, boxes = _sweep(1)
    return (jmodel, jvars, tmodel, cap,
            [h_buf, xyz_buf, prev_h, prev_xyz], upd_src, upd_dst, slot_idx,
            pts, boxes)


@pytest.mark.parametrize("mode", ["grid", "pairs"])
def test_pair_scorer_cached_frames_match_jax(monkeypatch, mode):
    jax_uniform_crops(monkeypatch)
    (jmodel, jvars, tmodel, cap, bufs, upd_src, upd_dst, slot_idx, pts,
     boxes) = _frame_inputs()
    seed = 7
    jscorer, tscorer = JaxScorer(jmodel, jvars), PairScorer(tmodel)
    j_bufs = [jnp.asarray(b.numpy()) for b in bufs]
    t_bufs = [b.clone() for b in bufs]
    common_np = (upd_src.astype(np.int32), upd_dst.astype(np.int32),
                 slot_idx.astype(np.int32))
    common_t = tuple(torch.from_numpy(a) for a in (upd_src, upd_dst,
                                                   slot_idx))
    if mode == "grid":
        jfn = jscorer.make_cached_frame_fn(8, 8, 8, cap, N_PTS)
        tfn = tscorer.make_cached_frame_fn(N_PTS)
        jout = jfn(*j_bufs, *map(jnp.asarray, common_np), np.int32(seed),
                   jnp.asarray(pts), jnp.asarray(boxes))
        with torch.no_grad():
            tout = tfn(*t_bufs, *common_t, seed, torch.from_numpy(pts),
                       torch.from_numpy(boxes))
    else:
        pair_t = np.array([0, 1, 1, 3, 4, 0] + [0] * 10, np.int32)
        pair_d = np.array([0, 2, 5, 1, 3, 6] + [0] * 10, np.int32)
        jfn = jscorer.make_cached_pair_frame_fn(8, 8, 8, 16, cap, N_PTS)
        tfn = tscorer.make_cached_pair_frame_fn(N_PTS)
        jout = jfn(*j_bufs, *map(jnp.asarray, common_np),
                   jnp.asarray(pair_t), jnp.asarray(pair_d), np.int32(seed),
                   jnp.asarray(pts), jnp.asarray(boxes))
        with torch.no_grad():
            tout = tfn(*t_bufs, *common_t, torch.from_numpy(pair_t),
                       torch.from_numpy(pair_d), seed, torch.from_numpy(pts),
                       torch.from_numpy(boxes))
    for name, t, j in zip(("h_buf", "xyz_buf", "logits", "h_d", "xyz_d"),
                          tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL, err_msg=name)
    last = tscorer.last_frame
    assert last["logits"] is tout[2] and last["h_d"] is tout[3]
    assert (last["pairs"] is None) == (mode == "grid")


def _scene(n_frames: int = 4, n_obj: int = 6, per_obj: int = 40):
    rs = np.random.RandomState(3)
    centers = (rs.rand(n_obj, 3) * 14 - 7).astype(np.float32)
    centers[:, 2] = 0.0
    labels = np.array([0, 1] * (n_obj // 2), np.int64)
    for t in range(n_frames):
        centers[:, :2] += rs.randn(n_obj, 2).astype(np.float32) * 0.2
        keep = np.ones(n_obj, bool)
        if t == 2:
            keep[1] = False                       # a missed detection
        boxes = np.concatenate(
            [centers, np.full((n_obj, 3), 2.0, np.float32),
             np.zeros((n_obj, 1), np.float32)], axis=1)[keep]
        pts = (np.repeat(centers, per_obj, axis=0)
               + rs.randn(n_obj * per_obj, 3).astype(np.float32) * 0.5)
        yield pts, boxes, np.ones(keep.sum(), np.float32), labels[keep]


@pytest.mark.parametrize("sparse", ["never", "always"])
def test_tracking_manager_steps_match_jax(monkeypatch, sparse):
    """Same scene, same crop draws: the same track ids and boxes every frame
    and the same logits within the model tolerance."""
    jax_uniform_crops(monkeypatch)
    jmodel, jvars, tmodel = tiny_models()
    j_logits, t_logits = [], []

    class JaxRec(JaxManager):
        def _step_device_cached(self, *a, **k):
            out = super()._step_device_cached(*a, **k)
            j_logits.append(out[0])
            return out

    class TorchRec(TrackingManager):
        def _step_device_cached(self, *a, **k):
            out = super()._step_device_cached(*a, **k)
            t_logits.append(out)
            return out

    kw = dict(subsample_number=N_PTS, seed=1, sparse_scoring=sparse)
    jmgr = JaxRec(JaxScorer(jmodel, jvars), **kw)
    tmgr = TorchRec(PairScorer(tmodel), **kw)
    for frame in _scene():
        jt = jmgr.step(*frame)
        tt = tmgr.step(*frame)
        assert [t.track_id for t in tt] == [t.track_id for t in jt]
        for a, b in zip(tt, jt):
            np.testing.assert_array_equal(a.box, b.box)
    assert len(t_logits) == len(j_logits) == 4
    scored = 0
    for t, j in zip(t_logits, j_logits):
        assert (t is None) == (j is None)
        if t is not None:
            np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
            fin = np.isfinite(j)
            scored += fin.sum()
            np.testing.assert_allclose(t[fin], j[fin], rtol=TOL, atol=TOL)
    assert scored > 0


def test_pair_scorer_cost_matrix_matches_jax():
    """Padded grid scoring with class gating: -inf exactly where the classes
    differ, the model tolerance elsewhere."""
    jmodel, jvars, tmodel = tiny_models()
    with torch.no_grad():
        xt, ht = tmodel.embed(torch.from_numpy(crops(30, 3)))
        xd, hd = tmodel.embed(torch.from_numpy(crops(31, 5)))
        got = PairScorer(tmodel).cost_matrix(ht, xt, hd, xd,
                                             np.array([0, 1, 0]),
                                             np.array([0, 0, 1, 1, 0]))
    want = np.asarray(JaxScorer(jmodel, jvars).cost_matrix(
        *(jnp.asarray(a.numpy()) for a in (ht, xt, hd, xd)),
        np.array([0, 1, 0]), np.array([0, 0, 1, 1, 0])))
    assert got.shape == (3, 5)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=TOL, atol=TOL)
