"""The port's motion, supervision and decision modules and its tracking-eval
accumulator against the JAX package, on the same seeded inputs."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import point_cloud_reid_tpu.tracking as jtracking  # noqa: E402
import point_cloud_reid_tpu.tracking.motion as jmotion  # noqa: E402
import point_cloud_reid_tpu.tracking.supervision as jsup  # noqa: E402
import point_cloud_reid_tpu_torch.tracking as ttracking  # noqa: E402
import point_cloud_reid_tpu_torch.tracking.motion as tmotion  # noqa: E402
import point_cloud_reid_tpu_torch.tracking.supervision as tsup  # noqa: E402
from point_cloud_reid_tpu.evaluation import (  # noqa: E402
    TrackingEvalAccumulator as JaxRecorder)
from point_cloud_reid_tpu_torch.convert import (  # noqa: E402
    from_jax_variables, to_jax_variables)
from point_cloud_reid_tpu_torch.evaluation import (  # noqa: E402
    TrackingEvalAccumulator)
from tests._torch_threads import few_threads  # noqa: E402,F401

TOL = 1e-5         # float32 on both sides; the LSTM and the losses
GEOM_TOL = 1e-6    # box arithmetic


def test_tracking_exports_cover_jax():
    assert set(jtracking.__all__) <= set(ttracking.__all__)
    import point_cloud_reid_tpu_torch.evaluation as tev
    assert "TrackingEvalAccumulator" in tev.__all__


@pytest.mark.parametrize("direction", ["from_jax", "to_jax"])
def test_lstm_incrementor_matches_jax(direction):
    """Weights carried by the converter both ways; outputs at the last step
    and at each row's own length."""
    seq = np.random.RandomState(0).randn(4, 6, 5).astype(np.float32)
    lengths = np.array([6, 3, 1, 4])
    jm = jmotion.LSTMIncrementor(hidden=8)
    if direction == "from_jax":
        jv = jm.init(jax.random.PRNGKey(3), jnp.asarray(seq))
        tm = tmotion.LSTMIncrementor(5, hidden=8)
        from_jax_variables(tm, jax.tree_util.tree_map(np.asarray, jv))
    else:
        torch.manual_seed(3)
        tm = tmotion.LSTMIncrementor(5, hidden=8)
        with torch.no_grad():       # torch's two biases both count
            tm.lstm.bias_ih_l0.uniform_(-0.5, 0.5)
        jv = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(tm))
    with torch.no_grad():
        got_last = tm(torch.from_numpy(seq)).numpy()
        got_len = tm(torch.from_numpy(seq), torch.from_numpy(lengths)).numpy()
    want_last = np.asarray(jm.apply(jv, jnp.asarray(seq)))
    want_len = np.asarray(jm.apply(jv, jnp.asarray(seq),
                                   lengths=jnp.asarray(lengths)))
    assert got_last.shape == (4, 2)
    np.testing.assert_allclose(got_last, want_last, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_len, want_len, rtol=TOL, atol=TOL)
    assert not np.allclose(got_len[1], got_last[1])


def test_box_updater_and_constant_velocity_match_jax():
    rs = np.random.RandomState(1)
    for _ in range(5):
        tb = (rs.randn(7) * 2).astype(np.float32)
        db = (rs.randn(7) * 2).astype(np.float32)
        db[6] = tb[6] + rs.choice([-1, 1]) * (np.pi - 0.3)   # wraps round
        vel = rs.randn(2).astype(np.float32)
        for dm, ym in ((0.7, 0.7), (0.2, 0.9)):
            want = np.asarray(jmotion.BoxUpdater(dm, ym)(jnp.asarray(tb),
                                                         jnp.asarray(db)))
            got = tmotion.BoxUpdater(dm, ym)(torch.from_numpy(tb),
                                             torch.from_numpy(db)).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=GEOM_TOL)
        want = np.asarray(jmotion.constant_velocity_step(
            jnp.asarray(tb), jnp.asarray(vel), dt=0.5))
        got = tmotion.constant_velocity_step(torch.from_numpy(tb),
                                             torch.from_numpy(vel), dt=0.5)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GEOM_TOL)


def _loss_inputs():
    rs = np.random.RandomState(2)
    T, D = 5, 7
    logits = (rs.randn(T, D) * 2).astype(np.float32)
    gt = np.array([3, -1, 0, 6, 2])
    valid = rs.rand(T, D) > 0.2
    valid[np.arange(T), np.clip(gt, 0, None)] = True
    targets = (rs.rand(T, D) > 0.6).astype(np.float32)
    weight = rs.rand(T, D).astype(np.float32)
    return logits, gt, valid, targets, weight


def _loss_cases():
    """name -> (jax fn of the float input, port fn of it): each loss of the
    supervision module, with and without its optional arguments."""
    logits, gt, valid, targets, weight = _loss_inputs()
    jv, tv = jnp.asarray(valid), torch.from_numpy(valid)
    jg, tg = jnp.asarray(gt), torch.from_numpy(gt)
    jt, tt = jnp.asarray(targets), torch.from_numpy(targets)
    jw, tw = jnp.asarray(weight), torch.from_numpy(weight)
    return logits, {
        "optax_sigmoid_ce": (
            lambda x: jnp.mean(jsup.optax_sigmoid_ce(x, jt)),
            lambda x: tsup.optax_sigmoid_ce(x, tt).mean()),
        "focal": (lambda x: jsup.sigmoid_focal_loss(x, jt),
                  lambda x: tsup.sigmoid_focal_loss(x, tt)),
        "focal_weighted_no_alpha": (
            lambda x: jsup.sigmoid_focal_loss(x, jt, alpha=-1, gamma=1.5,
                                              weight=jw),
            lambda x: tsup.sigmoid_focal_loss(x, tt, alpha=-1, gamma=1.5,
                                              weight=tw)),
        "margin": (lambda x: jsup.association_margin_loss(x, jg, 0.3),
                   lambda x: tsup.association_margin_loss(x, tg, 0.3)),
        "margin_valid": (
            lambda x: jsup.association_margin_loss(x, jg, valid=jv),
            lambda x: tsup.association_margin_loss(x, tg, valid=tv)),
        "softmax": (lambda x: jsup.softmax_association_loss(x, jg),
                    lambda x: tsup.softmax_association_loss(x, tg)),
        "softmax_valid": (
            lambda x: jsup.softmax_association_loss(x, jg, valid=jv),
            lambda x: tsup.softmax_association_loss(x, tg, valid=tv)),
    }


@pytest.mark.parametrize("name", list(_loss_cases()[1]))
def test_supervision_losses_and_gradients_match_jax(name):
    x, cases = _loss_cases()
    jfn, tfn = cases[name]
    want, wgrad = jax.value_and_grad(jfn)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tfn(xt)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wgrad), rtol=TOL,
                               atol=TOL)


PC_RANGE = [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]


def test_bev_sampling_and_triplet_loss_match_jax():
    """sample_bev_features (no jitter: the noise draws are each package's
    own) and bev_triplet_metric_loss, values and gradients in the map and
    the features."""
    rs = np.random.RandomState(3)
    bev = rs.randn(16, 16, 6).astype(np.float32)
    centers = rs.uniform(-55, 55, (9, 2)).astype(np.float32)  # some outside
    ids = np.array([0, 1, 2, 0, 1, -1, 2, 2, 0])

    def jloss(b):
        f = jsup.sample_bev_features(b, jnp.asarray(centers), PC_RANGE)
        return jsup.bev_triplet_metric_loss(f, jnp.asarray(ids), 3), f

    (want, wf), wgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(bev))
    bt = torch.from_numpy(bev).requires_grad_(True)
    f = tsup.sample_bev_features(bt, torch.from_numpy(centers), PC_RANGE)
    got = tsup.bev_triplet_metric_loss(f, torch.from_numpy(ids), 3)
    got.backward()
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(wf), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(wgrad), rtol=TOL,
                               atol=TOL)
    # jitter draws from the generator it is given
    g1 = tsup.sample_bev_features(torch.from_numpy(bev),
                                  torch.from_numpy(centers), PC_RANGE,
                                  torch.Generator().manual_seed(0))
    g2 = tsup.sample_bev_features(torch.from_numpy(bev),
                                  torch.from_numpy(centers), PC_RANGE,
                                  torch.Generator().manual_seed(0))
    assert torch.equal(g1, g2) and not torch.allclose(g1, f.detach())


def test_bev_memory_matches_jax():
    rs = np.random.RandomState(4)
    jm, tm = jsup.BEVMemory(), tsup.BEVMemory()
    for _ in range(3):
        feats = rs.randn(5, 4).astype(np.float32)
        ids = rs.randint(-1, 3, 5) * 7
        for m, conv in ((jm, jnp.asarray), (tm, torch.from_numpy)):
            m.append(0, conv(feats), ids)
            m.append(2, conv(feats[:3]), ids[:3])
    want, got = float(jm.metric_loss(0.5)), float(tm.metric_loss(0.5))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert got > 0
    tm.reset()
    assert float(tm.metric_loss()) == 0.0


def test_decisions_match_jax():
    from point_cloud_reid_tpu.tracking import decisions as jd
    from point_cloud_reid_tpu_torch.tracking import decisions as td
    for mode in ("always", "never", "linear_decay", "cosine_decay"):
        for epoch in (0, 3, 10, 12):
            assert (td.sampling_rate(mode, epoch, 10)
                    == jd.sampling_rate(mode, epoch, 10))
    with pytest.raises(ValueError):
        td.sampling_rate("sometimes", 0, 1)
    assert td.DECISION_TYPES == jd.DECISION_TYPES
    rs = np.random.RandomState(5)
    mods = (jd.DecisionModifier(seed=7), td.DecisionModifier(seed=7))
    for epoch in range(4):
        for m in mods:
            m.set_epoch(epoch, 4)
        pred = [(int(t), int(d)) for t, d in rs.randint(0, 6, (5, 2))]
        gt = [(int(t), int(d)) for t, d in rs.randint(0, 6, (4, 2))]
        pn, gn = list(rs.randint(0, 8, 4)), list(rs.randint(0, 8, 3))
        outs = [(m.modify_matches(pred, gt, 6, 6), m.modify_newborns(pn, gn))
                for m in mods]
        assert outs[0] == outs[1]


class _T:
    def __init__(self, tid, hits):
        self.track_id, self.hits = tid, hits


def _decision_stream(seed: int):
    """A seeded stream of frames of association decisions with scene ends:
    (kind, payload) items."""
    rs = np.random.RandomState(seed)
    items, next_tid = [], 0
    for _ in range(2):
        live = []
        for _ in range(6):
            matched = [(t, int(rs.randint(-1, 4)), int(rs.randint(0, 3)))
                       for t in live if rs.rand() < 0.7]
            unmatched = [t for t in live if t not in {m[0] for m in matched}]
            newborn = []
            for _ in range(rs.randint(0, 3)):
                newborn.append((next_tid, int(rs.randint(-1, 4)),
                                int(rs.randint(0, 3))))
                live.append(next_tid)
                next_tid += 1
            dropped = [int(g) for g in rs.randint(-1, 4, rs.randint(0, 2))]
            items.append(("frame", (matched, newborn, unmatched, dropped)))
            dead = [t for t in unmatched if rs.rand() < 0.3]
            live = [t for t in live if t not in dead]
            items.append(("dead", [_T(t, rs.randint(1, 6)) for t in dead]))
        items.append(("end", [_T(t, rs.randint(1, 6)) for t in live]))
    return items


def _replay(acc, items):
    for kind, payload in items:
        if kind == "frame":
            acc.observe_frame(*payload)
        elif kind == "dead":
            acc.observe_dead(payload)
        else:
            acc.end_scene(payload)
    return acc


def test_tracking_eval_accumulator_matches_jax():
    """The copied accumulator gives JAX's summary on a seeded decision
    stream, and after a per-rank merge."""
    items_a, items_b = _decision_stream(6), _decision_stream(7)
    j = _replay(JaxRecorder(), items_a)
    t = _replay(TrackingEvalAccumulator(), items_a)
    assert t.summary() == j.summary()
    assert t.summary()["association"]["correct"] > 0
    jm = copy.deepcopy(j).merge(_replay(JaxRecorder(), items_b))
    tm = copy.deepcopy(t).merge(_replay(TrackingEvalAccumulator(), items_b))
    assert tm.summary() == jm.summary()
    assert tm.summary()["scenes"] == 4


_FRESH = """
import ctypes, json, sys
import numpy as np
import torch
def refuse(*a, **k):
    raise AssertionError('ctypes library touched on the CPU path')
ctypes.CDLL = refuse
import point_cloud_reid_tpu_torch.evaluation.tracking_summary
import point_cloud_reid_tpu_torch.ops.bev_feat
import point_cloud_reid_tpu_torch.tools.track
import point_cloud_reid_tpu_torch.tracking.decisions
import point_cloud_reid_tpu_torch.tracking.motion
import point_cloud_reid_tpu_torch.tracking.supervision
from point_cloud_reid_tpu_torch.configs import point_transformer_point_cat
from point_cloud_reid_tpu_torch.inference import PairScorer
from point_cloud_reid_tpu_torch.models import build_model
from point_cloud_reid_tpu_torch.tracking import TrackingManager
model = build_model(point_transformer_point_cat(
    conv_out=16, mul=1, nsample=(8, 8, 8), backbone_list=(16, 8, 4)))
mgr = TrackingManager(PairScorer(model), subsample_number=32,
                      match_threshold=1.0, device_cache=False,
                      nms_threshold=0.5)
rs = np.random.RandomState(0)
c = np.array([[0, 0, 0], [6, 0, 0], [0, 6, 0]], np.float32)
boxes = np.concatenate([c, np.full((3, 3), 2, np.float32),
                        np.zeros((3, 1), np.float32)], 1)
boxes = np.concatenate([boxes, boxes[:1] + [0.3, 0.2, 0, 0, 0, 0, 0]])
for _ in range(2):
    pts = np.repeat(c, 30, 0) + rs.randn(90, 3).astype(np.float32) * 0.4
    mgr.step(pts, boxes, np.array([0.9, 0.8, 0.8, 0.3], np.float32),
             np.zeros(4, np.int64))
print(json.dumps(dict(tracks=len(mgr.store), cached=len(mgr.cache),
                      jax='jax' in sys.modules,
                      jax_pkg=any(m.startswith('point_cloud_reid_tpu.')
                                  for m in sys.modules))))
"""


def test_new_modules_need_no_jax_and_the_host_path_no_cuda_library():
    """In a fresh interpreter (this suite's conftest imports jax): the
    slice's new modules import without jax or the JAX package, and the
    host-cache manager with NMS runs on the CPU without building or loading
    the CUDA library."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _FRESH], cwd=repo,
                          env=dict(os.environ, PYTHONPATH=repo),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == dict(tracks=3, cached=3, jax=False, jax_pkg=False)
