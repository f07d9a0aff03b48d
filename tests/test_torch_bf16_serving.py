"""bf16 serving, the port against the JAX package at bf16: the flagship
(full width) PairScorer's embed and its dense and pair-list device-cache
frames against JAX's bf16 PairScorer(pallas_interpret=True), one DeiT-tiny
image frame (rgb_deit-tiny_point-cat_r_*, no pretrained weights), and
tools/track.py --bf16 --device cpu against JAX's TrackingManager at bf16.
The same float32 weights on every side (convert.to_jax_variables), the same
numpy-seeded inputs and crop draws.

Bars: embeddings within the modules' 3e-2 (rtol = atol); logits within
6e-2 of JAX's bf16 logits, relative to max(1, |logit|): at the flagship's
widths on the CPU JAX's own two bf16 routes (Pallas in interpret mode and
XLA) differ by 0.043 on logits of order 1. The port's bf16 logits against
JAX's float32 ones are printed and held to the same bar."""
import copy
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.inference import PairScorer as JaxScorer  # noqa: E402
from point_cloud_reid_tpu_torch.inference import PairScorer  # noqa: E402
from tests._torch_port import crops, jax_uniform_crops, to_jax_tree  # noqa: E402
from tests.test_torch_tracking import _sweep  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

BF16, JBF16 = torch.bfloat16, jnp.bfloat16
EMBED_TOL = 3e-2
LOGIT_TOL = 6e-2
N_PTS = 32


def _j(t: torch.Tensor):
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy(), JBF16)
    return jnp.asarray(t.numpy())


def _logit_gap(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@functools.lru_cache(maxsize=1)
def flagship():
    """(port float32, port bf16, JAX bf16 scorer, JAX float32 scorer) of
    the flagship at full width with one set of seeded float32 weights."""
    from point_cloud_reid_tpu.configs.models import (
        point_transformer_point_cat as jax_cfg)
    from point_cloud_reid_tpu.models import build_model as jax_build
    from point_cloud_reid_tpu_torch.configs import point_transformer_point_cat
    from point_cloud_reid_tpu_torch.models import build_model
    cfg = point_transformer_point_cat()
    t32 = build_model(cfg, generator=torch.Generator().manual_seed(0))
    t16 = build_model(cfg, generator=torch.Generator().manual_seed(0),
                      dtype=BF16)
    jvars = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(t32))
    j16 = JaxScorer(jax_build(jax_cfg(), dtype=JBF16), jvars,
                    pallas_interpret=True)
    j32 = JaxScorer(jax_build(jax_cfg()), jvars, pallas_interpret=True)
    return t32, t16, j16, j32


def test_flagship_embed_bf16_matches_jax():
    _, t16, j16, _ = flagship()
    x = crops(40, 6)
    jxyz, jh = j16.embed(jnp.asarray(x))
    with torch.no_grad():
        xyz, h = PairScorer(t16).embed(torch.from_numpy(x))
    assert (h.dtype, xyz.dtype) == (BF16, torch.float32)
    assert (jh.dtype, jxyz.dtype) == (JBF16, jnp.float32)
    np.testing.assert_array_equal(xyz.numpy(), np.asarray(jxyz))
    np.testing.assert_allclose(h.float().numpy(), np.asarray(jh, np.float32),
                               rtol=EMBED_TOL, atol=EMBED_TOL)


def _buffers(model, cap: int = 8, d_prev: int = 8):
    with torch.no_grad():
        xyz_buf, h_buf = model.embed(torch.from_numpy(crops(20, cap + 1)))
        prev_xyz, prev_h = model.embed(torch.from_numpy(crops(21, d_prev)))
    return [h_buf, xyz_buf, prev_h, prev_xyz]


@pytest.mark.parametrize("mode", ["dense", "pairs"])
def test_flagship_frames_bf16_match_jax(monkeypatch, mode):
    """One device-cache frame (scatter, gather, crops, embed, score) of each
    kind on the same inputs and crop draws: the port's bf16 frame against
    JAX's bf16 frame; the port's bf16 logits against JAX's float32 frame
    (its own float32 buffers) are printed and held to the same bar."""
    jax_uniform_crops(monkeypatch)
    t32, t16, j16, j32 = flagship()
    cap, seed = 8, 7
    upd_src = np.array([0, 1, 2, 0, 0, 0, 0, 0], np.int64)
    upd_dst = np.array([5, 2, 7, cap, cap, cap, cap, cap], np.int64)
    slot_idx = np.array([2, 5, 0, 7, 1, cap, cap, cap], np.int64)
    pts, boxes = _sweep(1)
    pair_t = np.array([0, 1, 1, 3, 4, 0] + [0] * 10, np.int32)
    pair_d = np.array([0, 2, 5, 1, 3, 6] + [0] * 10, np.int32)
    bufs16 = _buffers(t16)
    assert bufs16[0].dtype == BF16 and bufs16[1].dtype == torch.float32
    idx_np = [jnp.asarray(a.astype(np.int32))
              for a in (upd_src, upd_dst, slot_idx)]
    idx_t = [torch.from_numpy(a) for a in (upd_src, upd_dst, slot_idx)]
    frame_np = (np.int32(seed), jnp.asarray(pts), jnp.asarray(boxes))

    def jax_frame(scorer, bufs):
        if mode == "dense":
            fn = scorer.make_cached_frame_fn(8, 8, 8, cap, N_PTS)
            return fn(*bufs, *idx_np, *frame_np)
        fn = scorer.make_cached_pair_frame_fn(8, 8, 8, 16, cap, N_PTS)
        return fn(*bufs, *idx_np, jnp.asarray(pair_t), jnp.asarray(pair_d),
                  *frame_np)

    scorer = PairScorer(t16)
    with torch.no_grad():
        if mode == "dense":
            out = scorer.make_cached_frame_fn(N_PTS)(
                *[b.clone() for b in bufs16], *idx_t, seed,
                torch.from_numpy(pts), torch.from_numpy(boxes))
        else:
            out = scorer.make_cached_pair_frame_fn(N_PTS)(
                *[b.clone() for b in bufs16], *idx_t,
                torch.from_numpy(pair_t), torch.from_numpy(pair_d), seed,
                torch.from_numpy(pts), torch.from_numpy(boxes))
    want = jax_frame(j16, [_j(b) for b in bufs16])
    want32 = jax_frame(j32, [_j(b) for b in _buffers(t32)])
    h_buf, xyz_buf, logits, h_d, xyz_d = out
    assert logits.dtype == BF16 and np.asarray(want[2]).dtype == JBF16
    assert (h_buf.dtype, h_d.dtype, xyz_d.dtype) == (BF16, BF16,
                                                     torch.float32)
    # the crops themselves (float32 on both sides): the same points
    # through the same rotation, to 1e-6 (tests/test_torch_tracking.py)
    np.testing.assert_allclose(xyz_d.numpy(), np.asarray(want[4]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(h_d.float().numpy(),
                               np.asarray(want[3], np.float32),
                               rtol=EMBED_TOL, atol=EMBED_TOL)
    got = logits.float().numpy()
    gap = _logit_gap(got, want[2])
    gap32 = _logit_gap(got, want32[2])
    print(f"[bf16 {mode} frame] |logits| up to "
          f"{np.abs(np.asarray(want32[2])).max():.3f}; port bf16 vs JAX "
          f"bf16 {gap:.4f}, vs JAX float32 {gap32:.4f} (bar {LOGIT_TOL})")
    assert gap <= LOGIT_TOL and gap32 <= LOGIT_TOL


def test_deit_tiny_image_frame_bf16_matches_jax():
    """One image frame of the DeiT-tiny leaf (full width, no pretrained
    weights) at bf16: 2 tracks x 3 detections of random 224 x 224 crops,
    the tokens through the downsample, the image grid."""
    from point_cloud_reid_tpu.models import build_model as jax_build
    from point_cloud_reid_tpu_torch.configs import get_experiment
    from point_cloud_reid_tpu_torch.models import build_model
    from point_cloud_reid_tpu_torch.tools.scenes import IMAGE_EXPERIMENT
    from tests._torch_image import jax_variables_of
    cfg = get_experiment(IMAGE_EXPERIMENT)["model"]
    t16 = build_model(copy.deepcopy(cfg),
                      generator=torch.Generator().manual_seed(0), dtype=BF16)
    jvars = jax_variables_of(t16, cfg["backbone"])
    jscorer = JaxScorer(jax_build(copy.deepcopy(cfg), dtype=JBF16), jvars,
                        image_mode=True, pallas_interpret=True)
    images = (np.random.RandomState(5).rand(5, 3, 224, 224) * 2 - 1).astype(
        np.float32)
    scorer = PairScorer(t16, image_mode=True)
    with torch.no_grad():
        _, h = scorer.embed(torch.from_numpy(images).to(BF16))
        logits = scorer.cost_matrix(h[:2], None, h[2:], None)
    _, jh = jscorer.embed(jnp.asarray(images))
    want = jscorer.cost_matrix(jh[:2], None, jh[2:], None)
    assert h.dtype == BF16 and jh.dtype == JBF16 and h.shape == (5, 197, 64)
    np.testing.assert_allclose(h.float().numpy(), np.asarray(jh, np.float32),
                               rtol=EMBED_TOL, atol=EMBED_TOL)
    assert logits.dtype == BF16 and logits.shape == (2, 3)
    gap = _logit_gap(logits.float().numpy(), want)
    print(f"[bf16 image frame] port bf16 vs JAX bf16 {gap:.4f} "
          f"(bar {LOGIT_TOL})")
    assert gap <= LOGIT_TOL


def test_track_cli_bf16_matches_jax(tmp_path, monkeypatch, capsys):
    """tools/track.py --bf16 --device cpu over one scene of four objects
    (with a near-duplicate detection a frame, NMS 0.5, Hungarian, sparse
    'auto') at the tiny widths, against JAX's TrackingManager with a bf16
    model, the same weights and crop draws: the same tracks, boxes and
    scores every frame, and the same association summary."""
    import importlib

    from point_cloud_reid_tpu.configs.models import (
        point_transformer_point_cat as jax_cfg)
    from point_cloud_reid_tpu.evaluation import (
        TrackingEvalAccumulator as JaxRecorder)
    from point_cloud_reid_tpu.models import build_model as jax_build
    from point_cloud_reid_tpu.ops import nms_bev as jax_nms_bev
    from point_cloud_reid_tpu_torch.tools import track
    from tests._torch_port import TINY
    from tests.test_torch_track_cli import (TINY_SET, _checkpoint,
                                            _write_scenes)
    jax_manager = importlib.import_module(
        "point_cloud_reid_tpu.tracking.manager")
    jax_uniform_crops(monkeypatch)
    scenes, work = tmp_path / "scenes", tmp_path / "out"
    scenes.mkdir()
    _write_scenes(str(scenes), n_scenes=1)
    ckpt, model = _checkpoint(tmp_path / "train")
    track.main([track.FLAGSHIP, "--checkpoint", ckpt, "--scene-dir",
                str(scenes), "--subsample", str(N_PTS), "--match-threshold",
                "1.0", "--method", "hungarian", "--nms-threshold", "0.5",
                "--sparse", "auto", "--work-dir", str(work), "--device",
                "cpu", "--bf16"] + sum([["--set", s] for s in TINY_SET], []))
    headline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert headline["frames"] == 4 and headline["device"] == "cpu"
    rows = [json.loads(line) for line in open(work / "tracks.jsonl")]
    summary = json.load(open(work / "tracking_summary.json"))

    # the JAX CLI's loop (its nms_bev given max_out, as
    # tests/test_torch_track_cli.py does), the model built at bf16
    monkeypatch.setattr(
        jax_manager, "nms_bev",
        lambda b, s, t: jax_nms_bev(b, s, t, max_out=b.shape[0]))
    jvars = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(model))
    rec = JaxRecorder()
    mgr = jax_manager.TrackingManager(
        JaxScorer(jax_build(jax_cfg(**TINY), dtype=JBF16), jvars),
        subsample_number=N_PTS, match_threshold=1.0, method="hungarian",
        nms_threshold=0.5, seed=0, eval_recorder=rec, sparse_scoring="auto")
    want_rows = []
    for name in sorted(os.listdir(scenes)):
        for t, (frame, boxes, scores, labels, gt) in enumerate(
                track.load_scene(os.path.join(scenes, name), False)):
            tracks = mgr.step(frame, boxes, scores, labels, det_gt_ids=gt)
            want_rows.append(dict(scene=name, frame=t, tracks=[
                dict(id=tr.track_id, cls=tr.cls,
                     box=[round(float(x), 4) for x in tr.box],
                     score=round(tr.score, 4)) for tr in tracks]))
        mgr.end_scene()
    assert rows == want_rows
    assert summary == json.loads(json.dumps(rec.summary()))
