"""The port's tracking CLI (point_cloud_reid_tpu_torch/tools/track.py) run
in-process on the CPU over .npz scenes with gt ids and near-duplicate
detections, against the JAX TrackingManager + TrackingEvalAccumulator driven
with the same frames, weights and crop draws; and its checkpoint loading."""
import importlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.evaluation import (  # noqa: E402
    TrackingEvalAccumulator as JaxRecorder)
from point_cloud_reid_tpu.inference import PairScorer as JaxScorer  # noqa: E402
from point_cloud_reid_tpu.ops import nms_bev as jax_nms_bev  # noqa: E402
from point_cloud_reid_tpu_torch.configs import (  # noqa: E402
    get_experiment, point_transformer_point_cat)
from point_cloud_reid_tpu_torch.convert import to_jax_variables  # noqa: E402
from point_cloud_reid_tpu_torch.models import build_model  # noqa: E402
from point_cloud_reid_tpu_torch.tools import track  # noqa: E402
from tests._torch_port import TINY, jax_uniform_crops  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

jax_manager = importlib.import_module("point_cloud_reid_tpu.tracking.manager")
FLAGSHIP = track.FLAGSHIP
# the flagship at tests/_torch_port.TINY widths, as CLI overrides
TINY_SET = [
    "model.backbone.conv_out=16", "model.backbone.mul=1",
    "model.backbone.nsample=[8,8,8]", "model.backbone_list=[16,8,4]",
    "model.cross_stage1.d_model=16", "model.cross_stage2.d_model=16",
    "model.output_sequence_size=16", "model.hidden_size=32",
    "model.match_head=[{'type': 'LinearRes', 'n_in': 32, 'n_out': 32, "
    "'norm': 'GN', 'ng': 8}, {'type': 'Linear', 'out_features': 1}]"]
N_PTS = 32
HEADLINE = {"experiment", "image_mode", "frames", "scenes", "median_step_ms",
            "wall_hz", "association", "outputs", "device"}


def _write_scenes(root, n_scenes: int = 2, n_frames: int = 4):
    """Scenes of four well-separated objects (two classes) with gt ids; each
    frame adds a near-duplicate of one object at a lower score (gt -1),
    which NMS at 0.5 removes (its BEV IoU is near 0.6); object 3 is missed
    in frame 2."""
    rs = np.random.RandomState(8)
    for s in range(n_scenes):
        centers = (np.array([[-8, -4, 0], [-1, 6, 0], [5, -5, 0],
                             [9, 4, 0]], np.float32)
                   + rs.randn(4, 3).astype(np.float32) * [1, 1, 0])
        labels = np.array([0, 1, 0, 1], np.int64)
        scene = {}
        for t in range(n_frames):
            centers[:, :2] += rs.randn(4, 2).astype(np.float32) * 0.2
            boxes = np.concatenate([centers, np.full((4, 3), 2.0, np.float32),
                                    np.zeros((4, 1), np.float32)], axis=1)
            d = t % 4
            dup = boxes[d] + np.array([0.3, 0.2, 0, 0, 0, 0, 0.05],
                                      np.float32)
            keep = [0, 1, 2] if t == 2 else [0, 1, 2, 3]
            scene[f"boxes_{t}"] = np.concatenate([boxes[keep], dup[None]])
            scene[f"scores_{t}"] = np.append(
                0.6 + 0.3 * rs.rand(len(keep)), 0.3).astype(np.float32)
            scene[f"labels_{t}"] = np.append(labels[keep], labels[d])
            scene[f"gt_ids_{t}"] = np.append(np.array(keep), -1)
            scene[f"points_{t}"] = (np.repeat(centers, 50, axis=0)
                                    + rs.randn(200, 3).astype(np.float32)
                                    * 0.4)
        np.savez(os.path.join(root, f"scene{s}.npz"), **scene)


def _checkpoint(work_dir):
    """A checkpoint of the tiny flagship written by Trainer.save_checkpoint
    (weights from seed 5, not the CLI's seed-0 init)."""
    from point_cloud_reid_tpu_torch.train import (ScheduleConfig, Trainer,
                                                  TrainState)
    cfg = get_experiment(FLAGSHIP, set_options=TINY_SET)["model"]
    model = build_model(cfg, generator=torch.Generator().manual_seed(5))
    state = TrainState.create(model, ScheduleConfig(max_epochs=1), 1)
    path = Trainer(model, None, None, dict(work_dir=str(work_dir))
                   ).save_checkpoint(state, tag="best")
    return path, model


def test_tiny_overrides_give_the_test_model():
    cfg = get_experiment(FLAGSHIP, set_options=TINY_SET)["model"]
    assert cfg == point_transformer_point_cat(**TINY)


def test_load_weights_reads_trainer_and_bare_checkpoints(tmp_path):
    path, model = _checkpoint(tmp_path)
    want = model.state_dict()
    bare = tmp_path / "bare.pt"
    torch.save(want, bare)
    cfg = get_experiment(FLAGSHIP, set_options=TINY_SET)["model"]
    for p in (path, bare):
        fresh = build_model(cfg, generator=torch.Generator().manual_seed(0))
        assert not torch.equal(fresh.state_dict()["match_head.1.weight"],
                               want["match_head.1.weight"])
        track.load_weights(fresh, str(p), "cpu")
        got = fresh.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)


def _jax_cli(scene_dir, model, monkeypatch, jax_cfg=None, subsample=N_PTS):
    """What the JAX CLI would write for these scenes if its nms_bev call
    passed max_out (tests/test_torch_boxes.py): the JAX manager with the
    port's weights (a JAX model of the config `jax_cfg`, by default the
    tiny flagship), frame by frame, crops of `subsample` points. Returns
    (tracks.jsonl rows, summary)."""
    monkeypatch.setattr(
        jax_manager, "nms_bev",
        lambda b, s, t: jax_nms_bev(b, s, t, max_out=b.shape[0]))
    from point_cloud_reid_tpu.configs.models import point_transformer_point_cat
    from point_cloud_reid_tpu.models import build_model as jax_build
    import jax
    jvars = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(model))
    rec = JaxRecorder()
    mgr = jax_manager.TrackingManager(
        JaxScorer(jax_build(jax_cfg or point_transformer_point_cat(**TINY)),
                  jvars),
        subsample_number=subsample, match_threshold=1.0, method="hungarian",
        nms_threshold=0.5, seed=0, eval_recorder=rec, sparse_scoring="auto")
    rows = []
    for name in sorted(os.listdir(scene_dir)):
        for t, (frame, boxes, scores, labels, gt) in enumerate(
                track.load_scene(os.path.join(scene_dir, name), False)):
            tracks = mgr.step(frame, boxes, scores, labels, det_gt_ids=gt)
            rows.append(dict(scene=name, frame=t, tracks=[
                dict(id=tr.track_id, cls=tr.cls,
                     box=[round(float(x), 4) for x in tr.box],
                     score=round(tr.score, 4)) for tr in tracks]))
        mgr.end_scene()
    return rows, json.loads(json.dumps(rec.summary()))


def test_track_cli_matches_jax_manager(tmp_path, monkeypatch, capsys):
    jax_uniform_crops(monkeypatch)
    scenes, work = tmp_path / "scenes", tmp_path / "out"
    scenes.mkdir()
    _write_scenes(str(scenes))
    ckpt, model = _checkpoint(tmp_path / "train")
    track.main([FLAGSHIP, "--checkpoint", ckpt, "--scene-dir", str(scenes),
                "--subsample", str(N_PTS), "--match-threshold", "1.0",
                "--method", "hungarian", "--nms-threshold", "0.5",
                "--sparse", "auto", "--work-dir", str(work),
                "--device", "cpu"] + sum([["--set", s] for s in TINY_SET],
                                         []))
    headline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(headline) == HEADLINE
    assert headline["frames"] == 8 and headline["scenes"] == 2
    assert headline["device"] == "cpu" and not headline["image_mode"]
    rows = [json.loads(line) for line in open(work / "tracks.jsonl")]
    summary = json.load(open(work / "tracking_summary.json"))

    want_rows, want_summary = _jax_cli(str(scenes), model, monkeypatch)
    assert len(rows) == 8
    for got, want in zip(rows, want_rows):
        assert got == want
    assert summary == want_summary
    # NMS dropped every duplicate: four tracks a frame, three in frame 2
    # (object 3 missed); every match after a scene's first frame correct
    assert [len(r["tracks"]) for r in rows] == [4, 4, 3, 4] * 2
    assert summary["association"]["correct"] == 22
    assert summary["association"]["fp_matches"] == 0


def test_track_cli_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        track.main([FLAGSHIP, "--frames", "1"])
    assert err.value.code not in (0, None) and "CUDA" in str(err.value.code)
