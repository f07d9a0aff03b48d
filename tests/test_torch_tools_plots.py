"""The port's plot and launch tools: acc_plots and tracking_plots draw the
same figure files as the JAX package's tools/acc_plots.py and
tools/tracking_plots.py on equal inputs (the port's own evaluator and
tracking-summary outputs), and the launcher's --dry-run lists port
commands."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("matplotlib")
pytest.importorskip("torch")

from point_cloud_reid_tpu_torch.evaluation import evaluate_results  # noqa: E402
from point_cloud_reid_tpu_torch.evaluation.tracking_summary import (  # noqa: E402
    TrackingEvalAccumulator)
from point_cloud_reid_tpu_torch.tools import (acc_plots,  # noqa: E402
                                              launcher, tracking_plots)
from tests._torch_threads import few_threads  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _report(seed):
    rng = np.random.RandomState(seed)
    n = 256
    gt = rng.randint(0, 2, n).astype(np.float64)
    logits = np.where(gt > 0, 3.0, -3.0) + rng.randn(n) * 2
    results = dict(
        val_match_preds=logits, val_match_gt=gt,
        match_classes=rng.randint(0, 4, size=(n, 2)),
        num_points=rng.randint(1, 512, size=(n, 2)),
        val_vis_gt_all=rng.randint(0, 4, size=(n, 2)),
        distances=rng.rand(n, 2) * 55.0)
    return evaluate_results(results,
                            cls_to_idx={f"class_{i}": i for i in range(4)},
                            num_classes=4)


def _jax_tool(name, *argv):
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", name),
                           *argv], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout)["plots"]


def _same_files(port_paths, jax_paths):
    names = sorted(os.path.basename(p) for p in port_paths)
    assert names == sorted(os.path.basename(p) for p in jax_paths)
    by_name = {os.path.basename(p): p for p in jax_paths}
    for p in port_paths:
        assert os.path.getsize(p) > 1000
        with open(p, "rb") as a, open(by_name[os.path.basename(p)], "rb") as b:
            assert a.read() == b.read(), p
    return names


def test_acc_plots_match_the_jax_tool(tmp_path, capsys):
    paths = []
    for s in (0, 1):
        p = tmp_path / f"run{s}.json"
        with open(p, "w") as f:
            json.dump(_report(s), f)
        paths.append(str(p))
    args = ["--labels", "A", "B", "--metrics", "acc", "f1", "--pair-buckets"]
    acc_plots.main([*paths, *args, "--out", str(tmp_path / "port")])
    port = json.loads(capsys.readouterr().out)["plots"]
    want = _jax_tool("acc_plots.py", *paths, *args, "--out",
                     str(tmp_path / "jax"))
    names = _same_files(port, want)
    assert "results_per_points_pair_heatmap.png" in names
    assert any(n.startswith("points_class_") for n in names)


def test_tracking_plots_match_the_jax_tool(tmp_path, capsys):
    acc = TrackingEvalAccumulator()
    acc.observe_frame([(1, 10, 0), (2, 11, 0), (3, -1, 1)], [(4, 12, 1)],
                      [], [])
    acc.observe_frame([(1, 10, 0), (2, 13, 0)], [], [3, 4], [])

    class _T:
        def __init__(self, tid, hits):
            self.track_id, self.hits = tid, hits

    acc.end_scene([_T(1, 2), _T(2, 2), _T(3, 1), _T(4, 1)])
    path = tmp_path / "tracking_summary.json"
    with open(path, "w") as f:
        json.dump(acc.summary(), f)
    tracking_plots.main([str(path), "--out", str(tmp_path / "port")])
    port = json.loads(capsys.readouterr().out)["plots"]
    want = _jax_tool("tracking_plots.py", str(path), "--out",
                     str(tmp_path / "jax"))
    names = _same_files(port, want)
    assert {"mistake_share.png", "track_length_frequency.png",
            "decision_metrics.png"} <= set(names)


def test_launcher_dry_run_lists_port_commands(tmp_path, capsys):
    jobs = tmp_path / "jobs.json"
    with open(jobs, "w") as f:
        json.dump([{"experiment": "testing_pts_pointnet_point-cat_nus_det_"
                    "4x256_500e", "args": ["--device", "cpu"]}], f)
    for argv, tool, n in (([], "train", 3),
                          (["--jobs", str(jobs), "--tool", "test"], "test",
                           1)):
        out = launcher.main(["--dry-run", *argv])
        capsys.readouterr()
        assert len(out) == n
        for r in out:
            assert r["status"] == "dry-run"
            assert r["cmd"][1:4] == [
                "-m", f"point_cloud_reid_tpu_torch.tools.{tool}",
                r["job"]["experiment"]]
            assert r["cmd"][4:] == r["job"]["args"]
