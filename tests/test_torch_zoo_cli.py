"""The CLIs take the leaves of the rest of the registry with no flag added:
tools/train.py and tools/test.py (DGCNN, the concat baseline) and
tools/track.py (PointNet, the xcorr-baseline baseline) on the CPU at test
size through --set, and tools/profile_train.py --experiment's kernel
knobs for a leaf without cross stages."""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from point_cloud_reid_tpu_torch.tools import test as test_cli  # noqa: E402
from point_cloud_reid_tpu_torch.tools import track  # noqa: E402
from point_cloud_reid_tpu_torch.tools import train as train_cli  # noqa: E402
from point_cloud_reid_tpu_torch.tools.profile_train import (  # noqa: E402
    train_spec)
from tests._torch_threads import few_threads  # noqa: E402,F401

CONCAT = "pts_point-transformer_baseline_nus_det_4x256_500e"
STNET = "pts_point-transformer_baseline-stnet_nus_det_4x256_500e"
POINTNET = "pts_pointnet_point-cat_nus_det_4x256_500e"
DGCNN = "pts_dgcnn_point-cat_nus_det_4x256_500e"
CROP = 32

# the new families at test size through --set, on crops of CROP points
CLI_SETS = {
    DGCNN: ["model.backbone.emb_dims=64", "model.backbone.k=6"],
    CONCAT: ["model.backbone.mul=1", "model.backbone.nsample=[8,8,8]",
             "model.backbone_list=[16,8,4]"],
}
CLI_SETS[STNET] = CLI_SETS[CONCAT]
CLI_SETS[POINTNET] = []


def _sets(leaf: str, data: bool) -> list:
    sets = CLI_SETS[leaf] + (
        [f"dataset.{s}.subsample_sparse={CROP}" for s in ("train", "val")]
        + ["dataset.val.max_combinations=4"] if data else [])
    return [a for s in sets for a in ("--set", s)]


@pytest.mark.parametrize("leaf", [DGCNN, CONCAT])
def test_train_and_test_clis_take_the_new_leaves(leaf, tmp_path):
    """tools/train.py trains the leaf for an epoch on a synthetic store
    and tools/test.py evaluates its testing_ twin from the checkpoint,
    with no flag added."""
    work = str(tmp_path / "train")
    metrics = train_cli.main([
        leaf, "--device", "cpu", "--epochs", "1", "--batch-size", "8",
        "--synthetic-objects", "24", "--work-dir", work,
        *_sets(leaf, True)])
    assert np.isfinite(metrics["val_match_acc"])
    tested = test_cli.main([
        "testing_" + leaf, "--device", "cpu", "--batch-size", "8",
        "--synthetic-objects", "24", "--work-dir", str(tmp_path / "test"),
        "--checkpoint", str(tmp_path / "train" / "ckpt_final.pt"),
        *_sets(leaf, True)])
    assert np.isfinite(tested["val_match_acc"])


@pytest.mark.parametrize("leaf", [POINTNET, STNET])
def test_track_cli_takes_the_new_leaves(leaf, tmp_path, capsys):
    track.main([leaf, "--device", "cpu", "--scenes", "1", "--frames", "3",
                "--objects", "4", "--pts-per-obj", "60", "--subsample",
                str(CROP), "--work-dir", str(tmp_path), *_sets(leaf, False)])
    headline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert headline["experiment"] == leaf and headline["frames"] == 3


def test_profile_train_knobs_follow_the_model():
    """tools/profile_train.py --experiment sets the kernel knobs a leaf
    takes: the concat baseline has no cross stage to set."""
    concat = train_spec(CONCAT, kernels=True)["model"]
    assert concat["knn_method"] == "pallas" and concat["cross_stage1"] is None
    pointnet = train_spec(POINTNET, kernels=True)["model"]
    assert pointnet["cross_stage2"]["attention"] == "linear-pallas"
