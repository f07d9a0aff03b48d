"""The port's reference-checkpoint path end to end on the CPU at tiny width
(tests/test_torch_track_cli.py::TINY_SET): a reference-named .pth (the
JAX suite's torch replica of the flagship, in mmcv's envelope with DDP
prefixes) through tools.convert_checkpoint into tools.test, and through
tools.parity_eval --pth: the same accuracy, delta 0 and exit 0 at it, exit
1 past the tolerance; --ckpt, --pairs replay and --image as well."""
import copy
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from point_cloud_reid_tpu_torch.configs import experiments as E  # noqa: E402
from point_cloud_reid_tpu_torch.configs import get_experiment  # noqa: E402
from point_cloud_reid_tpu_torch.convert import (  # noqa: E402
    reference_state_dict)
from point_cloud_reid_tpu_torch.data import (SyntheticStore,  # noqa: E402
                                             build_pair_dataset)
from point_cloud_reid_tpu_torch.models import build_model  # noqa: E402
from point_cloud_reid_tpu_torch.tools import (  # noqa: E402
    convert_checkpoint, parity_eval)
from point_cloud_reid_tpu_torch.tools import test as test_cli  # noqa: E402
from tests._torch_image import tiny_image_cfg  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401
from tests.test_convert_full_model import TorchReIDNet  # noqa: E402
from tests.test_torch_track_cli import TINY_SET  # noqa: E402

LEAF = "testing_pts_point-transformer_point-cat_nus_det_4x256_500e"
SETS = TINY_SET + ["dataset.val.subsample_sparse=32",
                   "dataset.val.max_combinations=4"]
DATA = ["--synthetic-objects", "24", "--batch-size", "16", "--device", "cpu"]


def _sets(sets):
    out = []
    for s in sets:
        out += ["--set", s]
    return out


@pytest.fixture(scope="module")
def replica_pth(tmp_path_factory):
    """The flagship replica's reference-named state dict as a released
    file: mmcv envelope, 'module.' prefixes, Conv2d SA convs, BatchNorm's
    num_batches_tracked, the FP modules' dead convs."""
    torch.manual_seed(3)
    sd = TorchReIDNet(conv_out=16).eval().state_dict()
    assert sd["backbone.SA_modules.0.mlp_convs.0.weight"].ndim == 4
    assert any(k.endswith("num_batches_tracked") for k in sd)
    sd["backbone.FP_modules.0.mlp_convs.0.weight"] = torch.ones(16, 16, 1)
    path = str(tmp_path_factory.mktemp("pth") / "replica.pth")
    torch.save({"meta": {}, "state_dict": {"module." + k: v
                                           for k, v in sd.items()}}, path)
    return path


@pytest.fixture(scope="module")
def tiny_leaf():
    """The flagship testing leaf at tiny width under a name of its own:
    tools.convert_checkpoint takes the JAX tool's arguments, no --set."""
    name = "testing_tiny_reference_path"
    E.EXPERIMENTS[name] = lambda **kw: E.apply_overrides(
        E.EXPERIMENTS[LEAF](**kw), TINY_SET)
    yield name
    del E.EXPERIMENTS[name]


def _parity(capsys, *argv):
    code = 0
    try:
        parity_eval.main(list(argv))
    except SystemExit as e:
        code = e.code
    return code, json.loads(capsys.readouterr().out)


def test_convert_then_test_and_parity_eval_agree(replica_pth, tiny_leaf,
                                                 tmp_path, capsys):
    ckpt = convert_checkpoint.main([replica_pth, tiny_leaf,
                                    str(tmp_path / "conv")])
    saved = json.loads(capsys.readouterr().out.splitlines()[0])
    assert saved == dict(saved=ckpt, unmatched_torch=0, unfilled_flax=0)
    metrics = test_cli.main([LEAF, "--checkpoint", ckpt, "--work-dir",
                             str(tmp_path / "test"), *DATA, *_sets(SETS)])
    capsys.readouterr()
    acc = 100.0 * metrics["val_match_acc"]

    wd = str(tmp_path / "parity")
    code, out = _parity(capsys, LEAF, "--pth", replica_pth, "--work-dir", wd,
                        "--expected-acc", repr(acc), *DATA, *_sets(SETS))
    assert code == 0
    assert out["delta_pct"] == 0.0 and out["parity"] is True
    assert out["val_match_acc_pct"] == round(acc, 3)
    with open(os.path.join(wd, "parity_report.json")) as f:
        report = json.load(f)
    assert report["val_match_acc_pct"] == out["val_match_acc_pct"]
    assert report["full_metrics"]["val_match_acc"] == metrics["val_match_acc"]

    code, out = _parity(capsys, LEAF, "--pth", replica_pth, "--expected-acc",
                        repr(acc + 0.6), *DATA, *_sets(SETS))
    assert code == 1 and out["parity"] is False
    # a converted checkpoint through --ckpt gives the same accuracy
    code, out = _parity(capsys, LEAF, "--ckpt", ckpt, "--expected-acc",
                        repr(acc), *DATA, *_sets(SETS))
    assert code == 0 and out["delta_pct"] == 0.0


def test_frozen_pairs_replay_the_seeded_accuracy(replica_pth, tmp_path,
                                                 capsys):
    code, base = _parity(capsys, LEAF, "--pth", replica_pth, *DATA,
                         *_sets(SETS))
    assert code == 0 and "delta_pct" not in base
    cfg = get_experiment(LEAF, set_options=SETS)
    store = SyntheticStore(num_objects=24, class_names=list(
        cfg["dataset"]["train"]["classes"]), crop_size=(32, 32))
    val = build_pair_dataset(cfg["dataset"]["val"], store, store)
    pairs = tmp_path / "pairs.json"
    with open(pairs, "w") as f:
        json.dump(val.dump_pairs(), f)
    code, replay = _parity(capsys, LEAF, "--pth", replica_pth, "--pairs",
                           str(pairs), *DATA, *_sets(SETS))
    assert code == 0
    assert replay["val_match_acc_pct"] == base["val_match_acc_pct"]


def test_image_checkpoint_through_parity_eval(tmp_path, capsys):
    """--image: an ImageReIDNet state dict under HF names below
    backbone.deit., with the teacher's classifier and the cross stages'
    dead pos_mlp, scored as tools.test scores the same weights."""
    leaf = "testing_rgb_deit-tiny_point-cat_r_nus_det_4x60_200e"
    cfg = dict(tiny_image_cfg("deit-test-no-pt"), image_size=224,
               output_sequence_size=197)
    sets = ["model=" + repr(cfg), "dataset.val.max_combinations=2"]
    model = build_model(copy.deepcopy(cfg),
                        generator=torch.Generator().manual_seed(6))
    sd = {k.replace("backbone.", "backbone.deit.", 1): v
          for k, v in reference_state_dict(model).items()}
    sd["backbone.cls_classifier.weight"] = torch.ones(10, 32)
    sd["backbone.pooler.dense.weight"] = torch.ones(32, 32)
    for i in (1, 2):
        sd[f"cross_stage{i}.pos_mlp.0.weight"] = torch.ones(16, 3)
    pth = str(tmp_path / "image.pth")
    torch.save(sd, pth)
    ckpt = str(tmp_path / "image.pt")
    torch.save(model.state_dict(), ckpt)
    data = ["--synthetic-objects", "12", "--batch-size", "8", "--device",
            "cpu"]
    metrics = test_cli.main([leaf, "--checkpoint", ckpt, "--work-dir",
                             str(tmp_path / "t"), *data, *_sets(sets)])
    capsys.readouterr()
    acc = 100.0 * metrics["val_match_acc"]
    assert np.isfinite(acc)
    code, out = _parity(capsys, leaf, "--pth", pth, "--image",
                        "--expected-acc", repr(acc), *data, *_sets(sets))
    assert code == 0 and out["delta_pct"] == 0.0
