"""The training CLI's flags on the CPU: --remat, --bf16, --profile, the
image (rgb_*) leaves, tools/test.py --bf16 and tools/profile_train.py's
set-up for the bf16, remat and image steps.

--remat is held to the plain step of the same model, point and image: the
recompute changes no number (equal logs, weights and running statistics
to float32 rounding), each stage's forward really runs twice, and the
BatchNorm running statistics move once. The CLIs run at tiny widths (the point flagship at
tests/test_torch_track_cli.TINY_SET, the image leaf on the tiny
'deit-test-no-pt' ViT at 224 x 224, as tests/test_torch_data_cli.py runs
them)."""
import copy
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from point_cloud_reid_tpu_torch.configs import get_experiment  # noqa: E402
from point_cloud_reid_tpu_torch.models import build_model  # noqa: E402
from point_cloud_reid_tpu_torch.models.layers import BatchNorm  # noqa: E402
from point_cloud_reid_tpu_torch.tools import make_synthetic_data  # noqa: E402
from point_cloud_reid_tpu_torch.tools import profile_train  # noqa: E402
from point_cloud_reid_tpu_torch.tools import test as test_cli  # noqa: E402
from point_cloud_reid_tpu_torch.tools import train as train_cli  # noqa: E402
from point_cloud_reid_tpu_torch.train import (ScheduleConfig,  # noqa: E402
                                              TrainState, make_train_step)
from tests._torch_image import images, tiny_image_cfg  # noqa: E402
from tests._torch_port import (KNOBS, pair_batch, tiny_cfg,  # noqa: E402
                               torch_batch)
from tests.test_torch_track_cli import TINY_SET  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

FLAGSHIP = "pts_point-transformer_point-cat_nus_det_4x256_500e"
IMAGE_LEAF = "rgb_deit-tiny_point-cat_r_nus_det_4x60_200e"
POINT_SET = TINY_SET + ["dataset.train.subsample_sparse=32",
                        "dataset.val.subsample_sparse=32",
                        "dataset.val.max_combinations=4",
                        "model.knn_method=pallas",
                        "model.cross_stage1.attention=linear-pallas",
                        "model.cross_stage2.attention=linear-pallas"]
IMAGE_CFG = dict(tiny_image_cfg("deit-test-no-pt"), image_size=224,
                 output_sequence_size=197)
IMAGE_SET = ["model=" + repr(IMAGE_CFG), "dataset.val.max_combinations=2"]
USE = dict(match=True, kl=True, triplet=True, cls=True, fp=True)
ALPHA = dict(kl=0.1, cls=0.5)
# remat against plain: the same operations on the same values, so float32
# rounding alone, relative to max(1, |plain|)
REMAT_TOL = 1e-6


def _sets(sets):
    out = []
    for s in sets:
        out += ["--set", s]
    return out


def _params_float32(state_dict) -> bool:
    return all(v.dtype == torch.float32 for k, v in state_dict.items()
               if v.is_floating_point())


# ---- --remat -----------------------------------------------------------------

def _one_step(kind: str, remat: bool):
    """One step of the tiny flagship (knobs on) or the tiny image model,
    with or without remat: the logs, the state dict after it, the state
    dict before it and how many times a module inside the first stage
    ran."""
    if kind == "point":
        model = build_model(tiny_cfg(**KNOBS),
                            generator=torch.Generator().manual_seed(0))
        batch, use = pair_batch(30), USE
        inner = model.backbone.SA_modules[0].mlp_bns[0]
        assert isinstance(inner, BatchNorm)
    else:
        model = build_model(tiny_image_cfg("deit-test"),
                            generator=torch.Generator().manual_seed(0))
        batch = dict(pair_batch(30), sparse_1=images(1, 6),
                     sparse_2=images(2, 6))
        use = dict(match=True, cls=True, fp=True, vis=True, triplet=True)
        inner = model.backbone.blocks[0].attn
    state = TrainState.create(model, ScheduleConfig(max_epochs=1), 2)
    step = make_train_step(model, use, ALPHA, remat=remat)
    calls = []
    inner.register_forward_hook(lambda *a: calls.append(1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, log = step(state, torch_batch(batch), torch.Generator().manual_seed(3))
    return ({k: float(v) for k, v in log.items()},
            {k: v.clone() for k, v in model.state_dict().items()}, before,
            len(calls))


@pytest.mark.parametrize("kind", ["point", "image"])
def test_remat_step_equals_the_plain_step(kind):
    plain_log, plain, start, plain_calls = _one_step(kind, False)
    log, got, start_r, calls = _one_step(kind, True)
    # the recompute ran the stage's forward a second time
    assert (plain_calls, calls) == (1, 2)
    assert set(log) == set(plain_log)
    for k, want in plain_log.items():
        assert abs(log[k] - want) <= REMAT_TOL * max(1.0, abs(want)), (
            k, log[k], want)
    for k, want in plain.items():
        assert torch.equal(start[k], start_r[k])
        if not want.is_floating_point():
            assert torch.equal(got[k], want), k
            continue
        err = (got[k] - want).abs().max().item()
        assert err <= REMAT_TOL * max(1.0, want.abs().max().item()), (k, err)
    if kind == "image":
        return
    # the running statistics moved, and once: what the plain step's single
    # update gives (a second update would move them by another 10 %)
    for k in ("backbone.SA_modules.0.mlp_bns.0.running_mean",
              "backbone.SA_modules.2.mlp_bns.2.running_var"):
        assert not torch.equal(got[k], start[k]), k
        moved, plain_moved = got[k] - start[k], plain[k] - start[k]
        assert torch.allclose(moved, plain_moved, rtol=1e-5, atol=1e-7), k


# ---- the CLIs ----------------------------------------------------------------

@pytest.fixture(scope="module")
def point_run(tmp_path_factory):
    """tools/train.py --bf16 --remat --profile on the tiny flagship, one
    epoch of a SyntheticStore; then tools/test.py --bf16 from its
    checkpoint."""
    base = tmp_path_factory.mktemp("flags")
    work, prof = str(base / "train"), str(base / "trace")
    metrics = train_cli.main([
        FLAGSHIP, "--device", "cpu", "--epochs", "1", "--batch-size", "8",
        "--synthetic-objects", "24", "--bf16", "--remat", "--profile", prof,
        "--work-dir", work, *_sets(POINT_SET)])
    ckpt = os.path.join(work, "ckpt_final.pt")
    tested = test_cli.main([
        "testing_" + FLAGSHIP, "--device", "cpu", "--batch-size", "8",
        "--synthetic-objects", "24", "--bf16", "--checkpoint", ckpt,
        "--work-dir", str(base / "test"), *_sets(POINT_SET)])
    return dict(base=base, work=work, prof=prof, ckpt=ckpt, metrics=metrics,
                tested=tested)


def test_train_cli_bf16_remat_trains_and_evaluates(point_run):
    with open(os.path.join(point_run["work"], "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    train = [r for r in lines if r["kind"] == "train"]
    assert train and all(np.isfinite(r["reid_loss"]) for r in train)
    assert np.isfinite(point_run["metrics"]["val_match_acc"])
    saved = torch.load(point_run["ckpt"], weights_only=True)
    # float32 parameters, running statistics and AdamW moments at bf16
    assert _params_float32(saved["model"])
    moments = [v for s in saved["optimizer"]["adamw"]["state"].values()
               for v in s.values() if torch.is_tensor(v) and v.dim()]
    assert moments and all(v.dtype == torch.float32 for v in moments)
    init = build_model(get_experiment(FLAGSHIP, set_options=POINT_SET)[
        "model"], generator=torch.Generator().manual_seed(66))
    for k in ("backbone.SA_modules.0.mlp_convs.0.weight",
              "backbone.SA_modules.0.mlp_bns.0.running_var"):
        assert not torch.equal(saved["model"][k], init.state_dict()[k]), k


def test_profile_flag_writes_a_trace(point_run):
    path = os.path.join(point_run["prof"], "trace.json")
    with open(path) as f:
        trace = json.load(f)
    names = {ev.get("name", "") for ev in trace["traceEvents"]}
    # the host ops of the training steps: products and the optimizer
    assert any("addmm" in n or "linear" in n for n in names)
    assert any("adamw" in n.lower() or "_foreach" in n for n in names)


def test_test_cli_evaluates_at_bf16(point_run):
    """tools/test.py --bf16 from the bf16 run's checkpoint: the metrics of
    the train command's closing eval (the same weights, the same val
    pairs, the same bf16 model)."""
    got, want = point_run["tested"], point_run["metrics"]
    assert os.path.exists(point_run["base"] / "test"
                          / "eval_results_full.json")
    for k in ("val_match_acc", "val_match_loss"):
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6), k


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_train_cli_trains_an_image_leaf(tmp_path, bf16):
    """An rgb_*_r_* leaf from an on-disk image store (--root), one epoch,
    then the closing eval: finite losses of the full image loss set, moved
    backbone and head weights, float32 parameters, eval metrics."""
    root = str(tmp_path / "img")
    make_synthetic_data.main([root, "--objects", "12", "--frames", "4",
                              "--images", "--seed", "4"])
    work = str(tmp_path / "train")
    metrics = train_cli.main([
        IMAGE_LEAF, "--root", root, "--device", "cpu", "--epochs", "1",
        "--batch-size", "8", "--work-dir", work, *(["--bf16"] * bf16),
        *_sets(IMAGE_SET)])
    with open(os.path.join(work, "metrics.jsonl")) as f:
        train = [json.loads(line) for line in f]
    last = [r for r in train if r["kind"] == "train"][-1]
    for k in ("match_loss", "cls_loss", "fp_loss", "vis_loss",
              "triplet_loss", "reid_loss", "grad_norm"):
        assert np.isfinite(last[k]), (k, last)
    assert np.isfinite(metrics["val_match_acc"])
    saved = torch.load(os.path.join(work, "ckpt_final.pt"),
                       weights_only=True)["model"]
    assert _params_float32(saved)
    init = build_model(copy.deepcopy(IMAGE_CFG),
                       generator=torch.Generator().manual_seed(66))
    for k in ("backbone.blocks.0.attn.qkv.weight", "match_head.1.weight",
              "vis_head.1.weight"):
        assert not torch.equal(saved[k], init.state_dict()[k]), k


# ---- tools/profile_train.py's set-up -------------------------------------

@pytest.mark.parametrize("experiment,bf16,remat", [
    (None, True, True), (IMAGE_LEAF, True, False), (IMAGE_LEAF, False, False)],
    ids=["flagship_bf16_remat", "image_bf16", "image_float32"])
def test_profile_train_setup_runs_a_step(experiment, bf16, remat):
    """The configurations tools/profile_train.py times on the card, at their
    full widths, two pairs, on the CPU: one train step and one loss of the
    phase split, finite; the image leaf with its own losses."""
    spec = profile_train.train_spec(experiment, kernels=True)
    if experiment:
        assert spec["image_size"] == 224 and spec["triplet_margin"] == 10.0
        assert spec["losses"]["vis"] and spec["losses"]["triplet"]
    else:
        assert spec["model"]["knn_method"] == "pallas"
    run = profile_train.train_setup(spec, torch.device("cpu"), batch=2,
                                    n_batches=2, bf16=bf16, remat=remat)
    assert run["model"].dtype == (torch.bfloat16 if bf16 else torch.float32)
    _, log = run["step"](run["state"], run["batches"][0], run["generator"])
    assert all(np.isfinite(float(v)) for v in log.values())
    loss = run["loss"](run["batches"][1])
    assert loss.dtype == torch.float32 and np.isfinite(loss.item())
