"""The port's data CLIs on the CPU, held against the JAX package.

The port's make_synthetic_data writes a store (the same files as the JAX
generator); the port's tools/train.py --root trains the flagship at tiny
widths for one epoch; its tools/test.py evaluates the checkpoint. The same
weights, carried to JAX by convert/jax_variables.py, go through the JAX
Trainer.evaluate over the JAX package's loaders on the same store: the pair
order, the per-pair ground truth and strata are equal, the logits within
LOGIT_TOL, the metrics equal. One tiny image (rgb_*) leaf is evaluated the
same way."""
import copy
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from point_cloud_reid_tpu import data as jd  # noqa: E402
from point_cloud_reid_tpu.configs import experiments as jexp  # noqa: E402
from point_cloud_reid_tpu.models import build_model as jax_build  # noqa: E402
from point_cloud_reid_tpu.parallel import make_mesh, shard_batch  # noqa: E402
from point_cloud_reid_tpu.train.loop import Trainer as JTrainer  # noqa: E402
from point_cloud_reid_tpu.train.state import TrainState as JTrainState  # noqa: E402
from point_cloud_reid_tpu.utils.logging import MetricLogger as JLogger  # noqa: E402
from point_cloud_reid_tpu_torch.configs import get_experiment  # noqa: E402
from point_cloud_reid_tpu_torch.convert import to_jax_variables  # noqa: E402
from point_cloud_reid_tpu_torch.models import build_model  # noqa: E402
from point_cloud_reid_tpu_torch.tools import make_synthetic_data  # noqa: E402
from point_cloud_reid_tpu_torch.tools import test as test_cli  # noqa: E402
from point_cloud_reid_tpu_torch.tools import train as train_cli  # noqa: E402
from point_cloud_reid_tpu_torch.train import to_device  # noqa: E402
from tests._torch_image import jax_variables_of, tiny_image_cfg  # noqa: E402
from tests.test_torch_track_cli import TINY_SET as MODEL_SET  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

FLAGSHIP = "pts_point-transformer_point-cat_nus_det_4x256_500e"
IMAGE_LEAF = "testing_rgb_deit-tiny_point-cat_r_nus_det_4x60_200e"
BATCH = 16             # pairs a batch (the CLIs clamp it to half an epoch)
POINT_SET = MODEL_SET + ["dataset.train.subsample_sparse=32",
                         "dataset.val.subsample_sparse=32",
                         "dataset.val.max_combinations=4"]
IMAGE_CFG = dict(tiny_image_cfg("deit-test-no-pt"), image_size=224,
                 output_sequence_size=197)
IMAGE_SET = ["model=" + repr(IMAGE_CFG), "dataset.val.max_combinations=2"]
LOGIT_TOL = 1e-4        # relative to max(1, max |JAX logit|)
PAIR_KEYS = ("val_match_gt", "match_classes", "val_cls_gt", "val_fp_gt",
             "is_fp", "num_points", "val_vis_gt_all", "distances")


@pytest.fixture(autouse=True, scope="module")
def jax_native_loaded():
    """Load the JAX package's native library before its loaders run. Its
    lazy first load is not thread-safe: BatchLoader workers that race it
    read their batches through the numpy fallback, another random stream
    (ROADMAP.md §3). The port's loader builds and loads under a lock."""
    from point_cloud_reid_tpu import native as jnative
    assert jnative.available()


def _cli_args(root, sets, *extra):
    out = ["--root", root, "--device", "cpu", "--batch-size", str(BATCH),
           *extra]
    for s in sets:
        out += ["--set", s]
    return out


@pytest.fixture(scope="module")
def point_run(tmp_path_factory):
    """The store, the one-epoch training run and the tools/test.py run."""
    base = tmp_path_factory.mktemp("cli")
    root, jroot = str(base / "store"), str(base / "jax_store")
    make_synthetic_data.main([root, "--objects", "48", "--seed", "3"])
    jd.SyntheticStore(num_objects=48, frames_per_obj=6, seed=3,
                      class_names=get_experiment(FLAGSHIP)["dataset"]
                      ["train"]["classes"], crop_size=(224, 224)).save(jroot)
    train_cli.main([FLAGSHIP, "--epochs", "1", *_cli_args(
        root, POINT_SET, "--work-dir", str(base / "train"))])
    ckpt = str(base / "train" / "ckpt_final.pt")
    metrics = test_cli.main(["testing_" + FLAGSHIP, *_cli_args(
        root, POINT_SET, "--work-dir", str(base / "test"),
        "--checkpoint", ckpt)])
    return dict(root=root, jroot=jroot, base=base, ckpt=ckpt,
                metrics=metrics)


def _port_side(leaf, sets, root, ckpt):
    """(port trainer, state) as tools/test.py builds them, and its per-pair
    eval results and loader batches."""
    args = train_cli.parse_args([leaf, *_cli_args(root, sets,
                                                  "--checkpoint", ckpt)])
    cfg = get_experiment(leaf, set_options=sets)
    trainer, state = train_cli.build_all(cfg, args, torch.device("cpu"))
    batches, results = [], []
    for batch in trainer.val_loader:
        batches.append(batch)
        res = trainer.eval_step(state, to_device(batch, "cpu"))
        results.append({k: v.numpy() for k, v in res.items()})
    return trainer, batches, results


def _jax_side(leaf, sets, root, batch_size, tmodel, variables=None):
    """JAX Trainer over the JAX package's loaders on the same store, with
    the port model's weights, on one CPU device: its per-pair results,
    batches and Trainer.evaluate metrics."""
    cfg = jexp.get_experiment(leaf, set_options=sets)
    dcfg = cfg["dataset"]
    store = jd.CropStore(root)
    complete = jd.CompleteStore(root)
    val_ds = jd.build_pair_dataset(dict(dcfg["val"], with_dense=False),
                                   store, complete)
    loader = jd.BatchLoader(val_ds, batch_size=batch_size, shuffle=False,
                            drop_last=True, num_threads=2)
    model = jax_build(copy.deepcopy(cfg["model"]))
    if variables is None:
        variables = jax.tree_util.tree_map(jnp.asarray,
                                           to_jax_variables(tmodel))
    runtime = dict(cfg["runtime"], work_dir=None, seed=66,
                   losses_to_use=cfg["losses_to_use"], alpha=cfg["alpha"],
                   cls_to_idx=dcfg["cls_to_idx"],
                   num_classes=dcfg["num_classes"],
                   fp_label_threshold=dcfg["fp_label_threshold"])
    mesh = make_mesh(devices=jax.devices()[:1])
    trainer = JTrainer(model, optax.identity(), None, loader, runtime,
                       mesh=mesh, logger=JLogger(None, quiet=True))
    state = JTrainState(params=variables["params"],
                        batch_stats=variables.get("batch_stats", {}),
                        opt_state=None, step=jnp.zeros((), jnp.int32))
    batches, results = [], []
    rng = jax.random.PRNGKey(66)
    for batch in loader:
        batches.append(batch)
        res = trainer.eval_step(state, shard_batch(mesh, batch), rng)
        results.append({k: np.asarray(v) for k, v in res.items()})
    return batches, results, trainer.evaluate(state)


def _assert_same_metrics(got, want, where="metrics"):
    assert set(got) == set(want), (where, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_same_metrics(got[k], want[k], f"{where}.{k}")
        elif k.endswith("_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=f"{where}.{k}")
        else:
            assert got[k] == want[k], (f"{where}.{k}", got[k], want[k])


def _assert_same_pairs(port_batches, port_res, jax_batches, jax_res):
    assert len(port_batches) == len(jax_batches) > 2
    for tb, jb in zip(port_batches, jax_batches):
        assert set(tb) == set(jb)
        for k in jb:
            assert np.array_equal(np.asarray(tb[k]), jb[k]), k
    got = {k: np.concatenate([r[k] for r in port_res]) for k in port_res[0]}
    want = {k: np.concatenate([r[k] for r in jax_res]) for k in jax_res[0]}
    for k in PAIR_KEYS:
        if k in want:
            np.testing.assert_array_equal(got[k].astype(np.float64),
                                          want[k].astype(np.float64), k)
    logits, jlogits = got["val_match_preds"], want["val_match_preds"]
    err = float(np.abs(logits - jlogits).max())
    assert err <= LOGIT_TOL * max(1.0, float(np.abs(jlogits).max())), err
    return logits, jlogits


def test_port_store_is_the_jax_generators(point_run):
    root, jroot = point_run["root"], point_run["jroot"]
    n = 0
    for dirpath, _, names in os.walk(jroot):
        for name in names:
            jp = os.path.join(dirpath, name)
            with open(jp, "rb") as f, open(os.path.join(
                    root, os.path.relpath(jp, jroot)), "rb") as g:
                assert f.read() == g.read(), jp
            n += 1
    # 12 FP objects of one frame, 36 TP of six, 48 complete shapes, the index
    assert n == 12 + 36 * 6 + 48 + 1


def test_train_root_writes_a_trained_checkpoint(point_run):
    base = point_run["base"]
    with open(base / "train" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r["kind"] == "train"]
    # 36 TP objects: two steps of 16 pairs
    assert train[-1]["step"] == 2 and np.isfinite(train[-1]["reid_loss"])
    saved = torch.load(point_run["ckpt"], weights_only=True)
    init = build_model(get_experiment(FLAGSHIP, set_options=POINT_SET)
                       ["model"], generator=torch.Generator().manual_seed(66))
    moved = [k for k, v in init.state_dict().items()
             if not torch.equal(v, saved["model"][k])]
    assert any("running_mean" in k for k in moved)
    assert any(k.endswith("q_proj.weight") for k in moved)
    with open(base / "test" / "eval_results_full.json") as f:
        report = json.load(f)
    assert report == json.loads(json.dumps(point_run["metrics"]))
    for key in ("val_match_acc", "val_match_f1_pos",
                "val_match_precision_pos", "val_match_recall_pos"):
        assert 0.0 <= report[key] <= 1.0, key
    assert set(report["stratified"]) == {
        "per_class", "results_per_points", "results_per_visibility",
        "results_per_distance"}


def test_test_cli_equals_jax_trainer_evaluate(point_run):
    leaf = "testing_" + FLAGSHIP
    trainer, batches, results = _port_side(leaf, POINT_SET, point_run["root"],
                                           point_run["ckpt"])
    jbatches, jresults, jmetrics = _jax_side(
        leaf, POINT_SET, point_run["root"], trainer.val_loader.batch_size,
        trainer.model)
    _assert_same_pairs(batches, results, jbatches, jresults)
    _assert_same_metrics(point_run["metrics"], jmetrics)


def test_image_leaf_evaluates_and_does_not_train(tmp_path):
    """tools/test.py on an image leaf against the JAX evaluator. (The name
    is older than image training: tools/train.py now trains the leaf, one
    epoch here, where it used to raise; test_torch_train_cli_flags.py
    checks what the training run writes.)"""
    root = str(tmp_path / "img")
    make_synthetic_data.main([root, "--objects", "12", "--frames", "4",
                              "--images", "--seed", "4"])
    leaf = IMAGE_LEAF.replace("testing_", "")
    trained = train_cli.main([leaf, "--epochs", "1", *_cli_args(
        root, IMAGE_SET, "--work-dir", str(tmp_path / "train"))])
    assert np.isfinite(trained["val_match_acc"])
    tmodel = build_model(copy.deepcopy(IMAGE_CFG),
                         generator=torch.Generator().manual_seed(1))
    ckpt = str(tmp_path / "image.pt")
    torch.save(tmodel.state_dict(), ckpt)      # a bare state_dict
    metrics = test_cli.main([IMAGE_LEAF, *_cli_args(
        root, IMAGE_SET, "--work-dir", str(tmp_path / "out"),
        "--checkpoint", ckpt)])
    trainer, batches, results = _port_side(IMAGE_LEAF, IMAGE_SET, root, ckpt)
    assert batches[0]["sparse_1"].shape == (trainer.val_loader.batch_size,
                                            3, 224, 224)
    jbatches, jresults, jmetrics = _jax_side(
        IMAGE_LEAF, IMAGE_SET, root, trainer.val_loader.batch_size, None,
        jax_variables_of(trainer.model, "deit-test-no-pt"))
    _assert_same_pairs(batches, results, jbatches, jresults)
    _assert_same_metrics(metrics, jmetrics)


def test_profile_loader_times_each_stage(point_run):
    """tools/profile_loader.py's stage timing on the CPU (no pin there): a
    positive time for the plan, the native read and the file read."""
    from point_cloud_reid_tpu_torch.data import CropStore, build_pair_dataset
    from point_cloud_reid_tpu_torch.tools import profile_loader
    store = CropStore(point_run["root"])
    ds = build_pair_dataset(get_experiment(FLAGSHIP)["dataset"]["val"],
                            store)
    out = profile_loader.stage_ms(ds, 2, 16, pin=False)
    assert set(out) == {"plan", "native", "files"}
    assert all(v > 0 for v in out.values())
