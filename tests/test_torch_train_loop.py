"""The port's losses, schedule, configs, eval step and Trainer against the
JAX package on the same numpy inputs (CPU, tiny shapes). The triplet
negatives are JAX's draw, injected into the port."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.configs import experiments as jexp  # noqa: E402
from point_cloud_reid_tpu.train import losses as jl  # noqa: E402
from point_cloud_reid_tpu.train import schedules as jsched  # noqa: E402
from point_cloud_reid_tpu.train.loop import make_eval_step as j_eval_step  # noqa: E402
from point_cloud_reid_tpu.train.state import TrainState as JTrainState  # noqa: E402
from point_cloud_reid_tpu_torch import configs as tcfg  # noqa: E402
from point_cloud_reid_tpu_torch.models import build_model  # noqa: E402
from point_cloud_reid_tpu_torch.train import (ScheduleConfig,  # noqa: E402
                                              SyntheticPairLoader, Trainer,
                                              TrainState, cyclic_schedule,
                                              make_eval_step, param_count)
from point_cloud_reid_tpu_torch.train import losses as tl  # noqa: E402
from tests._torch_port import (KNOBS, jax_negatives, pair_batch,  # noqa: E402
                               tiny_cfg, torch_batch, train_models)
from tests._torch_threads import few_threads  # noqa: E402,F401

LOSS_TOL = 1e-5
FLAGSHIP = "pts_point-transformer_point-cat_nus_det_4x256_500e"


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol=LOSS_TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _loss_case(name):
    """(port value, JAX value) of one loss function on seeded inputs."""
    rs = np.random.RandomState(sum(map(ord, name)))
    B = 8
    f32 = np.float32
    logits = (rs.randn(B) * 3).astype(f32)
    target = (rs.rand(B) > 0.5).astype(f32)
    weights = (rs.rand(B) > 0.3)
    h1, h2 = rs.randn(B, 6, 5).astype(f32), rs.randn(B, 6, 5).astype(f32)
    ids = np.arange(B, dtype=np.int32)
    id2 = np.where(np.arange(B) % 2 == 0, ids, (ids + 3) % B).astype(np.int32)
    match = (ids == id2).astype(f32)
    if name == "bce":
        a = (logits, target)
        return tl.bce_with_logits(*_t(*a)), jl.bce_with_logits(*_j(*a))
    if name == "bce_weighted":
        a = (logits, target, weights)
        return tl.bce_with_logits(*_t(*a)), jl.bce_with_logits(*_j(*a))
    if name in ("softmax_ce", "softmax_ce_weighted"):
        a = [(rs.randn(B, 7) * 2).astype(f32),
             rs.randint(0, 7, B).astype(np.int32)]
        if name.endswith("weighted"):
            a.append(weights)
        return tl.softmax_ce(*_t(*a)), jl.softmax_ce(*_j(*a))
    if name in ("smooth_l1", "smooth_l1_weighted"):
        a = ((rs.randn(B, 9) * 2).astype(f32), rs.randn(B, 9).astype(f32))
        w = weights if name.endswith("weighted") else None
        return (tl.smooth_l1(*_t(*a), weights=None if w is None
                             else torch.from_numpy(w)),
                jl.smooth_l1(*_j(*a), weights=None if w is None
                             else jnp.asarray(w)))
    if name == "kl_pair":
        a = (h1, h2, match)
        return tl.kl_pair_loss(*_t(*a)), jl.kl_pair_loss(*_j(*a))
    if name == "chamfer":
        a = (rs.randn(B, 10, 3).astype(f32), rs.randn(B, 14, 3).astype(f32))
        return tl.chamfer_per_sample(*_t(*a)), jl.chamfer_per_sample(*_j(*a))
    if name == "shape":
        a = (rs.randn(B, 10, 3).astype(f32), rs.randn(B, 14, 3).astype(f32),
             weights)
        return tl.shape_loss(*_t(*a)), jl.shape_loss(*_j(*a))
    if name == "triplet":
        key = jax.random.PRNGKey(5)
        neg = jax_negatives(key, ids, id2, 4)
        want = jl.triplet_loss(key, *_j(h1, h2, ids, id2, match),
                               sample_num=4, margin=0.3)
        got = tl.triplet_loss(*_t(h1, h2, ids, id2, match), sample_num=4,
                              margin=0.3, neg_idx=torch.from_numpy(neg))
        return got, want
    if name == "dense_distill":
        a = (h1, h2, np.where(weights, ids, -1).astype(np.int32))
        return tl.dense_distill_loss(*_t(*a)), jl.dense_distill_loss(*_j(*a))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "bce", "bce_weighted", "softmax_ce", "softmax_ce_weighted", "smooth_l1",
    "smooth_l1_weighted", "kl_pair", "chamfer", "shape", "triplet",
    "dense_distill"])
def test_loss_matches_jax(name):
    got, want = _loss_case(name)
    _close(got, want, what=name)


def test_match_metrics_match_jax():
    rs = np.random.RandomState(3)
    logits = (rs.randn(16) * 2).astype(np.float32)
    match = (rs.rand(16) > 0.5).astype(np.float32)
    got = tl.match_metrics(*_t(logits, match), prefix="val_")
    want = jl.match_metrics(*_j(logits, match), prefix="val_")
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], what=k)


def _fake_outputs(rs, B, n, C, n_cls, dense):
    f32 = np.float32
    return dict(
        h1=rs.randn(B, n, C).astype(f32), h2=rs.randn(B, n, C).astype(f32),
        o1=rs.randn(B, n, C).astype(f32), o2=rs.randn(B, n, C).astype(f32),
        match_logits=(rs.randn(B) * 2).astype(f32),
        cls_logits=rs.randn(2 * B, n_cls).astype(f32),
        fp_logits=rs.randn(2 * B).astype(f32),
        shape_points=rs.randn(2 * B, n, 3).astype(f32),
        vis_logits=rs.randn(2 * B, 4).astype(f32))


@pytest.mark.parametrize("use_o", [False, True], ids=["h", "o"])
def test_reid_losses_match_jax(use_o):
    """Every loss on at once (vis included), weighted by alpha: the total
    and every logged value."""
    rs = np.random.RandomState(11)
    B, n, C = 6, 8, 5
    batch = pair_batch(12, B=B, n_pts=n, dense=10)
    batch["vis_1"][0] = -1
    out = _fake_outputs(rs, B, n, C, 20, 10)
    out["match"] = (batch["id_1"] == batch["id_2"]).astype(np.float32)
    dense_feats = rs.randn(2 * B, n, C).astype(np.float32)
    use = dict(match=True, cls=True, fp=True, shape=True, kl=True,
               dense=True, vis=True, triplet=True)
    alpha = dict(match=1.0, cls=0.5, fp=0.25, shape=2.0, kl=0.1, dense=0.3,
                 vis=0.7, triplet=1.5)
    key = jax.random.PRNGKey(2)
    neg = jax_negatives(key, batch["id_1"], batch["id_2"], 5)
    jtotal, jlog = jl.reid_losses(
        {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, use, alpha, rng=key,
        dense_feats=jnp.asarray(dense_feats), use_o=use_o)
    ttotal, tlog = tl.reid_losses(
        {k: torch.from_numpy(v) for k, v in out.items()}, torch_batch(batch),
        use, alpha, dense_feats=torch.from_numpy(dense_feats), use_o=use_o,
        neg_idx=torch.from_numpy(neg))
    assert set(tlog) == set(jlog)
    assert {"match_loss", "cls_loss", "fp_loss", "shape_loss", "kl_loss",
            "dense_loss", "vis_loss", "triplet_loss", "reid_loss"} <= set(tlog)
    _close(ttotal, jtotal, what="total")
    for k in jlog:
        _close(tlog[k], jlog[k], what=k)


def test_draw_negatives_differ_from_the_anchor_and_follow_the_generator():
    ids = torch.tensor([0, 1, 2, 3, 3, 5])
    id2 = torch.tensor([0, 9, 2, 8, 3, -1])
    g = torch.Generator().manual_seed(3)
    neg = tl.draw_negatives(ids, id2, 7, g)
    assert neg.shape == (6, 7)
    cat = torch.cat([ids, id2])
    assert (cat[neg] != ids[:, None]).all()
    again = tl.draw_negatives(ids, id2, 7, torch.Generator().manual_seed(3))
    assert torch.equal(neg, again)
    # an anchor with no valid negative draws index 0
    same = torch.zeros(3, dtype=torch.long)
    assert (tl.draw_negatives(same, same, 4, g) == 0).all()


# ---- schedule and configs ----------------------------------------------------

@pytest.mark.parametrize("what", ["lr", "beta1"])
def test_cyclic_schedule_matches_jax(what):
    cfg = ScheduleConfig()
    total = 500 * 37
    up = int(total * cfg.step_ratio_up)
    base, ratio = ((cfg.lr, cfg.target_ratio) if what == "lr"
                   else (cfg.momentum_base, cfg.momentum_ratio))
    tfn = cyclic_schedule(base, total, ratio, cfg.step_ratio_up)
    jfn = jsched.cyclic_schedule(base, total, ratio, cfg.step_ratio_up)
    with jax.enable_x64():
        for step in (0, up - 1, up, total - 1, total + 5):
            want = float(jfn(jnp.asarray(step, jnp.int64)))
            assert abs(tfn(step) - want) <= 1e-7 * abs(want), (step, want)
    assert tfn(0) == pytest.approx(base)
    assert tfn(up) == pytest.approx(base * ratio[0])
    assert tfn(total + 5) == tfn(total - 1)


@pytest.mark.parametrize("name", ["cyclic_500e_lr3e-4", "cosine",
                                  "cyclic_200e_lr1e-4_norm1",
                                  "cyclic_40e_lr3e-4_norm1_accum2"])
def test_schedule_names_parse_as_in_jax(name):
    assert (dataclasses.asdict(tcfg.schedule(name))
            == dataclasses.asdict(jexp.schedule(name)))


def test_flagship_experiment_and_overrides_match_jax():
    sets = ["model.knn_method=pallas",
            "model.cross_stage1.attention=linear-pallas",
            "model.cross_stage2.attention=linear-pallas",
            "losses_to_use.match=false", "schedule.lr=1e-4",
            "model.backbone_list=64,32,16"]
    for prefix in ("", "testing_"):
        t = tcfg.get_experiment(prefix + FLAGSHIP, set_options=sets)
        j = jexp.get_experiment(prefix + FLAGSHIP, set_options=sets)
        assert t["model"] == j["model"]
        assert (dataclasses.asdict(t["schedule"])
                == dataclasses.asdict(j["schedule"]))
        assert t["losses_to_use"] == j["losses_to_use"]
        assert t["alpha"] == j["alpha"]
        assert t["runtime"] == j["runtime"]
        for k in ("cls_to_idx", "num_classes", "fp_label_threshold",
                  "samples_per_device"):
            assert t["dataset"][k] == j["dataset"][k], k
        assert (t["dataset"]["subsample_sparse"]
                == j["dataset"]["train"]["subsample_sparse"] == 128)
    # a new key on a dict that is no component raises, in both packages
    for mod in (tcfg, jexp):
        with pytest.raises(KeyError):
            mod.get_experiment(FLAGSHIP, set_options=["losses_to_use.kl=true"])
    with pytest.raises(AttributeError):
        tcfg.get_experiment(FLAGSHIP, set_options=["schedule.nope=1"])
    with pytest.raises(KeyError, match="unknown experiment"):
        # a name neither package registers
        tcfg.get_experiment("pts_no-such-net_point-cat_nus_det_4x256_500e")


# ---- eval step ---------------------------------------------------------------

def test_eval_step_matches_jax():
    jmodel, jvars, tmodel = train_models(**KNOBS)
    batch = pair_batch(21)
    use = dict(match=True, cls=True, fp=True, kl=True)
    alpha = dict(kl=0.1)
    jstate = JTrainState(params=jvars["params"],
                         batch_stats=jvars["batch_stats"], opt_state=None,
                         step=jnp.zeros((), jnp.int32))
    want = j_eval_step(jmodel, use, alpha, fp_label_threshold=9)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    got = make_eval_step(tmodel, use, alpha, fp_label_threshold=9)(
        None, torch_batch(batch))
    assert set(got) == set(want) == {
        "val_match_preds", "val_match_gt", "match_classes", "val_cls_gt",
        "val_fp_gt", "is_fp", "val_cls_preds", "val_fp_preds", "num_points",
        "val_vis_gt_all", "distances", "val_match_loss", "val_cls_loss",
        "val_fp_loss", "val_kl_loss", "val_reid_loss"}
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(
            got[k].numpy().astype(np.float64),
            np.asarray(want[k]).astype(np.float64), rtol=1e-3, atol=1e-3,
            err_msg=k)
    # an eval step changes nothing in the model
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, before[k]), k


# ---- Trainer -----------------------------------------------------------------

def _tiny_trainer(work_dir, seed=0, **cfg):
    model = build_model(tiny_cfg(**KNOBS),
                        generator=torch.Generator().manual_seed(seed))
    loaders = [SyntheticPairLoader(batch_size=4, num_batches=n, num_points=32,
                                   num_objects=12, seed=s)
               for n, s in ((3, 1), (2, 2))]
    runtime = dict(work_dir=str(work_dir), seed=seed, max_epochs=2,
                   eval_interval=1, checkpoint_interval=1, max_keep_ckpts=1,
                   log_interval=2,
                   losses_to_use=dict(match=True, kl=True, triplet=True,
                                      cls=True, fp=True),
                   alpha=dict(kl=0.1), num_classes=10, fp_label_threshold=9,
                   cls_to_idx={"car": 0, "truck": 1})
    runtime.update(cfg)
    from point_cloud_reid_tpu_torch.utils.logging import MetricLogger
    trainer = Trainer(model, loaders[0], loaders[1], runtime,
                      logger=MetricLogger(str(work_dir), quiet=True))
    state = TrainState.create(
        model, ScheduleConfig(max_epochs=2, lr=1e-3), steps_per_epoch=3)
    return trainer, state


def _next_loss(trainer, state, seed=9):
    batch = torch_batch(pair_batch(seed, B=4))
    g = torch.Generator().manual_seed(0)
    _, log = trainer.train_step(state, batch, g)
    return float(log["reid_loss"]), float(log["grad_norm"])


def test_trainer_fit_and_checkpoint_round_trip(tmp_path):
    trainer, state = _tiny_trainer(tmp_path / "a")
    assert param_count(state.model) > 10000
    w0 = {k: v.clone() for k, v in state.model.state_dict().items()}
    state = trainer.fit(state)
    assert state.step == 6 and state.optimizer.updates == 6
    changed = [k for k, v in state.model.state_dict().items()
               if not torch.equal(v, w0[k])]
    assert any("running_mean" in k for k in changed)
    assert any(k.endswith("q_proj.weight") for k in changed)
    files = sorted(os.listdir(tmp_path / "a"))
    # interval checkpoints keep the newest one only; best, last, final stay
    assert [f for f in files if f.startswith("ckpt_")] == [
        "ckpt_best.pt", "ckpt_epoch_2.pt", "ckpt_final.pt", "ckpt_last.pt"]
    records = [json.loads(line) for line in
               open(tmp_path / "a" / "metrics.jsonl")]
    train = [r for r in records if r["kind"] == "train"]
    assert [r["step"] for r in train] == [2, 3, 5, 6]
    assert all(np.isfinite(r["reid_loss"]) and np.isfinite(r["grad_norm"])
               for r in train)
    evals = [r for r in records if r["kind"] == "eval"]
    assert len(evals) == 2 and 0.0 <= evals[-1]["val_match_acc"] <= 1.0
    assert os.path.exists(tmp_path / "a" / "eval_results.json")

    # save -> load gives the same next step
    path = trainer.save_checkpoint(state, tag="probe")
    trainer_b, state_b = _tiny_trainer(tmp_path / "b", seed=5)
    state_b = trainer_b.load_checkpoint(state_b, path)
    assert state_b.step == 6 and state_b.optimizer.updates == 6
    assert _next_loss(trainer_b, state_b) == _next_loss(trainer, state)
    for (k, a), b in zip(state.model.state_dict().items(),
                         state_b.model.state_dict().values()):
        assert torch.equal(a, b), k

    # load_weights: the weights, but a fresh optimizer and step
    trainer_c, state_c = _tiny_trainer(tmp_path / "c", seed=6)
    state_c = trainer_c.load_weights(state_c, path)
    assert state_c.step == 0 and state_c.optimizer.updates == 0
    assert not state_c.optimizer.adamw.state
    saved = torch.load(path, weights_only=True)["model"]
    for k, v in state_c.model.state_dict().items():
        assert torch.equal(v, saved[k]), k


def test_trainer_dense_loss_leaves_batchnorm_to_the_sparse_forward(tmp_path):
    """The dense branch is a no-grad eval forward: with the dense loss on,
    the running statistics move exactly as without it."""
    stats = []
    for dense in (False, True):
        trainer, state = _tiny_trainer(
            tmp_path / str(dense),
            losses_to_use=dict(match=True, dense=dense))
        batch = torch_batch(pair_batch(4, B=4, dense=32))
        _, log = trainer.train_step(state, batch)
        assert ("dense_loss" in log) == dense
        stats.append({k: v.clone() for k, v in state.model.state_dict().items()
                      if "running_" in k})
    for k in stats[0]:
        assert torch.equal(stats[0][k], stats[1][k]), k


def test_synthetic_loader_is_seeded_per_epoch():
    a = SyntheticPairLoader(4, 2, num_points=16, seed=3, dense_points=20)
    b = SyntheticPairLoader(4, 2, num_points=16, seed=3, dense_points=20)
    a.set_epoch(1)
    b.set_epoch(1)
    first = list(a)
    assert len(a) == 2 == len(first)
    assert first[0]["sparse_1"].shape == (4, 16, 3)
    assert first[0]["dense_2"].shape == (4, 20, 3)
    assert {"id_1", "id_2", "label_1", "label_2", "size_1", "vis_2",
            "dist_1"} <= set(first[0])
    for x, y in zip(first, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    b.set_epoch(2)
    assert not np.array_equal(first[0]["sparse_1"], next(iter(b))["sparse_1"])
    both = np.concatenate([x["id_1"] == x["id_2"] for x in first])
    assert both.any() and not both.all()
