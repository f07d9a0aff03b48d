"""The port's parallel layer (point_cloud_reid_tpu_torch/parallel) and the
sharded scorer against the JAX package.

Data parallel: two gloo processes on the CPU (tests/_torch_dp_worker.py),
started once for the file and joined through a FileStore under tmp_path,
each with its own timeout (a hang fails, it never skips). Their step is
the step over the global batch:

  - JAX tests/test_parallel.py's TINY model: two ranks' steps in float64
    against JAX's step on make_mesh(data=8) over the same global batch,
    JAX's own triplet negatives on both sides (tests/_torch_port.py says
    why float64). This model's step is compiled as JAX compiles it: with
    XLA's algebraic simplifier off (tests/_torch_port.NO_ALGSIMP, which
    the flagship-shaped model needs on this CPU backend) its gradient is
    NaN, and with it on its float64 grad_norm on one device agrees with
    the one-process port's to 1e-14 (13.040704976421 on this batch, match
    loss alone);
  - the flagship-shaped tiny model with both kernel knobs on: Trainer.fit
    on two ranks against one process in float32, then Trainer.evaluate;
  - dp_step_check on two ranks against one; allgather_results' order;
  - fused_train with remat_stages and remat under two ranks against one
    process in float64 (the recompute replays the global statistics).

Sharded scoring: PairScorer(mesh=eight "cpu" entries) against JAX's
PairScorer(mesh=make_mesh(data=4, pairs=2)) on the conftest's eight
virtual devices, and against the port's unsharded scorer.
"""
import copy
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests import _torch_dp_worker as W  # noqa: E402
from tests._torch_port import (assert_close_scaled, crops,  # noqa: E402
                               jax_batch, jax_negatives, port_flat,
                               tiny_models)
from tests._torch_threads import TEST_THREADS, few_threads  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
JOIN_TIMEOUT = 240      # seconds for both ranks, start-up included
# float64: the JAX side keeps float32 pieces (its learning-rate schedule)
STEP64_TOL = 1e-6
# float32, two ranks against one process: the losses and grad_norm at
# tests/_torch_port.LEAF_STEP32_TOL; the weights at JAX's own bars for a
# sharded step (tests/test_parallel.py: Adam amplifies reduction-order
# rounding); the running statistics at 1e-4 of their scale
F32_LOG_TOL = 1e-3
F32_W_RTOL, F32_W_ATOL = 2e-3, 1e-3
F32_STAT_TOL = 1e-4
# float64 two ranks against one process, the same code path: the logs at
# EXACT64; the weights at STEP64_TOL (a bias in front of a BatchNorm has a
# gradient that is zero but for rounding, which Adam scales up); the fused
# SA chain keeps its statistics in float32 at every dtype, as JAX's does,
# so there two reduction orders differ at float32's rounding (1.5e-6 of
# the largest log after two steps): FUSED_TOL
EXACT64 = 1e-9
FUSED_TOL = 1e-5
SCORE_TOL = 1e-3        # port against JAX, as tests/test_torch_tracking.py


def _neg():
    b = W.tiny_batch()
    with jax.enable_x64():
        return torch.from_numpy(jax_negatives(jax.random.PRNGKey(7),
                                              b["id_1"], b["id_2"], 5))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results (rank0.pt, rank1.pt) and the run's directory."""
    out = tmp_path_factory.mktemp("dp")
    torch.save(dict(neg=_neg()), out / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=REPO,
               OMP_NUM_THREADS=str(TEST_THREADS))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests._torch_dp_worker", str(r), str(WORLD),
         str(out / "store"), str(out)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the {WORLD} ranks did not finish in {JOIN_TIMEOUT} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)], out


def test_global_batch_norm_backward():
    """The data-parallel BatchNorm (models/layers._GlobalBatchNorm: fused
    kernels, its own backward) in one process, float64: its gradients
    against finite differences, and its values and gradients against
    flax's formula under autograd."""
    from point_cloud_reid_tpu_torch.models.layers import _GlobalBatchNorm
    g = torch.Generator().manual_seed(0)
    x, w, b, dy = (torch.randn(*s, generator=g, dtype=torch.float64)
                   for s in ((40, 3), (3,), (3,), (40, 3)))
    x = (x * 2 + 1).requires_grad_()
    w.requires_grad_()
    b.requires_grad_()

    def fused(x, w, b):
        return _GlobalBatchNorm.apply(x, w, b, 1e-5)[0]

    def flax(x, w, b):
        m = x.mean(0)
        v = ((x * x).mean(0) - m * m).clamp(min=0.0)
        return (x - m) * torch.rsqrt(v + 1e-5) * w + b
    assert torch.autograd.gradcheck(fused, (x, w, b))
    got, want = fused(x, w, b), flax(x, w, b)
    np.testing.assert_allclose(got.detach(), want.detach(), atol=1e-12)
    for a, e in zip(torch.autograd.grad(got, (x, w, b), dy),
                    torch.autograd.grad(want, (x, w, b), dy)):
        np.testing.assert_allclose(a, e, atol=1e-12)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the error of a machine without a card")
def test_no_card_needs_a_device():
    """Without a card, make_mesh() and dp_step_check() raise unless the
    caller names the CPU: no quiet CPU run."""
    from point_cloud_reid_tpu_torch import parallel
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.dp_step_check()
    assert parallel.make_mesh(devices=["cpu"]).size == 1


def test_model_on_copies_once_per_weights():
    """utils/cache.model_on, the sharded scorer's weights for an entry on
    another device ("cpu:0" stands for one: it is not the model's "cpu"):
    one copy while the weights stand, a new one after an update, the model
    itself on its own device."""
    from point_cloud_reid_tpu_torch.utils.cache import model_on
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        a = model_on(model, "cpu:0")
        assert a is not model and model_on(model, "cpu:0") is a
        assert model_on(model, "cpu") is model
        model.weight.add_(1.0)
        b = model_on(model, "cpu:0")
    assert b is not a and torch.equal(b.weight, model.weight)


def test_init_distributed_and_allgather(ranks):
    res, _ = ranks
    for r, out in enumerate(res):
        assert out["info"] == dict(process_index=r, process_count=WORLD,
                                   local_devices=1, global_devices=WORLD)
        x = np.arange(6, dtype=np.float32).reshape(3, 2)
        np.testing.assert_array_equal(out["gathered"]["x"],
                                      np.concatenate([x, x + 100]))
        np.testing.assert_array_equal(out["gathered"]["y"], [0, 0, 1, 1])


def test_one_process_defaults():
    from point_cloud_reid_tpu_torch import parallel
    assert parallel.__all__ == [
        "allgather_results", "barrier", "batch_sharding", "dp_step_check",
        "init_distributed", "make_mesh", "replicated", "shard_batch",
        "sync_hosts"]
    info = parallel.init_distributed(device="cpu")
    assert info["process_count"] == 1 and info["process_index"] == 0
    parallel.barrier()
    parallel.sync_hosts()
    r = {"a": np.arange(6).reshape(3, 2)}
    assert parallel.allgather_results(r) is r
    mesh = parallel.make_mesh(data=4, pairs=2, devices=["cpu"] * 8)
    assert mesh.size == 8 and mesh.axis_names == ("data", "pairs")
    assert mesh.shape == dict(data=4, pairs=2)
    assert parallel.batch_sharding(mesh) == (0, 1)
    b = W.tiny_batch()
    assert parallel.shard_batch(mesh, b) is b
    with pytest.raises(ValueError):
        parallel.make_mesh(data=4, pairs=2, devices=["cpu"] * 4)


def _jax_tiny_steps(steps: int):
    """JAX's TINY step on make_mesh(data=8), float64, from the port's init:
    per step the logs and {port key: weights}."""
    from point_cloud_reid_tpu.models import build_model as jax_build
    from point_cloud_reid_tpu.parallel import (make_mesh, replicated,
                                               shard_batch)
    from point_cloud_reid_tpu.train.loop import make_train_step as j_step
    from point_cloud_reid_tpu.train.schedules import (
        ScheduleConfig as JScheduleConfig, build_optimizer)
    from point_cloud_reid_tpu.train.state import TrainState as JTrainState
    from point_cloud_reid_tpu_torch.convert import to_jax_variables
    from point_cloud_reid_tpu_torch.models import build_model
    tmodel = build_model(copy.deepcopy(W.TINY),
                         generator=torch.Generator().manual_seed(0))
    key = jax.random.PRNGKey(7)
    out = []
    with jax.enable_x64():
        jvars = jax.tree_util.tree_map(lambda a: jnp.asarray(a, np.float64),
                                       to_jax_variables(tmodel))
        tx = build_optimizer(JScheduleConfig(**W.SCHED), 3)
        state = JTrainState(params=jvars["params"],
                            batch_stats=jvars["batch_stats"],
                            opt_state=tx.init(jvars["params"]),
                            step=jnp.zeros((), jnp.int32))
        mesh = make_mesh(data=8)
        with mesh:
            state = jax.device_put(state, replicated(mesh))
            batch = shard_batch(mesh, jax_batch(W.tiny_batch(), np.float64))
            step = j_step(jax_build(copy.deepcopy(W.TINY), dtype=np.float64),
                          tx, W.TINY_USE, {}, donate=False, monitor=True)
            for _ in range(steps):
                state, log = step(state, batch, key)
                out.append(dict(
                    log={k: float(v) for k, v in log.items()},
                    weights=dict(port_flat(jax.device_get(state.params)),
                                 **port_flat(jax.device_get(
                                     state.batch_stats)))))
    return out


def test_two_rank_step_matches_jax_mesh_step(ranks):
    """Two ranks' float64 steps of TINY against JAX's one SPMD step over
    the same 16 pairs on an 8-device mesh: every log (BatchNorm statistics,
    masked means, triplet negatives and metrics over the global batch),
    every weight and running statistic, after each of two steps."""
    res, _ = ranks
    want = _jax_tiny_steps(len(res[0]["tiny"]["steps"]))
    for got0, got1, w in zip(res[0]["tiny"]["steps"], res[1]["tiny"]["steps"],
                             want):
        assert got0["log"] == got1["log"]
        assert set(got0["log"]) == set(w["log"])
        for k, v in w["log"].items():
            assert abs(got0["log"][k] - v) <= STEP64_TOL * max(1.0, abs(v)), (
                k, got0["log"][k], v)
        assert set(got0["weights"]) == set(w["weights"])
        for k, v in w["weights"].items():
            assert torch.equal(got0["weights"][k], got1["weights"][k]), k
            assert_close_scaled(got0["weights"][k].numpy(), v, STEP64_TOL, k)


@pytest.fixture(scope="module")
def one_fit(tmp_path_factory):
    """fit_and_eval in this process, without a group: float64 and the
    float32 first step."""
    return (W.fit_and_eval(str(tmp_path_factory.mktemp("one"))),
            W.fit_and_eval(str(tmp_path_factory.mktemp("one32")),
                           torch.float32, steps=1))


def test_two_rank_fit_matches_one_process(ranks, one_fit):
    """Trainer.fit on two ranks against one process, both kernel knobs on
    (their plain versions), in float64: every logged value of every step
    (losses, accuracies, counts, grad_norm), the weights and the running
    statistics after three steps. Rank 0 alone writes the checkpoint and
    the log."""
    res, _ = ranks
    got, one = res[0]["fit"], one_fit[0]
    assert len(got["records"]) == len(one["records"]) == W.FIT_STEPS + 1
    assert res[1]["fit"]["records"] == got["records"]   # the one file
    assert "ckpt_final.pt" in got["files"] and "metrics.jsonl" in got["files"]
    assert got["files"] == one["files"]
    for g, w in zip(got["records"], one["records"]):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, str):
                assert g[k] == v
            elif k not in ("wall_s", "epoch_time_s"):
                assert abs(g[k] - v) <= EXACT64 * max(1.0, abs(v)), (k, g[k],
                                                                     v)
    for k, w in one["weights"].items():
        assert torch.equal(got["weights"][k], res[1]["fit"]["weights"][k]), k
        assert_close_scaled(got["weights"][k].numpy(), w.numpy(), STEP64_TOL,
                            k)


def test_two_rank_first_step_float32_matches_one_process(ranks, one_fit):
    """The same first step as the port trains, in float32: the logs, the
    weights (Adam's first update is about lr * sign(g), so a gradient
    entry that is zero but for rounding moves by up to 2 lr either way)
    and the running statistics."""
    res, _ = ranks
    got, one = res[0]["fit32"], one_fit[1]
    for k in ("reid_loss", "match_loss", "kl_loss", "triplet_loss",
              "cls_loss", "fp_loss", "grad_norm", "match_acc", "cls_acc",
              "fp_acc", "num_gt_1", "num_preds_1"):
        g, w = got["records"][0][k], one["records"][0][k]
        assert abs(g - w) <= F32_LOG_TOL * max(1.0, abs(w)), (k, g, w)
    for k, w in one["weights"].items():
        g = got["weights"][k]
        if "running_" in k:
            assert_close_scaled(g.numpy(), w.numpy(), F32_STAT_TOL, k)
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=F32_W_RTOL,
                                       atol=F32_W_ATOL, err_msg=k)


def test_two_rank_eval_matches_one_process(ranks, one_fit):
    """Trainer.evaluate on two ranks (each its shard of the val batches,
    gathered) reports the one-process metrics and pair count, float64
    after the three steps above."""
    res, _ = ranks
    one = one_fit[0]["metrics"]
    assert one_fit[0]["pairs"] == W.EVAL_BATCHES * W.FIT_PAIRS
    for r in res:
        assert r["fit"]["pairs"] == one_fit[0]["pairs"]
        got = r["fit"]["metrics"]
        assert set(got) == set(one)
        for k, w in one.items():
            if not isinstance(w, (dict, str)):
                assert got[k] == pytest.approx(w, rel=1e-9, abs=1e-12), k


def test_dp_step_check_two_ranks_equal_one(ranks):
    from point_cloud_reid_tpu_torch.parallel import dp_step_check
    res, _ = ranks
    want = dp_step_check(batch_per_device=4, device=torch.device("cpu"))
    for out in res:
        assert out["dp_check"] == pytest.approx(want, rel=1e-5)


def test_fused_remat_two_ranks_equal_one_process(ranks):
    """fused_train over every SA stage under remat_stages, with the global
    remat on, two ranks against one process in float64, one step: the
    recompute replays each stage's global statistics (no second
    collective) and the fused chain's population sums are the global
    batch's. An SA conv's bias feeds a BatchNorm, which cancels it: its
    gradient is the chain's float32 rounding, and Adam's first update
    moves it by the learning rate either way, so those weights are held to
    2 x the learning rate (after a second step the running means would
    carry that move)."""
    res, _ = ranks
    want = W.fused_remat_steps()
    for out in res:
        for g, w in zip(out["fused"]["logs"], want["logs"]):
            assert set(g) == set(w)
            for k, v in w.items():
                assert abs(g[k] - v) <= FUSED_TOL * max(1.0, abs(v)), (
                    k, g[k], v)
        for k, v in want["weights"].items():
            got = out["fused"]["weights"][k].numpy()
            if "mlp_convs" in k and k.endswith(".bias"):
                err = float(np.abs(got - v.numpy()).max())
                assert err <= 2 * want["lr_spent"], (k, err)
            else:
                assert_close_scaled(got, v.numpy(), FUSED_TOL, k)


# ---- sharded scoring ---------------------------------------------------------

def _meshes():
    from point_cloud_reid_tpu.parallel import make_mesh as jax_mesh
    from point_cloud_reid_tpu_torch.parallel import make_mesh
    return (make_mesh(data=4, pairs=2, devices=["cpu"] * 8),
            jax_mesh(data=4, pairs=2))


def _embedded(tmodel, seed: int, n: int):
    with torch.no_grad():
        return tmodel.embed(torch.from_numpy(crops(seed, n)))


@pytest.mark.parametrize("nt,nd,pad", [(8, 8, True), (5, 125, False),
                                       (3, 5, True)])
def test_sharded_cost_matrix_matches_jax(nt, nd, pad):
    """The port's eight-entry mesh against JAX's 4 x 2 mesh, the unsharded
    port beside it: a divisible grid, a non-divisible 5 x 125 grid (15
    or 16 detections a shard) and a grid below the mesh size after
    padding."""
    from point_cloud_reid_tpu.inference import PairScorer as JaxScorer
    from point_cloud_reid_tpu_torch.inference import PairScorer
    jmodel, jvars, tmodel = tiny_models()
    mesh, jmesh = _meshes()
    xt, ht = _embedded(tmodel, 50, nt)
    xd, hd = _embedded(tmodel, 51, nd)
    scorer = PairScorer(tmodel, mesh=mesh)
    before = [dict(e) for e in mesh.launches]
    with torch.no_grad():
        got = scorer.cost_matrix(ht, xt, hd, xd)
        plain = PairScorer(tmodel).cost_matrix(ht, xt, hd, xd)
    assert mesh.launches == before       # the CPU runs no kernel
    args = [jnp.asarray(a.numpy()) for a in (ht, xt, hd, xd)]
    want = np.asarray(JaxScorer(jmodel, jvars, mesh=jmesh).cost_matrix(
        *args, pad=pad))
    assert got.shape == (nt, nd) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_sharded_frame_fn_matches_jax():
    """make_frame_fn under a mesh: the sharded embed (one crop shard an
    entry) and the sharded grid against JAX's fused mesh frame."""
    from point_cloud_reid_tpu.inference import PairScorer as JaxScorer
    from point_cloud_reid_tpu_torch.inference import PairScorer
    jmodel, jvars, tmodel = tiny_models()
    mesh, jmesh = _meshes()
    xt, ht = _embedded(tmodel, 52, 4)
    dets = crops(53, 6)
    logits, h_d, xyz_d = PairScorer(tmodel, mesh=mesh).make_frame_fn(4, 6)(
        ht, xt, torch.from_numpy(dets))
    jl, jh, jx = JaxScorer(jmodel, jvars, mesh=jmesh).make_frame_fn(4, 6)(
        jnp.asarray(ht.numpy()), jnp.asarray(xt.numpy()), jnp.asarray(dets))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    np.testing.assert_allclose(h_d.numpy(), np.asarray(jh), rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    xd_plain, hd_plain = _embedded(tmodel, 53, 6)
    np.testing.assert_allclose(h_d.numpy(), hd_plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(xyz_d.numpy(), xd_plain.numpy())


def test_sharded_pairs_match_jax_grid():
    """A pair list of 37 pairs in eight shards: the logits of JAX's mesh
    grid at those pairs (pairs are bit-equal to grid cells in both
    packages), and the port's unsharded pair list."""
    from point_cloud_reid_tpu.inference import PairScorer as JaxScorer
    from point_cloud_reid_tpu_torch.kernels.match_grid import (
        pair_logits, sharded_pair_logits)
    jmodel, jvars, tmodel = tiny_models()
    mesh, jmesh = _meshes()
    xt, ht = _embedded(tmodel, 54, 6)
    xd, hd = _embedded(tmodel, 55, 9)
    rs = np.random.RandomState(3)
    t_idx = torch.from_numpy(rs.randint(0, 6, 37))
    d_idx = torch.from_numpy(rs.randint(0, 9, 37))
    with torch.no_grad():
        got = sharded_pair_logits(tmodel, ht, xt, hd, xd, t_idx, d_idx, mesh)
        plain = pair_logits(tmodel, ht, xt, hd, xd, t_idx, d_idx)
    grid = np.asarray(JaxScorer(jmodel, jvars, mesh=jmesh).cost_matrix(
        *[jnp.asarray(a.numpy()) for a in (ht, xt, hd, xd)], pad=False))
    want = grid[t_idx.numpy(), d_idx.numpy()]
    np.testing.assert_allclose(got.numpy(), want, rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_sharded_score_frame_zero_tracks():
    """A scene's first frame, no tracks: an empty (0, n) matrix and the
    detections' sharded embedding, as JAX's score_frame."""
    from point_cloud_reid_tpu_torch.inference import FeatureCache, PairScorer
    _, _, tmodel = tiny_models()
    mesh, _ = _meshes()
    mat, h_d, xyz_d = PairScorer(tmodel, mesh=mesh).score_frame(
        FeatureCache(), [], torch.from_numpy(crops(56, 5)))
    assert tuple(mat.shape) == (0, 5)
    xd, hd = _embedded(tmodel, 56, 5)
    np.testing.assert_allclose(h_d.numpy(), hd.numpy(), rtol=1e-5, atol=1e-5)


def test_sharded_image_grid_and_pairs_match_jax():
    """The image head: JAX's mesh cost matrix against the port's sharded
    grid and sharded pair list."""
    from point_cloud_reid_tpu.inference import PairScorer as JaxScorer
    from point_cloud_reid_tpu_torch.inference import PairScorer
    from point_cloud_reid_tpu_torch.kernels.match_grid import (
        sharded_image_pair_logits)
    from tests._torch_image import tiny_image_models, tokens
    jmodel, jvars, tmodel = tiny_image_models()
    mesh, jmesh = _meshes()
    ht = torch.from_numpy(tokens(60, 5, 6))
    hd = torch.from_numpy(tokens(61, 11, 6))
    with torch.no_grad():
        got = PairScorer(tmodel, image_mode=True, mesh=mesh).cost_matrix(
            ht, None, hd, None)
        t_idx = torch.tensor([0, 4, 2, 3, 1, 0, 4, 2, 2, 1])
        d_idx = torch.tensor([10, 0, 5, 3, 7, 7, 1, 9, 2, 4])
        pairs = sharded_image_pair_logits(tmodel, ht, hd, t_idx, d_idx, mesh)
    want = np.asarray(JaxScorer(jmodel, jvars, image_mode=True,
                                mesh=jmesh).cost_matrix(
        jnp.asarray(ht.numpy()), None, jnp.asarray(hd.numpy()), None,
        pad=False))
    np.testing.assert_allclose(got.numpy(), want, rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    np.testing.assert_allclose(pairs.numpy(),
                               want[t_idx.numpy(), d_idx.numpy()],
                               rtol=SCORE_TOL, atol=SCORE_TOL)


def test_sharded_tracker_frames_equal_unsharded():
    """TrackingManager with a mesh scorer (device cache, dense and gated
    sparse): every frame's logits equal the unsharded manager's."""
    from point_cloud_reid_tpu_torch.inference import PairScorer
    from point_cloud_reid_tpu_torch.tracking import TrackingManager
    _, _, tmodel = tiny_models()
    mesh, _ = _meshes()
    rs = np.random.RandomState(0)
    c = (rs.rand(5, 3) * 10).astype(np.float32)
    c[:, 2] = 0
    boxes = np.concatenate([c, np.full((5, 3), 2, np.float32),
                            np.zeros((5, 1), np.float32)], 1)
    sweeps = [np.repeat(c, 30, 0) + rs.randn(150, 3).astype(np.float32)
              * 0.4 for _ in range(3)]
    for sparse in ("never", "always"):
        logits = []
        for m in (mesh, None):
            scorer = PairScorer(tmodel, mesh=m)
            mgr = TrackingManager(scorer, subsample_number=32,
                                  sparse_scoring=sparse)
            frames = []
            for pts in sweeps:
                mgr.step(pts, boxes, np.ones(5, np.float32),
                         np.zeros(5, np.int64))
                if scorer.last_frame is not None:    # a frame with tracks
                    frames.append(scorer.last_frame["logits"].clone())
            logits.append(frames)
        assert len(logits[0]) == len(logits[1]) == len(sweeps) - 1
        for a, b in zip(*logits):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5)
