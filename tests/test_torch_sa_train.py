"""The port's fused train-mode SA chain (point_cloud_reid_tpu_torch/ops/
sa_train.py) and the backbone knobs that reach it, against the JAX package.

The chain against JAX's ops/sa_train.py on the same seeded inputs, as
tests/test_sa_train.py holds JAX's two forms to each other: outputs, the
batch statistics, and the gradients of every differentiable input and
parameter, with duplicated neighbour indices for exact max-over-K ties.
JAX tests/test_parallel.py's TINY model with fused_train takes a train step
against JAX's step with the same knob (float64, JAX's own negatives,
compiled as JAX compiles it: tests/test_torch_parallel.py says why for this
model), and with remat_stages against the port's plain step.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.ops import sa_train as J  # noqa: E402
from point_cloud_reid_tpu_torch.ops import sa_train as T  # noqa: E402
from tests._torch_dp_worker import TINY  # noqa: E402
from tests._torch_port import (LEAF_SCHED, LEAF_USE, jax_batch,  # noqa: E402
                               jax_negatives, pair_batch, port_flat,
                               torch_batch)
from tests._torch_threads import few_threads  # noqa: E402,F401

CFG = (1e-5, "float32")
# JAX's own bars between its two forms of the chain (tests/test_sa_train.py)
RTOL, ATOL = 2e-4, 2e-5
# a whole step with fused_train against JAX's: JAX's bars between its
# fused and plain steps (tests/test_sa_train.py::test_full_model_train_
# step_fused_matches_plain), since both chains keep their statistics and
# their backward in float32 at every dtype and two summation orders differ
# at float32's rounding, which each BatchNorm's backward scales up (the
# grad_norm of the step below lies 4.8e-5 from JAX's in float64)
LOSS_TOL, GRAD_NORM_TOL = 2e-5, 2e-4
STAT_RTOL, STAT_ATOL = 2e-4, 2e-5
DIFF = [i for i in range(13) if i != 2]      # every input but idx


def _inputs(seed=0, B=3, N=24, S=12, K=8, C=16, dup=True):
    rs = np.random.RandomState(seed)
    A = rs.randn(B, N, C).astype(np.float32)
    Ct = rs.randn(B, S, C).astype(np.float32)
    idx = rs.randint(0, N, size=(B, S, K))
    if dup:
        idx[:, :, K // 2:] = idx[:, :, :K - K // 2]   # exact max ties
    w = [rs.randn(C, C).astype(np.float32) * 0.3 if i % 2 == 0
         else rs.randn(C).astype(np.float32) * 0.1 for i in range(4)]
    bn = [rs.rand(C).astype(np.float32) + 0.5 for _ in range(3)]
    bb = [rs.randn(C).astype(np.float32) * 0.1 for _ in range(3)]
    return [A, Ct, idx.astype(np.int32), *w, bn[0], bb[0], bn[1], bb[1],
            bn[2], bb[2]]


def _jax(fn, args, wout):
    def loss(*d):
        a = [jnp.asarray(x) for x in args]
        for i, v in zip(DIFF, d):
            a[i] = v
        return jnp.sum(fn(CFG, *a)[0] * wout)
    out, stats = jax.jit(lambda *a: fn(CFG, *a))(*[jnp.asarray(x)
                                                    for x in args])
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(DIFF)))))(
        *[jnp.asarray(args[i]) for i in DIFF])
    return (np.asarray(out), [[np.asarray(t) for t in mv] for mv in stats],
            [np.asarray(g) for g in grads])


def _port(fn, args, wout):
    t = [torch.from_numpy(x) for x in args]
    t[2] = t[2].long()
    for i in DIFF:
        t[i].requires_grad_(True)
    out, stats = fn((1e-5, torch.float32), *t)
    (out * torch.from_numpy(wout)).sum().backward()
    return (out.detach().numpy(), [[x.numpy() for x in mv] for mv in stats],
            [t[i].grad.numpy() for i in DIFF])


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("name", ["sa_train_pooled", "sa_train_reference"])
def test_chain_matches_jax(name, dup):
    """Each form of the port's chain against the same form of JAX's:
    output, the three layers' batch statistics, the gradient of every
    input and parameter (A, Ct, both convs, the three BatchNorms)."""
    args = _inputs(dup=dup)
    wout = np.random.RandomState(7).randn(3, 12, 16).astype(np.float32)
    want = _jax(getattr(J, name), args, wout)
    got = _port(getattr(T, name), args, wout)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    for g, w in zip(got[1], want[1]):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for i, (a, b) in enumerate(zip(got[2], want[2])):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"input {DIFF[i]}")


@pytest.mark.parametrize("dup", [False, True])
def test_custom_backward_matches_autograd(dup):
    """sa_train_pooled's backward against autograd through the same
    forward (sa_train_reference): the forwards are the same function, and
    the ties split alike (torch.amax)."""
    args = _inputs(seed=1, dup=dup)
    wout = np.random.RandomState(8).randn(3, 12, 16).astype(np.float32)
    a = _port(T.sa_train_pooled, args, wout)
    b = _port(T.sa_train_reference, args, wout)
    np.testing.assert_array_equal(a[0], b[0])
    for g, w in zip(a[1], b[1]):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)
    for i, (x, y) in enumerate(zip(a[2], b[2])):
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL,
                                   err_msg=f"input {DIFF[i]}")


def test_pop_stats_is_flax_fast_variance():
    rs = np.random.RandomState(4)
    h = rs.randn(3, 5, 4, 8).astype(np.float32) * 2 + 1
    m, v = T._pop_stats(torch.from_numpy(h))
    jm, jv = J._pop_stats(jnp.asarray(h))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("knob", [dict(fused_train=True),
                                  dict(fused_train=True,
                                       fused_train_vjp=False),
                                  dict(remat_stages=[0, 1, 2])])
def test_build_backbone_takes_the_knobs(knob):
    """The registry builds both knobs (it refused them before): the
    stages carry them."""
    from point_cloud_reid_tpu_torch.models.registry import build_backbone
    bb = build_backbone(dict(type="Pointnet_Backbone", mul=1, **knob))
    for i, sa in enumerate(bb.SA_modules):
        assert sa.fused_train == knob.get("fused_train", False)
        assert sa.fused_train_vjp == knob.get("fused_train_vjp", True)
        assert sa.remat == (i in knob.get("remat_stages", ()))


def _cfg(**backbone):
    cfg = copy.deepcopy(TINY)
    cfg["backbone"] = dict(cfg["backbone"], **backbone)
    return cfg


def _port_step(cfg, batch, neg, dtype):
    from point_cloud_reid_tpu_torch.models import build_model
    from point_cloud_reid_tpu_torch.train import (ScheduleConfig, TrainState,
                                                  make_train_step)
    model = build_model(copy.deepcopy(cfg),
                        generator=torch.Generator().manual_seed(0)).to(dtype)
    state = TrainState.create(model, ScheduleConfig(**LEAF_SCHED), 3)
    step = make_train_step(model, LEAF_USE, {}, monitor=True)
    tb = {k: v.to(dtype) if v.is_floating_point() else v
          for k, v in torch_batch(batch).items()}
    _, log = step(state, tb, None, neg)
    return ({k: float(v) for k, v in log.items()},
            {k: v.double().numpy() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))})


def test_fused_train_step_matches_jax():
    """One step of TINY with fused_train (the custom backward)
    against JAX's step with the same knob, both in float64: the losses,
    grad_norm and the running statistics that the chain's batch statistics
    moved (the weights are not compared: a conv bias in front of a
    BatchNorm has a gradient that is float32 rounding in both chains, and
    Adam's first update turns its sign into a move of the learning rate's
    size). The autograd form is held to JAX's at the chain above."""
    from point_cloud_reid_tpu.models import build_model as jax_build
    from point_cloud_reid_tpu.train.loop import make_train_step as j_step
    from point_cloud_reid_tpu.train.schedules import (
        ScheduleConfig as JScheduleConfig, build_optimizer)
    from point_cloud_reid_tpu.train.state import TrainState as JTrainState
    from point_cloud_reid_tpu_torch.convert import to_jax_variables
    from point_cloud_reid_tpu_torch.models import build_model
    cfg = _cfg(fused_train=True)
    batch = pair_batch(30, B=4)
    key = jax.random.PRNGKey(7)
    tmodel = build_model(copy.deepcopy(cfg),
                         generator=torch.Generator().manual_seed(0))
    with jax.enable_x64():
        neg = torch.from_numpy(jax_negatives(key, batch["id_1"],
                                             batch["id_2"], 5))
        jvars = jax.tree_util.tree_map(lambda a: jnp.asarray(a, np.float64),
                                       to_jax_variables(tmodel))
        tx = build_optimizer(JScheduleConfig(**LEAF_SCHED), 3)
        state = JTrainState(params=jvars["params"],
                            batch_stats=jvars["batch_stats"],
                            opt_state=tx.init(jvars["params"]),
                            step=jnp.zeros((), jnp.int32))
        jb = jax_batch(batch, np.float64)
        step = j_step(jax_build(copy.deepcopy(cfg), dtype=np.float64), tx,
                      LEAF_USE, {}, donate=False, monitor=True).lower(
            state, jb, key).compile()
        state, jlog = step(state, jb, key)
        jlog = {k: float(v) for k, v in jlog.items()}
        jstats = port_flat(state.batch_stats)
    log, stats = _port_step(cfg, batch, neg, torch.float64)
    assert set(log) == set(jlog)
    for k in ("reid_loss", "match_loss", "triplet_loss"):
        assert log[k] == pytest.approx(jlog[k], rel=LOSS_TOL), k
    assert log["grad_norm"] == pytest.approx(jlog["grad_norm"],
                                             rel=GRAD_NORM_TOL)
    assert set(stats) == set(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(stats[k], v, rtol=STAT_RTOL,
                                   atol=STAT_ATOL, err_msg=k)


@pytest.mark.parametrize("knob", [dict(remat_stages=[0]),
                                  dict(remat_stages=[0, 1, 2]),
                                  dict(fused_train=True,
                                       remat_stages=[0, 1, 2])])
def test_remat_stages_step_matches_plain_step(knob):
    """remat_stages only changes what the backward keeps: a float64 step
    with the stages checkpointed equals the step without (with
    fused_train, the fused step without), logs and running statistics
    (the recompute leaves them where the forward moved them)."""
    batch = pair_batch(31, B=4)
    neg = torch.zeros((4, 5), dtype=torch.int64)
    base = {k: v for k, v in knob.items() if k != "remat_stages"}
    want = _port_step(_cfg(**base), batch, neg, torch.float64)
    got = _port_step(_cfg(**knob), batch, neg, torch.float64)
    assert set(got[0]) == set(want[0])
    for k, v in want[0].items():
        assert got[0][k] == pytest.approx(v, rel=1e-12, abs=1e-12), k
    for k, v in want[1].items():
        np.testing.assert_allclose(got[1][k], v, rtol=1e-12, atol=1e-12,
                                   err_msg=k)
