"""bf16 training of the port against the JAX package's: the tiny flagship
built with dtype=torch.bfloat16 (float32 parameters and optimizer state,
bf16 compute where flax casts) under make_train_step, against
build_model(cfg, dtype=bfloat16) under the JAX package's make_train_step
(compiled with XLA's algebraic simplifier off, tests/_torch_port.py), both
kernel knobs on (the JAX Pallas kernels in interpret mode, the port's plain
versions on CPU tensors), the triplet negatives JAX's own draw.

Held at the JAX suite's bf16 bar BF16_TOL (3e-2): after one step the logs,
the running statistics and the weights' moves (where the sign of Adam's
first update is not rounding); after three the total loss and the running
statistics, with the loss terms and update_norm at BF16_DRIFT and
grad_norm not compared (tests/_torch_port.py says why).

Not at 3e-2, with the reason: the whole step's gradient. Through the SA
stages' BatchNorms a bf16 gradient is largely rounding (a sum of bf16
products that cancels): on this batch the JAX package's bf16 gradient lies
24 % (L2) from the float32 one, the port's 28 %, and the two 28 % from
each other, while each module of the chain, from the same inputs, agrees
at 3e-2 (tests/test_torch_bf16_train_modules.py). The port's is held to
1.5 times JAX's own distance from float32. The float32 reference is the
port's float32 step, which tests/test_torch_train_step.py holds to the JAX
package's. Also: the state that must stay float32 (parameters, AdamW
moments, the accumulated gradient)."""
import copy
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.models import build_model as jax_build  # noqa: E402
from point_cloud_reid_tpu.train import losses as jl  # noqa: E402
from point_cloud_reid_tpu.train.loop import make_train_step as j_train_step  # noqa: E402
from point_cloud_reid_tpu.train.schedules import (  # noqa: E402
    ScheduleConfig as JScheduleConfig, build_optimizer as j_build_optimizer)
from point_cloud_reid_tpu.train.state import TrainState as JTrainState  # noqa: E402
from point_cloud_reid_tpu_torch.models import build_model  # noqa: E402
from point_cloud_reid_tpu_torch.train import (ScheduleConfig,  # noqa: E402
                                              TrainState, make_train_step)
from point_cloud_reid_tpu_torch.train import losses as tl  # noqa: E402
from tests._torch_port import (BF16_TOL, KNOBS,  # noqa: E402
                               assert_bf16_logs_close, assert_close_scaled,
                               compile_together, flat_grads, jax_batch,
                               jax_negatives, pair_batch, port_flat,
                               tiny_cfg, to_jax_tree, torch_batch)
from tests._torch_threads import few_threads  # noqa: E402,F401

BF16 = jnp.bfloat16
USE = dict(match=True, kl=True, triplet=True, cls=True, fp=True)
ALPHA = dict(kl=0.1, cls=0.5)
STEPS_PER_EPOCH, EPOCHS = 3, 2
SCHED = dict(lr=3e-4, max_epochs=EPOCHS, grad_clip_norm=35.0)


def _models(dtype, **knobs):
    """(port model, JAX model, flax variables) of the tiny flagship at a
    compute dtype, from one set of float32 weights."""
    cfg = tiny_cfg(**knobs)
    tmodel = build_model(copy.deepcopy(cfg),
                         generator=torch.Generator().manual_seed(0),
                         dtype=dtype)
    jvars = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(tmodel))
    jdt = BF16 if dtype == torch.bfloat16 else jnp.float32
    return tmodel, jax_build(copy.deepcopy(cfg), dtype=jdt), jvars


# ---- the train step ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _port_run(dtype, steps: int = 3):
    """The port's tiny flagship (knobs on) at a compute dtype for `steps`
    steps on the test batches: per step the logs and the weights, and the
    gradient of step 1."""
    tmodel, _, _ = _models(dtype, **KNOBS)
    state = TrainState.create(tmodel, ScheduleConfig(**SCHED),
                              STEPS_PER_EPOCH)
    step = make_train_step(tmodel, USE, ALPHA, monitor=True)
    keys = jax.random.split(jax.random.PRNGKey(7), steps)
    recs = []
    for i, key in enumerate(keys):
        batch = pair_batch(30 + i)
        tbatch = torch_batch(batch)
        neg = torch.from_numpy(jax_negatives(key, batch["id_1"],
                                             batch["id_2"], 5))
        rec = {}
        if i == 0:
            probe = copy.deepcopy(tmodel)
            loss, _ = tl.reid_losses(probe(tbatch, train=True), tbatch, USE,
                                     ALPHA, pool_type=probe.pool_type,
                                     neg_idx=neg)
            loss.backward()
            rec["grads"] = {k: (p.grad if p.grad is not None else
                                torch.zeros_like(p)).double().numpy()
                            for k, p in probe.named_parameters()}
        _, log = step(state, tbatch, None, neg)
        rec["log"] = {k: float(v) for k, v in log.items()}
        rec["weights"] = {k: v.double().numpy().copy()
                          for k, v in tmodel.state_dict().items()
                          if not k.endswith("num_batches_tracked")}
        recs.append(rec)
    return recs, state


@pytest.fixture(scope="module")
def bf16_run():
    """The JAX bf16 step (make_train_step, compiled with XLA's algebraic
    simplifier off) for three steps beside the port's bf16 and float32
    runs, and JAX's bf16 gradient of step 1."""
    tmodel, jmodel, jvars = _models(torch.bfloat16, **KNOBS)
    start = {k: v.double().numpy().copy()
             for k, v in tmodel.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    tx = j_build_optimizer(JScheduleConfig(**SCHED), STEPS_PER_EPOCH)
    jstate = JTrainState(params=jvars["params"],
                         batch_stats=jvars["batch_stats"],
                         opt_state=tx.init(jvars["params"]),
                         step=jnp.zeros((), jnp.int32))
    keys = jax.random.split(jax.random.PRNGKey(7), 3)

    def jax_grads(params, batch_stats, batch, key):
        def loss_fn(params):
            out, _ = jmodel.apply(
                {"params": params, "batch_stats": batch_stats}, batch,
                train=True, mutable=["batch_stats"])
            return jl.reid_losses(out, batch, losses_to_use=USE, alpha=ALPHA,
                                  rng=key, pool_type=jmodel.pool_type)[0]
        return jax.grad(loss_fn)(params)

    jbatch = jax_batch(pair_batch(30))
    args = (jstate.params, jstate.batch_stats, jbatch, keys[0])
    jgrad, jstep = compile_together(
        jax.jit(jax_grads).lower(*args),
        j_train_step(jmodel, tx, USE, ALPHA, donate=False,
                     monitor=True).lower(jstate, jbatch, keys[0]))
    jgrads = port_flat(jgrad(*args))
    jrecs = []
    for i, key in enumerate(keys):
        jstate, log = jstep(jstate, jax_batch(pair_batch(30 + i)), key)
        jrecs.append(dict(log={k: float(v) for k, v in log.items()},
                          weights=dict(port_flat(jstate.params),
                                       **port_flat(jstate.batch_stats))))
    t16, state16 = _port_run(torch.bfloat16)
    t32, _ = _port_run(torch.float32)
    return dict(start=start, j=jrecs, jgrads=jgrads, t=t16, t32=t32,
                state=state16)


def _running(weights: dict) -> dict:
    return {k: v for k, v in weights.items() if "running_" in k}


def test_one_bf16_step_matches_jax(bf16_run):
    r = bf16_run
    assert_bf16_logs_close(r["t"][0]["log"], r["j"][0]["log"], 1)
    want = r["j"][0]["weights"]
    got = r["t"][0]["weights"]
    for k, v in _running(want).items():
        assert_close_scaled(got[k], v, BF16_TOL, k)
    # the whole gradient: the port's within 1.5 times JAX's own distance
    # from the float32 gradient, and not further from JAX's than from it
    f32 = flat_grads(r["t32"][0]["grads"])
    t, j = flat_grads(r["t"][0]["grads"]), flat_grads(r["jgrads"])
    assert np.linalg.norm(t - j) <= 1.5 * np.linalg.norm(j - f32)
    # the weights' moves where neither bf16 gradient's rounding reaches half
    # the float32 gradient (Adam's first update is about lr * sign(g)
    # there): within the bar of the leaf's largest move
    g32, gt, gj = r["t32"][0]["grads"], r["t"][0]["grads"], r["jgrads"]
    clear, total = 0, 0
    for k in gj:
        sure = np.abs(g32[k]) > 2 * np.maximum(np.abs(gt[k] - g32[k]),
                                               np.abs(gj[k] - g32[k]))
        moved_t, moved_j = got[k] - r["start"][k], want[k] - r["start"][k]
        if np.any(sure):
            scale = np.max(np.abs(moved_j))
            err = np.max(np.abs(moved_t - moved_j)[sure])
            assert err <= BF16_TOL * scale + 1.2e-7 * np.max(np.abs(
                want[k])), (k, err, scale)
        clear, total = clear + int(sure.sum()), total + sure.size
    assert clear > 0.3 * total, (clear, total)


def test_three_bf16_steps_match_jax(bf16_run):
    r = bf16_run
    for step in (1, 2, 3):
        assert_bf16_logs_close(r["t"][step - 1]["log"],
                               r["j"][step - 1]["log"], step)
    got, want = r["t"][2]["weights"], r["j"][2]["weights"]
    for k, v in _running(want).items():
        assert_close_scaled(got[k], v, BF16_TOL, k)
    for k in ("backbone.SA_modules.0.mlp_bns.0.running_var",
              "cross_stage1.q_proj.weight",
              "backbone.SA_modules.1.mlp_convs.0.weight"):
        assert not np.array_equal(got[k], r["start"][k]), k


def test_bf16_training_keeps_float32_state(bf16_run):
    """Parameters, running statistics and AdamW moments stay float32 at a
    bf16 compute dtype, and so does the accumulated gradient of
    cumulative_iters > 1."""
    state = bf16_run["state"]
    assert state.model.dtype == torch.bfloat16
    assert all(v.dtype == torch.float32
               for v in state.model.state_dict().values()
               if v.is_floating_point())
    moments = [v for s in state.optimizer.adamw.state.values()
               for v in s.values() if torch.is_tensor(v) and v.dim()]
    assert moments and all(v.dtype == torch.float32 for v in moments)
    tmodel, _, _ = _models(torch.bfloat16)
    acc = TrainState.create(tmodel, ScheduleConfig(
        **dict(SCHED, cumulative_iters=2)), STEPS_PER_EPOCH)
    make_train_step(tmodel, dict(match=True), {})(
        acc, torch_batch(pair_batch(30)))
    assert acc.optimizer.mini_step == 1
    assert all(a.dtype == torch.float32 for a in acc.optimizer._acc)
