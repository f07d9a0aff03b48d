"""Train steps of the port against the JAX package's make_train_step: one
init and one batch (crops with duplicated points) on both sides, the triplet
negatives JAX's own draw.

The JAX side is the package's own jitted step, in float64 (tests/_torch_port
.train_models says why) and compiled with XLA's algebraic simplifier off:
on this CPU backend the default compilation returns a gradient that fails a
finite-difference check (global norm 74.75 against 79.54 on a batch of this
file's kind); with the simplifier off it agrees with the same function run
op by op, and with the port, to 4e-14 of the largest entry. `python -m
tests._torch_grad_reference` prints these numbers.

The port is held to it in two modes. 'float32': the port as it trains,
both kernel knobs on (the JAX Pallas kernels in interpret mode, the port's
plain versions on CPU tensors), at 1e-4 after one step and 1e-3 after
three. 'float64': the port in float64 too, where rounding is out of the
way and every gradient leaf, every weight update and every running
statistic is held to its own scale; there the knobs are off, because the
JAX Pallas kernels compute in float32 whatever the model's dtype."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.train import losses as jl  # noqa: E402
from point_cloud_reid_tpu.train.loop import make_train_step as j_train_step  # noqa: E402
from point_cloud_reid_tpu.train.schedules import (  # noqa: E402
    ScheduleConfig as JScheduleConfig, build_optimizer as j_build_optimizer)
from point_cloud_reid_tpu.train.state import TrainState as JTrainState  # noqa: E402
from point_cloud_reid_tpu_torch.train import (ScheduleConfig, TrainState,  # noqa: E402
                                              cyclic_schedule,
                                              make_train_step)
from point_cloud_reid_tpu_torch.train.losses import reid_losses  # noqa: E402
from tests._torch_port import (F32_LEAF_FLOOR, KNOBS,  # noqa: E402
                               assert_close_scaled, assert_grads_close,
                               compile_together, jax_batch, jax_negatives,
                               pair_batch, port_flat, torch_batch,
                               train_models)

USE = dict(match=True, kl=True, triplet=True, cls=True, fp=True)
ALPHA = dict(kl=0.1, cls=0.5)
STEPS_PER_EPOCH, EPOCHS = 3, 2      # 6 updates: the lr peaks at update 2
# per mode: the port's dtype, the kernel knobs, then relative tolerances
# after (one step, three steps) for logs / weights / running statistics /
# gradient leaves, for what a weight moved by against the largest move in
# its tensor, and how small a gradient leaf's scale may be taken against the
# largest entry of all leaves (tests/_torch_port.F32_LEAF_FLOOR says why).
# float32: the first Adam update is lr * g / (|g| + eps) and turns a
# relative gradient error d into about d * eps / |g|; later updates carry d
# itself, hence the wider tolerance of the moves after three steps.
# float64: the JAX side keeps float32 pieces (its learning-rate schedule,
# parts of the losses), which show at 2e-7 in the logs.
MODES = {
    "float32": dict(dtype=torch.float32, knobs=KNOBS, tol=(1e-4, 1e-3),
                    move_tol=(1e-3, 1e-2), leaf_floor=F32_LEAF_FLOOR),
    "float64": dict(dtype=torch.float64, knobs={}, tol=(1e-6, 1e-6),
                    move_tol=(1e-3, 1e-3), leaf_floor=1e-3),
}
NOISE = 1e-5    # float32: an applied gradient below this share of the
#                 largest one is rounding, see _check
# a mode's compiled JAX gradient: the same program whatever the optimizer,
# so the plain and the accumulated runs of a mode share it
_GRADS = {}


def _run(mode: str, cumulative_iters: int, clip: float, steps: int):
    """Both trainers for `steps` steps: per step the logs, the gradients,
    the weights and the running statistics of the JAX side ('j') and of the
    port ('t'), and the weights at the start."""
    with jax.enable_x64():
        return _run_x64(dict(MODES[mode], name=mode), cumulative_iters, clip,
                        steps)


def _run_x64(mode, cumulative_iters, clip, steps):
    sched = dict(lr=3e-4, max_epochs=EPOCHS, grad_clip_norm=clip,
                 cumulative_iters=cumulative_iters)
    jmodel, jvars, tmodel = train_models(jax_dtype=np.float64,
                                         **mode["knobs"])
    tmodel = tmodel.to(mode["dtype"])
    batches = [pair_batch(30 + i) for i in range(steps)]
    keys = jax.random.split(jax.random.PRNGKey(7), steps)

    tx = j_build_optimizer(JScheduleConfig(**sched), STEPS_PER_EPOCH)
    jstate = JTrainState(params=jvars["params"],
                         batch_stats=jvars["batch_stats"],
                         opt_state=tx.init(jvars["params"]),
                         step=jnp.zeros((), jnp.int32))
    jstep = jgrad = None

    def jax_grads(params, batch_stats, batch, key):
        def loss_fn(params):
            out, _ = jmodel.apply(
                {"params": params, "batch_stats": batch_stats}, batch,
                train=True, mutable=["batch_stats"])
            return jl.reid_losses(out, batch, losses_to_use=USE, alpha=ALPHA,
                                  rng=key, pool_type=jmodel.pool_type)[0]
        return jax.grad(loss_fn)(params)

    def port_weights():
        return {k: v.double().numpy().copy()
                for k, v in tmodel.state_dict().items()
                if not k.endswith("num_batches_tracked")}

    state = TrainState.create(tmodel, ScheduleConfig(**sched),
                              STEPS_PER_EPOCH)
    tstep = make_train_step(tmodel, USE, ALPHA, monitor=True)
    start = dict(t=port_weights(), j=dict(port_flat(jstate.params),
                                          **port_flat(jstate.batch_stats)))

    records = []
    for i, (batch, key) in enumerate(zip(batches, keys)):
        jbatch = jax_batch(batch, np.float64)
        tbatch = {k: v.to(mode["dtype"]) if v.is_floating_point() else v
                  for k, v in torch_batch(batch).items()}
        neg = torch.from_numpy(jax_negatives(key, batch["id_1"],
                                             batch["id_2"], 5))
        rec = {"start": start}
        args = (jstate.params, jstate.batch_stats, jbatch, key)
        if i == 0:
            lowered = [j_train_step(jmodel, tx, USE, ALPHA, donate=False,
                                    monitor=True).lower(jstate, jbatch, key)]
            if mode["name"] not in _GRADS:
                lowered.append(jax.jit(jax_grads).lower(*args))
            jstep, *fresh = compile_together(*lowered)
            if fresh:
                _GRADS[mode["name"]] = fresh[0]
            jgrad = _GRADS[mode["name"]]
            probe = copy.deepcopy(tmodel)
            loss, _ = reid_losses(probe(tbatch, train=True), tbatch, USE,
                                  ALPHA, pool_type=probe.pool_type,
                                  neg_idx=neg)
            loss.backward()
            rec["tgrads"] = {k: (p.grad if p.grad is not None
                                 else torch.zeros_like(p)).double().numpy()
                             for k, p in probe.named_parameters()}
        rec["jgrads"] = port_flat(jgrad(*args))
        jstate, jlog = jstep(jstate, jbatch, key)
        state, tlog = tstep(state, tbatch, None, neg)
        rec["jlog"] = {k: float(v) for k, v in jlog.items()}
        rec["tlog"] = {k: float(v) for k, v in tlog.items()}
        rec["jweights"] = dict(port_flat(jstate.params),
                               **port_flat(jstate.batch_stats))
        rec["tweights"] = port_weights()
        rec["steps"] = (int(jstate.step), state.step, state.optimizer.updates)
        records.append(rec)
    return records


@pytest.fixture(scope="module", params=list(MODES))
def plain_run(request):
    return request.param, _run(request.param, cumulative_iters=1, clip=35.0,
                               steps=3)


def _lr_spent(updates: int) -> float:
    """Sum of the learning rates of the first `updates` updates."""
    total = EPOCHS * STEPS_PER_EPOCH
    lr = cyclic_schedule(3e-4, total)
    return sum(lr(i) for i in range(updates))


def _moves(rec, side):
    """(what the weights moved by since the start, the running statistics
    now), each {key: array}."""
    now, was = rec[side + "weights"], rec["start"][side]
    moved = {k: now[k] - was[k] for k in now if "running_" not in k}
    return moved, {k: v for k, v in now.items() if "running_" in k}


def _check(mode, recs, window=1):
    """The last of `recs` (all steps so far): logs, weights and running
    statistics within the mode's tolerance, and what each weight moved by
    within its move tolerance of the largest move in its tensor.

    Adam divides each gradient entry by its own running magnitude, so where
    an entry is zero but for rounding (a conv bias in front of a BatchNorm,
    a weight the batch barely touches) the float32 update has the size of
    the learning rate and the sign of the rounding error. In float32,
    entries whose applied gradient (the mean over an accumulation window of
    `window` steps) was below NOISE of the largest one at any update so far
    may therefore differ by twice the learning rates spent; they are 11 %
    of the weights after two updates and 16 % after three, and the float64
    mode makes no such exception."""
    rec, spec = recs[-1], MODES[mode]
    late = rec["steps"][2] > 1
    tol, move_tol = spec["tol"][late], spec["move_tol"][late]
    assert set(rec["tlog"]) == set(rec["jlog"])
    assert {"reid_loss", "match_loss", "kl_loss", "triplet_loss", "cls_loss",
            "fp_loss", "grad_norm", "param_norm",
            "update_norm"} <= set(rec["tlog"])
    for k, want in rec["jlog"].items():
        assert abs(rec["tlog"][k] - want) <= tol * max(1.0, abs(want)), (
            k, rec["tlog"][k], want)
    got, got_stats = _moves(rec, "t")
    want, want_stats = _moves(rec, "j")
    assert set(got) == set(want) and set(got_stats) == set(want_stats)
    for k, v in want_stats.items():
        assert_close_scaled(got_stats[k], v, tol, k)
    if mode == "float64":
        for k in want:
            assert_close_scaled(rec["tweights"][k], rec["jweights"][k], tol,
                                k)
        assert_grads_close(got, want, move_tol)
        return
    noise = {k: np.zeros(w.shape, bool) for k, w in want.items()}
    for u in range(rec["steps"][2]):
        applied = {k: sum(r["jgrads"][k] for r in
                          recs[u * window:(u + 1) * window]) / window
                   for k in want}
        floor = NOISE * max(float(np.max(np.abs(g))) for g in applied.values())
        for k, g in applied.items():
            if np.any(g):       # a tensor outside the loss moves by decay
                noise[k] |= np.abs(g) < floor
    loose = 2.0 * _lr_spent(rec["steps"][2])
    top = max(float(np.max(np.abs(v))) for v in want.values())
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        # a float32 weight cannot move by less than its own spacing
        bound = (move_tol * max(float(np.max(np.abs(w))), 1e-3 * top)
                 + 1.2e-7 * float(np.max(np.abs(rec["jweights"][k]))))
        assert np.all(diff[~noise[k]] <= bound), (
            k, float(diff[~noise[k]].max()), bound)
        assert np.all(diff[noise[k]] <= loose + bound), (k, float(diff.max()))
    n_noise = sum(int(m.sum()) for m in noise.values())
    n_all = sum(m.size for m in noise.values())
    assert n_noise < 0.2 * n_all, (n_noise, n_all)


def test_one_train_step_matches_jax(plain_run):
    mode, recs = plain_run
    rec = recs[0]
    assert rec["steps"] == (1, 1, 1)
    assert_grads_close(rec["tgrads"], rec["jgrads"], MODES[mode]["tol"][0],
                       MODES[mode]["leaf_floor"])
    # the shape head takes no part in these losses: its gradient is zero on
    # both sides, and weight decay alone moves it
    assert not np.any(rec["tgrads"]["shape_head.0.weight"])
    _check(mode, recs[:1])


def test_three_train_steps_match_jax(plain_run):
    mode, recs = plain_run
    assert recs[2]["steps"] == (3, 3, 3)
    _check(mode, recs)
    # the weights moved, and so did the running statistics
    first, last = recs[0]["tweights"], recs[2]["tweights"]
    for k in ("backbone.SA_modules.0.mlp_bns.0.running_var",
              "cross_stage1.q_proj.weight", "shape_head.0.weight"):
        assert not np.array_equal(first[k], last[k]), k


@pytest.mark.parametrize("mode", list(MODES))
def test_accumulated_train_steps_match_jax(mode):
    """cumulative_iters=2 with the clip at norm 1 (it bites): the weights
    stand still after the first step and move by the clipped mean gradient
    after the second."""
    recs = _run(mode, cumulative_iters=2, clip=1.0, steps=2)
    assert [r["steps"] for r in recs] == [(1, 1, 0), (2, 2, 1)]
    assert recs[0]["tlog"]["grad_norm"] > 1.0
    assert recs[0]["tlog"]["update_norm"] == 0.0
    _check(mode, recs[:1], window=2)
    _check(mode, recs, window=2)
    params = [k for k in recs[0]["tweights"] if "running_" not in k]
    w = [r["tweights"] for r in recs]
    assert any(not np.array_equal(w[0][k], w[1][k]) for k in params)
