"""Image (rgb_*) training steps of the port against the JAX package's
make_train_step: the tiny ViT ReID model of tests/_torch_image.py, one
init and the same batches on both sides (the image leaf's train sampler
over a seeded store of 32 x 32 crops: the pipeline's ids, labels and
visibility classes, one visibility set to -1), the image leaves' loss set
(match, cls, fp, vis and triplet with margin 10), the triplet negatives
JAX's own draw.

float32: the port as it trains, against the JAX step in float64, as
tests/test_torch_train_step.py holds the point model: the JAX package's
float32 step is not a stable reference on this CPU backend (its grad_norm
here moves by 2e-4 between two compilations of the same program, with the
persistent compilation cache on and off, while its float64 step and the
port agree to 5e-7), held at 1e-4 after one step and 1e-3 after three.
bf16: both models built at a bf16 compute dtype from the same float32
weights, held at the JAX suite's bf16 bar 3e-2 after one step (the logs,
the weights' moves where Adam's sign is not rounding) and, after three,
as tests/_torch_port.assert_bf16_logs_close says; the whole gradient
within 1.5 times JAX's own distance from float32. freeze_backbone: the
ViT takes no gradient, so AdamW only decays it, as optax does."""
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
                                              TrainState, cyclic_schedule,
                                              make_train_step)
from point_cloud_reid_tpu_torch.train.losses import reid_losses  # noqa: E402
from tests._torch_image import jax_variables_of, tiny_image_cfg  # noqa: E402
from tests._torch_port import (F32_LEAF_FLOOR,  # noqa: E402
                               assert_bf16_logs_close, assert_grads_close,
                               compile_together, flat_grads, jax_batch,
                               jax_negatives, port_flat, torch_batch)
from tests._torch_threads import few_threads  # noqa: E402,F401

VARIANT = "deit-test"
LEAF = "rgb_deit-tiny_point-cat_r_nus_det_4x60_200e"
USE = dict(match=True, cls=True, fp=True, vis=True, triplet=True)
MARGIN = 10.0           # the image leaves' triplet margin
STEPS_PER_EPOCH, EPOCHS = 3, 2
SCHED = dict(lr=3e-4, max_epochs=EPOCHS, grad_clip_norm=35.0)
# per mode: the dtypes, then the tolerance after (one step, three steps)
# for logs and gradient leaves, and for what a weight moved by against the
# largest move in its tensor
MODES = {
    "float32": dict(dtype=torch.float32, jax_dtype=jnp.float64,
                    tol=(1e-4, 1e-3), move_tol=(1e-3, 1e-2)),
    "bf16": dict(dtype=torch.bfloat16, jax_dtype=jnp.bfloat16,
                 tol=(3e-2, 3e-2), move_tol=(3e-2, 3e-2)),
}
NOISE = 1e-5    # float32: an applied gradient below this share of the
#                 largest one is rounding (tests/test_torch_train_step.py)


@functools.lru_cache(maxsize=1)
def _pipeline_batches() -> tuple:
    """Three batches of 6 pairs of the image leaf's train sampler (the
    port's data pipeline) over a seeded SyntheticStore of 32 x 32 image
    crops: ids with matches, non-matches and false positives (id -1),
    labels and visibility classes as the pipeline gives them."""
    from point_cloud_reid_tpu_torch.configs import get_experiment
    from point_cloud_reid_tpu_torch.data import (BatchLoader, SyntheticStore,
                                                 build_pair_dataset)
    dcfg = get_experiment(LEAF)["dataset"]
    store = SyntheticStore(num_objects=48,
                           class_names=list(dcfg["train"]["classes"]),
                           with_images=True, crop_size=(32, 32), seed=3)
    ds = build_pair_dataset(dict(dcfg["train"], with_dense=False), store,
                            store)
    loader = BatchLoader(ds, batch_size=6, shuffle=True, seed=3)
    return tuple(b for _, b in zip(range(3), loader))


def image_batch(i: int) -> dict:
    """Pipeline batch i, with one visibility class set to -1 (a frame
    without a visibility record) so that the vis loss's mask is used."""
    batch = {k: v.copy() for k, v in _pipeline_batches()[i].items()}
    batch["vis_1"][1] = -1
    return batch


def _run(dtype, jax_dtype, steps: int, freeze: bool = False):
    """Both trainers for `steps` steps from one init: per step the logs,
    the weights of the JAX side ('j') and of the port ('t'), and at step 1
    both gradients. jax_dtype float64 runs the JAX side in float64."""
    if jax_dtype == jnp.float64:
        with jax.enable_x64():
            return _run_on(dtype, jax_dtype, steps, freeze)
    return _run_on(dtype, jax_dtype, steps, freeze)


def _run_on(dtype, jax_dtype, steps, freeze):
    cfg = dict(tiny_image_cfg(VARIANT), freeze_backbone=freeze)
    tmodel = build_model(copy.deepcopy(cfg),
                         generator=torch.Generator().manual_seed(0),
                         dtype=dtype)
    jvars = jax_variables_of(tmodel, VARIANT)
    x64 = jax_dtype == jnp.float64
    if x64:
        jvars = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a,
            jvars)
    jmodel = jax_build(copy.deepcopy(cfg), dtype=jax_dtype)
    tx = j_build_optimizer(JScheduleConfig(**SCHED), STEPS_PER_EPOCH)
    jstate = JTrainState(params=jvars["params"], batch_stats={},
                         opt_state=tx.init(jvars["params"]),
                         step=jnp.zeros((), jnp.int32))
    state = TrainState.create(tmodel, ScheduleConfig(**SCHED),
                              STEPS_PER_EPOCH)
    tstep = make_train_step(tmodel, USE, {}, triplet_margin=MARGIN,
                            monitor=True)
    keys = jax.random.split(jax.random.PRNGKey(7), steps)

    def jax_grads(params, batch, key):
        def loss_fn(params):
            out = jmodel.apply({"params": params}, batch, train=True)
            return jl.reid_losses(out, batch, losses_to_use=USE, alpha={},
                                  rng=key, pool_type=jmodel.pool_type,
                                  triplet_margin=MARGIN)[0]
        return jax.grad(loss_fn)(params)

    def port_weights():
        return {k: v.double().numpy().copy()
                for k, v in tmodel.state_dict().items()}

    start = dict(t=port_weights(), j=port_flat(jstate.params))
    records, jstep, jgrad = [], None, None
    for i, key in enumerate(keys):
        batch = image_batch(i)
        jbatch = jax_batch(batch, np.float64 if x64 else np.float32)
        tbatch = torch_batch(batch)
        neg = torch.from_numpy(jax_negatives(key, batch["id_1"],
                                             batch["id_2"], 5))
        rec = {"start": start}
        if i == 0:
            jgrad, jstep = compile_together(
                jax.jit(jax_grads).lower(jstate.params, jbatch, key),
                j_train_step(jmodel, tx, USE, {}, donate=False, monitor=True,
                             triplet_margin=MARGIN).lower(jstate, jbatch,
                                                          key))
        rec["jgrads"] = port_flat(jgrad(jstate.params, jbatch, key))
        if i == 0:
            probe = copy.deepcopy(tmodel)
            loss, _ = reid_losses(probe(tbatch, train=True), tbatch, USE, {},
                                  pool_type=probe.pool_type, neg_idx=neg,
                                  triplet_margin=MARGIN)
            loss.backward()
            rec["tgrads"] = {k: (p.grad if p.grad is not None
                                 else torch.zeros_like(p)).double().numpy()
                             for k, p in probe.named_parameters()}
        jstate, jlog = jstep(jstate, jbatch, key)
        state, tlog = tstep(state, tbatch, None, neg)
        rec["jlog"] = {k: float(v) for k, v in jlog.items()}
        rec["tlog"] = {k: float(v) for k, v in tlog.items()}
        rec["jweights"] = port_flat(jstate.params)
        rec["tweights"] = port_weights()
        rec["steps"] = (int(jstate.step), state.step, state.optimizer.updates)
        records.append(rec)
    records[-1]["params"] = [p.dtype for p in tmodel.parameters()]
    return records


@functools.lru_cache(maxsize=None)
def _records(mode: str):
    spec = MODES[mode]
    return _run(spec["dtype"], spec["jax_dtype"], steps=3)


@pytest.fixture(scope="module", params=list(MODES))
def image_run(request):
    return request.param, _records(request.param)


def _lr_spent(updates: int) -> float:
    lr = cyclic_schedule(SCHED["lr"], EPOCHS * STEPS_PER_EPOCH)
    return sum(lr(i) for i in range(updates))


def _check_logs(mode, rec, step):
    assert {"match_loss", "cls_loss", "fp_loss", "vis_loss", "triplet_loss",
            "reid_loss", "grad_norm"} <= set(rec["tlog"])
    if mode == "bf16":
        assert_bf16_logs_close(rec["tlog"], rec["jlog"], step)
        return
    tol = MODES[mode]["tol"][step > 1]
    assert set(rec["tlog"]) == set(rec["jlog"])
    for k, want in rec["jlog"].items():
        assert abs(rec["tlog"][k] - want) <= tol * max(1.0, abs(want)), (
            k, rec["tlog"][k], want)


def _check_moves(mode, recs):
    """What each weight moved by since the start, against the JAX side's,
    within the move tolerance of the largest move in its tensor. Adam
    turns a gradient entry that is rounding (a key bias, whose gradient is
    zero but for it) into a move of the learning rate's size with the
    rounding's sign; such entries may differ by twice the learning rates
    spent. In float32 they are the entries whose gradient at any step so
    far is below NOISE of that step's largest; at bf16 (the first step
    only) those where either bf16 gradient is further than half its size
    from the float32 one."""
    rec = recs[-1]
    move_tol = MODES[mode]["move_tol"][rec["steps"][2] > 1]
    start = rec["start"]
    got = {k: rec["tweights"][k] - start["t"][k] for k in start["j"]}
    want = {k: rec["jweights"][k] - start["j"][k] for k in start["j"]}
    g0 = recs[0]
    if mode == "float32":
        noise = {k: np.zeros(w.shape, bool) for k, w in want.items()}
        for r in recs:
            top = max(float(np.max(np.abs(g))) for g in r["jgrads"].values())
            for k, g in r["jgrads"].items():
                if np.any(g):   # a tensor outside the loss moves by decay
                    noise[k] |= np.abs(g) < NOISE * top
    else:
        f32 = _records("float32")[0]["jgrads"]
        noise = {k: 2 * np.maximum(np.abs(g0["jgrads"][k] - f32[k]),
                                   np.abs(g0["tgrads"][k] - f32[k]))
                 >= np.abs(f32[k]) for k in f32}
    loose = 2.0 * _lr_spent(rec["steps"][2])
    top = max(float(np.max(np.abs(v))) for v in want.values())
    n_noise = 0
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        bound = (move_tol * max(float(np.max(np.abs(w))), 1e-3 * top)
                 + 1.2e-7 * float(np.max(np.abs(rec["jweights"][k]))))
        assert np.all(diff[~noise[k]] <= bound), (
            k, float(diff[~noise[k]].max()), bound)
        assert np.all(diff[noise[k]] <= loose + bound), (k, float(diff.max()))
        n_noise += int(noise[k].sum())
    return n_noise / sum(w.size for w in want.values())


def test_one_image_train_step_matches_jax(image_run):
    mode, recs = image_run
    rec = recs[0]
    assert rec["steps"] == (1, 1, 1)
    _check_logs(mode, rec, 1)
    if mode == "float32":
        assert_grads_close(rec["tgrads"], rec["jgrads"], MODES[mode]["tol"][0],
                           F32_LEAF_FLOOR)
    else:
        # a bf16 gradient lies far (L2) from the float32 one on this model,
        # JAX's and the port's alike, and much nearer each other. Held:
        # the port's within 1.5 times JAX's own distance from float32
        f32 = flat_grads(_records("float32")[0]["jgrads"])
        t, j = flat_grads(rec["tgrads"]), flat_grads(rec["jgrads"])
        assert np.linalg.norm(t - j) <= 1.5 * np.linalg.norm(j - f32)
        assert np.linalg.norm(t - j) < np.linalg.norm(t - f32)
    noise = _check_moves(mode, recs[:1])
    assert noise < (0.1 if mode == "float32" else 0.5), noise


def test_three_image_train_steps_match_jax(image_run):
    mode, recs = image_run
    assert recs[2]["steps"] == (3, 3, 3)
    for step, rec in enumerate(recs, 1):
        _check_logs(mode, rec, step)
    if mode == "float32":
        _check_moves(mode, recs)
    assert all(dt == torch.float32 for dt in recs[-1]["params"])
    first, last = recs[0]["tweights"], recs[2]["tweights"]
    for k in ("backbone.blocks.0.attn.qkv.weight", "backbone.pos_embed",
              "vis_head.1.weight", "match_head.1.weight"):
        assert not np.array_equal(first[k], last[k]), k


def test_frozen_backbone_only_decays():
    """freeze_backbone=True: the ViT's gradient is zero on both sides
    (ScheduledAdamW.gradients() hands AdamW zeros where a parameter took no
    gradient), so AdamW moves each backbone weight by -lr * weight_decay *
    weight, as optax's adamw does, while the heads train as JAX's."""
    rec = _run(torch.float32, jnp.float64, steps=1, freeze=True)[0]
    backbone = [k for k in rec["jgrads"] if k.startswith("backbone.")]
    assert backbone and all(not np.any(rec["jgrads"][k]) for k in backbone)
    assert all(not np.any(rec["tgrads"][k]) for k in backbone)
    _check_logs("float32", rec, 1)
    decay = SCHED["lr"] * ScheduleConfig().weight_decay
    for k in backbone:
        w0 = rec["start"]["t"][k]
        want = -decay * w0
        # a float32 weight moves in steps of its own spacing
        bound = 1e-3 * np.max(np.abs(want)) + 1.2e-7 * np.max(np.abs(w0))
        for side in "tj":
            moved = rec[side + "weights"][k] - rec["start"][side][k]
            assert np.max(np.abs(moved - want)) <= bound, (side, k)
    heads = {k: v for k, v in rec["jgrads"].items() if k not in backbone}
    assert_grads_close({k: rec["tgrads"][k] for k in heads}, heads, 1e-4,
                       F32_LEAF_FLOOR)
