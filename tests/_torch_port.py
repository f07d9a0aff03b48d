"""Shared set-up of the torch-port parity tests: one tiny flagship-shaped
model on both sides (JAX reference and PyTorch port) with the same weights.

Widths as tests/test_convert_full_model.py: mul=1, conv_out=16, N=32-point
crops, backbone_list=[16, 8, 4], nsample=[8, 8, 8]. The weights are the
port's seeded init (BatchNorm running statistics are not the identity),
handed to JAX as a flax tree by convert.to_jax_variables, so no flax init is
traced.
"""
from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from point_cloud_reid_tpu_torch.convert import to_jax_variables as to_jax_tree

TINY = dict(conv_out=16, mul=1, nsample=(8, 8, 8), backbone_list=(16, 8, 4))
N_PTS = 32


def tiny_torch_model(seed: int = 0):
    from point_cloud_reid_tpu_torch.configs import point_transformer_point_cat
    from point_cloud_reid_tpu_torch.models import build_model
    return build_model(point_transformer_point_cat(**TINY),
                       generator=torch.Generator().manual_seed(seed))


@functools.lru_cache(maxsize=1)
def tiny_models():
    """(jax_model, jax_variables, torch_model) sharing one set of weights."""
    import jax
    import jax.numpy as jnp
    from point_cloud_reid_tpu.configs.models import (
        point_transformer_point_cat as jax_cfg)
    from point_cloud_reid_tpu.models import build_model as jax_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmodel = tiny_torch_model()
    jvars = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(tmodel))
    return jax_build(jax_cfg(**TINY)), jvars, tmodel


def crops(seed: int, n: int, n_pts: int = N_PTS) -> np.ndarray:
    return (np.random.RandomState(seed).randn(n, n_pts, 3) * 0.6
            ).astype(np.float32)


def jax_uniform_crops(monkeypatch):
    """Make the port's crop draws JAX's: jax.random.uniform(PRNGKey(seed),
    (M, S)) with the seed the port's generator was seeded with."""
    import jax
    from point_cloud_reid_tpu_torch.tracking import crops as tcrops

    def uniforms(generator, M, S, device):
        key = jax.random.PRNGKey(generator.initial_seed())
        return torch.from_numpy(np.array(jax.random.uniform(key, (M, S))))

    monkeypatch.setattr(tcrops, "_crop_uniforms", uniforms)


# ---- training parity: one init on both sides, knobs on ----------------------

KNOBS = dict(knn_method="pallas", attention="linear-pallas")
# jax.jit(f).lower(*a).compile(compiler_options=NO_ALGSIMP): on this CPU
# backend the default compilation of the training gradient is wrong (it
# fails a finite-difference check that the same function run op by op
# passes); with XLA's algebraic simplifier off it is right.
# `python -m tests._torch_grad_reference` shows both.
NO_ALGSIMP = {"xla_disable_hlo_passes": "algsimp"}


def compile_together(*lowered):
    """The compiled programs of jax.jit(...).lower(...) results, each with
    NO_ALGSIMP, compiled at once, a thread each: XLA's compiler releases
    the GIL, so a test's gradient and train step (the same model's forward
    and backward, each compiled for tens of seconds) compile side by
    side."""
    with ThreadPoolExecutor(len(lowered)) as pool:
        return list(pool.map(
            lambda low: low.compile(compiler_options=NO_ALGSIMP), lowered))


def tiny_cfg(knn_method="argsort", attention="linear", aux=True) -> dict:
    """The tiny flagship config with the training knobs; the same dict
    builds the JAX model and the port's."""
    from point_cloud_reid_tpu_torch.configs import point_transformer_point_cat
    cfg = point_transformer_point_cat(**TINY, with_aux_heads=aux)
    if aux:
        # the flagship's 16 groups would hold 2 channels each at this width,
        # and a GroupNorm over 2 values amplifies rounding without bound
        cfg["cls_head"][0]["ng"] = cfg["fp_head"][0]["ng"] = 4
    cfg["knn_method"] = knn_method
    cfg["cross_stage1"]["attention"] = attention
    cfg["cross_stage2"]["attention"] = attention
    return cfg


def train_models(seed: int = 0, jax_dtype=np.float32, **knobs):
    """(jax_model, jax_variables, torch_model): fresh on every call, since
    training mutates the port's model. The JAX Pallas kernels the knobs
    select run in interpret mode on the CPU.

    jax_dtype=np.float64 (inside `with jax.enable_x64():`) builds the JAX
    side in float64. Gradient tests use it: through the whole backbone the
    JAX package's float32 gradients on the CPU are 3.6e-3 of the largest
    entry off its own float64 ones, the port's float32 ones 5e-6
    (`python -m tests._torch_grad_reference`), so only the float64
    reference can hold the port to 1e-4, and the port run in float64 too
    is held to it far tighter."""
    import copy
    import jax
    import jax.numpy as jnp
    from point_cloud_reid_tpu.models import build_model as jax_build
    from point_cloud_reid_tpu_torch.models import build_model
    cfg = tiny_cfg(**knobs)
    tmodel = build_model(copy.deepcopy(cfg),
                         generator=torch.Generator().manual_seed(seed))
    jvars = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jax_dtype),
                                   to_jax_tree(tmodel))
    return jax_build(copy.deepcopy(cfg), dtype=jax_dtype), jvars, tmodel


def jax_batch(batch: dict, dtype=np.float32) -> dict:
    """A numpy batch as jnp arrays, its float arrays in `dtype`."""
    import jax.numpy as jnp
    return {k: jnp.asarray(v, dtype) if v.dtype.kind == "f"
            else jnp.asarray(v) for k, v in batch.items()}


def port_flat(tree) -> dict:
    """A flax collection (params, batch_stats or gradients shaped like
    params) as {port state-dict key: numpy array in the port's layout}."""
    from point_cloud_reid_tpu_torch.convert import port_key
    from point_cloud_reid_tpu_torch.convert.jax_variables import (
        _flatten, _port_layout)
    out = {}
    for path, value in _flatten(tree).items():
        key, transpose = port_key(path)
        out[key] = _port_layout(value) if transpose else value
    return out


def pair_batch(seed: int, B: int = 6, n_pts: int = N_PTS, dense: int = 0,
               dups: bool = True) -> dict:
    """A numpy training batch: sparse crops with duplicated points (as
    resample-with-replacement makes them; dups=False keeps every point
    distinct), ids with matches and non-matches, labels on both sides of
    the false-positive threshold."""
    rs = np.random.RandomState(seed)

    def crop():
        if not dups:
            return (rs.randn(B, n_pts, 3) * 0.6).astype(np.float32)
        base = (rs.randn(B, n_pts - 6, 3) * 0.6).astype(np.float32)
        dup = base[:, rs.randint(0, n_pts - 6, 6)]
        return np.concatenate([base, dup], axis=1)

    id_1 = np.arange(B, dtype=np.int32)
    id_2 = np.where(np.arange(B) % 2 == 0, id_1, (id_1 + 1) % B).astype(
        np.int32)
    id_2[-1] = -1
    batch = dict(sparse_1=crop(), sparse_2=crop(), id_1=id_1, id_2=id_2,
                 label_1=rs.randint(0, 20, B).astype(np.int32),
                 label_2=rs.randint(0, 20, B).astype(np.int32),
                 size_1=rs.randint(1, 500, B).astype(np.int32),
                 size_2=rs.randint(1, 500, B).astype(np.int32),
                 vis_1=rs.randint(0, 4, B).astype(np.int32),
                 vis_2=rs.randint(0, 4, B).astype(np.int32),
                 dist_1=(rs.rand(B) * 60).astype(np.float32),
                 dist_2=(rs.rand(B) * 60).astype(np.float32))
    if dense:
        batch["dense_1"] = (rs.randn(B, dense, 3) * 0.6).astype(np.float32)
        batch["dense_2"] = (rs.randn(B, dense, 3) * 0.6).astype(np.float32)
    return batch


def torch_batch(batch: dict) -> dict:
    from point_cloud_reid_tpu_torch.train import to_device
    return to_device(batch, "cpu")


def jax_negatives(key, id_1, id_2, sample_num: int) -> np.ndarray:
    """The (B, sample_num) negatives that the JAX package's triplet_loss
    draws from `key` for these ids (train/losses.py: one categorical draw
    over the rows of [h1; h2] whose id differs from the anchor's)."""
    import jax
    import jax.numpy as jnp
    id_1, id_2 = jnp.asarray(id_1), jnp.asarray(id_2)
    id_cat = jnp.concatenate([id_1, id_2], axis=0)
    logits = jnp.where(id_cat[None, :] != id_1[:, None], 0.0, -jnp.inf)
    neg = jax.random.categorical(key, logits[:, None, :], axis=-1,
                                 shape=(id_1.shape[0], sample_num))
    return np.asarray(neg).astype(np.int64)


# A bias in front of a BatchNorm has a gradient that is zero but for
# rounding, and that rounding follows the layer's other gradients: 5 % of the
# largest entry of all leaves is the least scale at which the port's float32
# gradients meet 1e-4 there. In float64 the floor is 1e-3.
F32_LEAF_FLOOR = 0.05


def assert_grads_close(got: dict, want: dict, tol: float,
                       floor: float = 1e-3) -> None:
    """Two {name: tensor} dicts with the same keys (gradients, or weight
    updates), each tensor within tol of its own scale: the largest |entry|
    of that tensor in `want`, but no less than `floor` times the largest
    entry of the whole set (a bias in front of a BatchNorm has a gradient
    that is zero but for rounding, so its own scale says nothing)."""
    assert set(got) == set(want)
    top = max(float(np.max(np.abs(np.asarray(v))))
              for v in want.values() if np.size(v))
    for k in sorted(want):
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if not g.size:
            continue
        scale = max(float(np.max(np.abs(w))), floor * top)
        err = float(np.max(np.abs(g - w)))
        assert err <= tol * scale, (
            f"{k}: err {err:.3e} > {tol:g} x {scale:.3e}")


def assert_close_scaled(got, want, tol: float, what: str = "") -> None:
    """max |got - want| <= tol * max(1, max |want|): a tolerance relative
    to the tensor's scale (single entries near zero carry no relative
    information in float32)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    bound = tol * max(1.0, float(np.max(np.abs(want))) if want.size else 0.0)
    assert err <= bound, f"{what}: err {err:.3e} > {bound:.3e}"


# ---- bf16 training parity ---------------------------------------------------

# the JAX suite's bf16 bar (tests/test_torch_bf16_modules.py)
BF16_TOL = 3e-2
# After the first step a bf16 run follows a trajectory of its own: a bf16
# gradient is rounding on many entries (a sum of bf16 products that
# cancels, through each BatchNorm and LayerNorm), Adam turns each such
# entry into a move of the learning rate's size with the rounding's sign,
# and the next gradients move with them. On the tiny image model the bf16
# grad_norm reads 112.3 (port) and 115.4 (JAX) at step 1 against float32's
# 184.1, and 32.9 and 51.0 at step 3 against 130.3; the JAX package's own
# bf16 grad_norm on it differs by 6 % at step 2 between two compilations of
# the same program. So after step 1 grad_norm is not compared; the total
# loss stays at BF16_TOL, and the loss terms and update_norm (which Adam
# normalises) are held at BF16_DRIFT: they lie up to 4.3e-2 apart after
# three steps on the tiny models.
BF16_DRIFT = 0.1


def assert_bf16_logs_close(got: dict, want: dict, step: int):
    """A bf16 train step's logs (`got`) against the JAX package's bf16 step
    (`want`), relative to max(1, |want|): every entry at BF16_TOL at the
    first step; after it reid_loss and param_norm at BF16_TOL, the loss
    terms and update_norm at BF16_DRIFT, and neither grad_norm nor the
    accuracies and counts (functions of logits next to a decision
    boundary)."""
    assert set(got) == set(want)
    for k, w in want.items():
        if step == 1 or k in ("reid_loss", "param_norm"):
            tol = BF16_TOL
        elif k.endswith("_loss") or k == "update_norm":
            tol = BF16_DRIFT
        else:
            continue
        assert abs(got[k] - w) <= tol * max(1.0, abs(w)), (step, k, got[k], w)


def flat_grads(grads: dict) -> np.ndarray:
    """A {leaf: gradient} dict as one vector, in key order."""
    return np.concatenate([np.asarray(v, np.float64).ravel()
                           for _, v in sorted(grads.items())])


# ---- one train step of a leaf against JAX -----------------------------------

LEAF_USE = dict(match=True, triplet=True)
LEAF_SCHED = dict(lr=3e-4, max_epochs=2, grad_clip_norm=35.0)
# the port in float64 against JAX's float64 step: the logs, weights and
# running statistics, relative to max(1, |JAX|) (JAX keeps float32 pieces,
# its learning-rate schedule among them, which show at 1e-9 in the
# weights); the port as it trains, in float32, against the same step: the
# losses and grad_norm (the point-transformer backbone's float32 gradient
# norm lies 1.1e-4 from the float64 one on these crops). update_norm and
# the weights are not compared in float32: Adam's first update is about
# lr * sign(g), and a gradient entry that is zero but for rounding (a bias
# in front of a BatchNorm) takes the rounding's sign.
LEAF_STEP64_TOL = 1e-6
LEAF_STEP32_TOL = 1e-3


def port_step(tmodel, batch: dict, dtype, neg, remat: bool = False):
    """One optimizer step of a copy of `tmodel` in `dtype` on a numpy
    batch with the triplet negatives `neg`: (logs, {state-dict key: array}
    after the step)."""
    import copy
    from point_cloud_reid_tpu_torch.train import (ScheduleConfig, TrainState,
                                                  make_train_step)
    model = copy.deepcopy(tmodel).to(dtype)
    state = TrainState.create(model, ScheduleConfig(**LEAF_SCHED), 3)
    step = make_train_step(model, LEAF_USE, {}, monitor=True, remat=remat)
    tb = {k: v.to(dtype) if v.is_floating_point() else v
          for k, v in torch_batch(batch).items()}
    _, log = step(state, tb, None, neg)
    return ({k: float(v) for k, v in log.items()},
            {k: v.double().numpy() for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")})


def check_leaf_step(cfg: dict, seed: int = 30, pairs: int = 4,
                    weights: bool = True) -> None:
    """One step of the model `cfg` (losses match + triplet) from the port's
    seeded init on `pairs` pairs of crops with duplicated points, against
    the JAX package's jitted step in float64 with XLA's algebraic
    simplifier off, the triplet negatives JAX's own draw. weights=False
    compares the logs alone: with an attention knob on, JAX's Pallas
    kernel computes in float32 at every dtype, and Adam's first update
    turns that rounding of a near-zero gradient entry into a move of the
    learning rate's size."""
    import copy
    import jax
    import jax.numpy as jnp
    from point_cloud_reid_tpu.models import build_model as jax_build
    from point_cloud_reid_tpu.train.loop import make_train_step as j_step
    from point_cloud_reid_tpu.train.schedules import (
        ScheduleConfig as JScheduleConfig, build_optimizer)
    from point_cloud_reid_tpu.train.state import TrainState as JTrainState
    from point_cloud_reid_tpu_torch.models import build_model
    tmodel = build_model(copy.deepcopy(cfg),
                         generator=torch.Generator().manual_seed(0))
    batch = pair_batch(seed, B=pairs)
    key = jax.random.PRNGKey(7)
    with jax.enable_x64():
        # the negatives JAX's step draws, drawn as it draws them (with x64)
        neg = torch.from_numpy(jax_negatives(key, batch["id_1"],
                                             batch["id_2"], 5))
        jvars = jax.tree_util.tree_map(lambda a: jnp.asarray(a, np.float64),
                                       to_jax_tree(tmodel))
        tx = build_optimizer(JScheduleConfig(**LEAF_SCHED), 3)
        jstate = JTrainState(params=jvars["params"],
                             batch_stats=jvars["batch_stats"],
                             opt_state=tx.init(jvars["params"]),
                             step=jnp.zeros((), jnp.int32))
        jb = jax_batch(batch, np.float64)
        step = j_step(jax_build(copy.deepcopy(cfg), dtype=np.float64), tx,
                      LEAF_USE, {}, donate=False, monitor=True).lower(
            jstate, jb, key).compile(compiler_options=NO_ALGSIMP)
        jstate, jlog = step(jstate, jb, key)
        jlog = {k: float(v) for k, v in jlog.items()}
        want = dict(port_flat(jstate.params), **port_flat(jstate.batch_stats))
    log64, moved = port_step(tmodel, batch, torch.float64, neg)
    assert set(log64) == set(jlog)
    for k, w in jlog.items():
        assert abs(log64[k] - w) <= LEAF_STEP64_TOL * max(1.0, abs(w)), (
            k, log64[k], w)
    if weights:
        assert set(moved) == set(want)
        for k, w in want.items():
            assert_close_scaled(moved[k], w, LEAF_STEP64_TOL, k)
    log32, _ = port_step(tmodel, batch, torch.float32, neg)
    for k in ("reid_loss", "match_loss", "triplet_loss", "grad_norm"):
        assert abs(log32[k] - jlog[k]) <= LEAF_STEP32_TOL * max(
            1.0, abs(jlog[k])), (k, log32[k], jlog[k])
