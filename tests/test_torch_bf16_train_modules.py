"""The port's bf16 modules under autograd, its losses on bf16 outputs and
the fused attention's bf16 gradient, against the JAX package's at the JAX
suite's bf16 bar BF16_TOL (3e-2), from the same bf16 inputs and float32
weights (a model built with dtype=torch.bfloat16 against
build_model(cfg, dtype=bfloat16)):
  the match chain (both cross stages and the match head), the aux heads
  and the FP stages: each gradient leaf and input gradient, scaled to the
  leaf with a floor (tests/_torch_port.assert_grads_close);
  the SA stages' train-mode forward (batch statistics in float32, running
  statistics float32 and moved as flax moves them, output bf16);
  the losses, each on bf16 inputs, in JAX's dtypes;
  the fused attention on bf16 q, k, v against jax.vjp of
  linear_attention_pallas (interpret mode).
Also utils/cache keeping one derived copy per weight however often the
weight is updated. The whole train step at bf16 is
tests/test_torch_train_bf16.py."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.models import build_model as jax_build  # noqa: E402
from point_cloud_reid_tpu.train import losses as jl  # noqa: E402
from point_cloud_reid_tpu_torch.models import build_model  # noqa: E402
from point_cloud_reid_tpu_torch.train import (ScheduleConfig,  # noqa: E402
                                              TrainState, make_train_step)
from point_cloud_reid_tpu_torch.train import losses as tl  # noqa: E402
from tests._torch_port import (BF16_TOL, F32_LEAF_FLOOR, KNOBS,  # noqa: E402
                               assert_close_scaled, assert_grads_close,
                               jax_negatives, pair_batch, port_flat,
                               tiny_cfg, to_jax_tree, torch_batch)
from tests._torch_threads import few_threads  # noqa: E402,F401

BF16 = jnp.bfloat16
USE = dict(match=True, kl=True, triplet=True, cls=True, fp=True)
ALPHA = dict(kl=0.1, cls=0.5)
STEPS_PER_EPOCH, EPOCHS = 3, 2
SCHED = dict(lr=3e-4, max_epochs=EPOCHS, grad_clip_norm=35.0)


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _bf16(x: np.ndarray):
    """The same bf16 values on both sides."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), BF16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


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


def _assert_leaves_close(got: dict, want: dict):
    """Each gradient leaf of `got` within BF16_TOL of `want`, scaled to the
    leaf with a floor of F32_LEAF_FLOOR times the largest entry of the set
    (tests/_torch_port.assert_grads_close)."""
    assert_grads_close({k: _np(v) for k, v in got.items()},
                       {k: _np(v) for k, v in want.items()}, BF16_TOL,
                       F32_LEAF_FLOOR)


# ---- modules under autograd ------------------------------------------------


def _port_grads(module, loss_fn, inputs):
    """d loss / d (parameters, inputs) of a port module at bf16."""
    module.requires_grad_(True)
    for p in module.parameters():
        p.grad = None
    ins = [t.detach().requires_grad_(True) for t in inputs]
    loss_fn(*ins).backward()
    out = {k: p.grad for k, p in module.named_parameters()
           if p.grad is not None}
    out.update({f"input{i}": t.grad for i, t in enumerate(ins)})
    module.requires_grad_(False)
    return out


def _chain_grads():
    """Gradients of a weighted sum of the bf16 match logits (train mode)
    over the cross stages' and match head's weights and the two bf16
    embeddings."""
    tmodel, jmodel, jvars = _models(torch.bfloat16, **KNOBS)
    h1, jh1 = _bf16(_randn(1, 6, 16, 16))
    h2, jh2 = _bf16(_randn(2, 6, 16, 16))
    x1, x2 = _randn(3, 6, 16, 3, scale=0.6), _randn(4, 6, 16, 3, scale=0.6)
    w = _randn(5, 6)

    def jloss(params, a, b):
        logits = jmodel.apply(
            {"params": params, "batch_stats": jvars["batch_stats"]}, a,
            jnp.asarray(x1), b, jnp.asarray(x2), train=True,
            method="match_logits", mutable=["batch_stats"])[0][0]
        return jnp.sum(logits.astype(jnp.float32) * w)

    gp, ga, gb = jax.grad(jloss, argnums=(0, 1, 2))(jvars["params"], jh1,
                                                    jh2)
    want = {k: v for k, v in port_flat(gp).items()
            if k.split(".")[0] in ("cross_stage1", "cross_stage2",
                                   "match_head")}
    want.update(input0=ga, input1=gb)

    def tloss(a, b):
        logits, _ = tmodel.match_logits(a, torch.from_numpy(x1), b,
                                        torch.from_numpy(x2), train=True)
        return (logits.float() * torch.from_numpy(w)).sum()

    got = _port_grads(tmodel, tloss, (h1, h2))
    return got, want


def test_match_chain_gradients_at_bf16_match_jax():
    got, want = _chain_grads()
    assert got["input0"].dtype == torch.bfloat16
    assert all(got[k].dtype == torch.float32 for k in got
               if not k.startswith("input"))
    _assert_leaves_close(got, want)


@pytest.mark.parametrize("head", ["cls_head", "fp_head"])
def test_aux_head_gradients_at_bf16_match_jax(head):
    """An aux head (LinearRes with GroupNorm, then Linear) on bf16 pooled
    features, under autograd."""
    tmodel, jmodel, jvars = _models(torch.bfloat16)
    x, jx = _bf16(_randn(6, 8, 32))
    w = _randn(7, 8, 20 if head == "cls_head" else 1)

    def jloss(params, a):
        y = jmodel.apply({"params": params}, a, method=lambda m, v: getattr(
            m, "_" + head)(v, train=True))
        return jnp.sum(y.astype(jnp.float32) * w)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(jvars["params"], jx)
    want = {k[len(head) + 1:]: v for k, v in port_flat(gp).items()
            if k.startswith(head + ".")}
    want["input0"] = gx
    module = getattr(tmodel, head)
    got = _port_grads(module, lambda a: (module(a, True).float()
                                         * torch.from_numpy(w)).sum(), (x,))
    _assert_leaves_close(got, want)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_fp_stage_gradients_at_bf16_match_jax(i):
    """An FP stage (attention interpolation, coarse -> fine) on bf16
    features and float32 xyz, under autograd."""
    from point_cloud_reid_tpu.models.point_transformer import (
        FeaturePropagationSA)
    specs = [dict(feat1_dim=3, feat2_dim=64, d_model=64, out_dim=32),
             dict(feat1_dim=32, feat2_dim=128, d_model=64, out_dim=64),
             dict(feat1_dim=64, feat2_dim=128, d_model=64, out_dim=128)]
    n1, n2 = (32, 16, 8)[i], (16, 8, 4)[i]
    spec = specs[i]
    xyz1, xyz2 = _randn(8, 4, n1, 3, scale=0.6), _randn(9, 4, n2, 3,
                                                          scale=0.6)
    w = _randn(10, 4, n1, spec["out_dim"])
    tmodel, _, jvars = _models(torch.bfloat16)
    t2, j2 = _bf16(_randn(12, 4, n2, spec["feat2_dim"]))
    if i == 0:                  # the finest level's features are its xyz
        t1, j1 = torch.from_numpy(xyz1), jnp.asarray(xyz1)
    else:
        t1, j1 = _bf16(_randn(11, 4, n1, spec["feat1_dim"]))
    jstage = FeaturePropagationSA(dtype=BF16, **spec)
    params = jvars["params"]["backbone"][f"fp_{i}"]

    def jloss(params, a, b):
        y = jstage.apply({"params": params}, jnp.asarray(xyz1),
                         jnp.asarray(xyz2), a, b)
        return jnp.sum(y.astype(jnp.float32) * w)

    gp, g1, g2 = jax.grad(jloss, argnums=(0, 1, 2))(params, j1, j2)
    want = {k[len(f"backbone.FP_modules.{i}."):]: v
            for k, v in port_flat({"backbone": {f"fp_{i}": gp}}).items()}
    want.update(input0=g1, input1=g2)
    stage = tmodel.backbone.FP_modules[i]
    got = _port_grads(stage, lambda a, b: (stage(
        torch.from_numpy(xyz1), torch.from_numpy(xyz2), a, b).float()
        * torch.from_numpy(w)).sum(), (t1, t2))
    _assert_leaves_close(got, want)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_sa_stage_train_forward_at_bf16_matches_flax(i):
    """An SA stage's train-mode forward at bf16: the edge MLP normalised
    with batch statistics computed in float32, the running statistics
    float32 and moved as flax moves them, the output bf16."""
    from point_cloud_reid_tpu.models.point_transformer import (
        SetAbstractionEdgeSA)
    tmodel, _, jvars = _models(torch.bfloat16)
    sa = (32, 64, 128)[i]
    mlp = [[3, sa, sa, sa], [sa + 3, sa, sa, sa], [sa + 3, sa, sa, sa]][i]
    n_in = (32, 16, 8)[i]
    S = (16, 8, 4)[i]
    xyz = _randn(13, 4, n_in, 3, scale=0.6)
    # input features: the previous stage's output, half this stage's width
    tp, jp = (None, None) if i == 0 else _bf16(_randn(14, 4, n_in, sa // 2))
    jstage = SetAbstractionEdgeSA(mlp=mlp, nsample=8, dtype=BF16)
    v = {c: jvars[c]["backbone"][f"sa_{i}"] for c in jvars}
    (jxyz, want), mutated = jstage.apply(v, jnp.asarray(xyz), jp, S,
                                         train=True, mutable=["batch_stats"])
    stage = tmodel.backbone.SA_modules[i]
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    with torch.no_grad():
        xyz_out, got = stage(torch.from_numpy(xyz), tp, S, train=True)
    assert got.dtype == torch.bfloat16 and xyz_out.dtype == torch.float32
    np.testing.assert_array_equal(xyz_out.numpy(), np.asarray(jxyz))
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL,
                               atol=BF16_TOL)
    stats = port_flat({"backbone": {f"sa_{i}": mutated["batch_stats"]}})
    assert len(stats) == 6
    state = tmodel.state_dict()
    for k, w in stats.items():
        assert state[k].dtype == torch.float32, k
        assert not torch.equal(state[k], before[k]), k
        assert_close_scaled(state[k].numpy(), w, BF16_TOL, k)


# ---- losses and the attention gradient -------------------------------------

def _loss_inputs(name):
    rs = np.random.RandomState(sum(map(ord, name)))
    B = 8
    logits = (rs.randn(B) * 3).astype(np.float32)
    target = (rs.rand(B) > 0.5).astype(np.float32)
    weights = rs.rand(B) > 0.3
    h1, h2 = rs.randn(B, 6, 5).astype(np.float32), rs.randn(B, 6, 5).astype(
        np.float32)
    ids = np.arange(B, dtype=np.int32)
    id2 = np.where(np.arange(B) % 2 == 0, ids, (ids + 3) % B).astype(np.int32)
    match = (ids == id2).astype(np.float32)
    return rs, logits, target, weights, h1, h2, ids, id2, match


@pytest.mark.parametrize("name", ["bce", "bce_weighted", "softmax_ce",
                                  "kl_pair", "triplet", "smooth_l1"])
def test_losses_at_bf16_follow_jax(name):
    """Each loss on bf16 model outputs (float32 targets and masks, as the
    step passes them) against the JAX loss on the same bf16 values: the
    same value within the bar and the same result dtype."""
    rs, logits, target, weights, h1, h2, ids, id2, match = _loss_inputs(name)
    (tlog, jlog), (th1, jh1), (th2, jh2) = (_bf16(logits), _bf16(h1),
                                           _bf16(h2))
    t = [torch.from_numpy(a) for a in (target, weights, ids, id2, match)]
    j = [jnp.asarray(a) for a in (target, weights, ids, id2, match)]
    if name == "bce":
        got, want = tl.bce_with_logits(tlog, t[0]), jl.bce_with_logits(
            jlog, j[0])
    elif name == "bce_weighted":
        got = tl.bce_with_logits(tlog, t[0], t[1])
        want = jl.bce_with_logits(jlog, j[0], j[1])
    elif name == "softmax_ce":
        (tc, jc) = _bf16((rs.randn(8, 7) * 2).astype(np.float32))
        lab = rs.randint(0, 7, 8).astype(np.int32)
        got = tl.softmax_ce(tc, torch.from_numpy(lab), t[1])
        want = jl.softmax_ce(jc, jnp.asarray(lab), j[1])
    elif name == "kl_pair":
        got, want = tl.kl_pair_loss(th1, th2, t[4]), jl.kl_pair_loss(
            jh1, jh2, j[4])
    elif name == "triplet":
        key = jax.random.PRNGKey(5)
        neg = jax_negatives(key, ids, id2, 4)
        want = jl.triplet_loss(key, jh1, jh2, j[2], j[3], j[4], sample_num=4,
                               margin=10.0)
        got = tl.triplet_loss(th1, th2, t[2], t[3], t[4], sample_num=4,
                              margin=10.0, neg_idx=torch.from_numpy(neg))
    else:
        got = tl.smooth_l1(th1, th2, weights=t[1])
        want = jl.smooth_l1(jh1, jh2, weights=j[1])
    assert str(got.dtype).split(".")[-1] == str(jnp.dtype(want.dtype)), (
        got.dtype, want.dtype)
    assert abs(float(got) - float(want)) <= BF16_TOL * max(1.0,
                                                            abs(float(want)))


def test_fused_attention_gradient_at_bf16_matches_jax():
    """The fused linear attention on bf16 q, k, v: the output bf16 from the
    float32 kernel, and the gradient the bf16 composite's, as JAX's
    custom VJP of linear_attention_pallas (interpret mode) computes it."""
    from point_cloud_reid_tpu.ops.pallas.linear_attention import (
        linear_attention_pallas)
    from point_cloud_reid_tpu_torch.kernels.linear_attention import (
        fused_linear_attention)
    (tq, jq), (tk, jk), (tv, jv) = (_bf16(_randn(20, 3, 24, 2, 8)),
                                    _bf16(_randn(21, 3, 16, 2, 8)),
                                    _bf16(_randn(22, 3, 16, 2, 8)))
    (tg, jg) = _bf16(_randn(23, 3, 24, 2, 8))
    want, vjp = jax.vjp(lambda q, k, v: linear_attention_pallas(
        q, k, v, interpret=True), jq, jk, jv)
    want_grads = vjp(jg)
    q, k, v = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    got = fused_linear_attention(q, k, v)
    got.backward(tg)
    assert got.dtype == torch.bfloat16 and want.dtype == BF16
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL,
                               atol=BF16_TOL)
    for t, w in zip((q, k, v), want_grads):
        assert t.grad.dtype == torch.bfloat16 and w.dtype == BF16
        err = np.linalg.norm(_np(t.grad) - _np(w))
        assert err <= BF16_TOL * np.linalg.norm(_np(w))
        np.testing.assert_allclose(_np(t.grad), _np(w), rtol=BF16_TOL,
                                   atol=BF16_TOL * np.abs(_np(w)).max())


# ---- utils/cache ------------------------------------------------------------

def test_cache_keeps_one_copy_per_weight_over_updates():
    """N optimizer updates, each followed by a bf16 eval forward, leave one
    bf16 copy of each weight in utils/cache, the copy of the weights as
    they stand."""
    from point_cloud_reid_tpu_torch.utils import cache
    cache._CACHE.clear()
    tmodel, _, _ = _models(torch.bfloat16)
    state = TrainState.create(tmodel, ScheduleConfig(**SCHED),
                              STEPS_PER_EPOCH)
    step = make_train_step(tmodel, dict(match=True), {})
    crops = torch_batch(pair_batch(31))
    sizes = []
    for i in range(4):
        step(state, torch_batch(pair_batch(30 + i)))
        with torch.no_grad():
            tmodel(crops, train=False)
        sizes.append(len(cache._CACHE))
    assert sizes == [sizes[0]] * 4 and sizes[0] > 0
    weight = tmodel.cross_stage1.q_proj.weight
    hits = [v for (key, v) in cache._CACHE.items()
            if key[0] == ("cast", torch.bfloat16)
            and v[0][0] is weight]
    assert len(hits) == 1
    assert torch.equal(hits[0][2], weight.detach().to(torch.bfloat16))
    cache._CACHE.clear()
