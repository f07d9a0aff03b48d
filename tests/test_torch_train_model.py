"""Train mode of the port's model against the JAX package: the SA stage and
the backbone (outputs, input gradients, BatchNorm running statistics), the
full training forward with aux heads and both kernel knobs on, the head
layers, and the converter in both directions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.models.layers import LinearRes as JLinearRes  # noqa: E402
from point_cloud_reid_tpu.models.point_transformer import (  # noqa: E402
    SetAbstractionEdgeSA as JStage)
from point_cloud_reid_tpu.models.registry import SequentialHead as JHead  # noqa: E402
from point_cloud_reid_tpu_torch.convert import (from_jax_variables,  # noqa: E402
                                                to_jax_variables)
from point_cloud_reid_tpu_torch.models import build_model, init_weights  # noqa: E402
from point_cloud_reid_tpu_torch.models.layers import LinearRes  # noqa: E402
from point_cloud_reid_tpu_torch.models.registry import build_head  # noqa: E402
from tests._torch_port import (F32_LEAF_FLOOR, KNOBS, N_PTS,  # noqa: E402
                               NO_ALGSIMP, TINY, assert_close_scaled,
                               assert_grads_close, pair_batch, port_flat,
                               tiny_cfg, torch_batch, train_models)
from tests._torch_threads import few_threads  # noqa: E402,F401

STAGE_TOL = 1e-4       # one stage / the backbone: float32, other sum orders
MODEL_TOL = 1e-3       # the full model (tests/test_convert_full_model.py)


def _compiled(fn, *args):
    """fn(*args) through one XLA compilation with the algebraic simplifier
    off (tests/_torch_port.NO_ALGSIMP: the CPU backend's default
    compilation of these gradients is wrong), instead of op by op: the
    same numbers, without running each op (and each interpreted Pallas
    grid step) on its own."""
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_ALGSIMP)(
        *args)


def _sub(tree, *path):
    for p in path:
        tree = tree[p]
    return tree


def _bn_stats(module, prefix=""):
    return {prefix + k: v.numpy().copy()
            for k, v in module.state_dict().items() if "running_" in k}


@pytest.mark.parametrize("dups", [False, True], ids=["distinct", "dups"])
@pytest.mark.parametrize("stage", [0, 1])
def test_train_mode_sa_stage_matches_jax(stage, dups):
    """Stage 0 has no input features (materialised edges); stage 1 runs the
    factored first layer. The port's kNN goes through its 'pallas' method;
    the JAX stage uses 'argsort', which gives the same indices, because a
    Pallas call cannot be differentiated with respect to its inputs (in
    training only the parameters carry gradients: the backbone test below
    does that with 'pallas' on both sides).

    With duplicated points (what resampling with replacement makes) the
    neighbourhoods hold identical rows and the max over neighbours is an
    exact tie. There the JAX stage's float32 gradients on the CPU miss its
    own float64 gradients by far more than 1e-4 (measured on the whole
    model by tests/_torch_grad_reference.py), while the port's float32
    gradients agree with both packages' float64 ones to 1e-4. So with
    duplicates the JAX stage runs in float64."""
    _, jvars, tmodel = train_models(knn_method="pallas")
    tstage = tmodel.backbone.SA_modules[stage]
    rs = np.random.RandomState(stage)
    xyz = (rs.randn(4, 24, 3) * 0.6).astype(np.float32)
    C_in = (tstage.mlp_convs[0].in_features - 3) // 2
    pts = rs.randn(4, 24, C_in).astype(np.float32) if stage else None
    if dups:
        xyz[:, 20:] = xyz[:, :4]
        if stage:
            pts[:, 20:] = pts[:, :4]
    S, C = 10, tstage.mlp_convs[-1].out_features
    cot = rs.randn(4, S, C).astype(np.float32)
    dt = np.float64 if dups else np.float32

    def jax_side():
        jstage = JStage(mlp=[tstage.mlp_convs[0].in_features, C, C, C],
                        nsample=tstage.nsample, knn_method="argsort",
                        dtype=dt)
        jv = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), dt),
            {c: _sub(jvars[c], "backbone", f"sa_{stage}")
             for c in ("params", "batch_stats")})

        def jloss(params, x, p):
            (nx, h), mut = jstage.apply(
                {"params": params, "batch_stats": jv["batch_stats"]}, x, p, S,
                True, mutable=["batch_stats"])
            return jnp.sum(h * jnp.asarray(cot, dt)), (nx, h,
                                                       mut["batch_stats"])

        grad = jax.value_and_grad(
            jloss, argnums=(0, 1, 2) if stage else (0, 1), has_aux=True)
        args = (jv["params"], jnp.asarray(xyz, dt),
                None if pts is None else jnp.asarray(pts, dt))
        if pts is None:
            out = _compiled(lambda p, x: grad(p, x, None), *args[:2])
        else:
            out = _compiled(grad, *args)
        return jax.tree_util.tree_map(np.asarray, out)

    if dups:
        with jax.enable_x64():
            (_, (jnx, jh, jstats)), jg = jax_side()
    else:
        (_, (jnx, jh, jstats)), jg = jax_side()

    tx = torch.from_numpy(xyz).requires_grad_(True)
    tp = None if pts is None else torch.from_numpy(pts).requires_grad_(True)
    tmodel.requires_grad_(True)
    tnx, th = tstage(tx, tp, S, train=True)
    (th * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(tnx.detach().numpy(),
                                  jnx.astype(np.float32))
    assert_close_scaled(th.detach().numpy(), jh, STAGE_TOL, "stage output")
    assert_close_scaled(tx.grad.numpy(), jg[1], STAGE_TOL, "d xyz")
    if stage:
        assert_close_scaled(tp.grad.numpy(), jg[2], STAGE_TOL, "d points")
    assert_grads_close(
        {"backbone.SA_modules.%d.%s" % (stage, k): p.grad.numpy()
         for k, p in tstage.named_parameters()},
        port_flat({"backbone": {f"sa_{stage}": jg[0]}}), STAGE_TOL,
        F32_LEAF_FLOOR)
    want = port_flat({f"sa_{stage}": jstats})
    got = _bn_stats(tstage, f"sa_{stage}.")
    assert len(got) == 6
    for k, v in got.items():
        jk = k.replace(f"sa_{stage}.mlp_bns.", f"sa_{stage}.mlp_").replace(
            ".running_", ".bn.running_")
        assert_close_scaled(v, want[jk], STAGE_TOL, k)


def test_train_mode_backbone_matches_jax():
    """Embedding, parameter gradients and running statistics of one
    train-mode pass on crops with duplicated points, kNN through 'pallas'
    on both sides; the JAX side in float64 (see train_models)."""
    x = pair_batch(5)["sparse_1"]
    cot = np.random.RandomState(6).randn(x.shape[0], N_PTS,
                                         TINY["conv_out"]).astype(np.float32)
    with jax.enable_x64():
        jmodel, jvars, tmodel = train_models(knn_method="pallas",
                                             jax_dtype=np.float64)

        def jloss(params):
            (_, h), mut = jmodel.apply(
                {"params": params, "batch_stats": jvars["batch_stats"]},
                jnp.asarray(x, np.float64), train=True, method="embed",
                mutable=["batch_stats"])
            return jnp.sum(h * cot), (h, mut["batch_stats"])

        (_, (jh, jstats)), jg = jax.tree_util.tree_map(
            np.asarray, _compiled(jax.value_and_grad(jloss, has_aux=True),
                                  {"backbone": jvars["params"]["backbone"]}))
    tx = torch.from_numpy(x)
    tmodel.requires_grad_(True)
    before = _bn_stats(tmodel)
    _, th = tmodel.embed(tx, train=True)
    (th * torch.from_numpy(cot)).sum().backward()
    assert_close_scaled(th.detach().numpy(), jh, STAGE_TOL, "embedding")
    assert_grads_close({k: p.grad.numpy()
                        for k, p in tmodel.named_parameters()
                        if p.grad is not None}, port_flat(jg), STAGE_TOL,
                       F32_LEAF_FLOOR)
    after, want = _bn_stats(tmodel), port_flat(jstats)
    assert set(after) == set(want) and len(after) == 18
    for k in after:
        assert_close_scaled(after[k], want[k], STAGE_TOL, k)
        assert not np.array_equal(after[k], before[k]), k
    # eval mode reads the statistics and leaves them alone
    with torch.no_grad():
        tmodel.embed(tx)
    for k, v in _bn_stats(tmodel).items():
        np.testing.assert_array_equal(v, after[k])


@pytest.mark.parametrize("knobs", [KNOBS, {}], ids=["kernels", "plain"])
def test_train_forward_with_aux_heads_matches_jax(knobs):
    jmodel, jvars, tmodel = train_models(**knobs)
    batch = pair_batch(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jout, _ = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=True, mutable=["batch_stats"]))(jvars, jbatch)
    with torch.no_grad():
        tout = tmodel(torch_batch(batch), train=True)
    assert set(tout) == set(jout) == {
        "xyz1", "xyz2", "h1", "h2", "cls_logits", "fp_logits", "shape_points",
        "match", "match_logits", "o1", "o2"}
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=MODEL_TOL, atol=MODEL_TOL, err_msg=k)
    # without aux and without ids the optional keys are gone
    with torch.no_grad():
        bare = tmodel({k: v for k, v in torch_batch(batch).items()
                       if k.startswith("sparse")}, with_aux=False)
    assert set(bare) == {"xyz1", "xyz2", "h1", "h2", "match_logits", "o1",
                         "o2"}


def test_non_linear_attention_scores_the_grid_without_the_kernel():
    """With 'linear-pallas' stages the grid scorers fall back to the
    materialised pair batch, as ReIDNet.match_logits_grid does in JAX."""
    from point_cloud_reid_tpu_torch.kernels import match_grid as mg
    jmodel, jvars, tmodel = train_models(**KNOBS)
    rs = np.random.RandomState(8)
    nt, nd = 2, 3
    with torch.no_grad():
        xt, ht = tmodel.embed(torch.from_numpy(
            (rs.randn(nt, N_PTS, 3) * 0.6).astype(np.float32)))
        xd, hd = tmodel.embed(torch.from_numpy(
            (rs.randn(nd, N_PTS, 3) * 0.6).astype(np.float32)))
        grid = mg.grid_logits(tmodel, ht, xt, hd, xd)
        pairs = mg.pair_logits(tmodel, ht, xt, hd, xd,
                               torch.tensor([1, 0]), torch.tensor([2, 1]))
    j = [jnp.asarray(a.numpy()) for a in (ht, xt, hd, xd)]
    jgrid = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, train=False, method="match_logits_grid"))(jvars, *j)
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid),
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    np.testing.assert_allclose(pairs.numpy(), grid.numpy()[[1, 0], [2, 1]],
                               rtol=1e-5, atol=1e-5)


def _head_pair(specs, n_in, seed=0):
    """A SequentialHead on both sides with the port's seeded weights."""
    thead = build_head(specs, n_in)
    init_weights(thead, torch.Generator().manual_seed(seed))
    holder = torch.nn.Module()
    holder.cls_head = thead
    tree = to_jax_variables(holder)
    jv = {c: tree[c].get("cls_head", {}) for c in tree}
    jhead = JHead(specs=tuple(dict(s) for s in specs))
    return jhead, jax.tree_util.tree_map(jnp.asarray, jv), thead


@pytest.mark.parametrize("specs,shape", [
    ([dict(type="LinearRes", n_in=12, n_out=16, norm="BN"),
      dict(type="ReLU"), dict(type="Linear", out_features=5)], (6, 12)),
    ([dict(type="LinearRes", n_in=16, n_out=16, norm="GN", ng=4),
      dict(type="LayerNorm"), dict(type="Sigmoid")], (6, 16)),
    ([dict(type="Conv1d", out_channels=8, kernel_size=3),
      dict(type="BatchNorm1d"), dict(type="GroupNorm", num_groups=2),
      dict(type="Linear", out_features=3)], (4, 9, 6)),
], ids=["linres-bn", "linres-gn", "conv-bn-gn"])
def test_sequential_head_types_match_jax(specs, shape):
    jhead, jv, thead = _head_pair(specs, shape[-1])
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    for train in (True, False):
        jout, mut = jhead.apply(jv, jnp.asarray(x), train=train,
                                mutable=["batch_stats"])
        with torch.no_grad():
            tout = thead(torch.from_numpy(x), train)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   rtol=1e-4, atol=1e-5)
        if train and jv["batch_stats"]:
            holder = torch.nn.Module()
            holder.cls_head = thead
            want = port_flat({"cls_head": mut["batch_stats"]})
            got = _bn_stats(holder)
            assert set(got) == set(want) and got
            for k in got:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)
            jv = dict(jv, batch_stats=mut["batch_stats"])


def test_sequential_head_unported_types_raise():
    """PostRes and Res1d build since the tracker-era zoo (held to JAX in
    tests/test_torch_zoo_modules.py); a type neither package has raises."""
    for t in ("PostRes", "Res1d"):
        head = build_head([dict(type=t, n_out=8)], 8)
        assert head.types == [t] and head.out_width == 8
    with pytest.raises(NotImplementedError, match="Unknown"):
        build_head([dict(type="Unknown", n_out=8)], 8)


def test_linear_res_group_norm_on_token_rows_matches_jax():
    """flax GroupNorm takes its statistics over every non-batch axis: on a
    (B, N, C) input a group spans the N rows too."""
    t = LinearRes(12, 16, norm="GN", ng=4)
    init_weights(t, torch.Generator().manual_seed(3))
    holder = torch.nn.Module()
    holder.block = t
    jv = jax.tree_util.tree_map(jnp.asarray,
                                to_jax_variables(holder)["params"]["block"])
    x = np.random.RandomState(2).randn(3, 7, 12).astype(np.float32)
    want = JLinearRes(n_in=12, n_out=16, norm="GN", ng=4).apply(
        {"params": jv}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = t(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_converter_round_trip_is_the_identity():
    """JAX variables (params and batch_stats, aux heads included) -> port ->
    JAX variables gives the same tree, leaf for leaf."""
    jmodel, _, _ = train_models(**KNOBS)
    batch = {k: jnp.zeros((2, N_PTS, 3)) for k in ("sparse_1", "sparse_2")}
    shapes = jax.eval_shape(lambda k: jmodel.init(k, batch, train=False),
                            jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(
        lambda s: rs.randn(*s.shape).astype(np.float32),
        {c: shapes[c] for c in ("params", "batch_stats")})
    tmodel = build_model(tiny_cfg(**KNOBS),
                         generator=torch.Generator().manual_seed(1))
    back = to_jax_variables(from_jax_variables(tmodel, variables))
    flat_in = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_out = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_in) == len(flat_out)
    assert any("cls_head" in str(p) for p, _ in flat_in)
    assert any("batch_stats" in str(p) for p, _ in flat_in)
    for path, value in flat_in:
        np.testing.assert_array_equal(flat_out[path], value, err_msg=str(path))
