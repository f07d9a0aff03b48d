"""The port's flagship model against the JAX ReIDNet with the same weights,
and the strictness of from_jax_variables."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu_torch.convert import from_jax_variables  # noqa: E402
from tests._torch_port import (N_PTS, crops, tiny_models,  # noqa: E402
                               tiny_torch_model, to_jax_tree)
from tests._torch_threads import few_threads  # noqa: E402,F401

# the JAX suite's bar for the full model through a converter
# (tests/test_convert_full_model.py)
MODEL_TOL = 1e-3


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_paths(v, p) if isinstance(v, dict) else {p: tuple(v.shape)})
    return out


def _flax_shapes():
    jmodel = tiny_models()[0]
    batch = dict(sparse_1=jnp.zeros((2, N_PTS, 3)),
                 sparse_2=jnp.zeros((2, N_PTS, 3)))
    return jax.eval_shape(lambda k: jmodel.init(k, batch, train=False),
                          jax.random.PRNGKey(0))


def test_from_jax_variables_fills_every_tensor_from_a_flax_tree():
    """Every leaf of the JAX model's own variable tree lands on a port
    tensor and every port tensor is set (strict), values intact."""
    shapes = _flax_shapes()
    rs = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(
        lambda s: rs.randn(*s.shape).astype(np.float32),
        {c: shapes[c] for c in ("params", "batch_stats")})
    model = from_jax_variables(tiny_torch_model(seed=1), variables)
    back = to_jax_tree(model)
    assert _paths(back) == _paths(variables)
    for c in variables:
        for (p, a), (q, b) in zip(
                sorted(jax.tree_util.tree_flatten_with_path(variables[c])[0],
                       key=lambda x: str(x[0])),
                sorted(jax.tree_util.tree_flatten_with_path(back[c])[0],
                       key=lambda x: str(x[0]))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("breakage", ["missing", "unused", "shape"])
def test_from_jax_variables_is_strict(breakage):
    tree = to_jax_tree(tiny_torch_model())
    if breakage == "missing":
        del tree["params"]["cross_stage2"]["merge"]
    elif breakage == "unused":
        tree["params"]["cross_stage2"]["extra"] = {
            "kernel": np.zeros((16, 16), np.float32)}
    else:
        tree["params"]["cross_stage1"]["q_proj"]["kernel"] = np.zeros(
            (16, 8), np.float32)
    with pytest.raises(ValueError, match="mismatch"):
        from_jax_variables(tiny_torch_model(seed=1), tree)


def test_build_model_is_seeded():
    a, b, c = tiny_torch_model(0), tiny_torch_model(0), tiny_torch_model(1)
    for (k, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(x, y), k
    assert not torch.equal(a.cross_stage1.q_proj.weight,
                           c.cross_stage1.q_proj.weight)


def test_embed_matches_jax():
    jmodel, jvars, tmodel = tiny_models()
    x = crops(1, 4)
    jx, jh = jax.jit(lambda v, p: jmodel.apply(v, p, train=False,
                                               method="embed"))(jvars, x)
    with torch.no_grad():
        tx, th = tmodel.embed(torch.from_numpy(x))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh),
                               rtol=MODEL_TOL, atol=MODEL_TOL)


def test_match_logits_and_grid_match_jax():
    jmodel, jvars, tmodel = tiny_models()
    nt, nd = 3, 5
    with torch.no_grad():
        xt, ht = tmodel.embed(torch.from_numpy(crops(2, nt)))
        xd, hd = tmodel.embed(torch.from_numpy(crops(3, nd)))
        grid = tmodel.match_logits_grid(ht, xt, hd, xd)
        aligned, _ = tmodel.match_logits(ht, xt, hd[:nt], xd[:nt])
    j = [jnp.asarray(a.numpy()) for a in (ht, xt, hd, xd)]
    jgrid = jmodel.apply(jvars, *j, train=False, method="match_logits_grid")
    jaligned, _ = jmodel.apply(jvars, j[0], j[1], j[2][:nt], j[3][:nt],
                               train=False, method="match_logits")
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid),
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    np.testing.assert_allclose(aligned.numpy(), np.asarray(jaligned),
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    # the hoisted grid is the aligned-pair forward on every pair
    np.testing.assert_allclose(np.diag(grid.numpy()[:, :nt]),
                               aligned.numpy(), rtol=1e-4, atol=1e-5)
