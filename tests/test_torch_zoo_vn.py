"""The vector-neuron layers and the VN-DGCNN backbone against the JAX
package (models/vector_neurons.py): the graph features, each VN layer, the
std-feature readout with and without a normalised frame, the backbone in
eval and train mode with its BatchNorm statistics, rotation equivariance
and invariance, and the converter both ways.

Weights are the port's seeded init handed to JAX by
convert.to_jax_variables; inputs come from numpy seeds, crops with
duplicated points as resample-with-replacement makes them. Tolerances,
relative to max(1, max |JAX|): kNN picks and graph features equal; float32
eval 1e-5; train mode (BatchNorm on the vector norms) in float64 on both
sides at 1e-9; the round trip bit for bit.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.models import vector_neurons as jvn  # noqa: E402
from point_cloud_reid_tpu_torch.convert import (from_jax_variables,  # noqa: E402
                                                to_jax_variables)
from point_cloud_reid_tpu_torch.models import init_weights  # noqa: E402
from point_cloud_reid_tpu_torch.models import vector_neurons as tvn  # noqa: E402
from tests._torch_port import assert_close_scaled, port_flat  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

EVAL_TOL = 1e-5
TRAIN64_TOL = 1e-9


def _holder(module: torch.nn.Module, seed: int = 0):
    holder = torch.nn.Module()
    holder.vn = module
    init_weights(holder, torch.Generator().manual_seed(seed))
    tree = to_jax_variables(holder)
    return holder, {c: tree[c].get("vn", {}) for c in tree}


def _vectors(seed: int, shape) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def dup_crops(seed: int, B: int = 3, N: int = 24, dups: int = 5):
    rs = np.random.RandomState(seed)
    base = (rs.randn(B, N - dups, 3) * 0.6).astype(np.float32)
    return np.concatenate([base, base[:, rs.randint(0, N - dups, dups)]], 1)


def _apply(jmod, var, args, train: bool, dtype=None):
    """The JAX module's output (and batch_stats after a train-mode call),
    jitted, with every float leaf and input in `dtype` when given."""
    cast = (lambda a: jnp.asarray(a, dtype)) if dtype else jnp.asarray
    var = jax.tree_util.tree_map(cast, {c: v for c, v in var.items() if v})
    args = [cast(a) for a in args]
    kw = {} if train is None else dict(train=train)
    if train:
        out, mut = jax.jit(lambda v, *a: jmod.apply(
            v, *a, **kw, mutable=["batch_stats"]))(var, *args)
        return out, mut["batch_stats"]
    return jax.jit(lambda v, *a: jmod.apply(v, *a, **kw))(var, *args), None


# (port module, JAX module of the same layer at a dtype, input shape, whether
# it takes `train`)
LAYERS = {
    "VNLinear": (lambda: tvn.VNLinear(5, 7),
                 lambda dt: jvn.VNLinear(7, dtype=dt), (2, 6, 3, 5), None),
    "VNBatchNorm": (lambda: tvn.VNBatchNorm(5),
                    lambda dt: jvn.VNBatchNorm(dtype=dt), (2, 6, 4, 3, 5),
                    True),
    "VNLeakyReLU": (lambda: tvn.VNLeakyReLU(5),
                    lambda dt: jvn.VNLeakyReLU(dtype=dt), (2, 6, 3, 5), None),
    "VNLeakyReLU-shared": (lambda: tvn.VNLeakyReLU(5, True, 0.1),
                           lambda dt: jvn.VNLeakyReLU(True, 0.1, dtype=dt),
                           (2, 6, 3, 5), None),
    "VNLinearLeakyReLU": (lambda: tvn.VNLinearLeakyReLU(4, 6),
                          lambda dt: jvn.VNLinearLeakyReLU(6, dtype=dt),
                          (2, 6, 5, 3, 4), True),
    "VNLinearLeakyReLU-shared": (
        lambda: tvn.VNLinearLeakyReLU(4, 6, share_nonlinearity=True),
        lambda dt: jvn.VNLinearLeakyReLU(6, share_nonlinearity=True,
                                         dtype=dt), (2, 6, 3, 4), True),
    "VNMaxPool": (lambda: tvn.VNMaxPool(5),
                  lambda dt: jvn.VNMaxPool(dtype=dt), (2, 6, 4, 3, 5), None),
    "VNStdFeature": (lambda: tvn.VNStdFeature(16),
                     lambda dt: jvn.VNStdFeature(dtype=dt), (2, 6, 3, 16),
                     True),
    "VNStdFeature-frame": (
        lambda: tvn.VNStdFeature(16, normalize_frame=True),
        lambda dt: jvn.VNStdFeature(normalize_frame=True, dtype=dt),
        (2, 6, 3, 16), True),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_vn_layer_matches_jax(name):
    """Eval in float32; with BatchNorm, train mode in float64 with the
    running statistics it moved."""
    make_t, make_j, shape, takes_train = LAYERS[name]
    holder, var = _holder(make_t())
    x = _vectors(3, shape)
    out, _ = _apply(make_j(jnp.float32), var, [x],
                    False if takes_train else None)
    with torch.no_grad():
        got = holder.vn(torch.from_numpy(x), False) if takes_train else \
            holder.vn(torch.from_numpy(x))
    for g, w in zip(*((got, out) if isinstance(got, tuple)
                      else ((got,), (out,)))):
        assert_close_scaled(g.numpy(), np.asarray(w), EVAL_TOL, name)
    if not takes_train:
        return
    with jax.enable_x64():
        out, stats = _apply(make_j(jnp.float64), var, [x], True, jnp.float64)
        out = jax.tree_util.tree_map(np.asarray, out)
        stats = port_flat({"vn": jax.tree_util.tree_map(np.asarray, stats)})
    holder = holder.double()
    with torch.no_grad():
        got = holder.vn(torch.from_numpy(x).double(), True)
    for g, w in zip(*((got, out) if isinstance(got, tuple)
                      else ((got,), (out,)))):
        assert_close_scaled(g.numpy(), w, TRAIN64_TOL, name)
    got_stats = {k: v.numpy() for k, v in holder.state_dict().items()
                 if "running_" in k}
    assert set(got_stats) == set(stats) and stats
    for k, v in stats.items():
        assert_close_scaled(got_stats[k], v, TRAIN64_TOL, k)


def test_graph_features_and_mean_pool_equal_jax():
    """vn_graph_feature's kNN picks in the flattened 3C space (repeated
    vectors tie exactly) and the edge features, equal; the mean pool (a
    sum in another order) at EVAL_TOL."""
    x = _vectors(4, (2, 16, 3, 4))
    x[:, -4:] = x[:, :4]
    want = np.asarray(jvn.vn_graph_feature(jnp.asarray(x), 5))
    got = tvn.vn_graph_feature(torch.from_numpy(x), 5).numpy()
    assert got.shape == (2, 16, 5, 3, 8)
    np.testing.assert_array_equal(got, want)
    assert_close_scaled(tvn.vn_mean_pool(torch.from_numpy(got)).numpy(),
                        np.asarray(jvn.vn_mean_pool(jnp.asarray(want))),
                        EVAL_TOL, "mean pool")


@pytest.mark.parametrize("pooling", ["max", "mean"])
def test_vn_dgcnn_backbone_matches_jax(pooling):
    """(pts, 2046-wide per-point features) in eval at float32, in train
    mode at float64 with every BatchNorm's statistics; the round trip of
    JAX's own init through the converter."""
    holder, var = _holder(tvn.VNDGCNNBackbone(n_knn=6, pooling=pooling))
    x = dup_crops(5)
    jmod = functools.partial(jvn.VNDGCNNBackbone, n_knn=6, pooling=pooling)
    (pts, want), _ = _apply(jmod(dtype=jnp.float32), var, [x], False)
    with torch.no_grad():
        tpts, got = holder.vn(torch.from_numpy(x))
    assert got.shape == (3, 24, 2046) == tuple(np.shape(want))
    np.testing.assert_array_equal(tpts.numpy(), x)
    assert_close_scaled(got.numpy(), np.asarray(want), EVAL_TOL, "eval")
    with jax.enable_x64():
        (_, want), stats = _apply(jmod(dtype=jnp.float64), var, [x], True,
                                  jnp.float64)
        want = np.asarray(want)
        stats = port_flat({"vn": jax.tree_util.tree_map(np.asarray, stats)})
    h64 = holder.double()
    with torch.no_grad():
        _, got = h64.vn(torch.from_numpy(x).double(), (), True)
    assert_close_scaled(got.numpy(), want, TRAIN64_TOL, "train")
    got_stats = {k: v.numpy() for k, v in h64.state_dict().items()
                 if "running_" in k}
    assert set(got_stats) == set(stats) and len(stats) == 2 * 7
    for k, v in stats.items():
        assert_close_scaled(got_stats[k], v, TRAIN64_TOL, k)
    # JAX's own init, moved by a train-mode call, through the converter
    j32 = jmod(dtype=jnp.float32)
    variables = j32.init(jax.random.PRNGKey(2), jnp.asarray(x), train=False)
    _, mut = j32.apply(variables, jnp.asarray(x), train=True,
                       mutable=["batch_stats"])
    tree = {"params": {"vn": variables["params"]},
            "batch_stats": {"vn": mut["batch_stats"]}}
    tree = jax.tree_util.tree_map(np.asarray, tree)
    back = to_jax_variables(from_jax_variables(holder.float(), tree))
    flat_w = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        assert flat_g[path].dtype == w.dtype, path
        np.testing.assert_array_equal(flat_g[path], w, err_msg=str(path))


def test_vn_dgcnn_is_rotation_invariant():
    """The backbone's std-feature readout is invariant to a global rotation
    of the crop, up to rounding."""
    holder, var = _holder(tvn.VNDGCNNBackbone(n_knn=6))
    x = dup_crops(6)
    a = 0.7
    rot = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                    [0.0, 0.0, 1.0]], np.float32)
    with torch.no_grad():
        _, f = holder.vn(torch.from_numpy(x))
        _, fr = holder.vn(torch.from_numpy(x @ rot.T))
    assert_close_scaled(fr.numpy(), f.numpy(), 1e-4, "rotated")
