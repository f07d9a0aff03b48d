"""The tracker-era zoo at bf16 against the JAX package at bf16, module by
module (LocalSelfAttention, the LoFTR transformer, the PostRes / Res1d
heads, the VN layers) and through the 'xcorr' and ReIDNetCosine
heads' logits: a model built with dtype=torch.bfloat16 (float32 weights,
bf16 compute where flax casts) from the same float32 weights.

The feature-space kNN picks of the local stages follow the bf16
features' roundings, which the two packages reach by different
summation orders, so JAX's picks are recorded (eager JAX) and fed to the
port's modules in the same order (as tests/test_torch_pointnet_dgcnn.py
does for DGCNN at bf16). Tolerances, relative to max(1, max |JAX|): the
JAX suite's bf16 bar 3e-2 for modules, 6e-2 for logits (the bar of
tests/test_torch_bf16_serving.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.models import attention_blocks as jab  # noqa: E402
from point_cloud_reid_tpu.models import loftr as jloftr  # noqa: E402
from point_cloud_reid_tpu.models import vector_neurons as jvn  # noqa: E402
from point_cloud_reid_tpu.models.registry import SequentialHead as JHead  # noqa: E402
from point_cloud_reid_tpu_torch.convert import to_jax_variables  # noqa: E402
from point_cloud_reid_tpu_torch.models import attention_blocks as tab  # noqa: E402
from point_cloud_reid_tpu_torch.models import build_model, init_weights  # noqa: E402
from point_cloud_reid_tpu_torch.models import loftr as tloftr  # noqa: E402
from point_cloud_reid_tpu_torch.models import vector_neurons as tvn  # noqa: E402
from point_cloud_reid_tpu_torch.models.layers import set_compute_dtype  # noqa: E402
from point_cloud_reid_tpu_torch.models.registry import build_head  # noqa: E402
from tests._torch_port import BF16_TOL, assert_close_scaled  # noqa: E402
from tests._torch_zoo import dup_crops, zoo_cfgs  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

BF16_LOGIT_TOL = 6e-2
BF16 = torch.bfloat16


@pytest.fixture
def jax_picks_fed(monkeypatch):
    """JAX's feature-space kNN picks, recorded call by call in the local
    stages (eager JAX), fed to the port's in the same order."""
    picks = []
    real = jab.knn_feature_space

    def recording(x, k, *a, **kw):
        idx = real(x, k, *a, **kw)
        picks.append(np.array(idx))
        return idx
    monkeypatch.setattr(jab, "knn_feature_space", recording)

    def fed(x, k):
        return torch.from_numpy(picks.pop(0)).long()
    monkeypatch.setattr(tab, "knn_feature_space", fed)
    return picks


def _holder(name: str, module: torch.nn.Module):
    holder = torch.nn.Module()
    setattr(holder, name, module)
    init_weights(holder, torch.Generator().manual_seed(0))
    tree = to_jax_variables(holder)
    set_compute_dtype(holder, BF16)
    return holder, {c: jax.tree_util.tree_map(jnp.asarray, tree[c].get(
        name, {})) for c in tree}


def _bf16_pair(x: np.ndarray):
    """The same bf16-rounded input on both sides."""
    t = torch.from_numpy(x).to(BF16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _close(got: torch.Tensor, want, tol: float, what: str):
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16, what
    assert_close_scaled(got.float().numpy(), np.asarray(want, np.float32),
                        tol, what)


@pytest.mark.parametrize("attention", ["linear", "linear-pallas"])
def test_local_self_attention_at_bf16(attention, jax_picks_fed):
    holder, var = _holder("local_stage1", tab.LocalSelfAttention(
        16, 2, knum=6, pos_size=16, attention=attention))
    rs = np.random.RandomState(1)
    f_t, f_j = _bf16_pair(rs.randn(3, 20, 16).astype(np.float32))
    xyz = (rs.randn(3, 20, 3) * 0.6).astype(np.float32)
    want = jab.LocalSelfAttention(16, 2, knum=6, pos_size=16,
                                  attention=attention,
                                  dtype=jnp.bfloat16).apply(
        {"params": var["params"]}, f_j, jnp.asarray(xyz))
    with torch.no_grad():
        got = holder.local_stage1(f_t, torch.from_numpy(xyz))
    assert not jax_picks_fed
    _close(got, want, BF16_TOL, attention)


@pytest.mark.parametrize("attention", ["full", "linear"])
def test_loftr_transformer_at_bf16(attention):
    names = ("self", "cross")
    holder, var = _holder("loftr", tloftr.LocalFeatureTransformer(
        16, 2, names, attention))
    rs = np.random.RandomState(2)
    a_t, a_j = _bf16_pair(rs.randn(2, 9, 16).astype(np.float32))
    b_t, b_j = _bf16_pair(rs.randn(2, 6, 16).astype(np.float32))
    want = jax.jit(jloftr.LocalFeatureTransformer(
        16, 2, names, attention, dtype=jnp.bfloat16).apply)(
        {"params": var["params"]}, a_j, b_j)
    with torch.no_grad():
        got = holder.loftr(a_t, b_t)
    for g, w, side in zip(got, want, ("feat0", "feat1")):
        _close(g, w, BF16_TOL, side)


def test_conv_residual_heads_at_bf16():
    """PostRes (stride 2, the downsample branch) and Res1d heads, eval."""
    for specs, shape in (
            ([dict(type="PostRes", n_out=12, stride=2, norm="BN")],
             (3, 7, 6, 8)),
            ([dict(type="Res1d", n_out=16, norm="GN", ng=4),
              dict(type="Linear", out_features=3)], (2, 9, 8))):
        holder, var = _holder("match_head", build_head(specs, shape[-1]))
        x_t, x_j = _bf16_pair(np.random.RandomState(3).randn(*shape).astype(
            np.float32))
        want = JHead(specs=tuple(dict(s) for s in specs),
                     dtype=jnp.bfloat16).apply(var, x_j, train=False)
        with torch.no_grad():
            got = holder.match_head(x_t)
        _close(got, want, BF16_TOL, specs[0]["type"])


@pytest.mark.parametrize("layer", ["VNLinearLeakyReLU", "VNStdFeature"])
def test_vn_layers_at_bf16(layer):
    """Eval. The whole VN-DGCNN backbone at bf16 is no stable reference:
    its directional max pools pick by bf16 dot products and its readout
    amplifies rounding, and JAX's own jitted and op-by-op bf16 runs of it
    differ by 0.10 at outputs of scale 0.09 (on dup_crops(4) at n_knn 6).
    So its layers are held to JAX one by one."""
    if layer == "VNLinearLeakyReLU":
        module, jmod = tvn.VNLinearLeakyReLU(8, 6), jvn.VNLinearLeakyReLU(
            6, dtype=jnp.bfloat16)
    else:
        module, jmod = tvn.VNStdFeature(16), jvn.VNStdFeature(
            dtype=jnp.bfloat16)
    holder, var = _holder("vn", module)
    x_t, x_j = _bf16_pair(np.random.RandomState(4).randn(
        2, 10, 3, 8 if layer == "VNLinearLeakyReLU" else 16).astype(
            np.float32))
    want = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(var, x_j)
    with torch.no_grad():
        got = holder.vn(x_t, False)
    for g, w in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        _close(g, w, BF16_TOL, layer)


@pytest.mark.parametrize("name", ["xcorr", "cosine"])
def test_zoo_logits_at_bf16(name, jax_picks_fed):
    """The embed (the flagship backbone at bf16) and the grid of 3 x 4
    crops through the 'xcorr' head (its local stages' picks fed from JAX)
    and ReIDNetCosine, from the same float32 weights."""
    from point_cloud_reid_tpu.models import build_model as jax_build
    cfg, jcfg = zoo_cfgs(name)
    t16 = build_model(cfg, generator=torch.Generator().manual_seed(0),
                      dtype=BF16)
    jmodel = jax_build(jcfg, dtype=jnp.bfloat16)
    jvars = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(t16))
    x = jnp.asarray(dup_crops(5, B=4))
    xyz, h = jax.jit(lambda v, x: jmodel.apply(v, x, train=False,
                                               method="embed"))(jvars, x)
    want = jmodel.apply(jvars, h[:3], xyz[:3], h, xyz,
                        method="match_logits_grid")
    with torch.no_grad():
        txyz, th = t16.embed(torch.from_numpy(np.asarray(x)))
        _close(th, h, BF16_TOL, "embed")
        got = t16.match_logits_grid(th[:3], txyz[:3], th, txyz)
    assert not jax_picks_fed
    _close(got, want, BF16_LOGIT_TOL, "logits")
