"""The two kernels' functions and the grouping op of the training path
against the JAX package on the same numpy inputs. The JAX Pallas kernels
run in interpret mode; the port's wrappers run their plain versions (CPU
tensors)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.ops import geometry as jgeo  # noqa: E402
from point_cloud_reid_tpu.ops.pallas import linear_attention_pallas  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import knn as kk  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import linear_attention as la  # noqa: E402
from point_cloud_reid_tpu_torch.ops import attention as tatt  # noqa: E402
from point_cloud_reid_tpu_torch.ops import geometry as tgeo  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401


def _cloud(kind: str, B=3, N=40, seed=0) -> np.ndarray:
    rs = np.random.RandomState(seed)
    if kind == "duplicates":
        base = rs.randn(B, N // 3, 3).astype(np.float32)
        return base[np.arange(B)[:, None], rs.randint(0, N // 3, (B, N))]
    if kind == "grid":        # multiples of 1/64: exact sums, many ties
        return rs.randint(-64, 64, (B, N, 3)).astype(np.float32) / 64.0
    return (rs.randn(B, N, 3) * 0.6).astype(np.float32)


@pytest.mark.parametrize("method,kind", [
    ("pallas", "random"), ("pallas", "duplicates"), ("pallas", "grid"),
    ("argsort", "random"), ("argsort", "duplicates"), ("argsort", "grid"),
    ("topk", "random")])
def test_knn_indices_match_jax_exactly(method, kind):
    xyz = _cloud(kind)
    S, k = 16, 12
    want = np.asarray(jgeo.knn_indices(k, jnp.asarray(xyz),
                                       jnp.asarray(xyz[:, :S]), method))
    got = tgeo.knn_indices(k, torch.from_numpy(xyz),
                           torch.from_numpy(xyz[:, :S]), method)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_knn_wrapper_checks_and_counts_nothing_on_cpu():
    x = torch.zeros((2, 8, 3))
    with pytest.raises(ValueError, match="k=9 > N=8"):
        kk.knn(x, x, 9)
    before = kk.knn.launches
    assert torch.equal(kk.knn(x, x, 3), kk.knn_reference(x, x, 3))
    assert kk.knn.launches == before
    with pytest.raises(ValueError, match="unknown knn method"):
        tgeo.knn_indices(3, x, x, "heap")


def _qkv(B, L, S, H, D, V, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, L, H, D).astype(np.float32),
            rs.randn(B, S, H, D).astype(np.float32),
            rs.randn(B, S, H, V).astype(np.float32),
            rs.randn(B, L, H, V).astype(np.float32))


@pytest.mark.parametrize("shape", [(3, 16, 16, 2, 8, 8), (2, 10, 24, 2, 8, 4)])
def test_fused_linear_attention_matches_jax_pallas(shape):
    """Forward and q/k/v gradients: JAX linear_attention_pallas (interpret
    mode, custom VJP) vs the port's autograd Function. float32 on both
    sides; the sums run in different orders."""
    q, k, v, cot = _qkv(*shape)
    jout, vjp = jax.vjp(linear_attention_pallas, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(cot))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    before = la.linear_attention_forward.launches
    tout = la.fused_linear_attention(tq, tk, tv)
    assert la.linear_attention_forward.launches == before   # CPU: plain
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=2e-4, atol=2e-5)
    # a non-contiguous cotangent, as a transposed consumer would send
    tcot = torch.from_numpy(cot).transpose(1, 2).contiguous().transpose(1, 2)
    for got, want in zip(torch.autograd.grad(tout, (tq, tk, tv), tcot),
                         jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-5)


def test_fused_linear_attention_takes_strided_views():
    q, k, v, _ = _qkv(2, 10, 12, 2, 8, 8)
    kv = torch.from_numpy(np.concatenate([k, v], axis=-1))
    tk, tv = kv[..., :8], kv[..., 8:]
    assert not tk.is_contiguous()
    got = la.fused_linear_attention(torch.from_numpy(q), tk, tv)
    want = la.linear_attention_reference(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_attention_config_strings():
    """'linear' and 'linear-pallas' name the plain composite and the
    kernel's Function; 'full', like every other string, is softmax
    attention, as the JAX package's dispatch has it."""
    from point_cloud_reid_tpu_torch.models.attention_blocks import _attn_fn
    assert _attn_fn("linear") is tatt.linear_attention
    assert _attn_fn("linear-pallas") is la.fused_linear_attention
    assert _attn_fn("full") is tatt.full_attention
    assert _attn_fn("softmax") is tatt.full_attention


@pytest.mark.parametrize("with_points", [False, True])
def test_sample_and_group_edge_matches_jax(with_points):
    xyz = _cloud("duplicates", B=2, N=30, seed=3)
    pts = (np.random.RandomState(4).randn(2, 30, 5).astype(np.float32)
           if with_points else None)
    jx, jp = jgeo.sample_and_group_edge(
        6, jnp.asarray(xyz), None if pts is None else jnp.asarray(pts), 10,
        knn_method="pallas")
    tx, tp = tgeo.sample_and_group_edge(
        6, torch.from_numpy(xyz),
        None if pts is None else torch.from_numpy(pts), 10,
        knn_method="pallas")
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kw,err", [
    (dict(sampling="FPS", use_knn=False, radius=0.8), None),
    (dict(use_knn=False, radius=0.8), None),
    (dict(sampling="GRID"), ValueError)])
def test_sample_and_group_edge_unported_modes_raise(kw, err):
    """An unknown sampling raises; the ball-query modes compute as JAX's
    (FPS from point 0, as the JAX function without a key)."""
    x = np.random.RandomState(5).randn(1, 8, 3).astype(np.float32)
    if err is not None:
        with pytest.raises(err):
            tgeo.sample_and_group_edge(4, torch.from_numpy(x), None, 4, **kw)
        return
    jx, jp = jgeo.sample_and_group_edge(4, jnp.asarray(x), None, 4, **kw)
    tx, tp = tgeo.sample_and_group_edge(4, torch.from_numpy(x), None, 4, **kw)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
