"""The port's ops against the JAX package's on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.ops import attention as jattn  # noqa: E402
from point_cloud_reid_tpu.ops import boxes as jboxes  # noqa: E402
from point_cloud_reid_tpu.ops import geometry as jgeo  # noqa: E402
from point_cloud_reid_tpu_torch.ops import attention as tattn  # noqa: E402
from point_cloud_reid_tpu_torch.ops import boxes as tboxes  # noqa: E402
from point_cloud_reid_tpu_torch.ops import geometry as tgeo  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def test_knn_indices_duplicates_exact():
    """Resample-with-replacement duplicates points: the neighbour order among
    equal distances (first occurrence) must be JAX's exactly."""
    rs = np.random.RandomState(0)
    base = rs.randn(2, 12, 3).astype(np.float32)
    xyz = base[:, rs.randint(0, 12, 40)]                  # (2, 40, 3) dups
    new_xyz = xyz[:, :16]
    want = np.asarray(jgeo.knn_indices(8, jnp.asarray(xyz),
                                       jnp.asarray(new_xyz)))
    got = tgeo.knn_indices(8, torch.from_numpy(xyz), torch.from_numpy(new_xyz))
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_point_sample_is_first_n():
    xyz = np.zeros((3, 10, 3), np.float32)
    np.testing.assert_array_equal(
        tgeo.random_point_sample(torch.from_numpy(xyz), 4).numpy(),
        np.asarray(jgeo.random_point_sample(jnp.asarray(xyz), 4)))


def test_square_distance_and_index_points():
    rs = np.random.RandomState(1)
    a = rs.randn(2, 10, 3).astype(np.float32)
    b = rs.randn(2, 7, 3).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.square_distance(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jgeo.square_distance(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-6)
    idx = rs.randint(0, 10, (2, 4, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        tgeo.index_points(torch.from_numpy(a), torch.from_numpy(idx)).numpy(),
        np.asarray(jgeo.index_points(jnp.asarray(a), jnp.asarray(idx))))


@pytest.mark.parametrize("with_points", [False, True])
def test_conv1_edge_factors(with_points):
    """f32, tolerance 1e-5: the same products in another summation order."""
    rs = np.random.RandomState(2)
    B, N, S, D, C = 2, 20, 8, 6, 16
    xyz = rs.randn(B, N, 3).astype(np.float32)
    pts = rs.randn(B, N, D).astype(np.float32) if with_points else None
    kernel = rs.randn(3 + (2 * D if with_points else 0), C).astype(np.float32)
    bias = rs.randn(C).astype(np.float32)
    cx, cp = xyz[:, :S], (pts[:, :S] if with_points else None)

    def j(x):
        return None if x is None else jnp.asarray(x)

    def t(x):
        return None if x is None else torch.from_numpy(x)

    jA, jC = jgeo.conv1_edge_factors(j(kernel), j(bias), j(xyz), j(pts),
                                     j(cx), j(cp), jnp.float32)
    tA, tC = tgeo.conv1_edge_factors(t(kernel), t(bias), t(xyz), t(pts),
                                     t(cx), t(cp))
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tC.numpy(), np.asarray(jC), rtol=1e-5, atol=1e-5)


def test_linear_attention():
    """f32, tolerance 1e-5 (einsum order differs)."""
    rs = np.random.RandomState(3)
    q = rs.randn(2, 12, 2, 8).astype(np.float32)
    k = rs.randn(2, 10, 2, 8).astype(np.float32)
    v = rs.randn(2, 10, 2, 8).astype(np.float32)
    want = np.asarray(jattn.linear_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v)))
    got = tattn.linear_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_points_in_rboxes_exact():
    rs = np.random.RandomState(4)
    pts = (rs.rand(500, 3) * 10 - 5).astype(np.float32)
    boxes = np.concatenate([rs.rand(6, 3) * 6 - 3, rs.rand(6, 3) * 3 + 0.5,
                            rs.rand(6, 1) * 6 - 3], axis=1).astype(np.float32)
    want = np.asarray(jboxes.points_in_rboxes(jnp.asarray(pts),
                                              jnp.asarray(boxes)))
    got = tboxes.points_in_rboxes(torch.from_numpy(pts),
                                  torch.from_numpy(boxes)).numpy()
    assert want.any()
    np.testing.assert_array_equal(got, want)
