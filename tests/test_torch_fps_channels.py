"""Farthest point sampling over C channels (fps_pallas's (B, N, C) points)
in the port, against the JAX package on the CPU: the plain loop against
fps_pallas in interpret mode at C = 1, 6 and 64 (indices equal, not close),
ties kept in first-occurrence order, and the launch plan of the kernel's
channel entry point (csrc/fps.cu pcr_fps_channels): the bytes its tiers
stage in shared memory count 4 N C, and C = 3 keeps its own plan."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.ops.pallas.fps import fps_pallas  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import fps as kfps  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401


def _cloud(kind: str, B: int, N: int, C: int, seed: int = 0) -> np.ndarray:
    """'random': Gaussian floats; 'grid': small integers, so every distance
    is exact in float32 and ties are everywhere."""
    rs = np.random.RandomState(seed)
    if kind == "random":
        return rs.randn(B, N, C).astype(np.float32)
    return rs.randint(-2, 3, (B, N, C)).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "grid"])
@pytest.mark.parametrize("C", [1, 6, 64])
def test_fps_over_channels_equals_fps_pallas(C, kind):
    B, N, npoint = 3, 16, 12
    xyz = _cloud(kind, B, N, C, seed=C)
    start = np.random.RandomState(C + 1).randint(0, N, B).astype(np.int32)
    want = np.asarray(fps_pallas(jnp.asarray(xyz), npoint,
                                 start=jnp.asarray(start), interpret=True))
    got = kfps.fps(torch.from_numpy(xyz), npoint,
                   torch.from_numpy(start).long())
    assert got.dtype == torch.int64 and got.shape == (B, npoint)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:, 0], start)
    assert kfps.fps.launches == 0


def test_fps_over_channels_sums_every_channel():
    """Two channels that alone would pick other points: the sum decides.
    Point 1 is farthest from point 0 in channel 0 alone, point 2 in both."""
    xyz = torch.tensor([[[0.0, 0.0], [3.0, 0.0], [2.5, 2.5], [0.1, 0.1]]])
    got = kfps.fps_reference(xyz, 3, torch.zeros(1, dtype=torch.long))
    assert got.tolist() == [[0, 2, 1]]
    # C = 3 is the same sum, left to right
    xyz3 = torch.from_numpy(_cloud("random", 2, 20, 3))
    a = kfps.fps_reference(xyz3, 8, torch.tensor([3, 5]))
    b = kfps.fps_reference(torch.cat([xyz3, torch.zeros(2, 20, 1)], -1), 8,
                           torch.tensor([3, 5]))
    assert torch.equal(a, b)


@pytest.mark.parametrize("C", [1, 6, 64, 256])
def test_channel_plan_stages_4NC_bytes(C):
    """Tier W while a cloud's 4 N C bytes fit (up to 4 clouds a block, as
    many as fit), tier BLOCK (coordinates and distances in shared memory)
    while they fit, then L2 and SCRATCH (coordinates from the input)."""
    for N in (1, 31, 128, 512, 513, 2048, 20000, 70000):
        how = kfps.plan(N, C=C)
        cloud = 4 * N * C
        assert how.smem <= kfps.MAX_SMEM
        if N <= kfps.WARP_MAX_N and cloud <= kfps.MAX_SMEM:
            clouds = min(kfps.WARP_CLOUDS, kfps.MAX_SMEM // cloud)
            points = next(p for p in (1, 2, 4, 8, 16) if 32 * p >= N)
            assert how == kfps.Plan(kfps.WARP, points, 32 * clouds, clouds,
                                    clouds * cloud)
            continue
        assert how.clouds == 1 and how.threads * how.points >= N
        if kfps.SLOT_BYTES + 4 * N + cloud <= kfps.MAX_SMEM:
            assert (how.tier, how.smem) == (kfps.BLOCK, kfps.SLOT_BYTES
                                            + 4 * N + cloud)
        elif kfps.SLOT_BYTES + 4 * N <= kfps.MAX_SMEM:
            assert (how.tier, how.smem) == (kfps.L2,
                                            kfps.SLOT_BYTES + 4 * N)
        else:
            assert (how.tier, how.smem) == (kfps.SCRATCH, kfps.SLOT_BYTES)
    with pytest.raises(ValueError):
        kfps.plan(0, C=C)


def test_xyz_keeps_its_plan():
    """C = 3 keeps the plan (and the kernels) it had: tier W to 512 points
    with x, y, z in registers, tier BLOCK's 12 N staged bytes."""
    assert kfps.plan(128) == kfps.plan(128, C=3) == kfps.Plan(
        kfps.WARP, 4, 128, 4, 0)
    assert kfps.plan(2048, C=3) == kfps.Plan(
        kfps.BLOCK, kfps.BLOCK_P, 256, 1, kfps.SLOT_BYTES + 12 * 2048)
    assert kfps.plan(128, C=6) != kfps.plan(128, C=3)
