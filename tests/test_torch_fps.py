"""Farthest point sampling of the port against the JAX package on the CPU:
the plain loop against farthest_point_sample and against fps_pallas in
interpret mode (indices equal, not close), also past the 1024 points the
first kernel took, FPS-sampled grouping, and one SetAbstractionEdgeSA stage
built with sampling="FPS" in eval and in train mode; and the kernel's
launch plan for every cloud size, and how the wrapper hands it over."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.models.point_transformer import (  # noqa: E402
    SetAbstractionEdgeSA as JaxStage)
from point_cloud_reid_tpu.ops import geometry as jgeo  # noqa: E402
from point_cloud_reid_tpu.ops.pallas.fps import fps_pallas  # noqa: E402
from point_cloud_reid_tpu_torch.convert.jax_variables import (  # noqa: E402
    to_jax_variables)
from point_cloud_reid_tpu_torch.kernels import fps as kfps  # noqa: E402
from point_cloud_reid_tpu_torch.models.build import init_weights  # noqa: E402
from point_cloud_reid_tpu_torch.models.point_transformer import (  # noqa: E402
    SetAbstractionEdgeSA)
from point_cloud_reid_tpu_torch.ops import geometry as tgeo  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

TOL = 1e-4


def _cloud(kind: str, B: int, N: int, seed: int = 0) -> np.ndarray:
    """'grid': integer coordinates, so every distance is exact in float32
    and full of ties; 'duplicates': such points resampled with replacement,
    as crops are; 'random': Gaussian floats."""
    rs = np.random.RandomState(seed)
    if kind == "random":
        return (rs.randn(B, N, 3) * 0.6).astype(np.float32)
    xyz = rs.randint(-4, 5, (B, N, 3)).astype(np.float32)
    if kind == "duplicates":
        xyz = xyz[np.arange(B)[:, None], rs.randint(0, N // 3, (B, N))]
    return xyz


@pytest.mark.parametrize("kind", ["grid", "duplicates", "random"])
@pytest.mark.parametrize("B,N,npoint", [(4, 32, 32), (3, 40, 16)])
def test_fps_indices_equal_jax(kind, B, N, npoint):
    xyz = _cloud(kind, B, N)
    start = np.random.RandomState(1).randint(0, N, B).astype(np.int32)
    # the JAX loop starts at point 0; its Pallas kernel takes start indices
    want0 = np.asarray(jgeo.farthest_point_sample(jnp.asarray(xyz), npoint))
    got0 = tgeo.farthest_point_sample(torch.from_numpy(xyz), npoint)
    assert got0.dtype == torch.int64 and got0.shape == (B, npoint)
    np.testing.assert_array_equal(got0.numpy(), want0)
    want = np.asarray(fps_pallas(jnp.asarray(xyz), npoint,
                                 start=jnp.asarray(start), interpret=True))
    got = tgeo.farthest_point_sample(torch.from_numpy(xyz), npoint,
                                     start=torch.from_numpy(start))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:, 0], start)
    assert kfps.fps.launches == 0


@pytest.mark.parametrize("kind", ["grid", "duplicates", "random"])
@pytest.mark.parametrize("N", [1025, 2048])
def test_fps_indices_equal_jax_large_clouds(kind, N):
    """Dense crops have 2048 points; the JAX loop and kernel take any N,
    and so does the port."""
    B, npoint = 2, 64
    xyz = _cloud(kind, B, N, seed=N)
    start = np.random.RandomState(N).randint(0, N, B).astype(np.int32)
    want0 = np.asarray(jgeo.farthest_point_sample(jnp.asarray(xyz), npoint))
    got0 = tgeo.farthest_point_sample(torch.from_numpy(xyz), npoint)
    np.testing.assert_array_equal(got0.numpy(), want0)
    want = np.asarray(fps_pallas(jnp.asarray(xyz), npoint,
                                 start=jnp.asarray(start), interpret=True))
    for first in (torch.from_numpy(start), torch.from_numpy(start).long()):
        got = kfps.fps(torch.from_numpy(xyz), npoint, first)
        np.testing.assert_array_equal(got.numpy(), want)
    if kind == "random":
        assert len(np.unique(want[0])) == npoint


def test_fps_plan_within_the_card_limits_for_every_n():
    """Every N from 1 to 70,000 gets a launch the kernel takes: at most 1024
    threads and 227 KB of shared memory a block, room for every point, and
    the shared memory its tier keeps the cloud in."""
    seen = set()
    for N in range(1, 70001):
        p = kfps.plan(N)
        seen.add(p.tier)
        assert 0 < p.threads <= kfps.MAX_THREADS and p.threads % 32 == 0
        assert 0 <= p.smem <= kfps.MAX_SMEM
        if p.tier == kfps.WARP:
            assert p.points in kfps.WARP_POINTS and 32 * p.points >= N
            assert p.threads == 32 * p.clouds and p.smem == 0
            assert p.points == 1 or 16 * p.points < N    # no idle half
        else:
            assert p.clouds == 1 and p.threads * p.points >= N
            if p.tier == kfps.BLOCK:
                assert p.points == kfps.BLOCK_P
                assert p.smem == kfps.SLOT_BYTES + 12 * N
            else:
                assert p.smem == kfps.SLOT_BYTES + (4 * N if p.tier == kfps.L2
                                                    else 0)
                assert p.threads * (p.points - 1) < N    # no idle thread
    assert seen == set(range(4))


def test_fps_plan_tier_boundaries():
    top = {kfps.WARP: kfps.WARP_MAX_N,
           kfps.BLOCK: kfps.BLOCK_P * kfps.MAX_THREADS,
           kfps.L2: (kfps.MAX_SMEM - kfps.SLOT_BYTES) // 4}
    assert top[kfps.BLOCK] == 8192 and top[kfps.L2] == 57984
    for tier, n in top.items():
        assert kfps.plan(n).tier == tier
        assert kfps.plan(n + 1).tier == tier + 1
    assert kfps.plan(128) == kfps.Plan(kfps.WARP, 4, 32 * kfps.WARP_CLOUDS,
                                       kfps.WARP_CLOUDS, 0)
    assert kfps.plan(2048) == kfps.Plan(kfps.BLOCK, 8, 256, 1,
                                        kfps.SLOT_BYTES + 12 * 2048)
    assert kfps.plan(20000) == kfps.Plan(kfps.L2, 20, 1024, 1,
                                         kfps.SLOT_BYTES + 4 * 20000)
    # forced plans, as tools/ab_fps.py times them; past a tier's reach, none
    assert kfps.plan(512, kfps.WARP) == kfps.Plan(
        kfps.WARP, 16, 32 * kfps.WARP_CLOUDS, kfps.WARP_CLOUDS, 0)
    assert kfps.plan(1024, kfps.BLOCK) == kfps.Plan(
        kfps.BLOCK, 8, 128, 1, kfps.SLOT_BYTES + 12 * 1024)
    assert kfps.plan(100, kfps.SCRATCH).points == 1
    assert kfps.plan(1024, kfps.WARP).points == 32
    for args in ((0,), (1025, kfps.WARP), (8193, kfps.BLOCK),
                 (57985, kfps.L2)):
        with pytest.raises(ValueError):
            kfps.plan(*args)


class _FakeLibrary:
    """Records the C call that kernels/fps.launch makes."""

    def __init__(self):
        self.calls = []

    def get(self):
        return self

    def pcr_fps_plan(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("N,dtype", [(128, torch.int32), (64, torch.int64),
                                     (60000, torch.int64)])
def test_fps_launch_hands_over_the_plan(monkeypatch, N, dtype):
    """One C call a launch: the points and start indices as given (int32 or
    int64, flagged), an int64 output, a scratch only for tier SCRATCH, and
    plan(N) in the entry point's order."""
    from point_cloud_reid_tpu_torch.kernels import _lib
    monkeypatch.setattr(_lib, "stream_ptr", lambda device: 7)
    lib = _FakeLibrary()
    xyz = torch.zeros((3, N, 3))
    start = torch.tensor([0, 1, 2], dtype=dtype)
    out = kfps.launch(xyz, 5, start, library=lib)
    assert out.dtype == torch.int64 and out.shape == (3, 5)
    (args,) = lib.calls
    p = kfps.plan(N)
    assert args[0] == xyz.data_ptr() and args[1] == start.data_ptr()
    assert args[2] == out.data_ptr()
    assert (args[3] is None) == (p.tier != kfps.SCRATCH)
    assert args[4:8] == (3, N, 5, int(dtype == torch.int64))
    assert args[8:13] == tuple(p) and args[13] == 7
    forced = kfps.plan(N, kfps.SCRATCH)
    kfps.launch(xyz, 5, start, forced, library=lib)
    assert lib.calls[1][3] is not None and lib.calls[1][8:13] == tuple(forced)
    with pytest.raises(ValueError, match="float32"):
        kfps.launch(xyz.double(), 5, start, library=lib)
    assert len(lib.calls) == 2 and kfps.fps.launches == 0


def test_fps_start_from_generator_and_bad_input():
    xyz = torch.from_numpy(_cloud("random", 5, 20))
    a = tgeo.farthest_point_sample(xyz, 4,
                                   generator=torch.Generator().manual_seed(3))
    b = tgeo.farthest_point_sample(xyz, 4,
                                   generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and len(set(a[:, 0].tolist())) > 1
    with pytest.raises(ValueError, match="npoint"):
        kfps.fps(xyz, 21, torch.zeros(5, dtype=torch.long))
    with pytest.raises(ValueError, match="start"):
        kfps.fps(xyz, 4, torch.zeros(4, dtype=torch.long))
    # any channel count C >= 1 is a cloud (fps_pallas's (B, N, C)); a
    # tensor of another rank, or of no channels, is not
    for bad in (xyz[..., 0], xyz[..., :0]):
        with pytest.raises(ValueError, match=r"\(B, N, C\)"):
            kfps.fps(bad, 4, torch.zeros(5, dtype=torch.long))
    with pytest.raises(ValueError, match="unknown sampling"):
        tgeo.sample_and_group_edge(4, xyz, None, 4, sampling="GRID")


@pytest.mark.parametrize("with_points", [False, True])
def test_sample_and_group_edge_fps_matches_jax(with_points):
    xyz = _cloud("random", 3, 24, seed=2)
    pts = (np.random.RandomState(3).randn(3, 24, 5).astype(np.float32)
           if with_points else None)
    jx, jp = jgeo.sample_and_group_edge(
        6, jnp.asarray(xyz), None if pts is None else jnp.asarray(pts), 8,
        sampling="FPS")
    tx, tp = tgeo.sample_and_group_edge(
        6, torch.from_numpy(xyz), None if pts is None
        else torch.from_numpy(pts), 8, sampling="FPS",
        fps_start=torch.zeros(3, dtype=torch.long))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_sa_stage_with_fps_matches_jax(train):
    """A stage with input features, sampling='FPS': the same centres and the
    same features as the JAX stage (which starts FPS at point 0), and in
    train mode the same running statistics."""
    D, C, K, S = 8, 16, 6, 8
    stage = SetAbstractionEdgeSA([3 + 2 * D, C, C, C], K, sampling="FPS")
    init_weights(stage, torch.Generator().manual_seed(0))
    tree = to_jax_variables(torch.nn.ModuleDict(
        {"backbone": torch.nn.ModuleDict(
            {"SA_modules": torch.nn.ModuleList([stage])})}))
    jvars = jax.tree_util.tree_map(
        jnp.asarray, {k: v["backbone"]["sa_0"] for k, v in tree.items()})
    jstage = JaxStage(mlp=[3 + 2 * D, C, C, C], nsample=K, sampling="FPS")
    xyz = _cloud("random", 4, 24, seed=5)
    pts = np.random.RandomState(6).randn(4, 24, D).astype(np.float32)
    if train:
        (jxyz, jh), upd = jstage.apply(jvars, jnp.asarray(xyz),
                                       jnp.asarray(pts), S, True,
                                       mutable=["batch_stats"])
    else:
        jxyz, jh = jstage.apply(jvars, jnp.asarray(xyz), jnp.asarray(pts), S,
                                False)
    with torch.no_grad():
        txyz, th = stage(torch.from_numpy(xyz), torch.from_numpy(pts), S,
                         train)
    np.testing.assert_array_equal(txyz.numpy(), np.asarray(jxyz))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=TOL, atol=TOL)
    # the centres are FPS's, not the first S points
    assert not np.array_equal(txyz.numpy(), xyz[:, :S])
    if train:
        for j, bn in enumerate(stage.mlp_bns):
            stats = upd["batch_stats"][f"mlp_{j}"]["bn"]
            np.testing.assert_allclose(bn.running_mean.numpy(),
                                       np.asarray(stats["mean"]), rtol=TOL,
                                       atol=TOL)
            np.testing.assert_allclose(bn.running_var.numpy(),
                                       np.asarray(stats["var"]), rtol=TOL,
                                       atol=TOL)
