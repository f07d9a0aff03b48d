"""tools/ab_fps.py on the CPU: its seeded clouds and shapes, how it calls
an older int32 version of the kernel, its count of mismatches against the
plain loop, and its refusal to run without a card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from point_cloud_reid_tpu_torch.kernels import fps as kf  # noqa: E402
from point_cloud_reid_tpu_torch.tools import ab_fps  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401


def test_inputs_are_seeded_clouds_of_every_kind():
    clouds = ab_fps.inputs(3, 40, seed=2, device="cpu")
    again = ab_fps.inputs(3, 40, seed=2, device="cpu")
    assert set(clouds) == set(ab_fps.KINDS)
    for kind, (xyz, start) in clouds.items():
        assert xyz.shape == (3, 40, 3) and xyz.dtype == torch.float32
        assert start.dtype == torch.int64 and start.shape == (3,)
        assert ((0 <= start) & (start < 40)).all()
        assert all(torch.equal(a, b) for a, b in zip((xyz, start),
                                                     again[kind]))
    exact = clouds["exact"][0]
    assert torch.equal(exact * 64, torch.round(exact * 64))
    assert len(torch.unique(clouds["duplicates"][0][0], dim=0)) < 40


def test_shapes_and_sweep_cases():
    assert {(128, 128, 128), (128, 128, 64), (128, 64, 32), (512, 128, 128),
            (512, 128, 64), (512, 64, 32), (128, 1024, 256),
            (512, 2048, 512), (4, 20000, 1024)} == set(ab_fps.SHAPES)
    # every tier the sweep forces exists at its N, and each comparison
    # straddles the default plan's choice
    cases = ab_fps.sweep_cases()
    assert len(cases) == len(ab_fps.SWEEP_B) * len(ab_fps.SWEEP_N) + 2
    for B, N, npoint, tiers in cases:
        assert 0 < npoint <= N
        assert [kf.plan(N, t).tier for t in tiers] == list(tiers)
        assert kf.plan(N).tier in tiers
    assert {t for case in cases for t in case[3]} == {
        kf.WARP, kf.BLOCK, kf.L2, kf.SCRATCH}


class _OldHandle:
    """An older build with only the int32 entry point `pcr_fps`."""

    def __init__(self):
        self.args = None

        def pcr_fps(*args):
            self.args = args
            return 0
        self.pcr_fps = pcr_fps

    def get(self):
        return self


def test_old_int32_entry_is_called_with_the_wrappers_casts(monkeypatch):
    from point_cloud_reid_tpu_torch.kernels import _lib
    monkeypatch.setattr(_lib, "stream_ptr", lambda device: 5)
    lib = _OldHandle()
    call, old = ab_fps.fps_call(lib)
    assert old
    xyz = torch.zeros((2, 9, 3))
    out = call(xyz, 4, torch.tensor([1, 8]))
    assert out.dtype == torch.int64 and out.shape == (2, 4)
    assert lib.args[0] == xyz.data_ptr() and lib.args[3:] == (2, 9, 4, 5)


def test_mismatches_count_indices_off_the_plain_loop(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    clouds = ab_fps.inputs(2, 30, device="cpu")

    def right(xyz, npoint, start, how=None):
        return kf.fps(xyz, npoint, start)

    def wrong(xyz, npoint, start, how=None):
        return kf.fps(xyz, npoint, start).flip(-1)
    assert ab_fps.mismatches(right, clouds, 8) == 0
    assert ab_fps.mismatches(wrong, clouds, 8) > 0
    with pytest.raises(RuntimeError, match="fps gave"):
        ab_fps.mismatches(lambda *a: right(*a).int(), clouds, 8)


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        ab_fps.main(["point_cloud_reid_tpu_torch/csrc/fps.cu"])


def test_tool_shares_the_timing_helpers_and_clouds():
    from point_cloud_reid_tpu_torch.tools import scenes, timing
    assert ab_fps.time_ms is timing.time_ms
    assert ab_fps.graph_ms is timing.graph_ms
    assert ab_fps.knn_cloud is scenes.knn_cloud
    assert np.array_equal(ab_fps.inputs(1, 5, device="cpu")["random"][0][0],
                          scenes.knn_cloud("random", 1, 5, 0)[0])
