"""tools/ab_train_kernels.py on the CPU: its seeded inputs, which are the
training path's kNN and attention calls, and its refusal to run without a
card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from point_cloud_reid_tpu_torch.kernels import knn as kk  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import (  # noqa: E402
    linear_attention as la)
from point_cloud_reid_tpu_torch.tools import (  # noqa: E402
    ab_train_kernels as ab)
from tests._torch_threads import few_threads  # noqa: E402,F401


def test_knn_inputs_are_the_flagship_stages():
    assert ab.knn_stages() == [(128, 128, 32), (64, 128, 48), (32, 64, 48)]
    stages = ab.knn_inputs(4, device="cpu")
    again = ab.knn_inputs(4, device="cpu")
    for (S, N, k, clouds), (_, _, _, clouds2) in zip(stages, again):
        assert set(clouds) == set(ab.KNN_KINDS)
        for kind, (q, xyz) in clouds.items():
            assert q.shape == (4, S, 3) and xyz.shape == (4, N, 3)
            assert q.is_contiguous() and q.dtype == torch.float32
            assert torch.equal(q, xyz[:, :S])
            assert all(torch.equal(a, b) for a, b in zip((q, xyz),
                                                         clouds2[kind]))
        exact = clouds["exact"][1]
        assert torch.equal(exact * 64, torch.round(exact * 64))
        dup = clouds["duplicates"][1]
        assert len(torch.unique(dup[0], dim=0)) < N


def test_knn_check_counts_mismatches_against_plain():
    S, N, k, clouds = ab.knn_inputs(2, device="cpu")[2]
    q, xyz = clouds["duplicates"]
    want = kk.knn_reference(q, xyz, k)
    assert ab.knn_check(want, q, xyz, k) == (0, 0, 0.0)
    wrong = want.flip(-1)
    bad, far, gap = ab.knn_check(wrong, q, xyz, k)
    assert bad > 0 and far > 0 and gap > 0


def test_attention_inputs_are_fused_projection_views():
    sets = ab.attention_inputs(3, 10, 7, 2, 4, 6, device="cpu")
    again = ab.attention_inputs(3, 10, 7, 2, 4, 6, device="cpu")
    assert len(sets) == 3
    for (q, k, v), other in zip(sets, again):
        assert q.shape == (3, 10, 2, 4) and k.shape == (3, 7, 2, 4)
        assert v.shape == (3, 7, 2, 6)
        assert not k.is_contiguous() and k.stride(-1) == 1
        assert v.data_ptr() == k.data_ptr() + 4 * k.element_size()
        assert all(torch.equal(a, b) for a, b in zip((q, k, v), other))
        out = la.linear_attention_forward(q, k, v)
        assert out.shape == (3, 10, 2, 6) and torch.isfinite(out).all()
    assert not torch.equal(sets[0][0], sets[1][0])
    default = ab.attention_inputs(sets=1, device="cpu")[0]
    assert [tuple(t.shape) for t in default] == [(256, 128, 2, 32),
                                                 (256, 128, 2, 32),
                                                 (256, 128, 2, 32)]


def test_knn_cloud_is_seeded():
    for kind in ab.KNN_KINDS:
        a, b = ab.knn_cloud(kind, 2, 9, 5), ab.knn_cloud(kind, 2, 9, 5)
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        ab.main(["--knn", "point_cloud_reid_tpu_torch/csrc/knn.cu"])


def test_tools_share_the_timing_helpers_and_clouds():
    from point_cloud_reid_tpu_torch.tools import (ab_match, ab_sa, scenes,
                                                  timing)
    assert ab_match.time_ms is timing.time_ms
    assert ab_sa.time_ms is timing.time_ms
    assert ab.time_ms is timing.time_ms and ab.graph_ms is timing.graph_ms
    assert ab.knn_cloud is scenes.knn_cloud


def test_knn_stages_take_the_crop_size():
    """--N sets SA1's cloud (a point-count ablation's crops); SA2 and SA3
    search the fixed centres as before."""
    assert ab.knn_stages(2048) == [(128, 2048, 32), (64, 128, 48),
                                   (32, 64, 48)]
    S, N, k, clouds = ab.knn_inputs(2, device="cpu", crop=300)[0]
    assert (S, N, k) == (128, 300, 32)
    assert clouds["random"][1].shape == (2, 300, 3)


def test_channel_stages_are_dgcnn_feature_knn():
    """The channel tier's stages: DGCNN's blocks 2-4 at 256 pairs of
    2048-point crops at both dtypes, then k and C apart; each a tier C
    launch."""
    assert (ab.CHANNEL_CLOUDS, ab.CHANNEL_POINTS) == (512, 2048)
    assert {(64, 20, "float32"), (128, 20, "float32"), (64, 20, "bfloat16"),
            (128, 20, "bfloat16")} <= set(ab.CHANNEL_STAGES)
    assert {k for C, k, _ in ab.CHANNEL_STAGES if C == 64} == {1, 8, 20, 48}
    assert {C for C, k, _ in ab.CHANNEL_STAGES if k == 20} == {
        16, 32, 64, 128, 256}
    for C, k, dtype in ab.CHANNEL_STAGES:
        how = kk.plan(ab.CHANNEL_POINTS, k, C=C, bf16=dtype == "bfloat16")
        assert how.tier == kk.CHANNELS


def test_channel_inputs_are_seeded_features():
    stages = ab.channel_inputs(2, 30, device="cpu")
    again = ab.channel_inputs(2, 30, device="cpu")
    assert [name for name, _, _ in stages] == [
        f"C{C}_k{k}_{d}" for C, k, d in ab.CHANNEL_STAGES]
    for (name, k, clouds), (_, k2, clouds2), (C, want_k, dtype) in zip(
            stages, again, ab.CHANNEL_STAGES):
        assert k == k2 == want_k and set(clouds) == set(ab.KNN_KINDS)
        for kind, (q, xyz) in clouds.items():
            assert q is xyz and q.shape == (2, 30, C)
            assert q.dtype == getattr(torch, dtype)
            assert torch.equal(q, clouds2[kind][0])
        dup = clouds["duplicates"][1].float()
        assert len(torch.unique(dup[0], dim=0)) < 30


def test_knn_check_takes_clouds_in_chunks():
    """knn_check sums its counts over chunks of clouds as over the whole
    batch, and at bf16 takes a near-tie as two bf16 roundings."""
    _, k, clouds = ab.channel_inputs(5, 40, device="cpu")[0]
    q, xyz = clouds["duplicates"]
    want = kk.knn_reference(q, xyz, k)
    wrong = want.flip(-1)
    whole = ab.knn_check(wrong, q, xyz, k)
    assert whole[0] > 0 and whole[1] > 0 and whole[2] > 0
    assert ab.knn_check(wrong, q, xyz, k, clouds=2) == whole
    assert ab.knn_check(want, q, xyz, k, clouds=1) == (0, 0, 0.0)
    # bf16: a swap of two picks one bf16 ulp apart is a near-tie
    x = torch.tensor([[[0.0], [1.0], [1.0078125], [3.0]]]).bfloat16()
    got = torch.tensor([[[0, 2, 1]]])
    bad, far, gap = ab.knn_check(got, x[:, :1], x, 3)
    assert (bad, far) == (2, 0) and gap > 0


def test_knn_call_launches_channel_versions(monkeypatch):
    """A version with the channel tier's entry point is launched through
    kernels/knn.launch with this package's plan: its arguments as the
    wrapper passes them."""
    seen = []

    class Handle:
        def pcr_knn_channels(self, *args):
            seen.append(args)
            return 0

    class Lib:
        def get(self):
            return Handle()
    monkeypatch.setattr(kk._lib, "stream_ptr", lambda device: 0)
    x = torch.zeros(2, 70, 64, dtype=torch.bfloat16)
    out = ab.knn_call(Lib())(x, x, 20)
    assert out.shape == (2, 70, 20) and out.dtype == torch.int64
    how = kk.plan(70, 20, C=64, bf16=True)
    assert seen[0][3:] == (2, 70, 70, 64, 20, how.points, how.smem, 1, 0)


def test_knn_call_launches_through_the_sources_tree(tmp_path):
    """A channel-tier source inside another tree of the package is launched
    by that tree's kernels/knn.launch (its own plan and shared bytes)."""
    pkg = tmp_path / "point_cloud_reid_tpu_torch"
    (pkg / "kernels").mkdir(parents=True)
    (pkg / "csrc").mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "kernels" / "__init__.py").write_text("")
    (pkg / "kernels" / "knn.py").write_text(
        "def launch(q, xyz, k, how=None, library=None):\n"
        "    return ('that tree', k, library)\n")
    src = pkg / "csrc" / "knn_channels.cu"
    src.write_text("")

    class Handle:
        def pcr_knn_channels(self, *args):
            raise AssertionError("launched past the tree's wrapper")

    class Lib:
        def get(self):
            return Handle()
    lib = Lib()
    x = torch.zeros(1, 5, 8)
    assert ab.knn_call(lib, str(src))(x, x, 4) == ("that tree", 4, lib)
