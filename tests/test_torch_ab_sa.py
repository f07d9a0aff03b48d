"""tools/ab_sa.py on the CPU: its seeded inputs, which are
fused_sa_convmax's arguments at the flagship's three stages (float32, and
bf16 at the flagship's and the 7M model's widths) or at --widths, the tree
whose wrapper launches each version, and its refusal to run without a
card."""
import pytest

torch = pytest.importorskip("torch")

from point_cloud_reid_tpu_torch.kernels import sa_stage as sa  # noqa: E402
from point_cloud_reid_tpu_torch.tools import ab_sa  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401


def test_stage_inputs_are_the_flagship_stages():
    stages = ab_sa.stage_inputs(2, device="cpu")
    shapes = [(a[0].shape[1:], a[2].shape[1:]) for a in stages]
    assert shapes == [((128, 128), (128, 32)), ((128, 256), (64, 48)),
                      ((64, 512), (32, 48))]
    again = ab_sa.stage_inputs(2, device="cpu")
    for a, b in zip(stages, again):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert all(x.is_contiguous() for x in a)
        out = sa.fused_sa_convmax(*a)
        assert out.shape == (2, a[2].shape[1], a[0].shape[2])
        assert torch.isfinite(out).all()


@pytest.mark.parametrize("mul,widths", [(4, (128, 256, 512)),
                                        (8, (256, 512, 1024)),
                                        (16, (512, 1024, 2048))])
def test_bf16_stage_inputs_at_both_widths(mul, widths):
    """--bf16 [--mul 8 | 16]: A and Ct bf16, idx int32, the weights and affines
    float32 (the bf16 kernel's arguments), the same bits from the same
    seed, and the plain version's bf16 output."""
    stages = ab_sa.stage_inputs(2, device="cpu", dtype=torch.bfloat16,
                                mul=mul)
    assert [a[0].shape[2] for a in stages] == list(widths)
    assert [tuple(a[2].shape[1:]) for a in stages] == [(128, 32), (64, 48),
                                                       (32, 48)]
    assert [a[0].shape[1] for a in stages] == [128, 128, 64]
    again = ab_sa.stage_inputs(2, device="cpu", dtype=torch.bfloat16,
                               mul=mul)
    for a, b in zip(stages, again):
        assert [x.dtype for x in a] == ([torch.bfloat16] * 2 + [torch.int32]
                                        + [torch.float32] * 8)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        out = sa.fused_sa_convmax(*a)
        assert out.dtype == torch.bfloat16
        assert out.shape == (2, a[2].shape[1], a[0].shape[2])
        assert torch.isfinite(out.float()).all()


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        ab_sa.main(["point_cloud_reid_tpu_torch/csrc/sa_stage.cu"])
    with pytest.raises(SystemExit, match="CUDA"):
        ab_sa.main(["point_cloud_reid_tpu_torch/csrc/sa_stage_bf16.cu",
                    "--bf16", "--mul", "8"])


def test_width_inputs_and_their_parsing(monkeypatch):
    """--widths C,...: one seeded random stage of SA3's geometry a width,
    multiples of 32 to 2048 only; without a card the tool exits first."""
    a = ab_sa.width_inputs(96, device="cpu", dtype=torch.bfloat16,
                           shape=(2, 8, 3, 5))
    assert [tuple(x.shape) for x in a[:5]] == [(2, 8, 96), (2, 3, 96),
                                               (2, 3, 5), (96, 96), (96, 96)]
    assert a[0].dtype == torch.bfloat16 and a[2].dtype == torch.int32
    again = ab_sa.width_inputs(96, device="cpu", dtype=torch.bfloat16,
                               shape=(2, 8, 3, 5))
    assert all(torch.equal(x, y) for x, y in zip(a, again))
    assert sa.fused_sa_convmax(*a).shape == (2, 3, 96)
    assert ab_sa.parse_widths("1024,1056,1536") == [1024, 1056, 1536]
    for bad in ("1000", "8224", "a,b", ""):
        with pytest.raises(SystemExit):
            ab_sa.parse_widths(bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        ab_sa.main(["point_cloud_reid_tpu_torch/csrc/sa_stage.cu",
                    "--widths", "1024,1536", "--layout", "plan",
                    "--layout", "wide"])


def test_a_version_launches_through_its_own_tree(tmp_path):
    """A source in this package's csrc/ (or outside any tree of it) is
    launched through this kernels/sa_stage; one in another tree of the
    package (an earlier commit's `git archive`) through that tree's own,
    whose entry points, plan and scratch are that commit's. --layout wide
    takes only versions whose wrapper has the wide layout."""
    here = "point_cloud_reid_tpu_torch/csrc/sa_stage.cu"
    assert ab_sa.wrapper(here, "sa_stage") is sa
    assert ab_sa.wrapper(str(tmp_path / "v1" / "sa_stage.cu"),
                         "sa_stage") is sa
    pkg = tmp_path / "tree" / "point_cloud_reid_tpu_torch"
    (pkg / "kernels").mkdir(parents=True)
    (pkg / "csrc").mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "kernels" / "__init__.py").write_text("")
    (pkg / "kernels" / "sa_stage.py").write_text(
        "TREE = 'older'\ndef launch(*a, **k):\n    return 'older'\n")
    older = str(pkg / "csrc" / "sa_stage.cu")
    mod = ab_sa.wrapper(older, "sa_stage")
    assert mod is not sa and mod.TREE == "older"
    assert ab_sa.versions([older, here], ["plan", "wide"]) == [
        (older, "plan"), (here, "plan"), (here, "wide")]


def test_each_version_pads_as_its_own_wrapper():
    """laid_out: this wrapper's stage at 1,056 channels padded once to the
    wide layout's 1,088 (float32 and bf16) and launched by `launch`, at 992
    to 1024 at float32 and not at bf16 (the mma_sync tier), `--layout wide`
    to the next multiple of 64 through `launch_wide`; an earlier wrapper
    without run_width at its own kernel_width."""
    import types
    for C, bf16, width in ((1056, False, 1088), (1056, True, 1088),
                           (992, False, 1024), (992, True, 992)):
        dtype = torch.bfloat16 if bf16 else torch.float32
        a = ab_sa.width_inputs(C, device="cpu", dtype=dtype,
                               shape=(1, 4, 2, 3))
        got, fn = ab_sa.laid_out(sa, a, "plan")
        assert fn is sa.launch and got[0].shape[-1] == width
        assert torch.equal(got[0][..., :C], a[0])
        assert not got[0][..., C:].any() and not got[3][C:].any()
        wide, fn = ab_sa.laid_out(sa, a, "wide")
        assert fn is sa.launch_wide
        assert wide[0].shape[-1] == -(-C // 64) * 64
    older = types.SimpleNamespace(kernel_width=sa.kernel_width,
                                  pad_args=sa.pad_args, launch="older")
    got, fn = ab_sa.laid_out(older, a, "plan")
    assert fn == "older" and got[0].shape[-1] == 992
