"""tools/ab_sa.py on the CPU: its seeded inputs, which are
fused_sa_convmax's arguments at the flagship's three stages (float32, and
bf16 at the flagship's and the 7M model's widths), and its refusal to run
without a card."""
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
