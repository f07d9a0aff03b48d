"""Why the match kernel runs its products in three TF32 passes.

csrc/match_grid.cu computes every product of the pair chain on the tensor
cores as hi*hi + hi*lo + lo*hi, where hi is the operand truncated to TF32
(10 mantissa bits) and lo = x - hi as the tensor core reads it (truncated to
TF32 too). Here the plain chain of kernels/match_grid.py runs with its
products emulated that way, on the CPU, at the flagship's widths (N=128,
C=64, 2 heads) and at the image head's S=197: three passes stay at the
float32 level, with hi truncated as in the kernel or rounded to nearest
(ties away from zero, cvt.rna.tf32.f32), and one pass does not.
"""
import pytest

torch = pytest.importorskip("torch")

from point_cloud_reid_tpu_torch.kernels import match_grid as mg  # noqa: E402
from point_cloud_reid_tpu_torch.tools.ab_match import inputs  # noqa: E402
from tests._tf32 import (mm_one_pass, mm_three_pass, rel,  # noqa: E402
                         tf32_round, tf32_truncate)
from tests._torch_threads import few_threads  # noqa: E402,F401

# the kernel's bar against the plain version, chip_smoke.py's MATCH_TOL:
# float32 level
THREE_PASS_TOL = 1e-5
ONE_PASS_FACTOR = 10.0


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                     # TF32 spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0e-3], dtype=torch.float32)
    got = tf32_round(x)
    assert got[0].item() == one + ulp and got[1].item() == -(one + ulp)
    assert got[2].item() == one and got[3].item() == one + ulp
    # hi + lo keeps 21 of float32's 24 bits when hi is rounded, 20 when it
    # is truncated
    for hi, bits in ((tf32_round, 20), (tf32_truncate, 19)):
        err = ((hi(x) + tf32_truncate(x - hi(x)) - x).abs()
               / x.abs()).max().item()
        assert err < 2.0 ** -bits


@pytest.mark.parametrize("split", ["truncate", "round"])
@pytest.mark.parametrize("head", ["point", "image"])
def test_three_tf32_passes_keep_float32_accuracy(monkeypatch, head, split):
    t, d, w1, w2, nhead = inputs(head, 2, 3, 128 if head == "point" else 197,
                                 device="cpu")
    t_idx = torch.tensor([0, 1, 1], dtype=torch.int32)
    d_idx = torch.tensor([2, 0, 1], dtype=torch.int32)
    with torch.no_grad():
        want = mg.match_pooled_reference(t, d, w1, w2, nhead, t_idx, d_idx)
        hi = tf32_truncate if split == "truncate" else tf32_round
        monkeypatch.setattr(mg, "_mm", mm_three_pass(hi))
        three = mg.match_pooled_reference(t, d, w1, w2, nhead, t_idx, d_idx)
        monkeypatch.setattr(mg, "_mm", mm_one_pass)
        one = mg.match_pooled_reference(t, d, w1, w2, nhead, t_idx, d_idx)
    assert torch.isfinite(three).all() and three.shape == want.shape
    err3, err1 = rel(three, want), rel(one, want)
    assert err3 <= THREE_PASS_TOL, err3
    assert err1 >= ONE_PASS_FACTOR * err3, (err1, err3)
    # one pass is worse than the kernel tests' own bar allows for
    # float32 results of a float32 chain
    assert err1 > THREE_PASS_TOL, err1
