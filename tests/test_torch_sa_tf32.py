"""Why the SA-stage kernel runs its products in three TF32 passes.

csrc/sa_stage.cu computes the stage's two C x C products on the tensor cores
as hi*hi + hi*lo + lo*hi, with hi the operand truncated to TF32 (see
tests/_tf32.py). Here the plain version of kernels/sa_stage.py runs with its
products emulated that way, on the CPU, at the flagship's three stage
shapes (N, S, K, C = 128, 128, 32, 128 / 128, 64, 48, 256 / 64, 32, 48, 512)
on two seeded crops, each stage fed by the one before as in the backbone:
three passes stay at the float32 level and one pass does not.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

from point_cloud_reid_tpu_torch.kernels import sa_stage as sa  # noqa: E402
from point_cloud_reid_tpu_torch.tools.ab_sa import stage_inputs  # noqa: E402
from tests._tf32 import (mm_one_pass, mm_three_pass, rel,  # noqa: E402
                         tf32_truncate)
from tests._torch_threads import few_threads  # noqa: E402,F401

# the kernel's bar against the plain version is chip_smoke.py's SA_TOL;
# three passes must stay at the float32 level, one pass 10x above them
THREE_PASS_TOL = 1e-5
ONE_PASS_FACTOR = 10.0


@functools.lru_cache(maxsize=1)
def stage_args():
    """The flagship's three SA stages on 2 crops (tools/ab_sa.py's inputs)."""
    return stage_inputs(2, device="cpu")


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_three_tf32_passes_keep_float32_accuracy(monkeypatch, stage):
    args = stage_args()[stage]
    assert args[0].shape[-1] == (128, 256, 512)[stage]
    with torch.no_grad():
        want = sa.sa_convmax_reference(*args)
        monkeypatch.setattr(sa, "_mm", mm_three_pass(tf32_truncate))
        three = sa.sa_convmax_reference(*args)
        monkeypatch.setattr(sa, "_mm", mm_one_pass)
        one = sa.sa_convmax_reference(*args)
    assert torch.isfinite(three).all() and three.shape == want.shape
    err3, err1 = rel(three, want), rel(one, want)
    print(f"SA{stage + 1}: three passes {err3:.3e}, one pass {err1:.3e}")
    assert err3 <= THREE_PASS_TOL, err3
    assert err1 >= ONE_PASS_FACTOR * err3, (err1, err3)
