"""tools/ab_match.py on the CPU: its seeded inputs, its libraries of other
kernel versions, and its refusal to run without a card."""
import pytest

torch = pytest.importorskip("torch")

from point_cloud_reid_tpu_torch.kernels import _lib  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import match_grid as mg  # noqa: E402
from point_cloud_reid_tpu_torch.tools import ab_match  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401


@pytest.mark.parametrize("head,parts", [("point", 5), ("image", 4)])
def test_inputs_are_the_kernels_inputs(head, parts):
    nt, nd, n_rows, C = 2, 3, 7, 16
    t, d, w1, w2, nhead = ab_match.inputs(head, nt, nd, n_rows, C,
                                          device="cpu")
    assert len(t) == len(d) == parts and nhead == 2
    for side, n in ((t, nt), (d, nd)):
        assert tuple(side[2].shape) == (n, C, 2 * C)
        assert all(x.is_contiguous() and x.shape[0] == n for x in side)
    again = ab_match.inputs(head, nt, nd, n_rows, C, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(t + d, again[0] + again[1]))
    assert set(w2) - set(w1) == {"q", "kv"}


def test_a_library_of_other_sources_builds_apart(tmp_path):
    src = tmp_path / "older.cu"
    src.write_text("// another version\n")
    lib = _lib.Library([src])
    assert lib.sources() == [src.resolve()]
    assert src.resolve() not in _lib.LIBRARY.sources()


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        ab_match.main(["point_cloud_reid_tpu_torch/csrc/match_grid.cu"])


def test_main_wants_width_and_rows_together(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit, match="--C and --N together"):
        ab_match.main(["point_cloud_reid_tpu_torch/csrc/match_rows.cu",
                       "--C", "128"])


def test_bf16_flag_takes_a_bf16_models_inputs(monkeypatch):
    """--bf16 is a flag beside the shape options: it needs a card like the
    float32 A/B, and --C / --N still come together; its inputs are a bf16
    model's (bf16 factors, float32 weights)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        ab_match.main(["point_cloud_reid_tpu_torch/csrc/match_grid_bf16.cu",
                       "--bf16"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit, match="--C and --N together"):
        ab_match.main(["point_cloud_reid_tpu_torch/csrc/match_rows_bf16.cu",
                       "--bf16", "--N", "2048"])
    t, d, w1, w2, _ = ab_match.inputs("point", 2, 3, 7, 16, device="cpu",
                                      dtype=torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in t + d)
    assert all(x.dtype == torch.float32 for x in (*w1.values(),
                                                   *w2.values()))


def test_shapes_name_several_point_shapes(monkeypatch):
    """--shapes C:N:GRID,... names several point-head shapes for one build
    (the four rows-tier shapes of the A/B in two calls); a malformed item
    exits, and without a card the tool exits before it builds."""
    assert ab_match.parse_shapes("128:128:128,64:2048:16,96:128:8:3") == [
        (128, 128, 128, 2), (64, 2048, 16, 2), (96, 128, 8, 3)]
    for bad in ("128:128", "128:0:16", "a:b:c"):
        with pytest.raises((SystemExit, ValueError)):
            ab_match.parse_shapes(bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        ab_match.main(["point_cloud_reid_tpu_torch/csrc/match_rows.cu",
                       "--shapes", "128:128:128,64:2048:16", "--bf16"])


def test_shapes_take_the_wide_kernel_and_16_heads(monkeypatch):
    """--shapes 256:128:128:2 (conv_out256: the rows tier's wide kernel,
    through the padded entry point), 128:128:128:16 (heads16: the exact
    C = 128 instantiation at 16 heads) and 256:197:128x64:2:image
    (image256's dense frame: the image head on the wide kernel, a 128 x 64
    grid of 197 tokens a side), at both dtypes; without a card the tool
    exits before it builds."""
    shapes = ab_match.parse_shapes("256:128:128:2,128:128:128:16")
    assert shapes == [(256, 128, 128, 2), (128, 128, 128, 16)]
    for dtype in (torch.float32, torch.bfloat16):
        for C, N, _, H in shapes:
            assert mg.plan(N, C, H, dtype=dtype).tier == mg.ROWS
            assert mg.rows_padded(C, H, 5) == (C > 128)
    image = ab_match.parse_shapes("256:197:128x64:2:image")
    assert image == [(256, 197, (128, 64), 2, "image")]
    assert ab_match.shape_cases(image + shapes[:1]) == (
        ("image_C256_N197_H2_grid_128x64", "image", 128, 64, 197, 256, 2),
        ("point_C256_N128_H2_grid_128x128", "point", 128, 128, 128, 256, 2))
    t, d, w1, w2, H = ab_match.inputs("image", 2, 1, 5, 256, 2, device="cpu")
    assert len(t) == 4
    for dtype in (torch.float32, torch.bfloat16):
        assert mg.plan(197, 256, 2, pos=False, dtype=dtype) == mg.Plan(
            mg.ROWS, mg.rows_layout(256, 1, dtype).smem)
    assert mg.kernel_width(256, mg.ROWS) == 256
    assert mg.rows_padded(256, 2, len(t))
    for bad in ("256:197:128x:2:image", "256:197:128x64x2:2:image",
                "256:197:image"):
        with pytest.raises(SystemExit):
            ab_match.parse_shapes(bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        ab_match.main(["point_cloud_reid_tpu_torch/csrc/match_rows.cu+"
                       "point_cloud_reid_tpu_torch/csrc/match_rows_pad.cu",
                       "--shapes", "256:128:128:2,128:128:128:16", "--bf16"])


def test_ptxas_usage_reads_a_build_log():
    """The registers and spills ab_match and chip_smoke.py report come from
    nvcc's -Xptxas -v lines, a kernel at a time."""
    log = """ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'
ptxas info    : Function properties for _Z1kv
    568 bytes stack frame, 1140 bytes spill stores, 1440 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_Z1jv' for 'sm_90a'
ptxas info    : Function properties for _Z1jv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers"""
    assert _lib.ptxas_usage(log) == {
        "_Z1kv": dict(registers=168, stack=568, spill_stores=1140,
                      spill_loads=1440),
        "_Z1jv": dict(registers=40, stack=0, spill_stores=0, spill_loads=0)}


def test_a_version_launches_through_its_own_tree(tmp_path):
    """A source in this package's csrc/ (or outside any tree of it) is
    launched through this kernels/match_grid; one in another tree of the
    package (an earlier commit's `git archive`) through that tree's own,
    imported once under a name of its own, so that its stage copies and
    layout checks are that commit's."""
    here = "point_cloud_reid_tpu_torch/csrc/match_rows.cu"
    assert ab_match.wrapper(here) is mg
    assert ab_match.wrapper(str(tmp_path / "older.cu")) is mg
    pkg = tmp_path / "tree" / "point_cloud_reid_tpu_torch"
    (pkg / "kernels").mkdir(parents=True)
    (pkg / "csrc").mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "kernels" / "__init__.py").write_text("")
    (pkg / "kernels" / "match_grid.py").write_text("TREE = 'older'\n")
    src = str(pkg / "csrc" / "match_rows.cu")
    older = ab_match.wrapper(src + "+" + str(pkg / "csrc" / "x.cu"))
    assert older is not mg and older.TREE == "older"
    assert ab_match.wrapper(src) is older