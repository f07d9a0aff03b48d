"""A/B timing of versions of the match kernel (csrc/match_grid.cu, or
csrc/match_rows.cu for the rows tier; with --bf16 their bf16 forms,
csrc/match_grid_bf16.cu and csrc/match_rows_bf16.cu) in one process on one
card.

Each SOURCE is a copy of csrc/match_grid.cu with the same C entry points
(`pcr_match_pooled`, `pcr_match_pooled_image`, `pcr_match_pooled_layout`),
for example the parent commit's file unpacked from `git archive`; with
--C / --N at a shape that kernels/match_grid.plan gives the rows tier, a
copy of csrc/match_rows.cu (`pcr_match_rows`, `pcr_match_rows_layout`).
With --bf16 the inputs are a bf16 model's (bf16 factors, the weights
converted once) and a SOURCE is a copy of the bf16 kernel of that tier
(`pcr_match_pooled_bf16`, `pcr_match_pooled_image_bf16`,
`pcr_match_pooled_bf16_layout`; `pcr_match_rows_bf16`,
`pcr_match_rows_bf16_layout`), compared with the bf16 plain version. Each
is
built as a kernels/_lib.Library of its own (all built together) and
launched through kernels/match_grid.launch, the wrappers' checked launch
path; then every version scores the same seeded inputs at the main paths'
shapes: the point grid 128 x 128 (N=128, C=64, 2 heads), the
image grid 128 x 64 (S=197), and 512-pair lists of both; with --C C and
--N N instead the point head alone at that width and row count, a --grid x
--grid grid and a 512-pair list (the 7M model's dense frame: --C 128 --N
128; a 2048-point ablation served at its crop size: --C 64 --N 2048 --grid
16), or several such shapes at once with --shapes
C:N:GRID[:HEADS][:image],... (one build for all; 2 heads unless given;
GRID is tracks x detections, NTxND, or one number for a square grid;
`image` takes the image head, N its tokens: 256:197:128x64:2:image is
image256's dense frame). A width the tiles have no
instantiation for runs in the padded layout (kernels/match_grid.pad_side).
The rows tier past 128 channels and 8 heads (--shapes 256:128:128:2 for
conv_out256's two 128-channel heads, 128:128:128:16 for heads16's 16 heads
of 8) runs from csrc/match_rows.cu (16 heads) and, past 128 channels, the
wide kernel of csrc/match_rows_pad.cu: give such a version as
csrc/match_rows.cu+csrc/match_rows_pad.cu (or their _bf16 files with
--bf16).
`--tier rows` drives every shape through the rows tier whatever the plan
picks (kernels/match_grid.launch(tier=ROWS)); given with `--tier plan` as
well, each source is timed both ways in turns, one version per (source,
tier): e.g. C = 16 past its cluster layout on the first rows kernel (the
plan) against the padded wgmma rows tier. The versions of csrc/match_rows*.cu from before the wgmma rows
tier export only the first rows kernel's entry points (`pcr_match_rows`,
`pcr_match_rows_layout`); kernels/match_grid.launch gives them that
kernel's arguments. Versions are timed
in turns (first to last, then last to first, `--rounds` times) with CUDA
events, and each output is compared with the first version's and with the
plain version. Prints ptxas's registers and spills of each version, then
one JSON line per version with the card's name and power limit, ptxas's
registers and spills of its kernels and, per shape, the shared bytes a
block of that version's layout.

A SOURCE may join several files with '+' into one version (a tier with
its padded entry points: csrc/match_rows.cu+csrc/match_rows_pad.cu).
Each version is launched through the kernels/match_grid.py of the tree
its first file lies in (SOURCE's csrc/../kernels), imported under a name of
its own when that is not this package: an earlier commit's sources from
its `git archive` run with that commit's stage copies and layout checks
(an earlier wide kernel, whose weight order and scratch differ from this
one's).

    python -m point_cloud_reid_tpu_torch.tools.ab_match SOURCE [SOURCE ...]
        [--rounds 2] [--iters 5] [--C 128 --N 128 [--grid 128]]
        [--shapes 128:128:128,64:2048:16,96:128:128:3,256:128:128:2,
                  128:128:128:16,256:197:128x64:2:image] [--bf16]
        [--tier plan] [--tier rows]

Needs a CUDA device and nvcc. TF32 off.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib
import importlib.util
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..kernels import _lib
from ..kernels import match_grid as mg
from .scenes import card_name
from .timing import time_ms


def inputs(head: str, nt: int, nd: int, n_rows: int, C: int = 64,
           nhead: int = 2, seed: int = 0, device="cuda",
           dtype: torch.dtype = torch.float32):
    """Factors and weights of the match kernel for `head` ("point" or
    "image"): two cross stages with seeded weights over seeded random
    features of nt tracks and nd detections, n_rows points or tokens each,
    the features (and so the factors) in `dtype`. Returns (t, d, w1, w2,
    nhead)."""
    from ..models.attention_blocks import CrossAttentionBlock, CrossLinAttn
    from ..models.build import init_weights
    block = CrossAttentionBlock if head == "point" else CrossLinAttn
    stages = torch.nn.ModuleList(block(C, nhead) for _ in range(2))
    init_weights(stages, torch.Generator().manual_seed(seed))
    stages.to(device).requires_grad_(False)
    rs = np.random.RandomState(seed)

    def r(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(device)

    def h(*shape):
        return r(*shape).to(dtype)
    with torch.no_grad():
        if head == "point":
            t = mg.grid_factors(stages[0], stages[1], h(nt, n_rows, C),
                                r(nt, n_rows, 3), nhead)
            d = mg.grid_factors(stages[0], stages[1], h(nd, n_rows, C),
                                r(nd, n_rows, 3), nhead)
        else:
            t = mg.image_grid_factors(stages[0], h(nt, n_rows, C), nhead)
            d = mg.image_grid_factors(stages[0], h(nd, n_rows, C), nhead)
        w1, w2 = mg.stage_weights(stages[0], stages[1])
    return t, d, w1, w2, nhead


def build(sources):
    """One loaded library per source and the headers beside it, built
    together (a source `A.cu+B.cu` is one version of both files, such as a
    tier and its padded entry points); prints ptxas's register and spill
    lines of each."""
    libs = []
    for src in sources:
        files = src.split("+")
        libs.append(_lib.Library(
            [*files, *sorted(Path(files[0]).parent.glob("*.cuh"))]))
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.get(), libs))
    for lib, src in zip(libs, sources):
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {src}: {line.strip()}")
    return libs


def wrapper(source: str, module: str = "match_grid"):
    """The kernels/<module> (match_grid, sa_stage for tools/ab_sa.py, knn
    for tools/ab_train_kernels.py) that launches a version: this package's
    for a source in its csrc/ (or outside any tree of the package), else
    that of the tree the source's first file lies in, imported once under a
    name of its own."""
    pkg = Path(source.split("+")[0]).resolve().parent.parent
    if (pkg == Path(mg.__file__).resolve().parent.parent
            or not (pkg / "kernels" / f"{module}.py").is_file()):
        return importlib.import_module(
            mg.__name__.rsplit(".", 1)[0] + "." + module)
    name = "ab_match_" + hashlib.sha1(str(pkg).encode()).hexdigest()[:12]
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        tree = importlib.util.module_from_spec(spec)
        sys.modules[name] = tree
        spec.loader.exec_module(tree)
    return importlib.import_module(f"{name}.kernels.{module}")


def layout_bytes(lib, t, nhead, tier=None, wrap=mg) -> int:
    """Shared bytes a block of one version's layout for `tier`, by default
    the one its wrapper's plan (`wrap`, kernels/match_grid) picks for these
    factors, at the width it runs them (a version without the wgmma rows
    tier: its first rows kernel's)."""
    N, C = t[0].shape[1], t[0].shape[2]
    bf16 = t[0].dtype == torch.bfloat16
    if tier is None:
        tier = wrap.plan(N, C, nhead, pos=len(t) == 5, dtype=t[0].dtype).tier
    W = wrap.kernel_width(C, tier)
    # a wrapper from before rows_padded pads the image head alone
    padded = W != C or (tier == mg.ROWS and (
        wrap.rows_padded(C, nhead, len(t)) if hasattr(wrap, "rows_padded")
        else len(t) == 4))
    entry = wrap.layout_entry(tier, bf16)
    if not hasattr(lib.get(), entry) and tier == mg.ROWS:
        entry = wrap.layout_entry(mg.ROWS_MMA, bf16)
    heads = 1 if padded else nhead
    if tier == mg.ROWS and hasattr(wrap, "layout_heads"):
        heads = wrap.layout_heads(C, nhead, len(t))
    need, limit = ctypes.c_longlong(), ctypes.c_longlong()
    getattr(lib.get(), entry)(N, W, heads, ctypes.byref(need),
                              ctypes.byref(limit))
    return need.value


def parse_shapes(text: str) -> list:
    """--shapes "C:N:GRID[:HEADS][:image],..." as [(C, N, GRID, HEADS),
    ...] (2 heads unless given; GRID an int for a square grid, (NT, ND)
    for NTxND), an image shape with "image" as a fifth element."""
    out = []
    for item in text.split(","):
        fields = item.split(":")
        image = fields[-1] == "image"
        fields = fields[:-1] if image else fields
        try:
            if len(fields) not in (3, 4):
                raise ValueError(item)
            parts = [int(x) for x in fields[:2] + fields[3:]]
            grid = [int(x) for x in fields[2].split("x")]
        except ValueError:
            parts, grid = [0], []
        if len(grid) not in (1, 2) or min(parts + grid) < 1:
            raise SystemExit(f"ab_match: --shapes wants C:N:GRID[:HEADS]"
                             f"[:image], got {item!r}")
        shape = (parts[0], parts[1], grid[0] if len(grid) == 1
                 else tuple(grid), parts[2] if len(parts) == 3 else 2)
        out.append(shape + (("image",) if image else ()))
    return out


def shape_cases(shapes) -> tuple:
    """(label, head, nt, nd, rows, C, heads) of each parsed --shapes item."""
    cases = []
    for C, N, grid, H, *image in shapes:
        head = "image" if image else "point"
        nt, nd = (grid, grid) if isinstance(grid, int) else grid
        cases.append((f"{head}_C{C}_N{N}_H{H}_grid_{nt}x{nd}", head, nt, nd,
                      N, C, H))
    return tuple(cases)


def call(lib, t, d, w1, w2, nhead, t_idx=None, d_idx=None, tier=None,
         wrap=mg):
    """(P, 2C) pooled features from one version of the kernel, through
    `tier` if given (its wrapper's kernels/match_grid.launch)."""
    out = wrap.launch(None, len(t), t, d, w1, w2, nhead, t_idx, d_idx, lib,
                      tier=tier)
    return out.reshape(-1, out.shape[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--C", type=int, default=None,
                    help="channels of a point-head shape (with --N)")
    ap.add_argument("--N", type=int, default=None,
                    help="rows a side of a point-head shape (with --C)")
    ap.add_argument("--grid", type=int, default=128,
                    help="tracks and detections of that shape's grid")
    ap.add_argument("--shapes", default=None,
                    help="shapes C:N:GRID[:HEADS][:image],... (instead of "
                         "--C/--N)")
    ap.add_argument("--tier", action="append", choices=("plan", "rows"),
                    help="the plan's tier (default) or the rows tier; both: "
                         "each source timed both ways")
    ap.add_argument("--bf16", action="store_true",
                    help="a bf16 model's inputs and the bf16 kernels")
    args = ap.parse_args(argv)
    if (args.C is None) != (args.N is None):
        raise SystemExit("ab_match: give --C and --N together")
    point = ([(args.C, args.N, args.grid, 2)] if args.C is not None
             else []) + (parse_shapes(args.shapes) if args.shapes else [])
    if not torch.cuda.is_available():
        raise SystemExit("ab_match needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    built = build(args.sources)
    tiers = [None if x == "plan" else mg.ROWS
             for x in dict.fromkeys(args.tier or ["plan"])]
    # a version: (source, its library, the tier it is driven through)
    versions = [(src, lib, tier) for src, lib in zip(args.sources, built)
                for tier in tiers]
    libs = [v[1] for v in versions]
    wraps = [wrapper(v[0]) for v in versions]
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    shapes = ((("point_grid_128x128", "point", 128, 128, 128, 64, 2),
               ("image_grid_128x64", "image", 128, 64, 197, 64, 2))
              if not point else shape_cases(point))
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    smem = [{} for _ in libs]
    for label, head, nt, nd, n_rows, C, H in shapes:
        t, d, w1, w2, nhead = inputs(head, nt, nd, n_rows, C, H, dtype=dtype)
        for i, (_, lib, tier) in enumerate(versions):
            smem[i][label] = layout_bytes(lib, t, nhead, tier, wraps[i])
        ti = torch.randint(0, nt, (512,), generator=gen, device="cuda",
                           dtype=torch.int32)
        di = torch.randint(0, nd, (512,), generator=gen, device="cuda",
                           dtype=torch.int32)
        pairs = label.split("_grid")[0] + "_pairs_512"
        cases[label] = (t, d, w1, w2, nhead, None, None)
        cases[pairs] = (t, d, w1, w2, nhead, ti, di)
    errs = [{} for _ in libs]
    for label, (t, d, w1, w2, nhead, ti, di) in cases.items():
        if ti is None:
            nt, nd = t[0].shape[0], d[0].shape[0]
            ti_all = torch.arange(nt, device="cuda").repeat_interleave(nd)
            di_all = torch.arange(nd, device="cuda").repeat(nt)
        else:
            ti_all, di_all = ti, di
        plain = mg.match_pooled_reference(t, d, w1, w2, nhead, ti_all,
                                          di_all)
        first = None
        for i, (_, lib, tier) in enumerate(versions):
            got = call(lib, t, d, w1, w2, nhead, ti, di, tier, wraps[i])
            torch.cuda.synchronize()
            first = got if first is None else first
            scale = max(1.0, plain.float().abs().max().item())
            errs[i][label] = dict(
                rel_plain=(got.float() - plain.float()).abs().max().item()
                / scale,
                vs_first=(got.float() - first.float()).abs().max().item())
    times = [{k: [] for k in cases} for _ in libs]
    for rnd in range(args.rounds):
        order = list(range(len(libs)))
        for i in order + order[::-1]:
            for label, (t, d, w1, w2, nhead, ti, di) in cases.items():
                times[i][label].append(time_ms(
                    lambda: call(libs[i], t, d, w1, w2, nhead, ti, di,
                                 versions[i][2], wraps[i]), args.iters))
    for i, (src, _, tier) in enumerate(versions):
        print(json.dumps(dict(
            source=src, card=card, dtype=str(dtype).split(".")[-1],
            tier="plan" if tier is None else mg.TIER_NAMES[tier],
            ms={k: float(np.median(v)) for k, v in times[i].items()},
            ms_all=times[i], errors=errs[i], smem_bytes=smem[i],
            ptxas=_lib.ptxas_usage(libs[i].build_log))))


if __name__ == "__main__":
    main()
