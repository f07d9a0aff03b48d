"""A/B timing of versions of the SA-stage kernel (csrc/sa_stage.cu, or with
--bf16 csrc/sa_stage_bf16.cu) in one process on one card.

Each SOURCE is a version of the kernel's file with its C entry points, for
example the parent commit's file unpacked from `git archive`. Each is built
as a kernels/_lib.Library of its own from that one source and the headers
beside it (seconds, against ~50 s for the whole library), all built
together, and launched through the kernels/sa_stage.launch of the tree the
source lies in (tools/ab_match.wrapper: SOURCE's csrc/../kernels, imported
under a name of its own when that is not this package), the wrapper's
checked launch with that commit's plan, padding, stage copies and scratch
(`laid_out`: each version gets the stage padded as its own wrapper pads
it, its output sliced back to the stage's width). Every
version runs the three eval SA stages on 128 seeded crops of 128 points, at
the flagship's widths (SA1 / SA2 / SA3: N, S, K, C = 128, 128, 32, 128 /
128, 64, 48, 256 / 64, 32, 48, 512) or with --mul 8 the 7M model's (C = 256
/ 512 / 1024; its SA stages are the flagship's at mul 8), or with --mul 16
the `mul16` width's (C = 512 / 1024 / 2048: SA3 on the wide layout at both
dtypes); seed-0 weights of a model of that dtype; each stage fed by the one
before, as in the backbone. With --widths C,... instead one seeded random
stage of SA3's geometry (B, N, S, K = 128, 64, 32, 48) at each width C.
`--layout wide` drives every stage through the wide layout
(kernels/sa_stage.launch_wide) whatever the plan picks; given with
`--layout plan` as well, each source whose wrapper has the wide layout is
timed both ways, one version per (source, layout). Versions are timed in turns
(first to last, then last to first, `--rounds` times) with CUDA events,
each output is compared with the plain version and with the first
version's, and the host time of one call (its enqueue, the card busy) is
taken. Prints ptxas's registers and spills of each build, then one JSON
line per version with the card's name and power limit: per stage the
median ms over rounds, all rounds, the error against the plain version
(relative to max(1, |plain|)), the largest difference from the first
version's output (`vs_first`), the median host us a call, the plan the
build reports (null for a build without a layout entry) and ptxas's
account of its kernels.

    python -m point_cloud_reid_tpu_torch.tools.ab_sa SOURCE [SOURCE ...]
        [--rounds 5] [--iters 10] [--bf16] [--mul 8|16]
        [--widths 1024,1056,1536,1792] [--layout plan] [--layout wide]

Needs a CUDA device and nvcc. TF32 off.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..kernels import _lib
from ..kernels import sa_stage as sa
from .ab_match import build, wrapper
from .scenes import card_name
from .timing import time_ms

# SA3's geometry (the flagship's at any mul): crops, points, centres, K
WIDTH_STAGE = (128, 64, 32, 48)


def stage_inputs(B: int = 128, seed: int = 0, device="cuda",
                 dtype: torch.dtype = torch.float32, mul: int = 4) -> list:
    """kernels/sa_stage.launch's arguments for the three eval SA stages of
    the flagship at `mul` (4: its own widths; 8: the 7M model's; 16: SA
    widths 512 / 1024 / 2048) on B seeded crops of 128 points, a model of
    `dtype` (bf16: A and Ct bf16), laid out as pad_args lays them out at
    kernel_width (each version's wrapper pads them further as it does:
    laid_out)."""
    from ..configs import point_transformer_point_cat
    from ..models import build_model
    from ..ops.geometry import knn_indices
    bf16 = dtype == torch.bfloat16
    model = build_model(point_transformer_point_cat(mul=mul), device=device,
                        generator=torch.Generator().manual_seed(seed),
                        dtype=dtype).eval()
    gen = torch.Generator(device=device).manual_seed(seed)
    xyz = torch.randn((B, 128, 3), generator=gen, device=device) * 0.6
    points, stages = None, []
    with torch.no_grad():
        for mod, S in zip(model.backbone.SA_modules, model.backbone_list):
            cidx = torch.arange(S, device=device).clamp(max=xyz.shape[1] - 1)
            idx = knn_indices(mod.nsample, xyz, xyz[:, cidx])
            args = sa.sa_stage_args(
                xyz, points, idx, [(c.weight, c.bias) for c in mod.mlp_convs],
                [(b.weight, b.bias, b.running_mean, b.running_var)
                 for b in mod.mlp_bns], mod.mlp_bns[0].eps,
                dtype if bf16 else None)
            stages.append(sa.pad_args(*args, sa.kernel_width(
                args[0].shape[-1])))
            xyz, points = mod(xyz, points, S)
    return stages


def width_inputs(C: int, seed: int = 0, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 shape=WIDTH_STAGE) -> tuple:
    """One seeded random stage of C channels (a multiple of 32) at `shape`
    (B, N, S, K): A and Ct in `dtype`, weights scaled by 1 / sqrt(C)."""
    B, N, S, K = shape
    gen = torch.Generator(device=device).manual_seed(seed + C)

    def r(*size):
        return torch.randn(size, generator=gen, device=device)
    idx = torch.randint(0, N, (B, S, K), generator=gen, device=device,
                        dtype=torch.int32)
    return (r(B, N, C).to(dtype), r(B, S, C).to(dtype), idx,
            r(C, C) / C ** 0.5, r(C, C) / C ** 0.5) + tuple(
                r(C) for _ in range(6))


def parse_widths(text: str) -> list:
    """--widths "C,C,..." as ints, each a multiple of 32 from 32 to MAX_C."""
    try:
        widths = [int(x) for x in text.split(",")]
    except ValueError:
        widths = []
    if not widths or any(C % 32 or not 32 <= C <= sa.MAX_C for C in widths):
        raise SystemExit(f"ab_sa: --widths wants multiples of 32 from 32 to "
                         f"{sa.MAX_C}, got {text!r}")
    return widths


def laid_out(wrap, args: tuple, layout: str) -> tuple:
    """(the stage's arguments as wrapper module `wrap` hands them to its
    kernel, the launch that takes them): at the plan's layout padded to
    the width its fused_sa_convmax runs C at (run_width; an earlier
    wrapper without it: kernel_width) and launched by `launch`; at the
    wide layout padded to the next multiple of 64 and launched by
    `launch_wide`."""
    C, bf16 = args[0].shape[-1], args[0].dtype == torch.bfloat16
    if layout == "wide":
        W, fn = wrap.wide_width(wrap.kernel_width(C)), wrap.launch_wide
    elif hasattr(wrap, "run_width"):
        W, fn = wrap.run_width(C, bf16), wrap.launch
    else:
        W, fn = wrap.kernel_width(C), wrap.launch
    return wrap.pad_args(*args, W), fn


def versions(sources, layouts) -> list:
    """(source, layout) of each version: every source at each layout its
    wrapper takes (an earlier wrapper without the wide layout: the plan's
    only)."""
    out = []
    for src in sources:
        takes = hasattr(wrapper(src, "sa_stage"), "launch_wide")
        for lay in layouts:
            if lay == "plan" or takes:
                out.append((src, lay))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--bf16", action="store_true",
                    help="versions of csrc/sa_stage_bf16.cu on bf16 inputs")
    ap.add_argument("--mul", type=int, default=4,
                    help="width multiplier: 4 the flagship, 8 the 7M model, "
                    "16 SA widths 512 / 1024 / 2048")
    ap.add_argument("--widths", default=None,
                    help="random stages of SA3's geometry at these widths "
                         "(instead of a model's three stages)")
    ap.add_argument("--layout", action="append", choices=("plan", "wide"),
                    help="the plan's layout (default) or the wide layout; "
                         "both: each source timed both ways")
    args = ap.parse_args(argv)
    widths = parse_widths(args.widths) if args.widths else None
    if not torch.cuda.is_available():
        raise SystemExit("ab_sa needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    built = dict(zip(args.sources, build(args.sources)))
    vers = versions(args.sources, list(dict.fromkeys(args.layout or ["plan"])))
    libs = [built[src] for src, _ in vers]
    wraps = [wrapper(src, "sa_stage") for src, _ in vers]
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    stages = ([width_inputs(C, dtype=dtype) for C in widths] if widths
              else stage_inputs(dtype=dtype, mul=args.mul))
    plain = [sa.sa_convmax_reference(*a).float() for a in stages]
    # each version's stages as its wrapper pads them, and its launch
    padded = [[laid_out(wraps[i], a, lay) for a in stages]
              for i, (_, lay) in enumerate(vers)]

    def call(i, j):
        a, fn = padded[i][j]
        return fn(*a, library=libs[i])

    errs, host_us, plans, outs = ([[] for _ in vers] for _ in range(4))
    for i in range(len(vers)):
        native = libs[i].get()
        for j, want in enumerate(plain):
            a = padded[i][j][0]
            got = call(i, j)[..., :want.shape[-1]].float()
            torch.cuda.synchronize()
            outs[i].append(got)
            errs[i].append((got - want).abs().max().item()
                           / max(1.0, want.abs().max().item()))
            entry = "pcr_sa_bf16_layout" if args.bf16 else "pcr_sa_f32_layout"
            reader = getattr(wraps[i], "kernel_plan_bf16" if args.bf16
                             else "kernel_plan_f32", None)
            how = (reader(a[0].shape[2], a[2].shape[2], native)
                   if reader and hasattr(native, entry) else None)
            plans[i].append(how._asdict() if how else None)
            enqueue = []
            for _ in range(20):
                t0 = time.perf_counter()
                call(i, j)
                enqueue.append((time.perf_counter() - t0) * 1e6)
            torch.cuda.synchronize()
            host_us[i].append(statistics.median(enqueue))
    times = [[[] for _ in stages] for _ in vers]
    for r in range(args.rounds):
        order = list(range(len(vers)))
        for i in (order if r % 2 == 0 else order[::-1]):
            for j in range(len(stages)):
                times[i][j].append(time_ms(lambda: call(i, j), args.iters))
    for i, (src, lay) in enumerate(vers):
        med = [statistics.median(t) for t in times[i]]
        vs_first = [(x - y).abs().max().item()
                    for x, y in zip(outs[i], outs[0])]
        print(json.dumps(dict(source=src, layout=lay, card=card,
                              dtype=str(dtype), mul=args.mul,
                              widths=[a[0].shape[2] for a in stages],
                              median_ms=med, sum_ms=sum(med),
                              all_ms=times[i], rel_err=errs[i],
                              vs_first=vs_first, host_us=host_us[i],
                              plan=plans[i],
                              ptxas=_lib.ptxas_usage(libs[i].build_log))),
              flush=True)


if __name__ == "__main__":
    main()
