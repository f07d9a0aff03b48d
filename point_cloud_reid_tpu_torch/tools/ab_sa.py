"""A/B timing of versions of the SA-stage kernel (csrc/sa_stage.cu, or with
--bf16 csrc/sa_stage_bf16.cu) in one process on one card.

Each SOURCE is a version of the kernel's file with its C entry point
(`pcr_sa_convmax`, or `pcr_sa_convmax_bf16` with --bf16; the arguments of
the first version), for example the parent commit's file from `git show`.
Each is built as a kernels/_lib.Library of its own from that one source and
the headers beside it (seconds, against ~50 s for the whole library), all
built together, and launched through kernels/sa_stage.launch, the wrapper's
checked launch (a bf16 version that exports `pcr_sa_bf16_layout` is held
to kernels/sa_stage.plan_bf16). Every version runs the three eval SA stages
on 128 seeded crops of 128 points, at the flagship's widths (SA1 / SA2 /
SA3: N, S, K, C = 128, 128, 32, 128 / 128, 64, 48, 256 / 64, 32, 48, 512)
or with --mul 8 the 7M model's (C = 256 / 512 / 1024; its SA stages are the
flagship's at mul 8), or with --mul 16 the `mul16` width's (C = 512 / 1024
/ 2048: SA3 on the float32 kernel's h1-from-gather layout and the bf16
kernel's mma_sync tier); seed-0 weights of a model of that dtype; each stage
fed by the one before, as in the backbone. Versions are timed in turns
(first to last, then last to first, `--rounds` times) with CUDA events,
each output is compared with the plain version and with the first
version's, and the host time of one call (its enqueue, the card busy) is
taken. Prints one JSON line per version with the card's name and power
limit: per stage the median ms over rounds, all rounds, the error against
the plain version (relative to max(1, |plain|)), the largest difference
from the first version's output (`vs_first`), the median host us a call
and, at bf16, the plan the build reports (null for a build without
`pcr_sa_bf16_layout`).

    python -m point_cloud_reid_tpu_torch.tools.ab_sa SOURCE [SOURCE ...]
        [--rounds 5] [--iters 10] [--bf16] [--mul 8|16]

Needs a CUDA device and nvcc. TF32 off.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..kernels import sa_stage as sa
from .ab_match import build
from .scenes import card_name
from .timing import time_ms


def stage_inputs(B: int = 128, seed: int = 0, device="cuda",
                 dtype: torch.dtype = torch.float32, mul: int = 4) -> list:
    """kernels/sa_stage.launch's arguments for the three eval SA stages of
    the flagship at `mul` (4: its own widths; 8: the 7M model's; 16: SA
    widths 512 / 1024 / 2048) on B seeded crops of 128 points, a model of
    `dtype` (bf16: A and Ct bf16), laid out as the wrapper hands them to
    the kernel (sa_stage.pad_args at kernel_width)."""
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_sa needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    libs = build(args.sources)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    stages = stage_inputs(dtype=dtype, mul=args.mul)
    plain = [sa.sa_convmax_reference(*a).float() for a in stages]
    errs, host_us, plans, outs = [], [], [], []
    for lib in libs:
        errs.append([])
        host_us.append([])
        plans.append([])
        outs.append([])
        for a, want in zip(stages, plain):
            got = sa.launch(*a, library=lib).float()
            torch.cuda.synchronize()
            outs[-1].append(got)
            errs[-1].append((got - want).abs().max().item()
                            / max(1.0, want.abs().max().item()))
            if args.bf16:
                native = lib.get()
                how = (sa.kernel_plan_bf16(a[0].shape[2], a[2].shape[2],
                                           native)
                       if hasattr(native, "pcr_sa_bf16_layout") else None)
                plans[-1].append(how._asdict() if how else None)
            enqueue = []
            for _ in range(20):
                t0 = time.perf_counter()
                sa.launch(*a, library=lib)
                enqueue.append((time.perf_counter() - t0) * 1e6)
            torch.cuda.synchronize()
            host_us[-1].append(statistics.median(enqueue))
    times = [[[] for _ in stages] for _ in libs]
    for r in range(args.rounds):
        order = list(range(len(libs)))
        for i in (order if r % 2 == 0 else order[::-1]):
            for j, a in enumerate(stages):
                times[i][j].append(time_ms(
                    lambda: sa.launch(*a, library=libs[i]), args.iters))
    for i, src in enumerate(args.sources):
        med = [statistics.median(t) for t in times[i]]
        vs_first = [(x - y).abs().max().item()
                    for x, y in zip(outs[i], outs[0])]
        print(json.dumps(dict(source=src, card=card, dtype=str(dtype),
                              mul=args.mul, median_ms=med, sum_ms=sum(med),
                              all_ms=times[i], rel_err=errs[i],
                              vs_first=vs_first, host_us=host_us[i],
                              plan=plans[i] if args.bf16 else None)),
              flush=True)


if __name__ == "__main__":
    main()
