"""A/B timing of versions of the SA-stage kernel (csrc/sa_stage.cu) in one
process on one card.

Each SOURCE is a version of csrc/sa_stage.cu with its C entry point
`pcr_sa_convmax` (its arguments are those of the first version), for
example the parent commit's file from `git show`. Each is built as a
kernels/_lib.Library of its own from that one source and the headers beside
it (seconds, against ~50 s for the whole library), all built together, and
launched through kernels/sa_stage.launch, the wrapper's checked launch.
Every version runs the flagship's three eval SA stages on 128 seeded crops
of 128 points (SA1 / SA2 / SA3: N, S, K, C = 128, 128, 32, 128 / 128, 64,
48, 256 / 64, 32, 48, 512; seed-0 weights; each stage fed by the one
before, as in the backbone). Versions are timed in turns (first to last,
then last to first, `--rounds` times) with CUDA events, each output is
compared with the plain version, and the host time of one call (its
enqueue, the card busy) is taken. Prints one JSON line per version with
the card's name and power limit: per stage the median ms over rounds, all
rounds, the error and the median host us a call.

    python -m point_cloud_reid_tpu_torch.tools.ab_sa SOURCE [SOURCE ...]
        [--rounds 5] [--iters 10]

Needs a CUDA device and nvcc. Float32, TF32 off.
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


def stage_inputs(B: int = 128, seed: int = 0, device="cuda") -> list:
    """fused_sa_convmax's arguments for the flagship's three eval SA stages
    on B seeded crops of 128 points."""
    from ..configs import point_transformer_point_cat
    from ..models import build_model
    from ..ops.geometry import knn_indices
    model = build_model(point_transformer_point_cat(), device=device,
                        generator=torch.Generator().manual_seed(seed)).eval()
    gen = torch.Generator(device=device).manual_seed(seed)
    xyz = torch.randn((B, 128, 3), generator=gen, device=device) * 0.6
    points, stages = None, []
    with torch.no_grad():
        for mod, S in zip(model.backbone.SA_modules, model.backbone_list):
            cidx = torch.arange(S, device=device).clamp(max=xyz.shape[1] - 1)
            idx = knn_indices(mod.nsample, xyz, xyz[:, cidx])
            stages.append(sa.sa_stage_args(
                xyz, points, idx, [(c.weight, c.bias) for c in mod.mlp_convs],
                [(b.weight, b.bias, b.running_mean, b.running_var)
                 for b in mod.mlp_bns], mod.mlp_bns[0].eps))
            xyz, points = mod(xyz, points, S)
    return stages


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_sa needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    libs = build(args.sources)
    stages = stage_inputs()
    plain = [sa.sa_convmax_reference(*a) for a in stages]
    errs, host_us = [], []
    for lib in libs:
        errs.append([])
        host_us.append([])
        for a, want in zip(stages, plain):
            got = sa.launch(*a, library=lib)
            torch.cuda.synchronize()
            errs[-1].append((got - want).abs().max().item()
                            / max(1.0, want.abs().max().item()))
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
        print(json.dumps(dict(source=src, card=card, median_ms=med,
                              sum_ms=sum(med), all_ms=times[i],
                              rel_err=errs[i], host_us=host_us[i])),
              flush=True)


if __name__ == "__main__":
    main()
