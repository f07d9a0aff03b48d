"""A/B timing of versions of the kNN kernel (csrc/knn.cu, or its channel
tier csrc/knn_channels.cu) and the linear-attention kernel
(csrc/linear_attention.cu) in one process on one card.

Each SOURCE is a version of one of the three files, for example the parent
commit's from `git show`, or a version of csrc/knn_channels.cu unpacked
with its tree from `git archive`. Each is built as a kernels/_lib.Library
of its own from that one source (seconds; all built together, ptxas's
register and spill lines printed) and launched as the wrapper launches it: through the kernels/knn.launch of the source's own
tree (tools/ab_match.wrapper; this package's for a source outside one) for
a version with the int64 entry point `pcr_knn_i64` or the channel tier's
`pcr_knn_channels`, so each version of the channel tier runs under its own
plan and shared bytes; for an older one with the int32 `pcr_knn` its
launch plus the wrapper's cast to int64, which is then inside the clock;
kernels/linear_attention.launch for attention. The training path's
shapes: kNN at the flagship's three SA stages on 512 crops (S, N, k = 128,
128, 32 / 64, 128, 48 / 32, 64, 48); the channel tier at DGCNN's
feature-space kNN at 256 pairs of 2048-point crops (512 clouds, every
point a query; C = 64 and 128, k = 20, float32 and bf16), then at float32
with k (1, 8, 48) and C (16, 32, 256) apart, the running top-k's share of
the time against the products'; both on exact-arithmetic, duplicated and
random seeded clouds, timed on the random ones; attention at the cross
stages' (B, L, S, H, D, V) = (256, 128, 128, 2, 32, 32), q and k / v views
of fused projections as the model hands them over, three input sets (more
than the 50 MB L2) in rotation. `--N` sets the crop size (SA1's kNN over N
points, attention at L = S = N: a point-count ablation's shapes; kNN
versions from before the tiers take N <= 128 only; the channel tier keeps
DGCNN's 2048) and `--C` the cross stages' width (D = V = C / 2: --C 128 for
the 1.5M and 7M models).
Versions are timed in turns (first to last,
then last to first, `--rounds` times), as chip_smoke.py times them
(tools/timing): `median_ms` by CUDA events around `--iters` calls made one
after another from Python, which the host can pace, and `device_ms` by a
CUDA graph of as many calls. Every output is
compared with the plain version: kNN index mismatches on exact and
duplicated inputs (want 0) and near-tie swaps on random ones, attention's
error relative to max(1, |plain|); and each kNN version's indices against
the first version's on every input (`equal_to_first`: want every float32
input equal, as a redesign of the channel tier keeps the first version's
float32 order). Prints one JSON line per version with the card's name and
power limit.

    python -m point_cloud_reid_tpu_torch.tools.ab_train_kernels
        [--knn SOURCE ...] [--attention SOURCE ...] [--rounds 5]
        [--iters 20] [--N 128] [--C 64]

Needs a CUDA device and nvcc. Float32, TF32 off; bf16 products summed in
float32 (cuBLAS's reduced-precision bf16 reduction off), as the channel
tier and JAX sum them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics

import numpy as np
import torch

from ..kernels import _lib
from ..kernels import knn as kk
from ..kernels import linear_attention as la
from .ab_match import build, wrapper
from .scenes import card_name, knn_cloud
from .timing import graph_ms, time_ms

KNN_KINDS = ("exact", "duplicates", "random")
KNN_TIE = 1e-6         # a swap needs plain distances this close (relative)
KNN_BF16_TIE = 2 ** -5  # at bf16: two roundings to the neighbouring value
# the channel tier's (C, k, dtype) on 512 clouds of 2048 points: DGCNN's
# blocks 2-4 at both dtypes, then k and C apart
CHANNEL_CLOUDS, CHANNEL_POINTS = 512, 2048
CHANNEL_STAGES = ((64, 20, "float32"), (128, 20, "float32"),
                  (64, 20, "bfloat16"), (128, 20, "bfloat16"),
                  (64, 1, "float32"), (64, 8, "float32"), (64, 48, "float32"),
                  (16, 20, "float32"), (32, 20, "float32"),
                  (256, 20, "float32"))


def knn_stages(crop: int = 128):
    """(S, N, k) of the flagship's three SA stages on crops of `crop`
    points: S centres among the previous stage's points (the crop's for
    SA1), k neighbours."""
    from ..configs import point_transformer_point_cat
    cfg = point_transformer_point_cat()
    centres = cfg["backbone_list"]
    points = [crop] + centres[:-1]
    return list(zip(centres, points, cfg["backbone"]["nsample"]))


def knn_inputs(B: int = 512, seed: int = 0, device="cuda",
               crop: int = 128) -> list:
    """Per SA stage (S, N, k, {kind: (queries, points)}): the first S points
    of each seeded cloud are its queries."""
    out = []
    for i, (S, N, k) in enumerate(knn_stages(crop)):
        clouds = {}
        for kind in KNN_KINDS:
            xyz = torch.from_numpy(knn_cloud(kind, B, N, seed + i)).to(device)
            clouds[kind] = (xyz[:, :S].contiguous(), xyz)
        out.append((S, N, k, clouds))
    return out


def channel_inputs(B: int = CHANNEL_CLOUDS, N: int = CHANNEL_POINTS,
                   seed: int = 0, device="cuda") -> list:
    """Per CHANNEL_STAGES entry (name, k, {kind: (queries, points)}): B
    seeded clouds of N points of C channels in the stage's dtype, every
    point a query."""
    out = []
    for i, (C, k, dtype) in enumerate(CHANNEL_STAGES):
        clouds = {}
        for kind in KNN_KINDS:
            x = torch.from_numpy(knn_cloud(kind, B, N, seed + i, C)).to(
                device, getattr(torch, dtype))
            clouds[kind] = (x, x)
        out.append((f"C{C}_k{k}_{dtype}", k, clouds))
    return out


def attention_inputs(B: int = 256, L: int = 128, S: int = 128, H: int = 2,
                     D: int = 32, V: int = 32, sets: int = 3, seed: int = 0,
                     device="cuda") -> list:
    """`sets` seeded (q, k, v): q contiguous, k and v the two halves of one
    (B, S, H, D + V) projection, as the cross stages' fused kv gives
    them."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(sets):
        q = torch.from_numpy(rs.randn(B, L, H, D).astype(np.float32))
        kv = torch.from_numpy(rs.randn(B, S, H, D + V).astype(np.float32))
        q, kv = q.to(device), kv.to(device)
        out.append((q, kv[..., :D], kv[..., D:]))
    return out


def knn_call(lib, source: str = None):
    """kNN as the wrapper calls one version: int64 straight from a kernel
    with `pcr_knn_i64` or `pcr_knn_channels`, through the kernels/knn.launch
    of the source's tree (this package's without a source); from an older
    int32 `pcr_knn`, its launch and the cast the wrapper then made."""
    handle = lib.get()
    if hasattr(handle, "pcr_knn_i64") or hasattr(handle, "pcr_knn_channels"):
        tree = kk if source is None else wrapper(source, "knn")
        return lambda q, xyz, k: tree.launch(q, xyz, k, library=lib)
    fn = handle.pcr_knn
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(q, xyz, k):
        B, S, _ = q.shape
        out = torch.empty((B, S, k), dtype=torch.int32, device=q.device)
        _lib.check(fn(q.data_ptr(), xyz.data_ptr(), out.data_ptr(), B, S,
                      xyz.shape[1], k, _lib.stream_ptr(q.device)), "pcr_knn")
        return out.long()
    return call


def knn_check(got, q, xyz, k, clouds: int = 64) -> tuple:
    """(mismatches, swaps beyond a near-tie, largest plain-distance gap)
    against the plain stable argsort (in the inputs' dtype), `clouds`
    clouds at a time."""
    tie = KNN_BF16_TIE if q.dtype == torch.bfloat16 else KNN_TIE
    n_bad = n_far = 0
    gap = 0.0
    for b in range(0, q.shape[0], clouds):
        qb, xb, gb = q[b:b + clouds], xyz[b:b + clouds], got[b:b + clouds]
        want = kk.knn_reference(qb, xb, k)
        bad = gb != want
        dist = kk.square_distance(qb, xb).float()
        dg, dw = dist.gather(-1, gb), dist.gather(-1, want)
        del dist
        diff = (dg - dw).abs()
        n_bad += int(bad.sum())
        n_far += int((diff[bad] > tie * dw.abs()[bad].clamp(min=1.0)).sum())
        gap = max(gap, float(diff.max()))
    return n_bad, n_far, gap


def run_knn(sources, rounds: int, iters: int, card: str,
            crop: int = 128) -> None:
    libs = build(sources)
    calls = [knn_call(lib, src) for lib, src in zip(libs, sources)]
    if hasattr(libs[0].get(), "pcr_knn_channels"):
        stages = channel_inputs()
    else:
        stages = [(f"S{S}_N{N}_k{k}", k, clouds)
                  for S, N, k, clouds in knn_inputs(crop=crop)]
    checks = [{} for _ in calls]
    same = [{} for _ in calls]
    for name, k, clouds in stages:
        for kind, (q, xyz) in clouds.items():
            first = None
            for i, call in enumerate(calls):
                got = call(q, xyz, k)
                torch.cuda.synchronize()
                if got.dtype != torch.int64 or got.shape != (*q.shape[:2], k):
                    raise RuntimeError(f"knn gave {got.dtype} {got.shape}")
                checks[i][f"{name}_{kind}"] = knn_check(got, q, xyz, k)
                if first is None:
                    first = got
                same[i][f"{name}_{kind}"] = bool(torch.equal(got, first))
                del got
            del first
    times = [[[] for _ in stages] for _ in libs]
    device = [[[] for _ in stages] for _ in libs]
    for r in range(rounds):
        order = list(range(len(libs)))
        for i in (order if r % 2 == 0 else order[::-1]):
            for j, (_, k, clouds) in enumerate(stages):
                q, xyz = clouds["random"]
                times[i][j].append(time_ms(
                    lambda: calls[i](q, xyz, k), iters))
                device[i][j].append(graph_ms(
                    lambda: calls[i](q, xyz, k), iters))
    for i, src in enumerate(sources):
        med = [statistics.median(t) for t in times[i]]
        dev = [statistics.median(t) for t in device[i]]
        res = checks[i]
        f32 = [key for key in same[i] if "bfloat16" not in key]
        print(json.dumps(dict(
            kernel="knn", source=src, card=card, crops=512,
            stages=[name for name, _, _ in stages],
            median_ms=med, sum_ms=sum(med), all_ms=times[i],
            device_ms=dev, device_sum_ms=sum(dev), device_all_ms=device[i],
            exact_mismatches=sum(v[0] for key, v in res.items()
                                 if not key.endswith("random")),
            random_swaps=sum(v[0] for key, v in res.items()
                             if key.endswith("random")),
            beyond_near_tie=sum(v[1] for v in res.values()),
            max_gap=max(v[2] for v in res.values()),
            f32_equal_to_first=all(same[i][key] for key in f32),
            equal_to_first=same[i], checks=res)),
            flush=True)


def run_attention(sources, rounds: int, iters: int, card: str,
                  rows: int = 128, width: int = 64) -> None:
    libs = build(sources)
    shape = dict(B=256, L=rows, S=rows, H=2, D=width // 2, V=width // 2)
    sets = attention_inputs(**shape)
    errs = []
    for lib in libs:
        err = 0.0
        for q, k, v in sets:
            got = la.launch(q, k, v, library=lib)
            want = la.linear_attention_reference(q, k, v)
            torch.cuda.synchronize()
            err = max(err, (got - want).abs().max().item()
                      / max(1.0, want.abs().max().item()))
        errs.append(err)
    times = [[] for _ in libs]
    device = [[] for _ in libs]
    for r in range(rounds):
        order = list(range(len(libs)))
        for i in (order if r % 2 == 0 else order[::-1]):
            turn = iter(range(10 ** 9))

            def call():
                la.launch(*sets[next(turn) % len(sets)], library=libs[i])
            times[i].append(time_ms(call, iters))
            device[i].append(graph_ms(call, iters))
    for i, src in enumerate(sources):
        print(json.dumps(dict(
            kernel="linear_attention", source=src, card=card,
            shape=shape,
            median_ms=statistics.median(times[i]), all_ms=times[i],
            device_ms=statistics.median(device[i]), device_all_ms=device[i],
            rel_err=errs[i])), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--knn", nargs="*", default=[])
    ap.add_argument("--attention", nargs="*", default=[])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--N", type=int, default=128,
                    help="points a crop (SA1's kNN, attention's rows)")
    ap.add_argument("--C", type=int, default=64,
                    help="the cross stages' width (attention D = V = C / 2)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_train_kernels needs a CUDA device")
    if not (args.knn or args.attention):
        raise SystemExit("give --knn and/or --attention sources")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_name()
    if args.knn:
        run_knn(args.knn, args.rounds, args.iters, card, args.N)
    if args.attention:
        run_attention(args.attention, args.rounds, args.iters, card, args.N,
                      args.C)


if __name__ == "__main__":
    main()
