"""A/B timing of versions of the farthest-point-sampling kernel
(csrc/fps.cu) in one process on one card.

Each SOURCE is a version of csrc/fps.cu, for example the parent commit's
from `git show`. Each is built as a kernels/_lib.Library of its own from
that one source (seconds; all built together, ptxas's register and spill
lines printed) and launched as the wrapper launches it: kernels/fps.launch
with plan(N) for a version with the `pcr_fps_plan` entry point, and for an
older one with the int32 `pcr_fps` its launch plus the wrapper's two casts
(int64 starts to int32, int32 indices to int64), which are then inside the
clock; such a version runs only the shapes with N <= 1024, its cap.

Shapes (B, N, npoint): the flagship's three SA stages at 128 crops
(serving) and at 512 (the train batch of 256 pairs), N = 1024 at 128
crops, dense crops of 2048 points at 512, and a 20,000-point cloud at 4.
Every version's indices are compared with the plain loop on
exact-arithmetic, duplicated and random seeded clouds (mismatches, want 0);
times are taken on the random ones, versions in turns (first to last, then
last to first, `--rounds` times), as chip_smoke.py times them
(tools/timing): `ms` by CUDA events around `--iters` calls made one after
another from Python, which the host can pace, `device_ms` by a CUDA graph
of as many calls, and `round_us` = device_ms / (npoint - 1) in us.
`--sweep` also times, for each version with `pcr_fps_plan`, tier W (a
warp a cloud, forced up to the 1024 points of its largest instantiation)
against tier BLOCK at N = 128 to 1024 and B = 128 and 512, and tiers
BLOCK, L2 and SCRATCH at N = 8192 and L2 and SCRATCH at 20,000 (B = 4),
each plan's indices checked the same way: the sweep behind
kernels/fps.py's tier boundaries. Prints one
JSON line per version with the card's name and power limit.

    python -m point_cloud_reid_tpu_torch.tools.ab_fps SOURCE [SOURCE ...]
        [--rounds 5] [--iters 20] [--sweep]

Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics

import numpy as np
import torch

from ..kernels import _lib
from ..kernels import fps as kf
from .ab_match import build
from .scenes import card_name, knn_cloud
from .timing import graph_ms, time_ms

KINDS = ("exact", "duplicates", "random")
# (B, N, npoint)
SHAPES = ((128, 128, 128), (128, 128, 64), (128, 64, 32),
          (512, 128, 128), (512, 128, 64), (512, 64, 32),
          (128, 1024, 256), (512, 2048, 512), (4, 20000, 1024))
OLD_MAX_N = 1024        # the int32 kernel's cap
SWEEP_N = (128, 256, 512, 1024)
SWEEP_B = (128, 512)


def inputs(B: int, N: int, seed: int = 0, device="cuda") -> dict:
    """{kind: (xyz, start)}: seeded clouds of tools/scenes.knn_cloud and
    int64 start indices, as ops/geometry.py draws them."""
    start = torch.from_numpy(np.random.RandomState(seed).randint(0, N, B))
    return {kind: (torch.from_numpy(knn_cloud(kind, B, N, seed)).to(device),
                   start.to(device)) for kind in KINDS}


def fps_call(lib):
    """FPS as the wrapper calls one version: a plan and int64 straight from
    a kernel with `pcr_fps_plan`; from an older int32 `pcr_fps`, its launch
    and the two casts the wrapper then made. Returns (call, old)."""
    handle = lib.get()
    if hasattr(handle, "pcr_fps_plan"):
        return (lambda xyz, npoint, start, how=None:
                kf.launch(xyz, npoint, start, how, library=lib)), False
    fn = handle.pcr_fps
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(xyz, npoint, start, how=None):
        B, N, _ = xyz.shape
        first = start.to(torch.int32)
        out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
        _lib.check(fn(xyz.data_ptr(), first.data_ptr(), out.data_ptr(), B, N,
                      npoint, _lib.stream_ptr(xyz.device)), "pcr_fps")
        return out.long()
    return call, True


def mismatches(call, clouds: dict, npoint: int, how=None) -> int:
    """Indices that differ from the plain loop's, over all kinds of cloud."""
    bad = 0
    for xyz, start in clouds.values():
        got = call(xyz, npoint, start, how)
        want = kf.fps_reference(xyz, npoint, start)
        torch.cuda.synchronize()
        if got.dtype != torch.int64 or got.shape != want.shape:
            raise RuntimeError(f"fps gave {got.dtype} {tuple(got.shape)}")
        bad += int((got != want).sum())
    return bad


def times(fn, npoint: int, iters: int) -> dict:
    dev = graph_ms(fn, iters)
    return dict(ms=time_ms(fn, iters), device_ms=dev,
                round_us=dev / max(npoint - 1, 1) * 1e3)


def sweep_cases():
    """(B, N, npoint, tiers) that the sweep times against each other: tier
    W against BLOCK, then the tiers on either side of BLOCK's and L2's
    reach."""
    cases = []
    for B in SWEEP_B:
        for N in SWEEP_N:
            tiers = ((kf.WARP, kf.BLOCK) if N <= 32 * max(kf.WARP_POINTS)
                     else (kf.BLOCK,))
            cases.append((B, N, N // 2 if N <= 128 else N // 4, tiers))
    return cases + [(4, 8192, 256, (kf.BLOCK, kf.L2, kf.SCRATCH)),
                    (4, 20000, 256, (kf.L2, kf.SCRATCH))]


def sweep(call, iters: int) -> dict:
    out = {}
    for B, N, npoint, tiers in sweep_cases():
        clouds = inputs(B, N, seed=N)
        xyz, start = clouds["random"]
        for tier in tiers:
            how = kf.plan(N, tier)
            res = times(lambda: call(xyz, npoint, start, how), npoint, iters)
            res["mismatches"] = mismatches(call, clouds, npoint, how)
            out[f"B{B}_N{N}_np{npoint}_{kf.TIER_NAMES[tier]}"] = res
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_fps needs a CUDA device")
    card = card_name()
    libs = build(args.sources)
    calls = [fps_call(lib) for lib in libs]
    shapes = [(B, N, npoint, inputs(B, N, seed=i))
              for i, (B, N, npoint) in enumerate(SHAPES)]

    def runs(old):
        return [s for s in shapes if not old or s[1] <= OLD_MAX_N]
    checks = [{f"B{B}_N{N}_np{npoint}": mismatches(call, clouds, npoint)
               for B, N, npoint, clouds in runs(old)}
              for call, old in calls]
    res = [{} for _ in libs]
    for r in range(args.rounds):
        order = list(range(len(libs)))
        for i in (order if r % 2 == 0 else order[::-1]):
            call, old = calls[i]
            for B, N, npoint, clouds in runs(old):
                xyz, start = clouds["random"]
                t = times(lambda: call(xyz, npoint, start), npoint,
                          args.iters)
                for key, v in t.items():
                    res[i].setdefault(f"B{B}_N{N}_np{npoint}", {}).setdefault(
                        key, []).append(v)
    for i, src in enumerate(args.sources):
        call, old = calls[i]
        shape_res = {}
        for name, bad in checks[i].items():
            t = res[i].get(name, {})
            shape_res[name] = dict(
                {k: statistics.median(v) for k, v in t.items()},
                all_device_ms=t.get("device_ms", []), mismatches=bad)
        line = dict(kernel="fps", source=src, card=card, int32_entry=old,
                    shapes=shape_res,
                    mismatches=sum(checks[i].values()))
        if args.sweep and not old:
            line["sweep"] = sweep(call, args.iters)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
