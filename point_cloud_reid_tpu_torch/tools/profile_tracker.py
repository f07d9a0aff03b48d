"""Where a tracker frame's time goes on the GPU.

Runs TrackingManager.step over the bench's drifting-objects scene (bench.py
_bench_tracker_e2e: n objects x pts-per-obj points, 2 m boxes, 0.2 m/frame
drift) with the flagship model at full width and seeded random weights,
then profiles the steady-state frames with torch.profiler and prints one
JSON line: median step ms (host clock around a synchronised step), device
time per kernel name, the device's copy time (host to device uploads and the
logits coming back), the share of the profiled window the device was busy
with kernels, and the card's name and power limit.

    python -m point_cloud_reid_tpu_torch.tools.profile_tracker
        [--objects 96] [--pts-per-obj 600] [--frames 10] [--warmup 4]
        [--sparse auto|never|always] [--trace build/profile_trace.json]
        [--image] [--host-cache] [--bf16] [--experiment LEAF]

With --image the frame is the image tracker's: the image model
(deit-tiny-no-pt at full width) on the bench's six-camera scene (bench.py
_bench_image_tracker_e2e: --objects boxes, default 64, six 900 x 1600 uint8
cameras), the frame's upload inside the step's clock. With --host-cache the
manager keeps track features in its host FeatureCache (device_cache=False):
they go up every frame and the detections' features come back. With --bf16
the model computes in bf16 (the bf16 kernels), as tools/track.py --bf16.
With --experiment a registered point leaf stands in for the flagship (the
7M model: pts_point-transformer-7M_point-cat_nus_det_4x256_500e).

Needs a CUDA device. match_threshold is 1.0: random weights give arbitrary
logits, and accepting every gated pair keeps the track set at the scene's
objects, as a trained model would.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch

from .scenes import (bench_scene, build_tracker_model, card_name,
                     image_scene)


def _busy_us(events) -> float:
    """Length of the union of [ts, ts + dur) intervals, in microseconds."""
    busy, end = 0.0, -1.0
    for ts, dur in sorted(events):
        if ts >= end:
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
    return busy


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--image", action="store_true",
                   help="profile the image tracker's frame")
    p.add_argument("--objects", type=int, default=None,
                   help="default 96, with --image 64")
    p.add_argument("--pts-per-obj", type=int, default=600)
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--warmup", type=int, default=4)
    p.add_argument("--sparse", default="auto",
                   choices=("auto", "always", "never"))
    p.add_argument("--host-cache", action="store_true",
                   help="device_cache=False: the host FeatureCache frame")
    p.add_argument("--bf16", action="store_true",
                   help="the model at a bf16 compute dtype")
    p.add_argument("--experiment", default=None,
                   help="a point leaf in place of the flagship")
    p.add_argument("--trace", default="build/profile_trace.json",
                   help="where the profiled window's chrome trace goes")
    args = p.parse_args(argv)
    if args.objects is None:
        args.objects = 64 if args.image else 96
    if not torch.cuda.is_available():
        raise SystemExit("profile_tracker needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile

    from point_cloud_reid_tpu_torch.inference import PairScorer
    from point_cloud_reid_tpu_torch.tracking import TrackingManager

    model = build_tracker_model(args.image, "cuda", dtype=(
        torch.bfloat16 if args.bf16 else torch.float32),
        experiment=args.experiment)
    mgr = TrackingManager(PairScorer(model, image_mode=args.image),
                          subsample_number=128, match_threshold=1.0,
                          sparse_scoring=args.sparse,
                          device_cache=not args.host_cache)
    if args.image:
        frames = list(image_scene(args.objects, args.frames))
    else:
        frames = list(bench_scene(args.objects, args.pts_per_obj,
                                  args.frames))
    times = []

    def step(frame):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.step(*frame)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    for frame in frames[:args.warmup]:
        step(frame)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for frame in frames[args.warmup:]:
            step(frame)
        window_us = (time.perf_counter() - t0) * 1e6
    n_prof = len(frames) - args.warmup
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    with open(args.trace) as f:
        trace = json.load(f)
    per_kernel = defaultdict(float)
    intervals = []
    memcpy_ms = 0.0
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") == "kernel":
            per_kernel[ev["name"][:80]] += ev["dur"] / 1e3 / n_prof
            intervals.append((ev["ts"], ev["dur"]))
        elif ev.get("cat") == "gpu_memcpy":
            memcpy_ms += ev["dur"] / 1e3 / n_prof
    if not intervals:
        raise RuntimeError("the profiler recorded no device kernels")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps(dict(
        card=card_name(), image=args.image, sparse=args.sparse,
        host_cache=args.host_cache, dtype=str(model.dtype),
        experiment=args.experiment,
        objects=args.objects,
        active_tracks=len(mgr.store.active()),
        step_ms=times, median_steady_step_ms=float(np.median(times[
            args.warmup:])),
        device_ms_per_frame=sum(per_kernel.values()),
        memcpy_ms_per_frame=memcpy_ms,
        device_busy_share=_busy_us(intervals) / window_us,
        kernels_ms_per_frame={k: v for k, v in top})))


if __name__ == "__main__":
    main()
