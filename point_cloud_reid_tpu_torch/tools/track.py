"""Run the port's TrackingManager on synthetic scenes and print track counts.

The synthetic generator is the JAX package's tools/track.py one (constant-
velocity objects with birth/death windows, detector position noise,
dropout and false positives). Weights are random from --seed: the tracks
exercise the pipeline, not a trained model.

    python -m point_cloud_reid_tpu_torch.tools.track
        [--scenes 2 --frames 10 --objects 16] [--sparse auto|always|never]
        [--image]

Runs the flagship at full width on the CUDA device; without one it exits.
With --image it tracks with the image model (deit-tiny-no-pt at full width)
on the bench's six-camera scene (tools/scenes.py image_scene: --objects
boxes around a ring of 900 x 1600 uint8 cameras).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--objects", type=int, default=16)
    p.add_argument("--pts-per-obj", type=int, default=400)
    p.add_argument("--fp-rate", type=float, default=0.1)
    p.add_argument("--dropout", type=float, default=0.05)
    p.add_argument("--num-classes", type=int, default=3)
    p.add_argument("--sparse", default="auto",
                   choices=("auto", "always", "never"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--image", action="store_true",
                   help="track camera crops with the image model")
    return p.parse_args(argv)


def synth_scene(rs: np.random.RandomState, args):
    """Constant-velocity objects with birth/death windows + a detector model
    (position noise, dropout, false positives). Yields per-frame
    (points, boxes, scores, labels)."""
    n = args.objects
    cls = rs.randint(0, args.num_classes, n)
    sizes = (rs.rand(n, 3) * 2 + 1.5).astype(np.float32)
    pos = (rs.rand(n, 3) * 50 - 25).astype(np.float32)
    pos[:, 2] = 0.0
    vel = (rs.randn(n, 2) * 0.15).astype(np.float32)
    birth = rs.randint(0, max(args.frames // 3, 1), n)
    death = rs.randint(2 * args.frames // 3, args.frames + 1, n)
    for t in range(args.frames):
        pos[:, :2] += vel
        live = (birth <= t) & (t < death)
        det = live & (rs.rand(n) >= args.dropout)
        boxes = np.concatenate(
            [pos[det] + rs.randn(det.sum(), 3).astype(np.float32) * 0.1,
             sizes[det],
             np.zeros((det.sum(), 1), np.float32)], axis=1)
        n_fp = rs.poisson(args.fp_rate * n)
        if n_fp:
            fp_pos = (rs.rand(n_fp, 3) * 50 - 25).astype(np.float32)
            fp_pos[:, 2] = 0.0
            boxes = np.concatenate([boxes, np.concatenate(
                [fp_pos, np.full((n_fp, 3), 2.0, np.float32),
                 np.zeros((n_fp, 1), np.float32)], axis=1)], axis=0)
        scores = np.ones(len(boxes), np.float32)
        labels = np.concatenate([cls[det],
                                 rs.randint(0, args.num_classes, n_fp)])
        centers = pos[live]
        pts = (np.repeat(centers, args.pts_per_obj, axis=0)
               + rs.randn(live.sum() * args.pts_per_obj, 3)
               .astype(np.float32) * 0.3)
        yield pts, boxes.astype(np.float32), scores, labels


def main(argv=None):
    args = parse_args(argv)
    from point_cloud_reid_tpu_torch.inference import PairScorer
    from point_cloud_reid_tpu_torch.tools.scenes import (build_tracker_model,
                                                         image_scene)
    from point_cloud_reid_tpu_torch.tracking import TrackingManager

    if not torch.cuda.is_available():
        raise SystemExit("tools.track needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    model = build_tracker_model(args.image, device, args.seed)
    mgr = TrackingManager(PairScorer(model, image_mode=args.image),
                          subsample_number=128, seed=args.seed,
                          sparse_scoring=args.sparse)
    rs = np.random.RandomState(args.seed)
    times = []
    for s in range(args.scenes):
        scene = (image_scene(args.objects, args.frames, args.seed + s)
                 if args.image else synth_scene(rs, args))
        for t, (pts, boxes, scores, labels) in enumerate(scene):
            t0 = time.perf_counter()
            tracks = mgr.step(pts, boxes, scores, labels)
            times.append(time.perf_counter() - t0)
            print(json.dumps(dict(scene=s, frame=t, detections=len(boxes),
                                  live_tracks=len(mgr.store),
                                  confirmed=len(tracks))))
        mgr.reset()
    print(json.dumps(dict(frames=len(times), device=str(device),
                          median_step_ms=float(np.median(times) * 1e3))))


if __name__ == "__main__":
    main()
