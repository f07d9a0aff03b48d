"""Tracking CLI of the port: run the ReID tracker over scenes, write
MOT-style outputs and the tracking-eval summary (the JAX package's
tools/track.py).

One TrackingManager.step per frame (device-cache frames: crops + embed +
scoring in one call, gated sparse pair-list scoring under 'auto'; optional
BEV NMS of the detections first); association decisions stream into
TrackingEvalAccumulator whenever the scene has gt ids.

Scenes come from --scene-dir (one .npz per scene, see below) or from the
built-in synthetic generator (constant-velocity objects with birth and
death, detector dropout and false positives), draw for draw the JAX CLI's.

Outputs in --work-dir:
  tracks.jsonl            one line per frame:
                          {"scene", "frame", "tracks": [{"id", "cls",
                           "box" (7), "score"}]}
  tracking_summary.json   TrackingEvalAccumulator.summary()
plus ONE headline JSON line on stdout (the JAX CLI's keys: experiment,
image_mode, frames, scenes, median_step_ms over frames from the 4th on,
wall_hz, association, outputs; and device).

Scene .npz format (per frame index i, point mode):
  boxes_{i} (D,7) [cx cy cz dx dy dz yaw], scores_{i} (D,), labels_{i} (D,)
  points_{i} (N,3+) lidar sweep; gt_ids_{i} (D,) optional (-1 = detector FP)
Image mode replaces points_{i} with images_{i} (ncam,3,H,W) uint8,
lidar2cams_{i} (ncam,4,4), intrinsics_{i} (ncam,3,3).

Usage:
    python -m point_cloud_reid_tpu_torch.tools.track [experiment]
        [--checkpoint ckpt_best.pt] [--scene-dir scenes/]
        [--scenes 2 --frames 40 --objects 16] [--nms-threshold 0.5]
        [--sparse auto|always|never] [--work-dir out/] [--set KEY=VAL]
        [--device cuda|cpu] [--bf16]

The experiment defaults to the point flagship (--image: the image model,
deit-tiny-no-pt). --checkpoint reads what the port's Trainer.save_checkpoint
writes (ckpt_{tag}.pt; its 'model' entry) or a bare model state_dict;
without one the weights are the seeded init (pipeline smoke only). Runs on
the CUDA device; without one it exits, unless --device cpu asks for the
plain versions on the CPU. --bf16 builds the model at a bf16 compute dtype
(float32 weights, bf16 embeddings and logits, the bf16 kernels), as the JAX
CLI's --bf16 does; a checkpoint loads into it unchanged.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import torch

FLAGSHIP = "pts_point-transformer_point-cat_nus_det_4x256_500e"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("experiment", nargs="?", default=None,
                   help=f"experiment name (default {FLAGSHIP}, or with "
                        "--image the image model's)")
    p.add_argument("--image", action="store_true",
                   help="track camera crops with the image model "
                        "(tools/scenes.IMAGE_EXPERIMENT)")
    p.add_argument("--checkpoint", default=None,
                   help="port checkpoint (Trainer.save_checkpoint's "
                        "ckpt_{tag}.pt, or a model state_dict); seeded init "
                        "weights when omitted (pipeline smoke only)")
    p.add_argument("--scene-dir", default=None,
                   help="directory of per-scene .npz files (see module "
                        "docstring); default: synthetic scenes")
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--objects", type=int, default=16)
    p.add_argument("--pts-per-obj", type=int, default=400)
    p.add_argument("--fp-rate", type=float, default=0.1,
                   help="expected detector false positives per frame, as a "
                        "fraction of --objects")
    p.add_argument("--dropout", type=float, default=0.05,
                   help="per-object detection dropout probability")
    p.add_argument("--num-classes", type=int, default=3)
    p.add_argument("--image-hw", type=int, nargs=2, default=(900, 1600),
                   metavar=("H", "W"), help="synthetic camera resolution "
                   "(image experiments)")
    p.add_argument("--subsample", type=int, default=128,
                   help="points per crop (subsample_number)")
    p.add_argument("--sparse", default="auto",
                   choices=("auto", "always", "never"))
    p.add_argument("--method", default="greedy",
                   choices=("greedy", "hungarian"))
    p.add_argument("--match-threshold", type=float, default=0.7)
    p.add_argument("--max-distance", type=float, default=2.0)
    p.add_argument("--nms-threshold", type=float, default=None)
    p.add_argument("--max-age", type=int, default=3)
    p.add_argument("--min-hits", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="compute in bf16 (the weights stay float32)")
    p.add_argument("--work-dir", default=".")
    p.add_argument("--set", dest="set_options", action="append", default=[],
                   metavar="KEY=VAL", help="config override (dotted path)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu runs every kernel's plain version (tests)")
    return p.parse_args(argv)


def load_weights(model: torch.nn.Module, checkpoint, device) -> None:
    """Load a port checkpoint into `model`: a Trainer checkpoint (its
    'model' entry) or a bare state_dict, strictly."""
    if checkpoint is None:
        print("WARNING: no --checkpoint; seeded init weights score noise "
              "(pipeline smoke only)", file=sys.stderr)
        return
    state = torch.load(checkpoint, map_location=device, weights_only=True)
    if isinstance(state.get("model"), dict):
        state = state["model"]
    model.load_state_dict(state)


def camera_ring(H: int, W: int):
    """tools/scenes.camera_ring with the intrinsics rescaled from its
    native 1600 x 900 to (W, H)."""
    from point_cloud_reid_tpu_torch.tools.scenes import camera_ring as ring
    l2cs, Ks = ring()
    Ks = Ks.copy()
    Ks[:, 0, :] *= W / 1600.0
    Ks[:, 1, :] *= H / 900.0
    return l2cs, Ks


def synth_scene(rs: np.random.RandomState, args, image_mode: bool):
    """Constant-velocity objects with birth/death windows + a detector model
    (position noise, dropout, false positives). Yields per-frame
    (frame_data, boxes, scores, labels, gt_ids)."""
    n = args.objects
    cls = rs.randint(0, args.num_classes, n)
    sizes = (rs.rand(n, 3) * 2 + 1.5).astype(np.float32)
    pos = (rs.rand(n, 3) * 50 - 25).astype(np.float32)
    pos[:, 2] = 0.0
    vel = (rs.randn(n, 2) * 0.15).astype(np.float32)
    birth = rs.randint(0, max(args.frames // 3, 1), n)
    death = rs.randint(2 * args.frames // 3, args.frames + 1, n)
    if image_mode:
        H, W = args.image_hw
        images = rs.randint(0, 256, (6, 3, H, W), dtype=np.uint8)
        l2cs, Ks = camera_ring(H, W)
    for t in range(args.frames):
        pos[:, :2] += vel
        live = (birth <= t) & (t < death)
        det = live & (rs.rand(n) >= args.dropout)
        boxes = np.concatenate(
            [pos[det] + rs.randn(det.sum(), 3).astype(np.float32) * 0.1,
             sizes[det],
             np.zeros((det.sum(), 1), np.float32)], axis=1)
        gt = np.flatnonzero(det).astype(np.int64)
        n_fp = rs.poisson(args.fp_rate * n)
        if n_fp:
            fp_pos = (rs.rand(n_fp, 3) * 50 - 25).astype(np.float32)
            fp_pos[:, 2] = 0.0
            boxes = np.concatenate([boxes, np.concatenate(
                [fp_pos, np.full((n_fp, 3), 2.0, np.float32),
                 np.zeros((n_fp, 1), np.float32)], axis=1)], axis=0)
            gt = np.concatenate([gt, np.full(n_fp, -1, np.int64)])
        scores = np.ones(len(boxes), np.float32)
        labels = np.concatenate([cls[det],
                                 rs.randint(0, args.num_classes, n_fp)])
        if image_mode:
            frame = (images, l2cs, Ks)
        else:
            centers = pos[live]
            frame = (np.repeat(centers, args.pts_per_obj, axis=0)
                     + rs.randn(live.sum() * args.pts_per_obj, 3)
                     .astype(np.float32) * 0.3)
        yield frame, boxes.astype(np.float32), scores, labels, gt


def load_scene(path: str, image_mode: bool):
    """Frames from one scene .npz (format in the module docstring)."""
    z = np.load(path)
    n_frames = sum(1 for k in z.files if k.startswith("boxes_"))
    for t in range(n_frames):
        boxes = z[f"boxes_{t}"].astype(np.float32)
        scores = z[f"scores_{t}"].astype(np.float32)
        labels = z[f"labels_{t}"].astype(np.int64)
        gt = z[f"gt_ids_{t}"] if f"gt_ids_{t}" in z.files else None
        if image_mode:
            frame = (z[f"images_{t}"], z[f"lidar2cams_{t}"],
                     z[f"intrinsics_{t}"])
        else:
            frame = z[f"points_{t}"]
        yield frame, boxes, scores, labels, gt


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tools.track needs a CUDA device (--device cpu "
                         "runs the plain versions on the CPU)")
    from point_cloud_reid_tpu_torch.configs import get_experiment
    from point_cloud_reid_tpu_torch.evaluation import TrackingEvalAccumulator
    from point_cloud_reid_tpu_torch.inference import PairScorer
    from point_cloud_reid_tpu_torch.models import build_model
    from point_cloud_reid_tpu_torch.tools.scenes import IMAGE_EXPERIMENT
    from point_cloud_reid_tpu_torch.tracking import TrackingManager

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    experiment = args.experiment or (IMAGE_EXPERIMENT if args.image
                                     else FLAGSHIP)
    cfg = get_experiment(experiment, set_options=args.set_options)
    image_mode = cfg["model"].get("type") == "ImageReIDNet"
    if args.image and not image_mode:
        raise SystemExit(f"--image: {experiment} is not an image model")
    model = build_model(cfg["model"], device=device,
                        generator=torch.Generator().manual_seed(0),
                        dtype=torch.bfloat16 if args.bf16 else torch.float32)
    load_weights(model, args.checkpoint, device)

    recorder = TrackingEvalAccumulator()
    mgr = TrackingManager(
        PairScorer(model, image_mode=image_mode),
        subsample_number=args.subsample,
        match_threshold=args.match_threshold,
        max_distance=args.max_distance, method=args.method,
        max_age=args.max_age, min_hits=args.min_hits,
        nms_threshold=args.nms_threshold, seed=args.seed,
        eval_recorder=recorder, sparse_scoring=args.sparse)

    if args.scene_dir:
        scene_files = sorted(glob.glob(os.path.join(args.scene_dir, "*.npz")))
        if not scene_files:
            sys.exit(f"no .npz scenes under {args.scene_dir}")
        scenes = [(os.path.basename(f), load_scene(f, image_mode))
                  for f in scene_files]
    else:
        rs = np.random.RandomState(args.seed)
        scenes = [(f"synthetic_{s}", synth_scene(rs, args, image_mode))
                  for s in range(args.scenes)]

    os.makedirs(args.work_dir, exist_ok=True)
    tracks_path = os.path.join(args.work_dir, "tracks.jsonl")
    step_times, n_frames = [], 0
    with open(tracks_path, "w") as out:
        for scene_name, frames in scenes:
            for t, (frame, boxes, scores, labels, gt) in enumerate(frames):
                t0 = time.perf_counter()
                tracks = mgr.step(frame, boxes, scores, labels,
                                  det_gt_ids=gt)
                step_times.append(time.perf_counter() - t0)
                n_frames += 1
                out.write(json.dumps(dict(
                    scene=scene_name, frame=t,
                    tracks=[dict(id=tr.track_id, cls=tr.cls,
                                 box=[round(float(x), 4) for x in tr.box],
                                 score=round(tr.score, 4))
                            for tr in tracks])) + "\n")
            mgr.end_scene()

    summary = recorder.summary()
    summary_path = os.path.join(args.work_dir, "tracking_summary.json")
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=1)

    warm = step_times[min(3, len(step_times) - 1):]
    print(json.dumps(dict(
        experiment=experiment, image_mode=image_mode,
        frames=n_frames, scenes=len(scenes),
        median_step_ms=round(float(np.median(warm)) * 1e3, 2),
        wall_hz=round(1.0 / max(float(np.median(warm)), 1e-9), 2),
        association=summary["association"],
        outputs=dict(tracks=tracks_path, summary=summary_path),
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")), indent=None))


if __name__ == "__main__":
    main()
