"""Where a train step's time goes on the GPU.

Trains the flagship point model at full width (seeded random weights) on
seeded synthetic pair batches with losses match + kl + triplet, first with
both kernel knobs on (knn_method 'pallas', cross stages 'linear-pallas': the
hand-written CUDA kernels), then with both off (plain PyTorch kNN and
attention), in one process on one card. For each it prints one JSON line:
median step ms (host clock around a synchronised step), forward / backward /
optimizer ms (CUDA events), peak memory, and from one torch.profiler window
the device time per kernel name (the 14 longest, and the training path's
two hand-written kernels, kNN and attention, apart), the kNN kernel's
launches a step by tier (kernels/knn.TIER_NAMES) and the share of the
window the device was busy; with the card's name and power limit.

    python -m point_cloud_reid_tpu_torch.tools.profile_train
        [--batch 256] [--steps 6] [--warmup 3] [--trace-dir build]
        [--bf16] [--remat] [--experiment NAME]

--bf16 builds the model at a bf16 compute dtype (float32 parameters and
optimizer state), as tools/train.py --bf16 trains it; --remat recomputes
each stage's forward in the backward, as tools/train.py --remat. --experiment
trains a leaf of configs.EXPERIMENTS with its own losses and triplet
margin instead: a point leaf on crops of its subsample_sparse points (the
knobs it takes on, then off: model_knobs), an image (rgb_*) leaf on seeded
224 x 224 image pairs (its path has no hand-written kernel: one line), e.g.
`--experiment rgb_deit-tiny_point-cat_r_nus_det_4x60_200e --batch 60`.
Needs a CUDA device. TF32 off.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch

from ..utils.profiling import StepTimer
from .profile_tracker import _busy_us
from .scenes import card_name

LOSSES = dict(match=True, kl=True, triplet=True)


def flagship_train_cfg(kernels: bool) -> dict:
    """The flagship model config with the two kernel knobs on or off."""
    from point_cloud_reid_tpu_torch.configs import point_transformer_point_cat
    cfg = point_transformer_point_cat()
    if kernels:
        cfg["knn_method"] = "pallas"
        cfg["cross_stage1"]["attention"] = "linear-pallas"
        cfg["cross_stage2"]["attention"] = "linear-pallas"
    return cfg


def model_knobs(model_cfg: dict) -> list:
    """The kernel knobs a point model config takes: knn_method 'pallas',
    and 'linear-pallas' attention on each stage where that names the
    kernel: the cross stages of type corss_attention (the concat baseline
    has none; LoFTR's 'linear-pallas' is softmax) and the 'xcorr' head's
    local stages. knn_method reaches the point-transformer's SA stages
    alone; PointNet, DGCNN and VN-DGCNN ignore it."""
    knobs = ["model.knn_method=pallas"]
    stages = [("cross_stage1", "corss_attention"),
              ("cross_stage2", "corss_attention")]
    if model_cfg.get("match_type") == "xcorr":
        stages += [("local_stage1", "local_self_attention"),
                   ("local_stage2", "local_self_attention")]
    for stage, kind in stages:
        if (model_cfg.get(stage) or {}).get("type") == kind:
            knobs.append(f"model.{stage}.attention=linear-pallas")
    return knobs


def train_spec(experiment, kernels: bool, sets=()) -> dict:
    """What one profiled configuration trains: the model config, losses,
    loss weights, triplet margin and the synthetic batches' shape (points
    a crop, classes, image side or 0). `experiment` None is the flagship
    with LOSSES; `sets` are --set overrides of the leaf (configs/zoo.py).
    A point leaf takes its kernel knobs on or off (model_knobs)."""
    if experiment is None:
        return dict(model=flagship_train_cfg(kernels), losses=LOSSES,
                    alpha={}, triplet_margin=0.2, num_points=128,
                    num_classes=10, image_size=0)
    from point_cloud_reid_tpu_torch.configs import get_experiment
    cfg = get_experiment(experiment, set_options=list(sets))
    image = cfg["model"].get("type") == "ImageReIDNet"
    if kernels and not image:
        cfg = get_experiment(experiment, set_options=list(sets) + model_knobs(
            cfg["model"]))
    data = cfg["dataset"]
    return dict(model=cfg["model"], losses=cfg["losses_to_use"],
                alpha=cfg["alpha"],
                triplet_margin=cfg.get("triplet_margin", 0.2),
                num_points=data["train"].get("subsample_sparse", 128),
                num_classes=data["num_classes"],
                image_size=cfg["model"].get("image_size", 224) if image
                else 0)


def train_setup(spec: dict, device, batch: int, n_batches: int,
                bf16: bool = False, remat: bool = False) -> dict:
    """The model, train state, train step, generator and `n_batches`
    synthetic batches on `device` of one configuration (train_spec), and
    loss(batch), its forward and losses alone."""
    from point_cloud_reid_tpu_torch.models import build_model
    from point_cloud_reid_tpu_torch.train import (ScheduleConfig,
                                                  SyntheticPairLoader,
                                                  TrainState, make_train_step,
                                                  reid_losses, to_device,
                                                  train_forward)
    model = build_model(spec["model"], device=device,
                        generator=torch.Generator().manual_seed(0),
                        dtype=torch.bfloat16 if bf16 else torch.float32)
    state = TrainState.create(model, ScheduleConfig(max_epochs=1),
                              n_batches)
    kw = dict(triplet_margin=spec["triplet_margin"])
    step = make_train_step(model, spec["losses"], spec["alpha"], remat=remat,
                           **kw)
    gen = torch.Generator(device=device).manual_seed(0)
    batches = [to_device(b, device) for b in SyntheticPairLoader(
        batch, n_batches, num_points=spec["num_points"],
        num_classes=spec["num_classes"], image_size=spec["image_size"],
        seed=0)]

    def loss(b):
        return reid_losses(train_forward(model, b, remat), b, spec["losses"],
                           spec["alpha"], generator=gen,
                           pool_type=model.pool_type, **kw)[0]

    return dict(model=model, state=state, step=step, generator=gen,
                batches=batches, loss=loss)


def _phases_ms(run: dict, batch):
    """One step split by CUDA events: forward + losses, backward, update."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    loss = run["loss"](batch)
    ev[1].record()
    run["state"].optimizer.zero_grad()
    loss.backward()
    ev[2].record()
    run["state"].optimizer.step()
    ev[3].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def profile_config(kernels: bool, args) -> dict:
    from torch.profiler import ProfilerActivity, profile

    spec = train_spec(args.experiment, kernels)
    n = args.warmup + 2 * args.steps + 1
    run = train_setup(spec, torch.device("cuda"), args.batch, n,
                      bf16=args.bf16, remat=args.remat)
    batches = run["batches"]
    torch.cuda.reset_peak_memory_stats()
    timer = StepTimer()

    def step(batch):
        timer.start()
        _, log = run["step"](run["state"], batch, run["generator"])
        timer.stop()
        return log

    from ..kernels import knn as kk
    for batch in batches[:args.warmup]:
        log = step(batch)
    tiers = dict(kk.knn.tier_launches)
    for batch in batches[args.warmup:args.warmup + args.steps]:
        log = step(batch)
    knn_tiers = {t: (kk.knn.tier_launches[t] - tiers[t]) / args.steps
                 for t in kk.TIER_NAMES}
    phases = _phases_ms(run, batches[args.warmup + args.steps])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[args.warmup + args.steps + 1:]:
            log = step(batch)
        window_us = (time.perf_counter() - t0) * 1e6
    times = [t * 1e3 for t in timer.times]
    label = "_".join([args.experiment or "flagship",
                      "kernels" if kernels else "plain"]
                     + ["bf16"] * args.bf16 + ["remat"] * args.remat)
    trace_path = os.path.join(args.trace_dir, f"train_trace_{label}.json")
    os.makedirs(args.trace_dir, exist_ok=True)
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        trace = json.load(f)
    per_kernel = defaultdict(float)
    intervals = []
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") == "kernel":
            per_kernel[ev["name"][:80]] += ev["dur"] / 1e3 / args.steps
            intervals.append((ev["ts"], ev["dur"]))
    if not intervals:
        raise RuntimeError("the profiler recorded no device kernels")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:14]
    return dict(
        card=card_name(), experiment=args.experiment or "flagship",
        kernels=kernels, dtype="bfloat16" if args.bf16 else "float32",
        remat=args.remat, batch_pairs=args.batch,
        loss=float(log["reid_loss"]), grad_norm=float(log["grad_norm"]),
        step_ms=times[args.warmup:args.warmup + args.steps],
        median_step_ms=float(np.median(
            times[args.warmup:args.warmup + args.steps])),
        median_profiled_step_ms=float(np.median(times[-args.steps:])),
        forward_ms=phases[0], backward_ms=phases[1], optimizer_ms=phases[2],
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        device_ms_per_step=sum(per_kernel.values()),
        device_kernels_per_step=len(intervals) / args.steps,
        device_busy_share=_busy_us(intervals) / window_us,
        knn_launches_per_step=knn_tiers,
        kernels_ms_per_step={k: v for k, v in top},
        hand_kernels_ms_per_step={
            k: v for k, v in per_kernel.items()
            if "knn_kernel" in k or "knn_channels" in k
            or "lin_attn_kernel" in k})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=256, help="pairs per step")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--trace-dir", default="build",
                   help="where the profiled windows' chrome traces go")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute, float32 parameters")
    p.add_argument("--remat", action="store_true",
                   help="recompute each stage's forward in the backward")
    p.add_argument("--experiment", default=None,
                   help="a leaf of configs.EXPERIMENTS (default: the "
                        "flagship with losses match + kl + triplet)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    image = train_spec(args.experiment, False)["image_size"] > 0
    for kernels in (False,) if image else (True, False):
        print(json.dumps(profile_config(kernels, args)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
