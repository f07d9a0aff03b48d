"""Where a train step's time goes on the GPU.

Trains the flagship point model at full width (seeded random weights) on
seeded synthetic pair batches with losses match + kl + triplet, first with
both kernel knobs on (knn_method 'pallas', cross stages 'linear-pallas': the
hand-written CUDA kernels), then with both off (plain PyTorch kNN and
attention), in one process on one card. For each it prints one JSON line:
median step ms (host clock around a synchronised step), forward / backward /
optimizer ms (CUDA events), peak memory, and from one torch.profiler window
the device time per kernel name (the 14 longest, and the training path's
two hand-written kernels, kNN and attention, apart) and the share of the
window the device was busy; with the card's name and power limit.

    python -m point_cloud_reid_tpu_torch.tools.profile_train
        [--batch 256] [--steps 6] [--warmup 3] [--trace-dir build]

Needs a CUDA device. Float32, TF32 off.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch

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


def _phases_ms(model, state, batch, generator):
    """One step split by CUDA events: forward + losses, backward, update."""
    from point_cloud_reid_tpu_torch.train.losses import reid_losses
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    loss, _ = reid_losses(model(batch, train=True), batch, LOSSES, {},
                          generator=generator, pool_type=model.pool_type)
    ev[1].record()
    state.optimizer.zero_grad()
    loss.backward()
    ev[2].record()
    state.optimizer.step()
    ev[3].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def profile_config(kernels: bool, args) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from point_cloud_reid_tpu_torch.models import build_model
    from point_cloud_reid_tpu_torch.train import (ScheduleConfig,
                                                  SyntheticPairLoader,
                                                  TrainState, make_train_step,
                                                  to_device)
    device = torch.device("cuda")
    model = build_model(flagship_train_cfg(kernels), device=device,
                        generator=torch.Generator().manual_seed(0))
    n = args.warmup + 2 * args.steps + 1
    state = TrainState.create(model, ScheduleConfig(max_epochs=1), n)
    step = make_train_step(model, LOSSES, {})
    gen = torch.Generator(device=device).manual_seed(0)
    batches = [to_device(b, device) for b in
               SyntheticPairLoader(args.batch, n, num_points=128, seed=0)]
    torch.cuda.reset_peak_memory_stats()
    times = []

    def run(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, log = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return log

    for batch in batches[:args.warmup + args.steps]:
        log = run(batch)
    phases = _phases_ms(model, state, batches[args.warmup + args.steps], gen)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[args.warmup + args.steps + 1:]:
            log = run(batch)
        window_us = (time.perf_counter() - t0) * 1e6
    trace_path = os.path.join(
        args.trace_dir, f"train_trace_{'kernels' if kernels else 'plain'}.json")
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
        card=card_name(), kernels=kernels, batch_pairs=args.batch,
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
        kernels_ms_per_step={k: v for k, v in top},
        hand_kernels_ms_per_step={
            k: v for k, v in per_kernel.items()
            if "knn_kernel" in k or "lin_attn_kernel" in k})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=256, help="pairs per step")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--trace-dir", default="build",
                   help="where the profiled windows' chrome traces go")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for kernels in (True, False):
        print(json.dumps(profile_config(kernels, args)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
