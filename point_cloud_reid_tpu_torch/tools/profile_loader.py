"""Where a data batch's time goes on the GPU machine: the loader's stages
and the eval forward.

    python -m point_cloud_reid_tpu_torch.tools.profile_loader \
        [--root STORE | --objects 2500] [--batches 20] [--threads 1 2 4 8]

Over an on-disk store (written by tools/make_synthetic_data.py into
build/profile_loader_store when --root is omitted; nuScenes classes, 6
frames an object) and the flagship's train and val samplers, it times per
batch of 256 pairs, one stage after another in this thread: the plan
(`plan_batch`), the native read and resample of the batch's 512 crops, a
plain open + read of the same 512 files from Python (what any reader pays
for the files on this machine, one file at a time), and the pin
(train/loop.pin_batch). Then the val BatchLoader's pairs/s at each
--threads (pinned, as tools/train.py runs it). Then the eval forward of
the flagship (seeded weights) on val batches already on the card, by host
clock around synchronised calls: with the three kernel knobs on, and with
them off and the SA stages' plain version. Prints one JSON line with the
card's name and power limit. Needs a CUDA device; float32, TF32 off.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

FLAGSHIP = "pts_point-transformer_point-cat_nus_det_4x256_500e"
KNOBS = ("model.knn_method=pallas",
         "model.cross_stage1.attention=linear-pallas",
         "model.cross_stage2.attention=linear-pallas")
PAIRS = 256


def crop_reads(ds, idx: np.ndarray):
    """(path rows, seeds) of the native read that ds.sample_batch(idx)
    makes: its 2 x len(idx) crops' paths and resample seeds."""
    from point_cloud_reid_tpu_torch.data.samplers import _mix_words
    p = ds.plan_batch(idx)
    rows = ds._tables().pts_path_table(ds.store)[np.concatenate([p["f1"],
                                                                 p["f2"]])]
    seeds = np.concatenate([_mix_words(ds.seed, ds.epoch, idx, slot)
                            for slot in (1, 2)])
    return rows, seeds


def stage_ms(ds, batches: int, batch_size: int, pin: bool = True) -> dict:
    """Median ms a batch of the loader's stages for `batches` consecutive
    batches of `ds` (a PairDataset over a CropStore): plan, native read,
    Python file read of the same crops, pin (when `pin`)."""
    from point_cloud_reid_tpu_torch import native
    from point_cloud_reid_tpu_torch.train import pin_batch
    times = {k: [] for k in ("plan", "native", "files", "pin")}
    for b in range(batches):
        idx = np.arange(b * batch_size, (b + 1) * batch_size) % len(ds)
        t0 = time.perf_counter()
        ds.plan_batch(idx)
        times["plan"].append(time.perf_counter() - t0)
        rows, seeds = crop_reads(ds, idx)
        t0 = time.perf_counter()
        native.load_point_batch_strided(rows, ds.subsample_sparse, seeds)
        times["native"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for row in rows:
            with open(row, "rb") as f:
                f.read()
        times["files"].append(time.perf_counter() - t0)
        if pin:
            batch = ds.sample_batch(idx)
            t0 = time.perf_counter()
            pin_batch(batch)
            times["pin"].append(time.perf_counter() - t0)
    return {k: float(np.median(v)) * 1e3 for k, v in times.items() if v}


def loader_pairs_per_s(ds, threads: int, batches: int) -> float:
    from point_cloud_reid_tpu_torch.data import BatchLoader
    from point_cloud_reid_tpu_torch.train import pin_batch
    loader = BatchLoader(ds, PAIRS, shuffle=False, num_threads=threads,
                         transform=pin_batch)
    t0 = time.perf_counter()
    n = 0
    for i, batch in enumerate(loader):
        n += len(batch["id_1"])
        if i + 1 == batches:
            break
    return n / (time.perf_counter() - t0)


def eval_ms(ds, batches: int, kernels: bool) -> dict:
    """ms a batch of the flagship's eval step on device-resident batches."""
    from point_cloud_reid_tpu_torch.configs import get_experiment
    from point_cloud_reid_tpu_torch.kernels import sa_stage
    from point_cloud_reid_tpu_torch.models import build_model
    from point_cloud_reid_tpu_torch.models import point_transformer
    from point_cloud_reid_tpu_torch.train import make_eval_step, to_device
    cfg = get_experiment(FLAGSHIP, set_options=KNOBS if kernels else None)
    model = build_model(cfg["model"], device=torch.device("cuda"),
                        generator=torch.Generator().manual_seed(0))
    step = make_eval_step(model, dict(match=True), {})
    data = [to_device(ds.sample_batch(np.arange(b * PAIRS, (b + 1) * PAIRS)),
                      "cuda") for b in range(batches)]
    stage = point_transformer.sa_stage_inference
    if not kernels:
        point_transformer.sa_stage_inference = sa_stage.sa_stage_reference
    try:
        step(None, data[0])
        times = []
        for batch in data:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(None, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        point_transformer.sa_stage_inference = stage
    ms = float(np.median(times))
    return dict(ms_per_batch=ms, pairs_per_s=PAIRS / ms * 1e3)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=None, help="crop store (default: write "
                   "one of --objects objects)")
    p.add_argument("--objects", type=int, default=2500)
    p.add_argument("--batches", type=int, default=20)
    p.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4, 8])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_loader needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from point_cloud_reid_tpu_torch.configs import get_experiment
    from point_cloud_reid_tpu_torch.data import CropStore, build_pair_dataset
    from .make_synthetic_data import main as make_store
    from .scenes import card_name
    root = args.root
    if root is None:
        root = os.path.join("build", "profile_loader_store")
        make_store([root, "--objects", str(args.objects)])
    store = CropStore(root)
    dcfg = get_experiment(FLAGSHIP)["dataset"]
    out = dict(card=card_name(), root=os.path.abspath(root),
               objects=len(store.objects), batch_pairs=PAIRS)
    for split in ("train", "val"):
        ds = build_pair_dataset(dcfg[split], store)
        n = min(args.batches, len(ds) // PAIRS)
        out[f"{split}_stage_ms"] = stage_ms(ds, n, PAIRS)
        out[f"{split}_batches"] = n
    val = build_pair_dataset(dcfg["val"], store)
    out["val_loader_pairs_per_s"] = {
        str(t): loader_pairs_per_s(val, t, args.batches)
        for t in args.threads}
    out["eval_kernels"] = eval_ms(val, args.batches, True)
    out["eval_plain"] = eval_ms(val, args.batches, False)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
