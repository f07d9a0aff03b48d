"""Training CLI of the port (the JAX package's tools/train.py).

    python -m point_cloud_reid_tpu_torch.tools.train \
        pts_point-transformer_point-cat_nus_det_4x256_500e --epochs 1 \
        --work-dir runs/exp1 --seed 66 \
        --set model.knn_method=pallas \
        --set model.cross_stage1.attention=linear-pallas \
        --set model.cross_stage2.attention=linear-pallas

Trains on the CUDA device; without one it exits. The data pipeline is not
ported yet: with no --root the run trains on 8 and evaluates on 2 seeded
synthetic pair batches an epoch (train/synthetic.py), and --root raises.
Float32, TF32 off.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("experiment", help="experiment name (configs.EXPERIMENTS)")
    p.add_argument("--root", default=None,
                   help="crop-store root (not ported yet: raises); synthetic "
                        "data when omitted")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint to load weights from (optimizer and step "
                        "start fresh)")
    p.add_argument("--resume", default=None,
                   help="checkpoint to resume the full training state from "
                        "(weights + optimizer + step)")
    p.add_argument("--seed", type=int, default=66)       # reference default
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="pairs per step; default samples_per_device")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--set", dest="set_options", action="append", default=[],
                   metavar="KEY.PATH=VALUE",
                   help="dotted-path config override (repeatable), e.g. "
                        "--set losses_to_use.match=false --set schedule.lr=1e-4 "
                        "--set model.knn_method=pallas")
    return p.parse_args(argv)


def build_all(cfg, args, device):
    """(trainer, state) of an experiment dict on `device`."""
    from point_cloud_reid_tpu_torch.models import build_model
    from point_cloud_reid_tpu_torch.train import (SyntheticPairLoader,
                                                  Trainer, TrainState)
    if args.root:
        raise NotImplementedError(
            "--root: the crop store and the pair samplers are not ported "
            "yet (the data slice); omit it to train on synthetic batches")
    dcfg = cfg["dataset"]
    losses = cfg.get("losses_to_use", {})
    dense = (dcfg["subsample_dense"]
             if losses.get("shape") or losses.get("dense") else 0)
    batch = args.batch_size or dcfg["samples_per_device"]
    common = dict(batch_size=batch, num_points=dcfg["subsample_sparse"],
                  num_classes=dcfg["num_classes"], dense_points=dense)
    train_loader = SyntheticPairLoader(num_batches=8, seed=args.seed,
                                       **common)
    val_loader = SyntheticPairLoader(num_batches=2, seed=args.seed + 1,
                                     **common)

    model = build_model(cfg["model"], device=device,
                        generator=torch.Generator().manual_seed(args.seed))
    sched = cfg["schedule"]
    if args.epochs:
        sched.max_epochs = args.epochs
    runtime = dict(cfg["runtime"])
    runtime.update(
        work_dir=args.work_dir, seed=args.seed, max_epochs=sched.max_epochs,
        losses_to_use=cfg["losses_to_use"], alpha=cfg["alpha"],
        cls_to_idx=dcfg["cls_to_idx"], num_classes=dcfg["num_classes"],
        fp_label_threshold=dcfg["fp_label_threshold"],
        triplet_margin=cfg.get("triplet_margin", 0.2),
        triplet_sample_num=cfg.get("triplet_sample_num", 5))
    trainer = Trainer(model, train_loader, val_loader, runtime)
    state = TrainState.create(model, sched,
                              steps_per_epoch=max(len(train_loader), 1))
    if args.resume:
        state = trainer.load_checkpoint(state, args.resume)
    elif args.checkpoint:
        state = trainer.load_weights(state, args.checkpoint)
    return trainer, state


def main(argv=None):
    args = parse_args(argv)
    from point_cloud_reid_tpu_torch.configs import get_experiment
    cfg = get_experiment(args.experiment, set_options=args.set_options)
    if not torch.cuda.is_available():
        raise SystemExit("tools.train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}", file=sys.stderr)

    trainer, state = build_all(cfg, args, device)
    trainer.logger.log_config(dict(experiment=args.experiment, seed=args.seed,
                                   schedule=str(cfg["schedule"]),
                                   model=cfg["model"]))
    if not (args.eval_only or cfg["runtime"].get("eval_only")):
        state = trainer.fit(state)
    metrics = trainer.evaluate(state)
    print(json.dumps({k: v for k, v in metrics.items()
                      if not isinstance(v, dict)}, indent=1))


if __name__ == "__main__":
    main()
