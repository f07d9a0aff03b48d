"""Checkpoint-parity harness of the port: a released .pth -> accuracy delta
(the JAX package's tools/parity_eval.py).

One command converts the reference checkpoint (convert.torch_checkpoint),
builds the crop store and the seeded (or frozen, --pairs) val pairs
through tools/train.py's build_all, runs the stratified evaluator
(Trainer.evaluate) and prints the accuracy delta against --expected-acc
with the BASELINE.md bar (+/- 0.5 % points). The reference's eval protocol
(launcher_testing.py:14-53; testing_base.py:8-18, the seeded
point-count-matched val set) as one call:

    python -m point_cloud_reid_tpu_torch.tools.import_reference_store ...
    python -m point_cloud_reid_tpu_torch.tools.parity_eval \
        testing_pts_point-transformer_point-cat_nus_det_4x256_500e \
        --pth checkpoints/pts_point-transformer_r_nus_det.pth \
        --data-root data/lstk/sparse-trainval-det-both \
        --expected-acc <released accuracy in %>

Without --data-root it runs on a SyntheticStore of --synthetic-objects
objects (a dry run). --ckpt takes a port checkpoint instead of a .pth (an
orbax directory cannot be read without JAX). Writes
{work_dir}/parity_report.json when --work-dir is given, prints the JSON,
and exits 1 when |delta| exceeds the tolerance. Runs on the CUDA device
unless --device cpu (the tests).
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("experiment", help="a testing_* experiment name")
    p.add_argument("--pth", default=None,
                   help="released torch checkpoint (.pth) to convert + eval")
    p.add_argument("--ckpt", default=None,
                   help="port checkpoint (ckpt_*.pt, e.g. from "
                        "tools.convert_checkpoint; alternative to --pth)")
    p.add_argument("--data-root", default=None,
                   help="imported crop store (tools.import_reference_store); "
                        "synthetic data when omitted (dry run)")
    p.add_argument("--pairs", default=None,
                   help="frozen val-pair artifact (tools.dump_val_pairs): "
                        "replay the exact pair list instead of reseeding")
    p.add_argument("--expected-acc", type=float, default=None,
                   help="released checkpoint's accuracy in %% (the parity "
                        "target)")
    p.add_argument("--tolerance", type=float, default=0.5,
                   help="accuracy bar in %% points (BASELINE.md: 0.5)")
    p.add_argument("--image", action="store_true",
                   help="image-branch checkpoint conversion")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--seed", type=int, default=66)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--synthetic-objects", type=int, default=60)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu runs every kernel's plain version (tests)")
    p.add_argument("--set", dest="set_options", action="append", default=[],
                   metavar="KEY.PATH=VALUE")
    return p.parse_args(argv)


def _frozen_val_loader(trainer, path):
    """The val loader over a frozen pair artifact, with the seeded val
    set's store, classes and crop settings and its loader's batch."""
    from point_cloud_reid_tpu_torch.data import BatchLoader, ValEvenPairs
    with open(path) as f:
        pairs = json.load(f)
    old_loader = trainer.val_loader
    old = old_loader.dataset
    val_ds = ValEvenPairs.from_artifact(
        pairs, store=old.store, classes=old.classes,
        cls_to_idx=old.cls_to_idx, tracking_classes=old.tracking_classes,
        complete_store=old.complete_store,
        subsample_sparse=old.subsample_sparse,
        subsample_dense=old.subsample_dense, mode=old.mode,
        with_dense=old.with_dense)
    print(f"replaying frozen pair list: {len(val_ds)} pairs", file=sys.stderr)
    return BatchLoader(val_ds, batch_size=old_loader.batch_size,
                       shuffle=False, drop_last=True,
                       num_threads=old_loader.num_threads,
                       transform=old_loader.transform)


def main(argv=None):
    args = parse_args(argv)
    if not (args.pth or args.ckpt):
        raise SystemExit("one of --pth / --ckpt is required")

    from point_cloud_reid_tpu_torch.configs import get_experiment
    from .train import build_all, select_device

    cfg = get_experiment(args.experiment, set_options=args.set_options)
    if not cfg["runtime"].get("eval_only"):
        print("note: experiment is not a testing_* leaf; evaluating anyway",
              file=sys.stderr)
    device = select_device(args.device, "tools.parity_eval")
    train_args = argparse.Namespace(
        experiment=args.experiment, root=args.data_root,
        work_dir=args.work_dir, checkpoint=None, resume=None, profile=None,
        seed=args.seed, epochs=None, batch_size=args.batch_size,
        eval_only=True, synthetic_objects=args.synthetic_objects,
        loader_threads=2, remat=False, bf16=False, device=args.device,
        set_options=args.set_options)
    trainer, state = build_all(cfg, train_args, device)

    if args.pth:
        from point_cloud_reid_tpu_torch.convert import (
            load_image_reference_state_dict, load_reference_state_dict,
            load_torch_state_dict)
        sd = load_torch_state_dict(args.pth)
        load = (load_image_reference_state_dict if args.image
                else load_reference_state_dict)
        report = load(state.model, sd, strict=True)
        print(f"converted {args.pth}: {len(sd)} torch tensors, "
              f"{len(report['unmatched_torch'])} unmatched", file=sys.stderr)
    else:
        state = trainer.load_weights(state, args.ckpt)

    if args.pairs:
        trainer.val_loader = _frozen_val_loader(trainer, args.pairs)

    metrics = trainer.evaluate(state)
    acc = 100.0 * float(metrics["val_match_acc"])
    out = dict(experiment=args.experiment,
               checkpoint=args.pth or args.ckpt,
               val_match_acc_pct=round(acc, 3),
               expected_acc_pct=args.expected_acc,
               tolerance_pct=args.tolerance)
    if args.expected_acc is not None:
        delta = acc - args.expected_acc
        out.update(delta_pct=round(delta, 3),
                   parity=bool(abs(delta) <= args.tolerance))
    if args.work_dir:
        os.makedirs(args.work_dir, exist_ok=True)
        with open(os.path.join(args.work_dir, "parity_report.json"),
                  "w") as f:
            json.dump(dict(out, full_metrics={
                k: v for k, v in metrics.items()
                if not isinstance(v, dict)}), f, indent=1)
    print(json.dumps(out, indent=1))
    if args.expected_acc is not None and not out["parity"]:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
