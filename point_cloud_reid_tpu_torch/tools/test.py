"""Evaluation CLI of the port (the JAX package's tools/test.py).

    python -m point_cloud_reid_tpu_torch.tools.test \
        testing_pts_point-transformer_point-cat_nus_det_4x256_500e \
        --root /data/nuscenes-reid --checkpoint runs/exp1/ckpt_final.pt \
        [--work-dir out/] [--set model.knn_method=pallas ...]

Eval only: tools/train.py's build_all (the val spec's ValEvenPairs over the
store, in order, drop_last) and Trainer.evaluate, the stratified evaluator
(match accuracy / F1 / precision / recall by class, point bucket,
visibility and distance). Writes {work_dir}/eval_results_full.json (work
dir default ".") and prints the scalar metrics. --checkpoint reads a port
checkpoint (ckpt_{tag}.pt or a model state_dict), as tools/track.py does;
without one the seeded init weights are evaluated. Evaluates the point
leaves and the image (rgb_*) leaves. The arguments are tools/train.py's;
runs on the CUDA device unless --device cpu.
"""
from __future__ import annotations

import json
import os
import sys

from .train import build_all, finish, parse_args, scalars, select_device


def main(argv=None):
    args = parse_args(argv)
    args.eval_only = True
    from point_cloud_reid_tpu_torch.configs import get_experiment
    cfg = get_experiment(args.experiment, set_options=args.set_options)
    device = select_device(args.device, "tools.test")
    trainer, state = build_all(cfg, args, device)
    metrics = trainer.evaluate(state)
    finish()
    if not trainer.writer:          # under torchrun rank 0 reports
        return metrics
    out_path = os.path.join(args.work_dir or ".", "eval_results_full.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(metrics, f, indent=1)
    print(scalars(metrics))
    print(f"full report: {out_path}", file=sys.stderr)
    return metrics


if __name__ == "__main__":
    main()
