"""Convert a reference PyTorch .pth checkpoint to a port checkpoint (the
JAX package's tools/convert_checkpoint.py, which writes orbax instead).

    python -m point_cloud_reid_tpu_torch.tools.convert_checkpoint \
        <ckpt.pth> <experiment-name> <out-dir> [--image] [--no-strict]

Loads the reference state dict (mmcv envelope and DDP 'module.' prefixes
taken off) into the named experiment's port model with
convert.torch_checkpoint (--image: the image model's loader, which skips
the cross stages' dead pos_mlp and reads the HF ViT under backbone.) and
writes {out-dir}/ckpt_converted.pt, a checkpoint whose 'model' entry
tools/test.py, tools/track.py and tools/train.py read with --checkpoint.
The conversion runs on the host: it moves tensors and runs no model.
Prints one JSON line: the saved path and the report's counts, then the
first unmatched keys and unfilled targets.
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkpoint")
    ap.add_argument("experiment")
    ap.add_argument("out_dir")
    ap.add_argument("--image", action="store_true",
                    help="image-branch checkpoint (skips the dead "
                         "cross-stage pos_mlp)")
    ap.add_argument("--no-strict", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from point_cloud_reid_tpu_torch.configs import get_experiment
    from point_cloud_reid_tpu_torch.convert import (
        load_image_reference_state_dict, load_reference_state_dict,
        load_torch_state_dict)
    from point_cloud_reid_tpu_torch.models import build_model

    model = build_model(get_experiment(args.experiment)["model"])
    sd = load_torch_state_dict(args.checkpoint)
    load = (load_image_reference_state_dict if args.image
            else load_reference_state_dict)
    report = load(model, sd, strict=not args.no_strict)

    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(args.out_dir, "ckpt_converted.pt"))
    torch.save(dict(model=model.state_dict(), source=args.checkpoint,
                    experiment=args.experiment), path)
    print(json.dumps(dict(
        saved=path,
        unmatched_torch=len(report["unmatched_torch"]),
        unfilled_flax=len(report["unfilled_flax"]))))
    for k in report["unmatched_torch"][:10]:
        print("  unmatched:", k)
    for k in report["unfilled_flax"][:10]:
        print("  unfilled:", k)
    return path


if __name__ == "__main__":
    main()
