"""Generate a synthetic crop store on disk (the JAX package's
tools/make_synthetic_data.py).

Writes a store with the exact on-disk layout of the real exports
({root}/{obj}/{frame}/pts_xyz.bin [+ img_crop.bin] + objects.pkl), so
tools/train.py --root, tools/test.py and the native loader run without the
datasets. The same arguments write the same files as the JAX tool, and the
JAX package reads the store.

    python -m point_cloud_reid_tpu_torch.tools.make_synthetic_data \
        /tmp/store --objects 200 [--images]
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root")
    ap.add_argument("--objects", type=int, default=100)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--images", action="store_true")
    ap.add_argument("--crop-size", type=int, default=224)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset", default="nuscenes",
                    choices=["nuscenes", "waymo"])
    args = ap.parse_args(argv)

    from point_cloud_reid_tpu_torch.configs.datasets import (NUSCENES_CLASSES,
                                                             WAYMO_CLASSES)
    from point_cloud_reid_tpu_torch.data import SyntheticStore

    classes = (list(NUSCENES_CLASSES) if args.dataset == "nuscenes"
               else list(WAYMO_CLASSES))
    store = SyntheticStore(
        num_objects=args.objects, frames_per_obj=args.frames,
        class_names=classes, with_images=args.images,
        crop_size=(args.crop_size, args.crop_size), seed=args.seed)
    store.save(args.root)
    print(json.dumps(dict(root=os.path.abspath(args.root),
                          objects=args.objects, frames=args.frames,
                          dataset=args.dataset, images=args.images)))


if __name__ == "__main__":
    main()
