"""Freeze the seeded validation pair lists to a JSON artifact (the JAX
package's tools/dump_val_pairs.py).

Dumps ValEvenPairs' positives and negatives (object tokens, frame ids,
class ids), so an eval run can be replayed pair for pair anywhere
(ValEvenPairs.from_artifact, in either package).

    python -m point_cloud_reid_tpu_torch.tools.dump_val_pairs <experiment> \
        --root <store> --out pairs.json
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("experiment")
    ap.add_argument("--root", default=None)
    ap.add_argument("--out", default="val_pairs.json")
    ap.add_argument("--synthetic-objects", type=int, default=60)
    ap.add_argument("--validation-seed", type=int, default=0)
    args = ap.parse_args(argv)

    from point_cloud_reid_tpu_torch.configs import get_experiment
    from point_cloud_reid_tpu_torch.data import (CropStore, SyntheticStore,
                                                 build_pair_dataset)

    cfg = get_experiment(args.experiment)
    dcfg = dict(cfg["dataset"]["val"], validation_seed=args.validation_seed)
    if args.root:
        store = CropStore(args.root)
    else:
        store = SyntheticStore(num_objects=args.synthetic_objects,
                               class_names=list(dcfg["classes"]))
    ds = build_pair_dataset(dcfg, store)
    art = dict(experiment=args.experiment,
               validation_seed=args.validation_seed,
               n_positives=len(ds.val_positives),
               n_negatives=len(ds.val_negatives),
               **ds.dump_pairs())
    with open(args.out, "w") as f:
        json.dump(art, f, indent=1, default=str)
    print(json.dumps(dict(out=os.path.abspath(args.out),
                          positives=art["n_positives"],
                          negatives=art["n_negatives"])))


if __name__ == "__main__":
    main()
