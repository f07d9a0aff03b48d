"""Import the published nuScenes-ReID / Waymo-ReID exports into a crop
store (the JAX package's tools/import_reference_store.py).

The released datasets ship lamtk metadata pickles ({scene_infos, obj_infos,
frame_infos}; reference object_loader_base.py:42-52,76-141,310-431) next to a
per-object/per-frame crop tree, which is already the store's layout. This
tool converts the metadata into the store's objects.pkl index (in the JAX
package's format: either package reads it) and stages
instance_token_to_id.pkl as token_to_int.pkl:

    python -m point_cloud_reid_tpu_torch.tools.import_reference_store \
        --metadata data/lstk/sparse-trainval-det-both/metadata/metadata.pkl \
        --data-root data/lstk/sparse-trainval-det-both --dataset nuscenes \
        [--split-map data/lstk/ds_name_to_scene_token.pkl \
         --version v1.0-trainval --split train] \
        [--instance-token-to-id data/lstk/instance_token_to_id.pkl]

Waymo metadata may be a directory of pickles, combined by union
(--dataset waymo). Then point tools/train.py --root at the data root.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--metadata", required=True,
                   help="metadata .pkl or directory of .pkl files")
    p.add_argument("--data-root", required=True,
                   help="crop-tree root; objects.pkl is written here")
    p.add_argument("--dataset", choices=("nuscenes", "waymo"),
                   default="nuscenes")
    p.add_argument("--split-map", default=None,
                   help="ds_name_to_scene_token.pkl for split filtering")
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--split", choices=("train", "val"), default="train")
    p.add_argument("--instance-token-to-id", default=None,
                   help="instance_token_to_id.pkl; staged as token_to_int.pkl")
    p.add_argument("--out-name", default="objects.pkl")
    p.add_argument("--verify-crops", action="store_true",
                   help="require every metadata-named pts_xyz.bin to exist")
    args = p.parse_args(argv)

    from point_cloud_reid_tpu_torch.data.import_reference import (
        import_reference_store)
    out_path, stats = import_reference_store(
        metadata_path=args.metadata,
        data_root=args.data_root,
        dataset=args.dataset,
        split_map_path=args.split_map,
        version=args.version,
        split=args.split,
        instance_token_to_id_path=args.instance_token_to_id,
        out_name=args.out_name,
        verify_crops=args.verify_crops,
    )
    print(json.dumps(dict(index=out_path, **stats), indent=1))


if __name__ == "__main__":
    main()
