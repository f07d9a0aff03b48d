"""Importer: published nuScenes-ReID / Waymo-ReID exports -> store index.

A copy of point_cloud_reid_tpu/data/import_reference.py (numpy only); it
writes objects.pkl with store.write_records, in the JAX package's format.

The reference consumes the released dataset exports through lamtk: a metadata
pickle (or directory of pickles) with {scene_infos, obj_infos, frame_infos}
drives ObjectLoaderSparse* (reference object_loader_base.py:42-52 load_metadata,
:76-141 field access, :310-431 per-dataset subclasses), plus nuScenes helper
dicts built from the devkit (instance_token_to_id.pkl,
reference reidentification_nuscenes.py:20-22, datasets/utils.py:71-76, and
ds_name_to_scene_token.pkl for split filtering, object_loader_base.py:55-72).

This module parses that exact schema and emits this framework's
self-describing `objects.pkl` index (data/store.ObjectRecord list) next to the
crop tree — the crop .bin layout itself is already byte-compatible
(store.py docstring), so importing metadata is all it takes to ingest the
real downloads.

Per-object field mapping (obj_infos[obj_id] -> ObjectRecord):
  id           <- obj['id'] (== key; FP objects are 'FP_*'-prefixed)
  class_name   <- obj['class_name']
  path         <- str(obj['path'])  (PosixPath in some exports,
                  combine_metadata_fix, object_loader_base.py:29-30)
  num_pts      <- {str(frame): int(n)} from obj['num_pts'] (keys are ints in
                  the exports — get_filtered_nums indexes with int(x),
                  object_loader_base.py:116)
  visibility   <- nuScenes: obj['visibility'] {str(frame): level 1-4}
                  Waymo: box2d PRESENCE -> {str(frame): 1} — the Waymo loader
                  keys every visibility filter off box2d keys
                  (object_loader_base.py:377-431)
  distance     <- per-frame ego BEV distance
                  sqrt(sum(all_sizes[nums_to_distance[frame], :2]**2)):
                  nums_to_distance enumerates num_pts keys in insertion order
                  (object_loader_base.py:135-139) and indexes obj['all_sizes']
                  rows (reidentification_waymo.py:166-201); missing frames get
                  index -1 = last row, reproduced verbatim.
  crop_size    <- obj['crop_size'] when present (image exports; load_image
                  reshapes by the stored size then crops,
                  object_loader_base.py:285-287)
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from .store import ObjectRecord, write_records


def load_metadata(metadata_path: str) -> Dict[str, Any]:
    """One pickle, or a directory of pickles combined by dict-union — the
    reference's load_metadata/combine_metadata (object_loader_base.py:16-52:
    scene_infos/obj_infos/frame_infos each merged with dict.update)."""
    if os.path.isfile(metadata_path):
        with open(metadata_path, "rb") as f:
            return pickle.load(f)
    combined: Dict[str, Dict] = dict(scene_infos={}, obj_infos={},
                                     frame_infos={})
    for name in sorted(os.listdir(metadata_path)):
        if not name.endswith(".pkl"):
            continue
        with open(os.path.join(metadata_path, name), "rb") as f:
            part = pickle.load(f)
        for key in combined:
            combined[key].update(part.get(key, {}))
    return combined


def filter_by_scene_ids(metadata: Dict[str, Any],
                        scene_ids: Iterable[str]) -> Dict[str, Any]:
    """Split filtering — lamtk filter_metadata_by_scene_ids as used at
    object_loader_base.py:55-72: keep objects/frames belonging to the split's
    scenes. Objects carry their scene under 'scene_id' (or 'scene_token');
    entries with no scene field are kept (FP exports don't always carry one).
    """
    keep = set(scene_ids)

    def scene_of(info):
        return info.get("scene_id", info.get("scene_token"))

    out = dict(
        scene_infos={k: v for k, v in metadata.get("scene_infos", {}).items()
                     if k in keep},
        obj_infos={k: v for k, v in metadata.get("obj_infos", {}).items()
                   if scene_of(v) is None or scene_of(v) in keep},
        frame_infos={k: v for k, v in metadata.get("frame_infos", {}).items()
                     if scene_of(v) is None or scene_of(v) in keep},
    )
    return out


def nuscenes_split_scenes(split_map: Dict[str, Any], version: str,
                          split: str) -> List[str]:
    """Scene tokens of one split from ds_name_to_scene_token.pkl
    (datasets/utils.py:55-68: {version: {'train'|'val': {name: token}}})."""
    return list(split_map[version][split].values())


def _frame_distances(obj: Dict[str, Any]) -> Dict[str, float]:
    """Per-frame ego BEV distance from all_sizes (see module docstring)."""
    sizes = obj.get("all_sizes")
    if sizes is None:
        return {}
    sizes = np.asarray(sizes, dtype=np.float64)
    if sizes.ndim != 2 or sizes.shape[1] < 2:
        return {}
    out: Dict[str, float] = {}
    for i, num in enumerate(obj.get("num_pts", {}).keys()):
        row = i if i < len(sizes) else -1
        out[str(num)] = float(np.sqrt((sizes[row, :2] ** 2).sum()))
    return out


def convert_obj_infos(obj_infos: Dict[str, Dict[str, Any]],
                      dataset: str = "nuscenes") -> List[ObjectRecord]:
    """lamtk obj_infos dict -> ObjectRecord list (field mapping above)."""
    records: List[ObjectRecord] = []
    for obj_id, obj in obj_infos.items():
        num_pts = {str(k): int(v) for k, v in obj.get("num_pts", {}).items()}
        if dataset == "waymo":
            box2d = obj.get("box2d", {})
            # degenerate list-typed box2d entries are unusable — the reference
            # returns [] from get_filtered_nums for them
            # (object_loader_base.py:403-409); import no visibility
            vis = ({str(k): 1 for k in box2d.keys()}
                   if isinstance(box2d, dict) else {})
        else:
            vis = {str(k): int(v)
                   for k, v in obj.get("visibility", {}).items()}
        rec = ObjectRecord(
            id=str(obj.get("id", obj_id)),
            class_name=str(obj["class_name"]),
            path=str(obj["path"]),
            num_pts=num_pts,
            visibility=vis,
            distance=_frame_distances(obj),
        )
        crop_size = obj.get("crop_size")
        if crop_size is not None:
            rec.crop_size = (int(crop_size[0]), int(crop_size[1]))
        records.append(rec)
    return records


def import_reference_store(
    metadata_path: str,
    data_root: str,
    dataset: str = "nuscenes",
    split_map_path: Optional[str] = None,
    version: str = "v1.0-trainval",
    split: str = "train",
    instance_token_to_id_path: Optional[str] = None,
    out_name: str = "objects.pkl",
    verify_crops: bool = False,
) -> Tuple[str, Dict[str, int]]:
    """End-to-end import: metadata [-> split filter] -> objects.pkl
    [+ token_to_int.pkl]. Returns (index path, summary stats).

    With verify_crops, every imported frame's pts_xyz.bin must exist under
    data_root (catches metadata/data mismatches up front instead of at
    sample time)."""
    assert dataset in ("nuscenes", "waymo"), dataset
    metadata = load_metadata(metadata_path)
    if split_map_path is not None:
        with open(split_map_path, "rb") as f:
            split_map = pickle.load(f)
        scenes = nuscenes_split_scenes(split_map, version, split)
        metadata = filter_by_scene_ids(metadata, scenes)

    records = convert_obj_infos(metadata.get("obj_infos", {}), dataset)

    missing = 0
    if verify_crops:
        for rec in records:
            for frame in rec.num_pts:
                p = os.path.join(data_root, rec.path, frame, "pts_xyz.bin")
                if not os.path.exists(p):
                    missing += 1
        if missing:
            raise FileNotFoundError(
                f"{missing} crop files named by the metadata are missing "
                f"under {data_root}")

    os.makedirs(data_root, exist_ok=True)
    out_path = os.path.join(data_root, out_name)
    write_records(out_path, records)

    if instance_token_to_id_path is not None:
        with open(instance_token_to_id_path, "rb") as f:
            token_to_int = pickle.load(f)
        with open(os.path.join(data_root, "token_to_int.pkl"), "wb") as f:
            pickle.dump({str(k): int(v) for k, v in token_to_int.items()}, f)

    n_fp = sum(1 for r in records if r.is_fp)
    stats = dict(
        objects=len(records),
        fp_objects=n_fp,
        tp_objects=len(records) - n_fp,
        frames=sum(len(r.num_pts) for r in records),
        classes=len({r.class_name for r in records}),
        with_distance=sum(1 for r in records if r.distance),
    )
    return out_path, stats
