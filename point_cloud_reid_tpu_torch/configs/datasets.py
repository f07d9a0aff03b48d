"""Dataset axis: class maps and loader/sampler specs of the point and image
datasets.

A copy of point_cloud_reid_tpu/configs/datasets.py (class maps as the
reference dataset bases: nuScenes 10 classes, FP ids 10-19,
reid_nuscenes_pts.py:1-120; Waymo 6 classes, FP ids 6-11,
reid_waymo_pts.py:1-50). Besides the JAX dict's keys, each dict carries
the specs' subsample_sparse at its top level, as the port's earlier copy
did (the samplers read the train and val specs' own).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

NUSCENES_CLASSES = ["car", "truck", "construction_vehicle", "bus", "trailer",
                    "barrier", "motorcycle", "bicycle", "pedestrian",
                    "traffic_cone"]

NUSCENES_TRACKING = {
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
    "bicycle": "bicycle", "truck": "truck", "car": "car",
    "trailer": "trailer", "bus": "bus", "motorcycle": "motorcycle",
    "pedestrian": "pedestrian",
}

WAYMO_CLASSES = ["car", "truck", "bus", "motorcycle", "bicycle", "pedestrian"]
WAYMO_TRACKING = {c: c for c in WAYMO_CLASSES}


def _dataset(classes, tracking, root: Optional[str], subsample_sparse: int,
             subsample_dense: int, mode: str, samples_per_device: int,
             max_combinations: int = 10, synthetic: Optional[Dict] = None):
    cls_to_idx = {c: i for i, c in enumerate(classes)}
    base = dict(classes=classes, cls_to_idx=cls_to_idx,
                tracking_classes=tracking, subsample_sparse=subsample_sparse,
                subsample_dense=subsample_dense, mode=mode)
    return dict(
        root=root,
        synthetic=synthetic,        # SyntheticStore kwargs when root is None
        samples_per_device=samples_per_device,
        num_classes=len(classes),
        # the reference's hardcoded `label > 9` (ReIDNet.py:372), as
        # num_classes - 1 per dataset
        fp_label_threshold=len(classes) - 1,
        cls_to_idx=cls_to_idx,
        subsample_sparse=subsample_sparse,
        train=dict(split="train", seed=0, **base),
        val=dict(split="val", validation_seed=0,
                 max_combinations=max_combinations, **base),
    )


def nuscenes_pts(root: Optional[str] = None, subsample_sparse: int = 128,
                 samples_per_device: int = 256, **kw) -> Dict[str, Any]:
    """nuScenes-ReID point crops (reid_nuscenes_pts.py; 4x256 batch)."""
    return _dataset(NUSCENES_CLASSES, NUSCENES_TRACKING, root,
                    subsample_sparse, 2048, "points", samples_per_device, **kw)


def waymo_pts(root: Optional[str] = None, subsample_sparse: int = 128,
              samples_per_device: int = 256, **kw) -> Dict[str, Any]:
    """Waymo-ReID point crops (reid_waymo_pts.py)."""
    return _dataset(WAYMO_CLASSES, WAYMO_TRACKING, root, subsample_sparse,
                    2048, "points", samples_per_device, **kw)


def nuscenes_image(root: Optional[str] = None,
                   samples_per_device: int = 60, **kw) -> Dict[str, Any]:
    """nuScenes-ReID 224x224 image crops (reid_nuscenes_image.py; 4x60)."""
    return _dataset(NUSCENES_CLASSES, NUSCENES_TRACKING, root, 224, 0,
                    "image", samples_per_device, **kw)


def waymo_image(root: Optional[str] = None,
                samples_per_device: int = 60, **kw) -> Dict[str, Any]:
    """Waymo-ReID 224x224 image crops: 6 classes, false-positive ids 6-11."""
    return _dataset(WAYMO_CLASSES, WAYMO_TRACKING, root, 224, 0, "image",
                    samples_per_device, **kw)
