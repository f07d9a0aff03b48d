"""Dataset axis: class maps and loader sizes of the point and image datasets.

A copy of the parts of point_cloud_reid_tpu/configs/datasets.py that
training reads (cls_to_idx, num_classes, fp_label_threshold,
samples_per_device, subsample sizes); the sampler specs come with the data
pipeline.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

NUSCENES_CLASSES = ["car", "truck", "construction_vehicle", "bus", "trailer",
                    "barrier", "motorcycle", "bicycle", "pedestrian",
                    "traffic_cone"]
WAYMO_CLASSES = ["car", "truck", "bus", "motorcycle", "bicycle", "pedestrian"]


def _dataset(classes, root, subsample_sparse: int, subsample_dense: int,
             mode: str, samples_per_device: int) -> Dict[str, Any]:
    cls_to_idx = {c: i for i, c in enumerate(classes)}
    return dict(
        root=root,
        samples_per_device=samples_per_device,
        num_classes=len(classes),
        # the reference's hardcoded `label > 9`, as num_classes - 1
        fp_label_threshold=len(classes) - 1,
        cls_to_idx=cls_to_idx,
        classes=classes,
        subsample_sparse=subsample_sparse,
        subsample_dense=subsample_dense,
        mode=mode,
    )


def nuscenes_pts(root: Optional[str] = None, subsample_sparse: int = 128,
                 samples_per_device: int = 256) -> Dict[str, Any]:
    """nuScenes-ReID point crops (reid_nuscenes_pts.py; 4x256 batch):
    10 classes, false-positive ids 10-19."""
    return _dataset(NUSCENES_CLASSES, root, subsample_sparse, 2048, "points",
                    samples_per_device)


def nuscenes_image(root: Optional[str] = None,
                   samples_per_device: int = 60) -> Dict[str, Any]:
    """nuScenes-ReID 224x224 image crops (reid_nuscenes_image.py; 4x60)."""
    return _dataset(NUSCENES_CLASSES, root, 224, 0, "image",
                    samples_per_device)


def waymo_image(root: Optional[str] = None,
                samples_per_device: int = 60) -> Dict[str, Any]:
    """Waymo-ReID 224x224 image crops: 6 classes, false-positive ids 6-11."""
    return _dataset(WAYMO_CLASSES, root, 224, 0, "image", samples_per_device)
