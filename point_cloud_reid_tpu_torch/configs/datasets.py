"""Dataset axis: class maps and loader sizes of the point datasets.

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


def nuscenes_pts(root: Optional[str] = None, subsample_sparse: int = 128,
                 samples_per_device: int = 256) -> Dict[str, Any]:
    """nuScenes-ReID point crops (reid_nuscenes_pts.py; 4x256 batch):
    10 classes, false-positive ids 10-19."""
    classes = NUSCENES_CLASSES
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
        subsample_dense=2048,
    )
