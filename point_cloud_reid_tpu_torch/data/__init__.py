"""Data frontend: crop store, density-bucket index, pair samplers, batch pipeline.

Copies of point_cloud_reid_tpu/data (numpy only), so the same store, seed
and epoch give the same batches bit for bit in both packages:
  store.py            object crop store (pts_xyz.bin / img_crop.bin layout,
                      the JAX package's objects.pkl) + synthetic generator
  buckets.py          power-of-2 density bucketing (object_loader_base.py:
                      154-238)
  samplers.py         train pair sampler (reidentification_nuscenes.py:37-72)
                      and seeded point-count-matched val pairs (ValEven,
                      :151-246)
  pipeline.py         subsamplePC + fixed-shape batch collation + the
                      threaded BatchLoader
  import_reference.py published nuScenes-ReID / Waymo-ReID metadata ->
                      objects.pkl
The batched crop reads go through the native loader (../native).
"""
from .buckets import DensityBuckets, POW2_BUCKETS
from .pipeline import subsample_pc_np, collate_pairs, BatchLoader
from .samplers import (PairDataset, ValEvenPairs, ValErrPairs,
                       ClassBalancedPairs, ConcatPairs, RepeatPairs,
                       TrackingErrorsSampler, build_pair_dataset)
from .store import (CompleteStore, CropStore, FakeCompleteStore,
                    SyntheticStore, ObjectRecord)

__all__ = [
    "DensityBuckets", "POW2_BUCKETS", "subsample_pc_np", "collate_pairs",
    "BatchLoader", "PairDataset", "ValEvenPairs", "build_pair_dataset",
    "ConcatPairs", "RepeatPairs",
    "CropStore", "SyntheticStore", "ObjectRecord",
]
