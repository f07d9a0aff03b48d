"""Power-of-2 density bucketing for point-count-matched pair sampling.

A copy of point_cloud_reid_tpu/data/buckets.py (numpy only).

Rebuilds the reference's bucket machinery (object_loader_base.py:154-238):
every frame of every object is binned by floor(log2(num_points)); per-object
bucket->frames maps plus a per-class global index of (object, bucket) pairs power
the density-matched negative mining in both train and val samplers.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# (2^i, 2^{i+1}) half-open bins, i in [0, 20) (object_loader_base.py:156)
POW2_BUCKETS: List[Tuple[int, int]] = [(2 ** i, 2 ** (i + 1)) for i in range(20)]


def bucket_of(n_points: int) -> int:
    """Bucket index of a point count (floor log2; 0 points -> bucket -1 clamps
    to 0 at use sites, mirroring special_log, object_loader_base.py:240-243)."""
    if n_points <= 0:
        return 0
    return min(int(np.log2(n_points)), len(POW2_BUCKETS) - 1)


class DensityBuckets:
    """Per-object and per-class density indexes.

    Args:
        frames: obj_id -> usable frame list (CropStore.frame_index()).
        num_pts: obj_id -> {frame: count}.
        class_of: obj_id -> class key. FP objects must already carry their
            'FP_'-prefixed class key (get_all_buckets, object_loader_base.py:177-199).
    """

    def __init__(self, frames: Dict[str, List[str]],
                 num_pts: Dict[str, Dict[str, int]],
                 class_of: Dict[str, str]):
        self.obj_buckets: Dict[str, Dict[int, List[str]]] = {}
        self.distribution: Dict[str, np.ndarray] = {}
        for obj, fl in frames.items():
            ob: Dict[int, List[str]] = {}
            for f in fl:
                ob.setdefault(bucket_of(num_pts[obj][f]), []).append(f)
            self.obj_buckets[obj] = ob
            dist = np.array([len(ob.get(i, [])) for i in
                             range(len(POW2_BUCKETS))], dtype=np.float64)
            s = dist.sum()
            self.distribution[obj] = dist / s if s > 0 else dist

        # class key -> bucket -> [(obj_id, n_frames)] (get_all_buckets)
        self.class_buckets: Dict[str, Dict[int, List[Tuple[str, int]]]] = {}
        for obj, ob in self.obj_buckets.items():
            ck = class_of.get(obj)
            if ck is None:
                continue
            cb = self.class_buckets.setdefault(ck, {})
            for b, fl in ob.items():
                cb.setdefault(b, []).append((obj, len(fl)))

    # ---- queries -------------------------------------------------------------

    def nearest_nonempty_bucket(self, obj: str, density: int) -> int:
        """Walk down then up from `density` to a bucket this object populates
        (get_random_frame_even search order, object_loader_base.py:201-215)."""
        ob = self.obj_buckets[obj]
        d = density
        while not ob.get(d):
            d -= 1
            if d < 0:
                d = 0
                while not ob.get(d):
                    d += 1
                    if d >= len(POW2_BUCKETS):
                        raise LookupError(f"object {obj} has no frames")
                break
        return d

    def random_frame_in_bucket(self, rng: np.random.RandomState, obj: str,
                               density: int) -> str:
        d = self.nearest_nonempty_bucket(obj, density)
        return rng.choice(self.obj_buckets[obj][d])

    def class_list_at_density(self, class_key: str, density: int
                              ) -> Tuple[List[Tuple[str, int]], int]:
        """Nearest bucket (down-then-up) of this class with >= 2 candidate
        objects (get_class_list_density, object_loader_base.py:217-238).

        Design delta: the reference raises when no single bucket holds >= 2
        objects; we fall back to the union of all buckets of the class (losing
        density matching but keeping small datasets usable) and only raise when
        the class has < 2 objects outright.
        """
        cb = self.class_buckets.get(class_key, {})
        d = density
        while len(cb.get(d, [])) <= 1:
            d -= 1
            if d < 0:
                d = 0
                while len(cb.get(d, [])) <= 1:
                    d += 1
                    if d >= len(POW2_BUCKETS):
                        merged: Dict[str, int] = {}
                        for lst in cb.values():
                            for obj, n in lst:
                                merged[obj] = merged.get(obj, 0) + n
                        if len(merged) >= 2:
                            return sorted(merged.items()), density
                        raise LookupError(
                            f"class {class_key} has <2 objects")
                break
        return cb[d], d

    def sample_density(self, rng: np.random.RandomState, obj: str) -> int:
        """Draw a bucket index from the object's own density distribution
        (get_random_other_even_train, reidentification_base.py:322-324)."""
        return int(rng.choice(len(POW2_BUCKETS), p=self.distribution[obj]))
