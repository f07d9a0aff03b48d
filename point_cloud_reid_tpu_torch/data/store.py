"""Object crop store: per-object, per-frame LiDAR/image crops on disk.

A copy of point_cloud_reid_tpu/data/store.py (numpy only): the same records,
the same synthetic generator, the same batched loaders. Keeps the
reference's on-disk crop layout so existing nuScenes-ReID / Waymo-ReID
exports load unchanged (object_loader_base.py:247-301):

    {root}/{obj.path}/{frame}/pts_xyz.bin   float32 (N, 3) flat
    {root}/{obj.path}/{frame}/img_crop.bin  float32 (3, H, W) flat

with the JAX package's self-describing `objects.pkl` index: a pickled list
of point_cloud_reid_tpu.data.store.ObjectRecord. `read_pickle` maps that
class path (and this module's) onto this module's ObjectRecord without
importing the JAX package; `write_records` writes the JAX class path, so a
store written here reads in the JAX package too. Missing image crops load
as zeros — the reference's deliberate soft-failure
(object_loader_base.py:289-295).

`SyntheticStore` generates a complete fake dataset (the reference's
FakeCompleteLoader pattern generalized, object_loader_base.py:499-504) for tests
and benchmarks: procedurally-generated per-object point clouds with consistent
per-object shape so ReID training on it is learnable.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class ObjectRecord:
    """Metadata for one object track in the store.

    Mirrors the fields the reference reads off lamtk obj_infos: id, class_name,
    path, num_pts/visibility dicts keyed by frame id (object_loader_base.py:99-141).
    """

    id: str
    class_name: str
    path: str
    num_pts: Dict[str, int]
    visibility: Dict[str, int] = dataclasses.field(default_factory=dict)
    # per-frame ego BEV distance in meters — the reference derives it as
    # sqrt(sum(all_sizes[nums_to_distance[frame], :2] ** 2)) at sample time
    # (reidentification_waymo.py:168-196, reidentification_nuscenes.py:320-346,
    # object_loader_base.py:135-139); the store exporter precomputes the norm.
    distance: Dict[str, float] = dataclasses.field(default_factory=dict)
    # stored image-crop size when it differs from the loader's target size —
    # the reference reshapes by the metadata size then crops to the target
    # (object_loader_base.py:285-287); None means crops are already target-size
    crop_size: Optional[Tuple[int, int]] = None

    @property
    def is_fp(self) -> bool:
        # FP objects are detector false positives, id-prefixed "FP_"
        # (reidentification_base.py:214, object_loader_base.py:186-190)
        return self.id.startswith("FP")


# the class path every objects.pkl holds: the JAX package's ObjectRecord
_RECORD_MODULE = "point_cloud_reid_tpu.data.store"
_RECORD_MODULES = (_RECORD_MODULE, __name__)


class _RecordUnpickler(pickle.Unpickler):
    """Resolves ObjectRecord under the JAX package's module path or this
    one's to this module's class, so reading a store imports nothing of
    the JAX package."""

    def find_class(self, module, name):
        if name == "ObjectRecord" and module in _RECORD_MODULES:
            return ObjectRecord
        return super().find_class(module, name)


class _RecordPickler(pickle._Pickler):
    """Pickles ObjectRecord under the JAX package's module path, the
    format every store holds, without importing that package (the C
    pickler checks that a class's module imports)."""

    def save_global(self, obj, name=None):
        if obj is not ObjectRecord:
            return super().save_global(obj, name)
        # what pickle._Pickler.save_global writes for a class (protocol 4+)
        self.save(_RECORD_MODULE)
        self.save("ObjectRecord")
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def read_pickle(path: str):
    """A store's pickle (objects.pkl, token_to_int.pkl), whichever package
    wrote it."""
    with open(path, "rb") as f:
        return _RecordUnpickler(f).load()


def write_records(path: str, records: Sequence[ObjectRecord]) -> None:
    """objects.pkl as the JAX package writes it: pickle.dump of the list at
    the default protocol, the records under the JAX class path."""
    with open(path, "wb") as f:
        _RecordPickler(f, pickle.DEFAULT_PROTOCOL).dump(list(records))


class CropStore:
    """Reads crops + metadata; analogous to ObjectLoaderSparse*/Complete*.

    Args:
        root: dataset root containing objects.pkl and crop directories.
        min_points: frames with fewer points are filtered out (filter_mode 'pts',
            object_loader_base.py:117-123).
        filter_mode: 'pts' | 'vis' | 'pts and vis' (reference filter modes).
        crop_size: (H, W) of image crops.
        load_fraction: fraction of each frame's points to load, taken from the
            file tail (reference load semantics, object_loader_base.py:258-268).
    """

    def __init__(self, root: str, min_points: int = 1, filter_mode: str = "pts",
                 crop_size: Tuple[int, int] = (224, 224),
                 load_fraction: float = 1.0):
        self.root = root
        self.min_points = min_points
        self.filter_mode = filter_mode
        self.crop_size = tuple(crop_size)
        self.load_fraction = load_fraction
        records: List[ObjectRecord] = read_pickle(
            os.path.join(root, "objects.pkl"))
        for r in records:
            if not hasattr(r, "distance"):   # pre-distance-schema pickles
                r.distance = {}
            if not hasattr(r, "crop_size"):
                r.crop_size = None
        self.objects: Dict[str, ObjectRecord] = {r.id: r for r in records}
        # stable integer id per TP object token: the real datasets' mapping
        # (reference instance_token_to_id.pkl,
        # reidentification_nuscenes.py:20-22) when the importer staged it,
        # else sorted enumeration — which matches the reference's own
        # construction (instances sorted by token, datasets/utils.py:71-76)
        tok_map = os.path.join(root, "token_to_int.pkl")
        if os.path.exists(tok_map):
            self.token_to_int = read_pickle(tok_map)
            # fail fast at load: a staged mapping that misses a TP token
            # (wrong split's instance_token_to_id.pkl, import without
            # --split-map) would otherwise KeyError mid-epoch deep inside a
            # loader worker (PairDataset._int_id)
            missing = [t for t, r in self.objects.items()
                       if not r.is_fp and t not in self.token_to_int]
            if missing:
                raise ValueError(
                    f"token_to_int.pkl at {root} is missing {len(missing)} "
                    f"TP object token(s) present in objects.pkl (first: "
                    f"{missing[0]!r}) — staged from the wrong split?")
        else:
            self.token_to_int = {tok: i
                                 for i, tok in enumerate(sorted(self.objects))}

    # ---- frame filtering (object_loader_base.py:99-141) ---------------------

    def filtered_frames(self, rec: ObjectRecord) -> List[str]:
        """Usable frames under filter_mode ('pts'|'vis'|'pts and vis'|'both'),
        mirroring get_filtered_nums (object_loader_base.py:99-141). For Waymo
        the reference keys 'visibility' off box2d presence
        (object_loader_base.py:377-431) — the store exporter writes that
        presence into ObjectRecord.visibility, so one implementation covers
        both datasets."""
        def by_pts(frames):
            return [f for f in frames if rec.num_pts.get(f, 0) >= self.min_points]

        frames = sorted(rec.num_pts.keys(), key=int)
        if self.filter_mode == "pts":
            return by_pts(frames)
        if self.filter_mode == "vis":
            return sorted(rec.visibility.keys(), key=int)
        if self.filter_mode == "pts and vis":
            vis = set(rec.visibility.keys())
            return [f for f in by_pts(frames) if f in vis]
        if self.filter_mode == "both":
            both = set(rec.num_pts) | set(rec.visibility)
            return sorted(both, key=int)
        raise ValueError(f"filter_mode {self.filter_mode}")

    def frame_index(self) -> Dict[str, List[str]]:
        """obj id -> usable frame list (collect_obj_id_to_nums,
        object_loader_base.py:143-147)."""
        return {k: self.filtered_frames(v) for k, v in self.objects.items()}

    # ---- crop IO -------------------------------------------------------------

    def _frame_dir(self, rec: ObjectRecord, frame: str) -> str:
        return os.path.join(self.root, rec.path, str(frame))

    def load_points(self, obj_id: str, frame: str) -> np.ndarray:
        """(N, 3) float32 xyz crop, already centered in the box frame by the
        exporter (reference load_points, object_loader_base.py:247-269)."""
        rec = self.objects[obj_id]
        path = os.path.join(self._frame_dir(rec, frame), "pts_xyz.bin")
        n_total = os.stat(path).st_size // (4 * 3)
        n_skip = n_total - int(n_total * self.load_fraction)
        return np.fromfile(path, offset=4 * 3 * n_skip,
                           dtype=np.float32).reshape(-1, 3)

    def points_path(self, obj_id: str, frame: str) -> str:
        return os.path.join(self._frame_dir(self.objects[obj_id], str(frame)),
                            "pts_xyz.bin")

    def load_point_batch(self, pairs, k: int, seeds) -> "np.ndarray":
        """Batched native-path load+resample of many (obj, frame) crops.

        Uses the C++ thread-pool loader (native/crop_loader.cpp, built at
        first use; a failed build raises); returns ((B, k, 3) float32, (B,)
        int32 counts).
        Note: full-file reads (load_fraction=1.0 only).
        """
        assert self.load_fraction == 1.0, "native batch path reads whole files"
        from .. import native
        paths = [self.points_path(o, f) for o, f in pairs]
        return native.load_point_batch(paths, k, seeds)

    def load_point_batch_strided(self, path_rows: "np.ndarray", k: int,
                                 seeds) -> "np.ndarray":
        """load_point_batch over a fixed-width bytes array of pre-built paths
        (one fancy-index gather from _PlanTables' path table) — no per-item
        Python marshalling. Same contract as load_point_batch."""
        assert self.load_fraction == 1.0, "native batch path reads whole files"
        from .. import native
        return native.load_point_batch_strided(path_rows, k, seeds)

    def load_image_batch(self, pairs) -> Tuple[np.ndarray, np.ndarray]:
        """Batched native read of many (obj, frame) img_crop.bin blobs.

        Returns ((B, 3, H, W) float32 at the loader crop_size, (B,) int32 ok
        flags; -1 = missing/short file, loaded as zeros — the reference's
        soft-failure semantics, object_loader_base.py:289-295). Records whose
        STORED crop size differs from the loader's are grouped per stored
        size, read at that size, and sliced like load_image (oversize crops
        truncate, object_loader_base.py:285-287; undersized raise)."""
        from .. import native
        H, W = self.crop_size
        out = np.zeros((len(pairs), 3, H, W), np.float32)
        ok = np.full((len(pairs),), -1, np.int32)
        groups: Dict[Tuple[int, int], List[int]] = {}
        for b, (o, f) in enumerate(pairs):
            stored = self.objects[o].crop_size or self.crop_size
            groups.setdefault(tuple(stored), []).append(b)
        for stored, idxs in groups.items():
            paths = [os.path.join(
                self._frame_dir(self.objects[pairs[b][0]], pairs[b][1]),
                "img_crop.bin") for b in idxs]
            if stored[0] < H or stored[1] < W:
                # per-item parity (load_image): a MISSING or truncated file
                # soft-fails to zeros (its reshape ValueError is caught)
                # before the undersize check ever runs; only a crop that
                # actually reads complete at the stored size fails fast
                nbytes = 4 * 3 * stored[0] * stored[1]
                for b, p in zip(idxs, paths):
                    if os.path.exists(p) and os.path.getsize(p) == nbytes:
                        o, f = pairs[b]
                        raise ValueError(
                            f"stored crop {stored} for {o}/{f} is smaller "
                            f"than loader crop_size {self.crop_size}")
                continue             # all missing/short -> zeros, ok=-1
            blobs, g_ok = native.load_blob_batch(paths, (3,) + stored)
            out[idxs] = blobs[:, :, :H, :W]
            ok[idxs] = g_ok
        return out, ok

    def load_image(self, obj_id: str, frame: str) -> np.ndarray:
        """(3, H, W) float32 image crop; zeros when the crop file is missing
        (object_loader_base.py:289-295)."""
        rec = self.objects[obj_id]
        path = os.path.join(self._frame_dir(rec, frame), "img_crop.bin")
        stored = rec.crop_size or self.crop_size
        try:
            im = np.fromfile(path, dtype=np.float32).reshape((3,) + tuple(stored))
        except (FileNotFoundError, ValueError):
            return np.zeros((3,) + self.crop_size, dtype=np.float32)
        if tuple(im.shape[1:]) != self.crop_size:
            # reshape by the stored size, crop to the target — the
            # reference's oversize-crop handling (object_loader_base.py:285-287).
            # Undersized crops fail fast (outside the zeros-fallback try): a
            # silent slice would emit a ragged array that breaks the
            # fixed-shape batch far from here.
            if (im.shape[1] < self.crop_size[0]
                    or im.shape[2] < self.crop_size[1]):
                raise ValueError(
                    f"stored crop {im.shape[1:]} for {obj_id}/{frame} is "
                    f"smaller than loader crop_size {self.crop_size}")
            im = im[:, :self.crop_size[0], :self.crop_size[1]]
        return im


class FakeCompleteStore:
    """Zeros stand-in for the dense complete-shape store — used by every released
    config since the shape loss is off (object_loader_base.py:499-504)."""

    def __init__(self, subsample_num: int = 2048):
        self.ssn = subsample_num

    def load_complete(self, obj_id: str) -> np.ndarray:
        return np.zeros((self.ssn, 3), dtype=np.float32)


class CompleteStore:
    """On-disk dense complete-shape store.

    Real equivalent of ObjectLoaderComplete{Nuscenes,Waymo}
    (object_loader_base.py:469-497): those subclass the lamtk Loader
    directly, whose load_points(info) reads the per-OBJECT aggregate at
    {data_root}/{obj.path}/pts_xyz.bin (no frame subdirectory) — the layout
    the published complete exports use. This store reads that first, falling
    back to the synthetic-store name complete_pts_xyz.bin; missing shapes
    load as zeros (the FakeCompleteLoader stand-in semantics all released
    configs use).
    """

    def __init__(self, root: str, subsample_num: int = 2048):
        self.root = root
        self.ssn = subsample_num
        idx = os.path.join(root, "objects.pkl")
        self.objects: Dict[str, ObjectRecord] = {}
        if os.path.exists(idx):
            self.objects = {r.id: r for r in read_pickle(idx)}

    def load_complete(self, obj_id: str) -> np.ndarray:
        rec = self.objects.get(obj_id)
        rel = rec.path if rec is not None else obj_id
        for name in ("pts_xyz.bin", "complete_pts_xyz.bin"):
            path = os.path.join(self.root, rel, name)
            if os.path.exists(path):
                return np.fromfile(path, dtype=np.float32).reshape(-1, 3)
        return np.zeros((self.ssn, 3), dtype=np.float32)


class SyntheticStore:
    """Procedural in-memory dataset with the CropStore interface.

    Each object is a random gaussian-blob "shape" with a per-object signature
    (anisotropic scale + offset pattern), observed over `frames_per_obj` frames
    at varying densities — so match training on it is actually learnable and the
    density-bucket machinery is exercised. Used by tests and bench.py in place
    of the external nuScenes/Waymo-ReID downloads (SURVEY.md §7 hard part 6).
    """

    def __init__(self, num_objects: int = 40, frames_per_obj: int = 6,
                 num_classes: int = 10, fp_fraction: float = 0.25,
                 min_points: int = 5, seed: int = 0,
                 point_range: Tuple[int, int] = (8, 400),
                 crop_size: Tuple[int, int] = (32, 32), with_images: bool = False,
                 class_names: Optional[Sequence[str]] = None,
                 metadata_only: bool = False):
        """metadata_only skips generating the per-frame point/crop ARRAYS
        (num_pts/visibility/distance metadata only) — pair PLANNING is a
        pure function of the metadata, so planner-scale profiling at
        nuScenes-ReID index sizes (50-100k objects) doesn't need gigabytes
        of synthetic points. load_points raises on such a store."""
        rng = np.random.RandomState(seed)
        if class_names is not None:
            num_classes = len(class_names)
        self.min_points = min_points
        self.crop_size = tuple(crop_size)
        self.with_images = with_images
        self.objects: Dict[str, ObjectRecord] = {}
        self._points: Dict[Tuple[str, str], np.ndarray] = {}
        self._images: Dict[Tuple[str, str], np.ndarray] = {}
        self._complete: Dict[str, np.ndarray] = {}

        n_fp = int(num_objects * fp_fraction)
        for i in range(num_objects):
            is_fp = i < n_fp
            tok = (f"FP_obj{i:04d}" if is_fp else f"obj{i:04d}")
            # round-robin within each of the FP/TP groups so every class gets
            # even coverage even in tiny test datasets; FP objects span only
            # as many classes as allows >=2 objects per FP class
            if is_fp:
                cls = i % max(1, min(num_classes, n_fp // 2))
            else:
                cls = (i - n_fp) % num_classes
            scale = 0.5 + rng.rand(3) * 2.0          # per-object signature
            base = rng.randn(64, 3) * scale           # canonical shape
            # ego-relative BEV trajectory: random start 2-55m + per-frame drift
            # (mirrors the all_sizes xy metadata the real exporter writes)
            bev = 2.0 + rng.rand(2) * np.array([53.0, 8.0]) * rng.choice(
                [-1.0, 1.0], size=2)
            num_pts, vis, dist = {}, {}, {}
            n_frames = 1 if is_fp else frames_per_obj
            for f in range(n_frames):
                n = int(rng.randint(point_range[0], point_range[1]))
                frame = str(f)
                if not metadata_only:
                    idx = rng.randint(0, 64, size=n)
                    pts = (base[idx]
                           + rng.randn(n, 3) * 0.05).astype(np.float32)
                    self._points[(tok, frame)] = pts
                num_pts[frame] = n
                vis[frame] = int(rng.randint(1, 5))   # nuScenes vis levels 1-4
                bev = bev + rng.randn(2) * 1.5
                dist[frame] = float(np.sqrt((bev ** 2).sum()))
                if with_images and not metadata_only:
                    im = rng.randn(3, *self.crop_size).astype(np.float32) * 0.1
                    im += scale[:, None, None]         # per-object signature
                    self._images[(tok, frame)] = im
            self.objects[tok] = ObjectRecord(
                id=tok,
                class_name=(class_names[cls] if class_names is not None
                            else f"class_{cls}"),
                path=tok,
                num_pts=num_pts, visibility=vis, distance=dist,
                # image exports record their stored crop size (the importer
                # does the same, import_reference.py) so a loader with a
                # smaller crop_size slices instead of zeroing
                crop_size=(self.crop_size if with_images else None))
            self._complete[tok] = (base + rng.randn(64, 3) * 0.02).astype(
                np.float32)
        self.token_to_int = {tok: i for i, tok in enumerate(sorted(self.objects))}
        self.filter_mode = "pts"

    def filtered_frames(self, rec: ObjectRecord) -> List[str]:
        return [f for f in sorted(rec.num_pts, key=int)
                if rec.num_pts[f] >= self.min_points]

    def frame_index(self) -> Dict[str, List[str]]:
        return {k: self.filtered_frames(v) for k, v in self.objects.items()}

    def load_points(self, obj_id: str, frame: str) -> np.ndarray:
        return self._points[(obj_id, str(frame))]

    def load_image(self, obj_id: str, frame: str) -> np.ndarray:
        key = (obj_id, str(frame))
        if key in self._images:
            return self._images[key]
        return np.zeros((3,) + self.crop_size, dtype=np.float32)

    def load_complete(self, obj_id: str) -> np.ndarray:
        return self._complete[obj_id]

    def save(self, root: str):
        """Materialize to the on-disk CropStore layout (for IO-path tests and
        the native C++ reader)."""
        os.makedirs(root, exist_ok=True)
        for (tok, frame), pts in self._points.items():
            d = os.path.join(root, tok, frame)
            os.makedirs(d, exist_ok=True)
            pts.astype(np.float32).tofile(os.path.join(d, "pts_xyz.bin"))
        for (tok, frame), im in self._images.items():
            d = os.path.join(root, tok, frame)
            os.makedirs(d, exist_ok=True)
            im.astype(np.float32).tofile(os.path.join(d, "img_crop.bin"))
        for tok, pts in self._complete.items():
            d = os.path.join(root, tok)
            os.makedirs(d, exist_ok=True)
            pts.astype(np.float32).tofile(
                os.path.join(d, "complete_pts_xyz.bin"))
        write_records(os.path.join(root, "objects.pkl"),
                      self.objects.values())
