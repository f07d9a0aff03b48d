"""Seeded synthetic pair batches in the training batch-dict format.

A small in-memory stand-in for the data pipeline, for chip_smoke.py's
train-step phase and tools/profile_train.py: `num_objects` random shapes,
each a cloud of points around a few random blobs; a pair is two noisy
resamplings, of one object (positive) or of two (negative). With
image_size, the crops are images instead: each object a coarse random
pattern scaled up to image_size x image_size, a pair two noisy copies. The
batches exercise the trainer; nothing can be learned from them that
transfers.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class SyntheticPairLoader:
    """Iterable of batch dicts: sparse_1/2 (B, N, 3) float32 (with
    image_size, (B, 3, image_size, image_size) images), id_1/2, label_1/2,
    size_1/2, vis_1/2 (B,) int32, dist_1/2 (B,) float32 and, with
    dense_points, dense_1/2 (B, dense_points, 3). set_epoch reseeds the
    draw; the same (seed, epoch) gives the same batches. With num_shards >
    1, batch_size is the global batch and the loader yields shard
    `shard_id`'s contiguous rows of each, as data.BatchLoader does."""

    def __init__(self, batch_size: int, num_batches: int, num_points: int = 128,
                 num_objects: int = 60, num_classes: int = 10,
                 dense_points: int = 0, seed: int = 0, image_size: int = 0,
                 shard_id: int = 0, num_shards: int = 1):
        if batch_size % num_shards or not 0 <= shard_id < num_shards:
            raise ValueError((batch_size, shard_id, num_shards))
        self.shard_id, self.num_shards = shard_id, num_shards
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.num_points = num_points
        self.num_classes = num_classes
        self.dense_points = dense_points
        self.seed = seed
        self.epoch = 0
        rs = np.random.RandomState(seed)
        self.blobs = rs.randn(num_objects, 6, 3).astype(np.float32) * 0.6
        self.labels = rs.randint(0, num_classes, num_objects)
        self.image_size = image_size
        if image_size:
            self.patterns = rs.randn(num_objects, 3, 14, 14).astype(
                np.float32)

    def __len__(self) -> int:
        return self.num_batches

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _crops(self, rs, ids, n) -> np.ndarray:
        if self.image_size:
            size = self.image_size
            up = -(-size // 14)
            img = self.patterns[ids].repeat(up, axis=2).repeat(up, axis=3)
            img = img[:, :, :size, :size]
            return img + rs.randn(*img.shape).astype(np.float32) * 0.1
        which = rs.randint(0, self.blobs.shape[1], (len(ids), n))
        centres = self.blobs[ids[:, None], which]
        return (centres + rs.randn(len(ids), n, 3) * 0.15).astype(np.float32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rs = np.random.RandomState([self.seed, self.epoch])
        B, n_obj = self.batch_size, len(self.labels)
        for _ in range(self.num_batches):
            id_1 = rs.randint(0, n_obj, B)
            other = (id_1 + rs.randint(1, n_obj, B)) % n_obj
            id_2 = np.where(rs.rand(B) < 0.5, id_1, other)
            batch = dict(
                sparse_1=self._crops(rs, id_1, self.num_points),
                sparse_2=self._crops(rs, id_2, self.num_points),
                id_1=id_1.astype(np.int32), id_2=id_2.astype(np.int32),
                label_1=self.labels[id_1].astype(np.int32),
                label_2=self.labels[id_2].astype(np.int32),
                size_1=rs.randint(1, 2048, B).astype(np.int32),
                size_2=rs.randint(1, 2048, B).astype(np.int32),
                vis_1=rs.randint(0, 4, B).astype(np.int32),
                vis_2=rs.randint(0, 4, B).astype(np.int32),
                dist_1=(rs.rand(B) * 60).astype(np.float32),
                dist_2=(rs.rand(B) * 60).astype(np.float32))
            if self.dense_points:
                batch["dense_1"] = self._crops(rs, id_1, self.dense_points)
                batch["dense_2"] = self._crops(rs, id_2, self.dense_points)
            n = B // self.num_shards
            yield {k: v[self.shard_id * n:(self.shard_id + 1) * n]
                   for k, v in batch.items()}
