"""Batch pipeline: fixed-shape collation + background batch assembly.

A copy of point_cloud_reid_tpu/data/pipeline.py (numpy only). The JAX
package's prefetch to the device is, in the port, a `transform` that pins
each batch in the worker thread (train/loop.pin_batch); the trainer's
to_device then copies it with non_blocking=True.

Replaces the reference's torch DataLoader + DataContainer collate + per-key list
re-stacking inside the model (apis/train.py:34-45, ReIDNet.preprocess_inputs,
ReIDNet.py:266-279) with direct numpy batch assembly: the sampler already yields
fixed-shape numpy items, so collation is a stack and the model sees plain arrays.

subsample_pc_np reproduces subsamplePC exactly (datasets/utils.py:606-621):
random resample WITH replacement to a fixed count; all-zeros when the crop has
fewer than 3 points. This is what makes every downstream shape static — the
load-bearing trick behind every fixed-shape kernel launch.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np


def subsample_pc_np(rng: np.random.RandomState, pc: np.ndarray,
                    n: int) -> np.ndarray:
    """(N, C>=3) -> (n, 3) via resample-with-replacement; zeros if N < 3.

    Mirrors subsamplePC (datasets/utils.py:606-621), including the keep-as-is
    path when N == n and the xyz-only truncation.
    """
    if n == 0:
        return pc.astype(np.float32)
    if pc.shape[0] <= 2:
        return np.zeros((n, 3), dtype=np.float32)
    pc = pc[:, :3]
    if pc.shape[0] != n:
        idx = rng.randint(0, pc.shape[0], size=n)
        pc = pc[idx]
    return np.ascontiguousarray(pc, dtype=np.float32)


def collate_pairs(items) -> Dict[str, np.ndarray]:
    """Stack a list of sampler items into one fixed-shape numpy batch."""
    out: Dict[str, np.ndarray] = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        out[k] = np.stack(vals) if np.ndim(vals[0]) > 0 else np.asarray(vals)
    return out


class BatchLoader:
    """Iterates fixed-size batches from a PairDataset with background workers.

    The reference uses worker subprocesses (workers_per_gpu, apis/train.py:37);
    here pair selection is numpy-cheap metadata work and the heavy part —
    reading + resampling B*2 crops (or reading B*2 image blobs) — runs
    through the dataset's `sample_batch` when it supports it: ONE call into
    the native C++ thread pool per batch (native/, GIL released). Datasets without the batch path (synthetic/in-memory, dense
    tensors on) fall back to per-item sampling + collate.

    Args:
        dataset: PairDataset/ValEvenPairs.
        batch_size: GLOBAL batch; with num_shards > 1 each process yields its
            batch_size/num_shards contiguous block of every global batch.
        shuffle: iterate a permutation of the index space each epoch.
        drop_last: drop the trailing partial batch (val: the metric depends
            on which pairs are kept, so it drops as the JAX package does).
        shard_id/num_shards: multi-process data partitioning — the
            DistributedSampler equivalent (reference apis/train.py:34-45).
            Every process plans the same global index order (same seed/epoch)
            and takes its contiguous slice of each batch, the process-local
            row block of the global batch. Without this, multi-process
            training would feed every sample process_count times.
        transform: optional fn(batch_dict) -> batch_dict, run in the worker
            thread (train/loop.pin_batch pins a batch for the upload).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 num_threads: int = 2, prefetch: int = 4,
                 shard_id: int = 0, num_shards: int = 1,
                 transform: Optional[Callable] = None):
        if num_shards > 1:
            if batch_size % num_shards:
                raise ValueError(
                    f"global batch {batch_size} not divisible by "
                    f"num_shards={num_shards}")
            if not drop_last:
                raise ValueError("num_shards > 1 requires drop_last=True "
                                 "(a ragged tail batch cannot be sharded "
                                 "evenly across processes)")
            if not 0 <= shard_id < num_shards:
                raise ValueError((shard_id, num_shards))
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.transform = transform
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch, seed=self.seed)

    def _index_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        return order

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._index_order()
        nb = len(self)
        use_batch_load = getattr(self.dataset, "supports_batch_load", False)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        window = threading.Condition()
        delivered = [0]

        def bounded_put(item) -> bool:
            # a consumer that aborted (stop set) drains the queue once and
            # leaves; with num_threads > prefetch that single drain can race
            # with putters mid-wakeup and strand the rest on a full queue
            # forever — so never block on put without re-checking stop
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker(worker_id: int):
            for b in range(worker_id, nb, self.num_threads):
                # bound total in-flight batches: without this gate a slow
                # batch lets fast workers run ahead and the consumer's
                # reordering dict grows unboundedly
                with window:
                    window.wait_for(
                        lambda: stop.is_set()
                        or b < delivered[0] + self.prefetch + self.num_threads)
                if stop.is_set():
                    return
                idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                if self.num_shards > 1:
                    per = self.batch_size // self.num_shards
                    idxs = idxs[self.shard_id * per:
                                (self.shard_id + 1) * per]
                try:
                    if use_batch_load:
                        # whole batch read+resampled by the C++ thread pool
                        # in one call (GIL released) — the training fast path
                        batch = self.dataset.sample_batch(idxs)
                    else:
                        batch = collate_pairs([self.dataset.sample(int(i))
                                               for i in idxs])
                    if self.transform is not None:
                        batch = self.transform(batch)
                except BaseException as e:   # propagate instead of deadlock:
                    # a dead worker would leave the consumer blocked on
                    # q.get() forever waiting for this batch index
                    bounded_put((b, e))
                    return
                if not bounded_put((b, batch)):
                    return

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_threads)]
        for t in threads:
            t.start()
        try:
            pending: Dict[int, Any] = {}
            want = 0
            got = 0
            while got < nb:
                while want not in pending:
                    b, batch = q.get()
                    if isinstance(batch, BaseException):
                        # the failed worker produces none of its later
                        # batches either — abort now, in-order delivery
                        # can never complete
                        raise batch
                    pending[b] = batch
                yield pending.pop(want)
                want += 1
                got += 1
                with window:
                    delivered[0] = want
                    window.notify_all()
        finally:
            stop.set()
            with window:
                window.notify_all()
            # drain so workers blocked on put() can exit
            while not q.empty():
                q.get_nowait()
