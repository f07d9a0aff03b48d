"""Device meshes, the batch's split over processes, replicated state.

Port of point_cloud_reid_tpu/parallel/mesh.py (make_mesh, batch_sharding,
replicated, shard_batch, sync_hosts). A JAX mesh is a grid of devices that
one SPMD program spans; here it is a plain (data, pairs) grid of
torch.devices that says where each shard runs:

  training   one process a card (torchrun), the data axis the processes:
             make_mesh() in a group of W processes has data = W, and each
             process trains on its contiguous block of the global batch
             (shard_batch, the DistributedSampler contract);
  scoring    PairScorer(model, mesh=...) splits a frame's detections (or
             its pair list) into one contiguous shard a mesh entry and runs
             the kernels of each shard on that entry's device
             (inference/pair_scoring.py). An entry may repeat a device:
             each entry is one shard, so eight "cpu" entries or "cuda:0"
             twice run the shard arithmetic on one device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .distributed import (backend_device, barrier, is_distributed,
                          process_count, process_index)


class Mesh:
    """A (data, pairs) grid of torch.devices.

    devices: the grid as a numpy object array; flat: its entries in
    row-major order (the order of the shards); size: the number of
    entries; shape: {axis name: length}; launches: per entry, the match
    and SA kernel launches of the shards it ran
    (kernels/match_grid.run_sharded)."""

    axis_names = ("data", "pairs")

    def __init__(self, grid: np.ndarray):
        self.devices = grid
        self.flat = [torch.device(d) for d in grid.reshape(-1)]
        self.size = len(self.flat)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.launches = [dict(match=0, sa=0) for _ in self.flat]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.flat]})"


def _global_devices() -> list:
    """One entry a process in a group (its card), else every visible card.
    Without a card the caller names the devices (devices=["cpu"] * n)."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh() without devices needs a CUDA device "
                           "(pass devices=['cpu'] * n for the CPU)")
    n = torch.cuda.device_count()
    if is_distributed():
        return [torch.device("cuda", r % n) for r in range(process_count())]
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(data: Optional[int] = None, pairs: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, pairs) mesh over `devices` (default: one card a process of
    the group, or this process's cards). data defaults to
    len(devices) // pairs; the first data * pairs devices are used, and
    fewer raise."""
    devices = list(devices) if devices is not None else _global_devices()
    if data is None:
        data = len(devices) // pairs
    if data < 1 or pairs < 1 or data * pairs > len(devices):
        raise ValueError(f"a ({data}, {pairs}) mesh needs {data * pairs} "
                         f"devices, got {len(devices)}")
    grid = np.empty((data * pairs,), dtype=object)
    for i, d in enumerate(devices[:data * pairs]):
        grid[i] = torch.device(d)
    return Mesh(grid.reshape(data, pairs))


def batch_sharding(mesh: Mesh, axis: str = "data") -> Tuple[int, int]:
    """(this process's block, the number of blocks) of a batch split along
    `axis`: (rank, W) in a group of W processes, whose mesh must have W
    entries on that axis; (0, 1) in one process, which trains on the whole
    batch."""
    if process_count() == 1:
        return 0, 1
    if mesh.shape[axis] != process_count():
        raise ValueError(f"a {process_count()}-process run needs a mesh with "
                         f"{process_count()} entries on '{axis}', got "
                         f"{mesh.shape}")
    return process_index(), process_count()


def shard_batch(mesh: Mesh, batch: Dict[str, Any], axis: str = "data"
                ) -> Dict[str, Any]:
    """This process's contiguous rows of the global batch (numpy arrays or
    tensors): process r of W takes rows [r B / W, (r + 1) B / W), the
    DistributedSampler contract; one process takes the whole batch."""
    index, count = batch_sharding(mesh, axis)
    if count == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.shape[0] % count:
            raise ValueError(f"{k}: {v.shape[0]} rows do not split over "
                             f"{count} processes")
        n = v.shape[0] // count
        out[k] = v[index * n:(index + 1) * n]
    return out


def _broadcast_(t: torch.Tensor, src: int) -> None:
    if t.device.type == "cpu" and dist.get_backend() == "nccl":
        dev = t.to(backend_device())
        dist.broadcast(dev, src)
        t.copy_(dev)
    else:
        dist.broadcast(t, src)


@torch.no_grad()
def replicated(*states, src: int = 0) -> None:
    """Broadcast, in place, every tensor of the given modules (parameters
    and buffers) and optimizers (train/schedules.ScheduledAdamW: AdamW's
    moments and step counts, the accumulated gradient and the update
    counters) from process `src`; a no-op in one process. Every process
    then holds the same state, as the JAX step's replicated parameters."""
    if process_count() == 1:
        return
    for s in states:
        if isinstance(s, torch.nn.Module):
            for t in s.state_dict().values():
                _broadcast_(t, src)
            continue
        for per_param in s.adamw.state.values():
            for t in per_param.values():
                if torch.is_tensor(t):
                    _broadcast_(t, src)
        for t in s._acc or ():
            _broadcast_(t, src)
        counters = [s.updates, s.mini_step]
        dist.broadcast_object_list(counters, src)
        s.updates, s.mini_step = counters


def sync_hosts(name: str = "sync") -> None:
    """Every process waits for the others; a no-op in one process."""
    barrier(name)

