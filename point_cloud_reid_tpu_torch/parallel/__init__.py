"""The parallel layer: process groups, meshes, data-parallel training.

Port of point_cloud_reid_tpu/parallel (the same nine names). The JAX
package's SPMD program over a mesh becomes one process a card under
torchrun with a torch.distributed group (NCCL on cards, gloo on the CPU):
init_distributed joins it, replicated broadcasts the initial state,
shard_batch gives a process its rows of the global batch, the train step
reduces every term that couples rows (parallel/distributed.py), and
allgather_results gathers eval results. make_mesh's grid also carries the
sharded scoring of inference/pair_scoring.py.
"""
from .distributed import (allgather_results, barrier, dp_step_check,
                          init_distributed)
from .mesh import (
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
    sync_hosts,
)

__all__ = ["allgather_results", "barrier", "batch_sharding", "dp_step_check",
           "init_distributed", "make_mesh", "replicated", "shard_batch",
           "sync_hosts"]
